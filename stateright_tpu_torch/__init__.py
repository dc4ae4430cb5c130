"""stateright_tpu_torch: the PyTorch/CUDA port of ``stateright_tpu``.

``TwoPhaseSys(n).checker().spawn_gpu().join()`` runs the device-resident
BFS model checker on one NVIDIA Hopper GPU (so do ``PackedLinearEquation``,
``Increment``, with its symmetry, ``IncrementLock`` and ``PackedPaxos``,
whose ``linearizable`` property the host evaluates): the loop's step is a
hand-written CUDA kernel (``csrc/fused_step.cu``) built with ``nvcc`` on
first use; ``gpu_options(device="cpu")`` runs the kernels' plain torch
versions instead. The package imports torch, numpy and the standard
library only — never JAX and nothing of ``stateright_tpu``, which stays
the reference the port is tested against.
"""

from .checker import Checker, CheckerBuilder, Path
from .core import Expectation, Model, Property
from .examples.increment import Increment
from .examples.increment_lock import IncrementLock
from .examples.paxos_packed import PackedPaxos
from .models.packed import PackedLinearEquation
from .models.twopc import TwoPhaseSys

__all__ = ["Checker", "CheckerBuilder", "Expectation", "Increment",
           "IncrementLock", "Model", "PackedLinearEquation", "PackedPaxos",
           "Path", "Property", "TwoPhaseSys"]
