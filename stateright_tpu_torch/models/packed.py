"""The packed-model protocol in batched torch form.

Counterpart of ``stateright_tpu/models/packed.py``. A :class:`PackedModel`
is an ordinary :class:`~stateright_tpu_torch.core.Model` that also defines
a canonical fixed-width uint32-word encoding of its states and a batched
transition relation and property evaluation over ``[F, W]`` tensors. The
inherited host methods stay the oracle for differential testing and for
replaying device-discovered witnesses.

The host/device contract (checked by :func:`validate_packed_model`):
  * ``fingerprint(state) == fp64_words(encode(state))``;
  * the multiset of valid successors of ``packed_step(encode(s))`` equals
    ``{encode(t) for t in next_states(s)}``;
  * ``packed_properties(encode(s))[i] == properties()[i].condition(self, s)``.

A model that supports symmetry reduction on the device also defines
``packed_representative(words)``: the canonical rows of a ``[F, W]``
batch, bit-exact with ``encode(representative(s))``.

On the card the engine does not call the torch methods: the step kernel
evaluates the model's CUDA device functions (``csrc/<name>.cuh``), named
by :meth:`PackedModel.cuda_spec`. The torch methods are their plain
versions.
"""

from __future__ import annotations

from typing import Any, Tuple

import numpy as np
import torch

from ..core import Model
from ..fingerprint import fp64_words


class PackedModel(Model):
    """Mixin adding the packed (GPU engine) interface to a model."""

    #: number of uint32 words per packed state
    packed_width: int
    #: static upper bound on actions per state
    max_actions: int
    #: property indices evaluated on the host (not ported: the GPU
    #: engine raises for models that declare any)
    host_property_indices: Tuple[int, ...] = ()

    def cache_key(self):
        """Hashable identity of this model's packed program."""
        return None

    def encode(self, state: Any) -> np.ndarray:
        """Canonical ``uint32[packed_width]`` encoding of ``state``."""
        raise NotImplementedError

    def decode(self, words) -> Any:
        """Inverse of :meth:`encode`."""
        raise NotImplementedError

    def packed_step(self, words: torch.Tensor):
        """Batched transition relation.

        Args:
          words: ``[F, packed_width]`` uint32 words (int32 bit patterns
            or int64 values).
        Returns:
          ``(succ int64[F, max_actions, packed_width], valid
          bool[F, max_actions])`` — row ``[f, a]`` is the result of
          action ``a`` on state ``f`` (values in ``[0, 2**32)``). Models
          whose encoding can overflow may return a third ``bool[F, A]``
          overflow mask; the engine then stops with an error.
        """
        raise NotImplementedError

    def packed_properties(self, words: torch.Tensor) -> torch.Tensor:
        """``bool[F, P]`` in ``self.properties()`` order."""
        raise NotImplementedError

    def cuda_spec(self, symmetry: bool = False
                  ) -> Tuple[str, Tuple[int, ...]]:
        """``(model name, integer parameters)`` of the CUDA device
        functions the step kernel is instantiated with; ``symmetry``
        asks for the ones of the symmetric step, which also canonicalize
        each child as ``packed_representative`` does."""
        raise NotImplementedError(
            f"{type(self).__name__} has no CUDA device functions; the "
            "GPU step kernel supports TwoPhaseSys in this slice")

    def fingerprint(self, state: Any) -> int:
        return fp64_words(self.encode(state).tolist())


def validate_packed_model(model: PackedModel, max_states: int = 2000,
                          batch: int = 256) -> int:
    """BFS-walk the host model and check the host/device contract for
    every reachable state (up to ``max_states``), one batched torch call
    per ``batch`` states. Returns the number of states validated."""
    from ..ops.hash_kernel import fp64_device

    properties = model.properties()
    seen = set()
    states = []
    queue = list(model.init_states())
    while queue and len(states) < max_states:
        state = queue.pop()
        fp = model.fingerprint(state)
        if fp in seen:
            continue
        seen.add(fp)
        states.append((state, fp))
        queue.extend(t for t in model.next_states(state)
                     if model.within_boundary(t))

    for start in range(0, len(states), batch):
        chunk = states[start:start + batch]
        encs = []
        for state, _fp in chunk:
            enc = model.encode(state)
            if enc.dtype != np.uint32 or enc.shape != (model.packed_width,):
                raise AssertionError(
                    f"encode() must return uint32[{model.packed_width}], "
                    f"got {enc.dtype}[{enc.shape}]")
            if not np.array_equal(model.encode(model.decode(enc)), enc):
                raise AssertionError(f"decode(encode(s)) != s for {state!r}")
            encs.append(enc)
        rows = torch.from_numpy(np.stack(encs).astype(np.int64))
        dhi, dlo = fp64_device(rows)
        out = model.packed_step(rows)
        succ, valid = out[0].numpy(), out[1].numpy()
        ovf = out[2].numpy() if len(out) == 3 else np.zeros_like(valid)
        pb = model.packed_properties(rows).numpy()
        host_props = set(model.host_property_indices)
        for k, (state, fp) in enumerate(chunk):
            dev_fp = (int(dhi[k]) << 32) | int(dlo[k])
            if dev_fp != fp:
                raise AssertionError(
                    f"device fp {dev_fp:#x} != host fp {fp:#x} for "
                    f"{state!r}")
            if ovf[k].any():
                raise AssertionError(
                    f"packed_step reports encoding overflow for {state!r}")
            packed_succ = sorted(tuple(succ[k, a].tolist())
                                 for a in range(model.max_actions)
                                 if valid[k, a])
            host_succ = sorted(tuple(model.encode(t).tolist())
                               for t in model.next_states(state)
                               if model.within_boundary(t))
            if packed_succ != host_succ:
                raise AssertionError(
                    "packed successors disagree with host successors for "
                    f"{state!r}:\n packed={packed_succ}\n host={host_succ}")
            for i, prop in enumerate(properties):
                if i in host_props:
                    continue
                want = bool(prop.condition(model, state))
                if bool(pb[k, i]) != want:
                    raise AssertionError(
                        f"packed property {prop.name!r} = {bool(pb[k, i])}"
                        f" != host {want} for {state!r}")
    return len(states)
