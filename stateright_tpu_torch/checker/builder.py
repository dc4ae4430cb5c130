"""Checker builder and results interface.

Counterpart of ``stateright_tpu/checker/builder.py``, trimmed to this
port's engine: ``spawn_gpu()`` with ``gpu_options(...)``. The builder
methods whose features are not ported (visitors, sound eventually,
checkpoints) are kept so a caller's intent is never dropped:
``spawn_gpu()`` raises ``NotImplementedError`` for each of them.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

from ..core import Expectation, Model
from .path import Path


class CheckerBuilder:
    """Builder for checking runs (the Rust crate's ``CheckerBuilder``)."""

    def __init__(self, model: Model):
        self.model = model
        self.symmetry_fn_: Optional[Callable[[Any], Any]] = None
        self.target_state_count_: Optional[int] = None
        self.visitor_ = None
        self.gpu_options_: dict = {}
        self.resume_path_ = None
        self.sound_eventually_: bool = False

    def symmetry(self) -> "CheckerBuilder":
        return self.symmetry_fn(lambda state: state.representative())

    def symmetry_fn(self, representative) -> "CheckerBuilder":
        """Symmetry reduction: ``representative(state)`` is the canonical
        member of the state's class. ``spawn_gpu()`` dedups on the
        fingerprint of the model's ``packed_representative`` (the device
        canonicalization, which must agree with ``representative`` bit
        for bit; checked on the init states) and replays witnesses
        through the original states it explored.
        ``generated_fingerprints()`` then answers canonical keys."""
        self.symmetry_fn_ = representative
        return self

    def target_state_count(self, count: int) -> "CheckerBuilder":
        """The checker may exceed this count but never stops short of it
        while more states exist."""
        self.target_state_count_ = count if count > 0 else None
        return self

    def visitor(self, visitor) -> "CheckerBuilder":
        self.visitor_ = visitor
        return self

    def sound_eventually(self) -> "CheckerBuilder":
        self.sound_eventually_ = True
        return self

    def resume_from(self, path) -> "CheckerBuilder":
        self.resume_path_ = path
        return self

    def gpu_options(self, **options) -> "CheckerBuilder":
        """Knobs of ``spawn_gpu``: ``capacity`` (visited-table slots, a
        power of two, default 2**20), ``fmax`` (frontier rows per step),
        ``cc_dedup`` (cross-chunk ring: True = 2**15 slots, False = off,
        or a power-of-two slot count), ``chunk_steps`` (iterations per
        chunk, default 64: the device runs up to that many steps between
        two host syncs; on the card one CUDA graph of an iteration is
        replayed that many times), ``pipeline`` (default True: chunk
        N+1 is launched before chunk N's counters are read, so one chunk
        is always in flight; a ``target_state_count`` then lands up to
        one chunk late, as in the JAX package; False: each chunk is read
        before the next is launched), ``grow_at`` (table load that
        triggers growth, default 0.55) — the JAX package's
        ``tpu_options`` of the same names — and ``device`` (default
        ``"cuda"``; ``device="cpu"`` runs the kernels' plain versions).

        The sharded engine adds ``mesh`` (a ``torch.distributed``
        DeviceMesh: CUDA with NCCL, or CPU with gloo; its device type
        sets the device), ``mesh_axis`` (default ``"shards"``; its size
        must be a power of two), ``exchange`` (``"bucket"``, the
        default, or ``"ring"``), ``kb`` (rows per destination of the
        bucketed exchange), ``kraw`` and ``kmax`` (candidate widths);
        ``capacity`` is then the global table, split evenly over the
        ranks. Its loop is a host loop: ``chunk_steps`` has no effect
        there and ``pipeline=True`` is refused."""
        self.gpu_options_.update(options)
        return self

    def spawn_gpu(self) -> "Checker":
        """The GPU engine: the device-resident BFS loop driving the
        hand-written CUDA step kernel. Requires a
        :class:`~stateright_tpu_torch.models.packed.PackedModel`. With
        ``gpu_options(mesh=...)`` the sharded engine runs instead, one
        rank per device of the mesh axis."""
        if "mesh" in self.gpu_options_:
            from ..parallel.engine import ShardedGpuChecker
            return ShardedGpuChecker(self)
        from .gpu import GpuChecker
        return GpuChecker(self)


class Checker:
    """Results interface (the Rust crate's ``Checker`` trait)."""

    def model(self) -> Model:
        raise NotImplementedError

    def state_count(self) -> int:
        """Total states generated including repeats (>= unique)."""
        raise NotImplementedError

    def unique_state_count(self) -> int:
        raise NotImplementedError

    def discoveries(self) -> Dict[str, Path]:
        raise NotImplementedError

    def join(self) -> "Checker":
        raise NotImplementedError

    def is_done(self) -> bool:
        raise NotImplementedError

    def profile(self) -> Dict[str, Any]:
        return {}

    def discovery(self, name: str) -> Optional[Path]:
        return self.discoveries().get(name)

    def discovery_classification(self, name: str) -> str:
        prop = self.model().property(name)
        if prop.expectation in (Expectation.ALWAYS, Expectation.EVENTUALLY):
            return "counterexample"
        return "example"

    def assert_properties(self) -> None:
        """Examples exist for every ``sometimes``; no counterexamples for
        any ``always``/``eventually``."""
        for p in self.model().properties():
            if p.expectation == Expectation.SOMETIMES:
                self.assert_any_discovery(p.name)
            else:
                self.assert_no_discovery(p.name)

    def assert_any_discovery(self, name: str) -> Path:
        found = self.discovery(name)
        if found is not None:
            return found
        if not self.is_done():
            raise AssertionError(
                f'Discovery for "{name}" not found, but model checking is '
                "incomplete.")
        raise AssertionError(f'Discovery for "{name}" not found.')

    def assert_no_discovery(self, name: str) -> None:
        found = self.discovery(name)
        if found is not None:
            raise AssertionError(
                f'Unexpected "{name}" {self.discovery_classification(name)} '
                f"{found}Last state: {found.last_state()!r}\n")
        if not self.is_done():
            raise AssertionError(
                f'Discovery for "{name}" not found, but model checking is '
                "incomplete.")
