"""Checker builder and results interface.

Counterpart of ``stateright_tpu/checker/builder.py``: ``spawn_bfs()``
and ``spawn_dfs()`` (the host engines, single worker), and
``spawn_gpu()`` with ``gpu_options(...)``, which races a budgeted host
BFS against the card by default as the JAX package's ``spawn_tpu()``
does. The builder methods whose features are not ported (visitors,
sound eventually) are kept so a caller's intent is never dropped: every
engine raises ``NotImplementedError`` for each of them.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional, Sequence

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
        """Resume a ``spawn_gpu`` run from a checkpoint written by
        ``Checker.save`` (the fingerprint record and the pending
        frontier), by this package or by the JAX package."""
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
        there and ``pipeline=True`` is refused.

        ``race`` (default True on one card): ``spawn_gpu()`` races a
        host BFS, budgeted to ``race_budget`` seconds (default 1.5),
        against the card and adopts the first to finish
        (``checker/race.py``); ``race=False`` runs the card alone.
        ``resumable=True`` keeps the pending frontier after the run, so
        ``save()`` can checkpoint it (it disables the race, as do
        symmetry and ``resume_from``). A mesh takes neither.

        The resilience layer of one card (``checker/resilience.py``), the
        JAX package's ``tpu_options`` of the same names, defaults and
        meanings: ``retries`` (consecutive transient faults recovered,
        default 0), ``backoff`` (first delay in seconds, doubled with
        jitter, default 1.0) and ``retry_seed`` (the jitter's seed);
        ``chunk_deadline`` (seconds a chunk's sync may take before the
        watchdog turns it into a transient fault); ``autosave`` (a
        checkpoint path, written every ``autosave_interval`` chunks,
        default 32, and at the two terminal endings); ``audit`` (every
        Nth chunk's fresh fingerprints re-hashed by the host oracle;
        ``True`` every chunk, a float a sampled fraction) and
        ``corrupt_hook``; ``fault_hook`` (called before each chunk's
        sync: the fault injection point); ``max_capacity`` (the table's
        growth budget, a power of two), ``spill`` (default True: past the
        budget, or on an allocation fault, cold prefix ranges of the
        table are evicted into the host tier), ``spill_frac`` (default
        0.5) and ``max_spills`` (consecutive, default 8); and the race's
        ``failover`` (default False on the port, True in the JAX package:
        with it, a raced run whose card fails transiently is answered by
        an un-budgeted host BFS). Any of
        ``retries``, ``autosave``, ``audit`` or ``max_capacity`` keeps a
        host shadow of the search, folded after every chunk. ``degrade``,
        ``min_mesh`` and ``blame_after`` (the mesh's degradation ladder)
        and every resilience key on a mesh raise (ROADMAP A9b), and
        ``max_segment`` with the per-level engine (ROADMAP B16)."""
        self.gpu_options_.update(options)
        return self

    def spawn_bfs(self) -> "Checker":
        """Breadth-first host engine (the Rust crate's
        ``checker.rs:116-130``), one worker."""
        from .bfs import BfsChecker
        return BfsChecker(self)

    def spawn_dfs(self) -> "Checker":
        """Depth-first host engine (``checker.rs:132-145``), one worker:
        the only host engine with symmetry reduction, as in the Rust
        crate."""
        from .dfs import DfsChecker
        return DfsChecker(self)

    def spawn_gpu(self) -> "Checker":
        """The GPU engine: the device-resident BFS loop driving the
        hand-written CUDA step kernel. Requires a
        :class:`~stateright_tpu_torch.models.packed.PackedModel`. By
        default a budgeted host BFS races it and the first to finish
        wins (``checker/race.py``); ``gpu_options(race=False)`` runs the
        card alone. With ``gpu_options(mesh=...)`` the sharded engine
        runs instead, one rank per device of the mesh axis, never
        raced."""
        from .race import RacingChecker, race_eligible
        if "mesh" in self.gpu_options_ and \
                self.gpu_options_.get("race") is True:
            raise NotImplementedError(
                "gpu_options(race=True) with a mesh is not ported "
                "(ROADMAP A9b): every rank would run its own host racer "
                "and could adopt a different winner without a collective "
                "decision")
        if race_eligible(self):
            return RacingChecker(self)
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

    def error(self) -> Optional[BaseException]:
        """The engine's failure, if any (overridden by engines)."""
        return None

    def profile(self) -> Dict[str, Any]:
        return {}

    def _metrics_summary(self, elapsed: float) -> str:
        """One compact ``# key=value ...`` line from ``profile()``
        (empty when it has none of the keys)."""
        prof = self.profile()
        parts: List[str] = []
        if "engine" in prof:
            parts.append(f"engine={prof['engine']}")
        for key in ("chunks", "grows"):
            if prof.get(key):
                parts.append(f"{key}={int(prof[key])}")
        if elapsed > 0 and "sync_stall" in prof:
            parts.append(f"stall={prof['sync_stall'] / elapsed:.0%}")
        return "# " + " ".join(parts) if parts else ""

    def discovery(self, name: str) -> Optional[Path]:
        return self.discoveries().get(name)

    def report(self, w) -> "Checker":
        """Status lines and the discovery summary (the Rust crate's
        ``checker.rs:217-242``): ``Checking. states=N, unique=N`` once a
        second while the run goes on, then ``Done. states=N, unique=N,
        sec=S[, rate=R/s]``, a ``# engine=... chunks=...`` line when the
        engine recorded any, and one block per discovery."""
        start = time.monotonic()
        if not self.is_done():
            w.write(f"Checking. states={self.state_count()}, "
                    f"unique={self.unique_state_count()}\n")
            self._start_background()
            last_print = time.monotonic()
            while not self.is_done():
                time.sleep(0.01)
                now = time.monotonic()
                if now - last_print >= 1.0:
                    w.write(f"Checking. states={self.state_count()}, "
                            f"unique={self.unique_state_count()}\n")
                    last_print = now
        err = self.error()
        if err is not None:
            raise err
        elapsed = time.monotonic() - start
        rate = (f", rate={self.state_count() / elapsed:.0f}/s"
                if elapsed > 0.1 else "")
        w.write(f"Done. states={self.state_count()}, "
                f"unique={self.unique_state_count()}, "
                f"sec={int(elapsed)}{rate}\n")
        summary = self._metrics_summary(elapsed)
        if summary:
            w.write(summary + "\n")
        for name, path in self.discoveries().items():
            w.write(f'Discovered "{name}" '
                    f"{self.discovery_classification(name)} {path}")
        return self

    def _start_background(self) -> None:
        """Hook for engines that can make progress concurrently."""

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

    def _raise_engine_error(self) -> None:
        """A crashed engine must not read as "checked clean"."""
        err = self.error()
        if err is not None:
            raise err

    def assert_any_discovery(self, name: str) -> Path:
        found = self.discovery(name)
        if found is not None:
            return found
        self._raise_engine_error()
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
        self._raise_engine_error()
        if not self.is_done():
            raise AssertionError(
                f'Discovery for "{name}" not found, but model checking is '
                "incomplete.")

    def assert_discovery(self, name: str, actions: Sequence[Any]) -> None:
        """Raises unless ``actions`` also witness the property (the Rust
        crate's ``checker.rs:291-338``)."""
        additional_info: List[str] = []
        found = self.assert_any_discovery(name)
        model = self.model()
        for init_state in model.init_states():
            path = Path.from_actions(model, init_state, actions)
            if path is None:
                continue
            prop = model.property(name)
            if prop.expectation == Expectation.ALWAYS:
                if not prop.condition(model, path.last_state()):
                    return
            elif prop.expectation == Expectation.EVENTUALLY:
                states = path.into_states()
                is_satisfied = any(prop.condition(model, s) for s in states)
                acts: List[Any] = []
                model.actions(states[-1], acts)
                is_terminal = not acts
                if not is_satisfied and is_terminal:
                    return
                if is_satisfied:
                    additional_info.append(
                        "incorrect counterexample satisfies eventually "
                        "property")
                if not is_terminal:
                    additional_info.append(
                        "incorrect counterexample is nonterminal")
            else:
                if prop.condition(model, path.last_state()):
                    return
        info = f" ({'; '.join(additional_info)})" if additional_info else ""
        raise AssertionError(
            f'Invalid discovery for "{name}"{info}, but a valid one was '
            f"found. found={found.into_actions()!r}")
