"""Small-model latency: race a budgeted host BFS against the card.

A copy of ``stateright_tpu/checker/race.py``. The device engine pays
fixed costs a tiny model never amortizes (the seed, the kernel build's
load, the graph capture), while the host enumerates such a model in
milliseconds. The Rust crate's ``check`` semantics are simply "the
spawned checking run finishes" (``checker.rs:116-145``), so
``spawn_gpu()`` spawns both engines and adopts whichever finishes first:

  * the host racer is budgeted (default 1.5 s, ``gpu_options(
    race_budget=seconds)``): small models finish well inside it; for big
    models it cancels itself;
  * the loser is cancelled cooperatively (``HostChecker.cancel()``), and
    a cancelled or failed racer is never adopted. A model whose
    successors overflow the packed layout (``EncodingOverflow``) waits
    for the budgeted host racer, as in the JAX package: a complete host
    result wins (``profile()["device_error"]`` names the overflow); the
    error surfaces only when the host cannot finish in budget. Any other
    device error (a failed build or launch, a kernel's fault, a probe
    overflow) ends the race at once and surfaces from ``join()``: the
    host's answer never hides a broken kernel;
  * for full enumerations both engines' unique counts and fingerprint
    sets agree exactly (the host BFS is the differential oracle of the
    device engine), so the adopted winner is observationally
    equivalent. Early-exit generated counts are engine-specific.

Racing is skipped (the card alone) whenever the run needs a
device-only or engine-specific feature: a visitor, symmetry reduction,
``sound_eventually``, ``resume_from``/``resumable``, an explicit
``gpu_options(mode=...)``, or ``gpu_options(race=False)``. A mesh never
races here: ``race=True`` with a mesh raises (``spawn_gpu``).

While both racers run, the interpreter's switch interval is shortened
(``SWITCH_INTERVAL_S``, 10 µs): the host BFS is a
pure-Python loop that gives up the interpreter lock only when forced,
and the device lane releases it in every CUDA call (its seed, the
graph capture, one launch call a chunk), so each return would otherwise
wait for the lock for up to the default 5 ms (``tools/torch_race_gil.py``
measures both; PERF.md § 5).

The failover rung, opt-in on the port: with ``gpu_options(
failover=True)`` a raced run whose device lane fails with a TRANSIENT
fault (``checker/resilience.py`` ``classify_error``: a dead backend,
retries exhausted) is answered by an un-budgeted host BFS instead
(``profile()["failovers"]`` 1, ``engine`` ``"host"``), as in the JAX
package, where it is on by default. Here it is off by default: an entry
point runs on the card unless the caller asks for the host, so a
transient fault surfaces from ``join()`` (after the card's own retries
and autosave) rather than being answered on the CPU. It applies only to
a raced run and only to a transient fault: a programming error (a
failed build or launch, a kernel's fault) still surfaces.
"""

from __future__ import annotations

import atexit
import sys
import threading
import time

from .builder import Checker, CheckerBuilder
from .gpu import EncodingOverflow

#: the interpreter's switch interval while both racers run (seconds)
SWITCH_INTERVAL_S = 1e-5

#: worker threads of cancelled losers (threads only — retaining the
#: checker objects would pin their visited sets, frontiers and device
#: buffers for the process's lifetime); a loser may still be draining a
#: device chunk when the decision is made
_LOSER_THREADS: list = []


def join_losers(timeout: float = 60.0) -> bool:
    """Wait up to ``timeout`` seconds for each retired loser's thread
    and forget the finished ones; returns whether none is still alive.
    A phase that reads ``ops._cuda.LAUNCHES`` calls it first, so a
    loser still draining a chunk adds nothing to its counts."""
    for thread in list(_LOSER_THREADS):
        thread.join(timeout=timeout)
    _LOSER_THREADS[:] = [t for t in _LOSER_THREADS if t.is_alive()]
    return not _LOSER_THREADS


@atexit.register
def _drain_losers() -> None:
    if not join_losers():
        names = ", ".join(repr(t.name) for t in _LOSER_THREADS)
        print(f"stateright_tpu_torch: raced loser thread(s) {names} still "
              "alive after a 60s join at interpreter exit; the process "
              "may not exit cleanly", file=sys.stderr)


def _retire(checker) -> None:
    checker.cancel()
    thread = getattr(checker, "_thread", None)
    if thread is not None:
        _LOSER_THREADS.append(thread)


#: the racers that hold the short switch interval, and the interval they
#: found (restored when the last one decides)
_SWITCH_LOCK = threading.Lock()
_SWITCH_STATE = {"holders": 0, "saved": None}


def _shorten_switch_interval() -> bool:
    """Set :data:`SWITCH_INTERVAL_S` (unless the interval is already
    shorter); returns whether the caller must restore it."""
    with _SWITCH_LOCK:
        if _SWITCH_STATE["holders"] == 0:
            _SWITCH_STATE["saved"] = sys.getswitchinterval()
            sys.setswitchinterval(min(SWITCH_INTERVAL_S,
                                      _SWITCH_STATE["saved"]))
        _SWITCH_STATE["holders"] += 1
    return True


def _restore_switch_interval() -> None:
    with _SWITCH_LOCK:
        _SWITCH_STATE["holders"] -= 1
        if _SWITCH_STATE["holders"] == 0:
            sys.setswitchinterval(_SWITCH_STATE["saved"])


def race_eligible(builder: CheckerBuilder) -> bool:
    opts = builder.gpu_options_
    return (opts.get("race", True)
            and "mesh" not in opts
            and "mode" not in opts
            and not opts.get("resumable")
            and builder.visitor_ is None
            and builder.symmetry_fn_ is None
            and not builder.sound_eventually_
            and builder.resume_path_ is None)


class RacingChecker(Checker):
    """Adopts the first engine (host BFS or the card) to finish."""

    #: host racer budget: small models finish in milliseconds; anything
    #: that outlives this is device territory. Overridable per run via
    #: ``gpu_options(race_budget=seconds)``.
    HOST_BUDGET_S = 1.5

    def __init__(self, builder: CheckerBuilder):
        from .bfs import BfsChecker
        from .gpu import GpuChecker

        self._model = builder.model
        self._builder = builder  # kept for the failover rung
        budget = builder.gpu_options_.get("race_budget")
        if budget is not None:
            self.HOST_BUDGET_S = float(budget)
        # built here, so a device the run cannot use raises from
        # spawn_gpu(), as it does unraced
        self._gpu = GpuChecker(builder)
        try:
            self._host = BfsChecker(builder)
        except Exception:
            # a model that can't run on the host engine races nothing
            self._host = None
        self._winner = None
        self._failover = False
        #: the device run's error when the host answered
        self._device_error = None
        self._decided = threading.Event()
        self._decider: threading.Thread | None = None
        self._decider_lock = threading.Lock()

    # ------------------------------------------------------------------
    def _start_background(self) -> None:
        """Start both engines and the decider thread (non-blocking, so
        ``report()``'s progress lines keep working)."""
        with self._decider_lock:
            if self._decider is None:
                shortened = (self._host is not None
                             and _shorten_switch_interval())
                self._gpu._start_background()
                if self._host is not None:
                    self._host._start_background()
                self._decider = threading.Thread(
                    target=self._decide_loop, args=(shortened,),
                    daemon=True)
                self._decider.start()

    def _decide_loop(self, shortened: bool) -> None:
        host, gpu = self._host, self._gpu
        fallback = False  # host is the un-budgeted failover engine
        t0 = time.monotonic()
        try:
            while True:
                # first, so a host that finished in the same poll cannot
                # hide it: an error of the card, not of the model (nor a
                # transient fault, which the host may answer for)
                if (gpu._done and gpu._error is not None
                        and not self._host_may_answer(gpu._error)):
                    self._winner = gpu
                    if host is not None:
                        _retire(host)
                    break
                if host is not None and host._done:
                    if host._error is None and not host.cancelled():
                        self._winner = host
                        self._device_error = gpu._error
                        _retire(gpu)
                        break
                    host = None  # disqualified; the device run decides
                if gpu._done and gpu._error is None:
                    self._winner = gpu
                    if host is not None:
                        _retire(host)
                    break
                # the model outgrew the packed layout, or the card failed
                # transiently: the budgeted host racer may still deliver
                # a complete, correct result — wait for it; past it, a
                # transient fault falls over to an un-budgeted host BFS
                if host is None and gpu._done:
                    host = None if fallback else self._spawn_fallback(gpu)
                    if host is None:
                        self._winner = gpu  # surfaces the device error
                        break
                    fallback = True
                    continue
                if (host is not None and not fallback
                        and time.monotonic() - t0 > self.HOST_BUDGET_S):
                    _retire(host)
                    host = None
                time.sleep(0.002)
        finally:
            if shortened:
                _restore_switch_interval()
        self._decided.set()
        # drop the loser after publishing the decision: retaining it
        # would pin its visited set, frontier and device buffers
        if self._winner is not self._gpu:
            self._gpu = None
        if self._winner is not self._host:
            self._host = None

    def _host_may_answer(self, err: BaseException) -> bool:
        """Whether the host may answer for a failed device run: an
        encoding overflow (a limit of the model's packed layout), or a
        transient fault with failover on."""
        return isinstance(err, EncodingOverflow) or self._failover_applies(
            err)

    def _failover_applies(self, err: BaseException) -> bool:
        from .resilience import FaultKind, classify_error
        return (self._builder.gpu_options_.get("failover", False)
                and classify_error(err) is FaultKind.TRANSIENT)

    def _spawn_fallback(self, gpu):
        """The failover rung (the JAX package's ``_spawn_fallback``):
        after a transient device failure, start an un-budgeted host BFS
        and return it, or ``None`` when failover does not apply (another
        error, failover not asked for, a model the host engine cannot
        run)."""
        err = gpu._error
        if err is None or not self._failover_applies(err):
            return None
        from .bfs import BfsChecker
        try:
            host = BfsChecker(self._builder)
        except Exception:
            return None
        self._failover = True
        host._start_background()
        return host

    def _decide(self):
        if self._winner is None:
            self._start_background()
            self._decided.wait()
        return self._winner

    # --- Checker interface (decides, then delegates) -------------------
    def join(self) -> "Checker":
        self._decide().join()
        return self

    def is_done(self) -> bool:
        return self._decided.is_set() and self._winner.is_done()

    def model(self):
        return self._model

    def state_count(self) -> int:
        # live progress before a winner exists: the device run's counts
        if self._decided.is_set():
            return self._winner.state_count()
        gpu = self._gpu
        return gpu.state_count() if gpu is not None else 0

    def unique_state_count(self) -> int:
        if self._decided.is_set():
            return self._winner.unique_state_count()
        gpu = self._gpu
        return gpu.unique_state_count() if gpu is not None else 0

    def profile(self):
        """The winning engine's ``profile()``, with ``engine`` naming the
        winner: ``"host"`` for the budgeted host racer (or the failover
        rung's host BFS), ``"device"`` for the card; a failover adds
        ``failovers`` 1."""
        from .bfs import BfsChecker

        winner = self._decide()
        prof = winner.profile()
        prof["engine"] = ("host" if isinstance(winner, BfsChecker)
                          else "device")
        if self._device_error is not None and winner is not self._gpu:
            prof["device_error"] = str(self._device_error)
        if self._failover:
            prof["failovers"] = prof.get("failovers", 0) + 1
        return prof

    def discoveries(self):
        return self._decide().discoveries()

    def generated_fingerprints(self):
        return self._decide().generated_fingerprints()

    def error(self):
        return self._decide().error()

    def save(self, path) -> None:
        # gpu_options(resumable=True) disables racing, so a raced run
        # never has a checkpointable frontier, whichever engine won
        raise RuntimeError(
            "save() needs the pending frontier: run with "
            "gpu_options(resumable=True) on the device engine")

    def __getattr__(self, name):
        # engine-specific surface: the winner's (losers are freed on
        # decision), else the not-yet-decided device checker's
        winner = self.__dict__.get("_winner")
        if winner is not None:
            return getattr(winner, name)
        gpu = self.__dict__.get("_gpu")
        if gpu is not None:
            return getattr(gpu, name)
        raise AttributeError(name)
