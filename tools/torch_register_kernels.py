#!/usr/bin/env python3
"""The register family's K1 instantiations on the card, at the steps
their runs launch, and the runs around them, one JSON line per tree and
measurement.

    python tools/torch_register_kernels.py
    python tools/torch_register_kernels.py --old build/parent
    python tools/torch_register_kernels.py --sweep
    python tools/torch_register_kernels.py --timer-sweep

The steps (``GROUP_STEPS``, ``OTHER_STEPS``): a mid-search carry of each
configuration, built by the tree's own loop (its digest printed, so two
trees are compared on the same carry), stepped once as the search
launches the step inside a chunk: gated, the pending rows a prefix whose
count the gate carries (``gated_launch``). K1-abd at PackedAbd(2)'s
256-row step (~54 pending), K1-single_copy at PackedSingleCopy(3)'s
9,954-row step (~588 pending), at a 512-row step of it with every row
pending and at PackedSingleCopy(4)'s 9,475-row step (``auto_fmax``'s)
with every row pending. On each: K1-K3 (one step) timed with CUDA events
and under ``torch.profiler`` (K1's own device ms, the median of
``TRACES`` traced launches), with a digest of its
outputs on the lanes and rows the redesigned K1 writes (``held``: the
same in both trees when both compute the same function there) and K1's
bound (bytes of the rows it steps, their children and the lanes' keys and
flags). Then the kernels the redesign must leave as they were, timed
alike: K1-abd_ordered at its three ``chip_smoke.py`` steps,
TwoPhaseSys(7) and IncrementLock(9) at 12,288 rows, PackedPaxos(3) at
8,192, and K7 at 2pc7's rows and at tpu_abd2's 331-word rows. Then
K1-write_once (``CRASH_STEPS``: PackedWriteOnce(7, net_capacity=16)
.crash_restart(2, actors=[0]) at its run's 256-row step and at 1,024
rows all pending; ``crash_step``), timed alike, with the delivery, crash
and restart children it builds. Then PackedAbd(2) (544 states) and
PackedSingleCopy(3) (4,243) end to end, twice each for the wall and once
under ``torch.profiler`` (device ms by kernel, busy share). Last, every
trace taken, each crash step held lane for lane to its plain version on
its active lanes, and K1's phase clocks read over it: a build of the
tree's kernels with ``-DSRT_K1_PHASES`` (``build/k1_phases``; a tree
whose sources have no clocks reads none) adds, per block, the SM clock
ticks of K1's prologue, delivery children, edit children (crash and
restart, or drop) and tail (``csrc/step_common.cuh`` ``K1Clock``: a
barrier ends each phase in that build only; a K1 without the clocks,
the narrow one, reads none). ``FIXTURE_STEPS`` (K1-ping_pong at
PingPong(7)'s two steps, K1-timer_count at TimerCount(8, 4)'s) are
timed alike by ``tools/torch_paxos_kernels.py`` (``fixture_steps``;
``--fixtures`` there runs them alone).

``--sweep`` times K1-abd and K1-single_copy instead at each of
``GROUP_STEPS`` over other launches of this tree (no rebuild:
``ops/_cuda.py`` ``GROUP_THREADS`` and ``GROUP_BLOCKS_PER_SM`` set
before each), its outputs' digest beside each; ``--timer-sweep``
K1-timer_count at its ``FIXTURE_STEPS`` alike (``TIMER_THREADS``,
``TIMER_BLOCKS_PER_SM``).

``--old DIR`` also times another tree of the repository (the parent
commit unpacked there: ``git archive HEAD~ stateright_tpu_torch
chip_smoke.py | tar -x -C build/parent``), built from its own sources,
in separate processes in the order old, new, new, old, in the same
call. Needs a CUDA device; every line carries the card's name and power
limit from ``nvidia-smi``.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib
import json
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: the kernels whose registers each line reports (``chip_smoke.py``
#: ``ptxas_usage`` names, by library)
KERNELS = (("fused_step", "expand_kernel[AbdModel]"),
           ("fused_step", "expand_kernel[SingleCopyModel]"),
           ("fused_step", "expand_kernel[AbdOrderedModel]"),
           ("fused_step", "expand_kernel[PaxosModel]"),
           ("fused_step", "expand_kernel[TwoPcModel]"),
           ("fused_step", "expand_kernel[IncrementLockModel]"),
           ("fused_step", "expand_kernel[WriteOnceModel]"),
           ("fused_step", "expand_kernel[PaxosCrashModel]"),
           ("chunk", "append_kernel[1x128]"),
           ("chunk", "append_kernel[4x256]"),
           ("chunk", "append_kernel[16x256]"))
#: H100 SXM device memory bytes per second (the bound's rate)
HBM_BYTES_S = 3.35e12
#: traced launches a step's device ms is the median of
TRACES = 5

#: K1-abd's and K1-single_copy's steps: label, model (``chip_smoke.py``
#: constructors), instantiation, rows, rows pending at least
GROUP_STEPS = (
    ("PackedAbd(2)", lambda s: s._abd(2), "abd", 256, 48),
    ("PackedSingleCopy(3)", lambda s: s._single_copy(3), "single_copy",
     9954, 512),
    ("PackedSingleCopy(3) at 512 rows", lambda s: s._single_copy(3),
     "single_copy", 512, 512),
    ("PackedSingleCopy(4)", lambda s: s._single_copy(4), "single_copy",
     9475, 9475))
#: the other K1s, which must stay as they were
OTHER_STEPS = (
    ("PackedAbd(2, ordered=True)", lambda s: s._abd(2, ordered=True),
     "abd_ordered", 256, 48),
    ("abd3", lambda s: s._abd(3, server_count=2, ordered=True,
                               channel_depth=8), "abd_ordered", 1728, 1728),
    ("tpu_abd2", lambda s: s._abd(2, server_count=3, ordered=True,
                                   channel_depth=8), "abd_ordered", 1055,
     1055),
    ("2pc7", None, "twopc", 12288, 12288),
    ("lock9", None, "increment_lock", 12288, 12288),
    ("paxos3", None, "paxos", 8192, 8192))
#: K1-write_once's steps (``chip_smoke.py`` ``CRASH_STEPS``): its run's
#: 256-row step (~200 pending) and 1,024 rows all pending
CRASH_STEPS = (
    ("PackedWriteOnce(7)", lambda s: s._write_once(7, net_capacity=16,
                                                   crashes=2),
     "write_once", 256, 200),
    ("PackedWriteOnce(7) at 1,024 rows",
     lambda s: s._write_once(7, net_capacity=16, crashes=2), "write_once",
     1024, 1024))
#: the actor test fixtures' K1s (``chip_smoke.py`` ``LOSSY_STEPS``):
#: K1-ping_pong at PingPong(7)'s 8,192-row step (lossy, duplicating), at
#: the non-duplicating PingPong(7)'s 2-row widest level, as a 2-row step
#: and as its run launches it (the small step's 256 rows, ``ops/
#: expand.py`` ``FMAX_SMALL``, 2 pending), and at the lossless
#: PingPong(7)'s 1-row levels (every level of both networks) as their
#: runs launch them; K1-timer_count at TimerCount(8, 4)'s 8,192-row step
#: and at its run's 256-row small step (8 pending) beside them
FIXTURE_STEPS = (
    ("PackedPingPong(7, lossy=True, duplicating=True)",
     lambda s: s._ping_pong(7), "ping_pong", 8192, 8192),
    ("PackedPingPong(7, lossy=True, duplicating=False)",
     lambda s: s._ping_pong(7, duplicating=False), "ping_pong", 2, 2),
    ("PackedPingPong(7, lossy=True, duplicating=False) at 256 rows",
     lambda s: s._ping_pong(7, duplicating=False), "ping_pong", 256, 2),
    ("PackedPingPong(7, lossy=False, duplicating=True) at 256 rows",
     lambda s: s._ping_pong(7, lossy=False), "ping_pong", 256, 1),
    ("PackedPingPong(7, lossy=False, duplicating=False) at 256 rows",
     lambda s: s._ping_pong(7, lossy=False, duplicating=False),
     "ping_pong", 256, 1),
    ("PackedTimerCount(8, 4)", lambda s: s._timer_count(8, 4),
     "timer_count", 8192, 8192),
    ("PackedTimerCount(8, 4) at 256 rows", lambda s: s._timer_count(8, 4),
     "timer_count", 256, 2))
#: the instantiations with crash/restart lanes
CRASH_NAMES = ("write_once", "paxos_crash")
#: the instantiations whose K1 writes the children of their active lanes
#: only (``chip_smoke.py`` ``lossy_active``): the drop lanes' models
LOSSY_NAMES = ("paxos_lossy", "ping_pong")
#: the define a build with K1's phase clocks passes to nvcc
#: (``csrc/step_common.cuh`` ``K1Clock``), its build directory and the
#: phases in the order of ``k1_phase_ticks``
PHASE_DEFINE = "-DSRT_K1_PHASES"
PHASE_BUILD = os.path.join("build", "k1_phases")
PHASES = ("rows", "deliveries", "edits", "tail")


def card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()


def carry_digest(carry) -> str:
    """sha256 of the carry's queue rows and its sorted table keys."""
    h = hashlib.sha256()
    h.update(carry.q[:carry.q_tail].cpu().numpy().tobytes())
    keys = carry.table[carry.table != 0].sort().values
    h.update(keys.cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def lossy(model) -> bool:
    """Whether ``model`` (an actor model) runs on a lossy network: its
    K1 instantiation has drop lanes."""
    return bool(model.lossy_network_)


def held(smoke, model, name: str, frontier, take: int):
    """The lanes and rows whose outputs this tree's K1 writes (bool
    tensors): the pending rows of a group model (``abd``,
    ``single_copy``, ``write_once``), every row of the others; and of
    their lanes those below the quiet lane (a group model), of non-empty
    channels (``abd_ordered``) or active (a model with crash lanes:
    ``chip_smoke.py`` ``crash_active``; with drop lanes, ``paxos_lossy``
    and a lossy ``ping_pong``: ``lossy_active``); every lane of a
    lossless ``ping_pong``; of ``timer_count`` the pending rows' Timeout
    lanes whose timer bit is set (the lanes K1's timer path writes; the
    parent's narrow K1 wrote every lane, these among them)."""
    import torch

    f, a = frontier.shape[0], model.max_actions
    dev = frontier.device
    pend = ("abd", "single_copy", "write_once", "timer_count")
    rows = torch.arange(f, device=dev) < (take if name in pend else f)
    lanes = rows.repeat_interleave(a)
    if name == "timer_count":
        tw = frontier[:, model._timer_off].to(torch.int64) & 0xFFFFFFFF
        bits = torch.arange(a - 1, device=dev)
        timeouts = ((tw[:, None] >> bits) & 1) != 0
        lanes &= torch.cat([torch.zeros_like(timeouts[:, :1]), timeouts],
                           dim=1).reshape(-1)
    elif name in CRASH_NAMES:
        lanes &= smoke.crash_active(model)(frontier)
    elif name in LOSSY_NAMES and lossy(model):
        lanes &= smoke.lossy_active(model)(frontier)
    elif name == "abd_ordered":
        lens = frontier[:, model._net_off:model._net_off + model._n_chan]
        lanes &= (lens != 0).reshape(-1)
    elif name in ("abd", "single_copy"):
        e = model.net_capacity
        slots = frontier[:, model._net_off:model._timer_off].reshape(f, e, 4)
        quiet = ((slots != 0).any(-1)
                 * torch.arange(1, e + 1, device=dev)).max(-1).values
        lanes &= (torch.arange(e, device=dev)[None, :]
                  < quiet[:, None]).reshape(-1)
    return lanes, rows


def children(smoke, model, frontier, take: int) -> dict:
    """The children K1 builds over the first ``take`` rows of
    ``frontier``: with crash lanes (``chip_smoke.py`` ``crash_active``)
    deliveries, crashes and restarts; else (``lossy_active``) the
    deliveries and the drops or Timeout lanes before the network's zero
    tail or with the timer set."""
    a, e = model.max_actions, model.net_capacity
    if model.max_crashes_:
        n = len(model._crash_idx)
        act = smoke.crash_active(model)(frontier[:take]).reshape(take, a)
        return {"deliveries": int(act[:, :e].sum()),
                "crashes": int(act[:, e:e + n].sum()),
                "restarts": int(act[:, e + n:].sum())}
    act = smoke.lossy_active(model)(frontier[:take]).reshape(take, a)
    rest = "timeouts" if model.device_timers else "drops"
    return {"deliveries": int(act[:, :e].sum()), rest: int(act[:, e:].sum())}


def use_phase_build(cuda, tree: str):
    """Load the kernels of ``tree`` built with K1's phase clocks
    (``PHASE_DEFINE``, in ``PHASE_BUILD`` under the tree) in place of the
    loaded ones. Returns a function that puts the loaded ones back."""
    from pathlib import Path

    saved = (cuda._LIB, cuda._BUILD, cuda._NVCC_FLAGS, dict(cuda.BUILD_INFO))
    cuda._LIB = None
    cuda._BUILD = Path(tree) / PHASE_BUILD
    cuda._NVCC_FLAGS = [*cuda._NVCC_FLAGS, PHASE_DEFINE]
    cuda.BUILD_INFO.clear()
    cuda.build()

    def restore():
        cuda._LIB, cuda._BUILD, cuda._NVCC_FLAGS = saved[:3]
        cuda.BUILD_INFO.clear()
        cuda.BUILD_INFO.update(saved[3])
    return restore


def k1_phases(smoke, model, carry, f: int, reps: int):
    """K1's phase clocks over ``reps`` gated steps of ``f`` rows of
    ``carry`` (the phase build loaded: :func:`use_phase_build`): per
    phase the SM clock ticks a block spent in it, and its share of the
    block's; None where the tree's K1 has no clocks."""
    import ctypes

    import torch

    from stateright_tpu_torch.ops import _cuda
    from stateright_tpu_torch.ops.fused import StepWorkspace

    read = getattr(_cuda._LIB["fused_step"], "srt_k1_phase_ticks", None)
    if read is None:
        return None
    read.argtypes = [ctypes.c_void_p]
    read.restype = ctypes.c_int
    ticks = (ctypes.c_ulonglong * (len(PHASES) + 1))()
    _block, args = smoke.block_args(model, carry, f)
    take = min(carry.q_tail - carry.q_head, f)
    table, ring = carry.table.clone(), carry.ring.clone()
    ws = StepWorkspace(table.numel(), ring.shape[0],
                       len(model.properties()), table.device)
    launch, bump = gated_launch(model, args, table, ring, ws, take)
    launch()
    torch.cuda.synchronize()
    if read(ticks):
        raise RuntimeError("srt_k1_phase_ticks failed")
    for _ in range(reps):
        table.copy_(carry.table)
        ring.copy_(carry.ring)
        bump()
        launch()
    if read(ticks):
        raise RuntimeError("srt_k1_phase_ticks failed")
    blocks = int(ticks[len(PHASES)])  # over the reps launches
    if not blocks:  # a K1 without the clocks (the narrow K1)
        return None
    per = [ticks[i] / blocks for i in range(len(PHASES))]
    total = sum(per) or 1.0
    return {"blocks_per_launch": blocks / reps,
            "ticks_per_block": dict(zip(PHASES, per)),
            "share": dict(zip(PHASES, (p / total for p in per)))}


def gated_launch(model, args, table, ring, ws, take: int):
    """One step as a chunk launches it: gated (the gate's size 1, head
    0, ``take`` rows pending, its own tag), over ``args`` (``block_args``
    of ``chip_smoke.py``). Returns ``(launch, bump)``: ``bump()`` gives
    the next launch a new tag."""
    import torch

    from stateright_tpu_torch.ops import _cuda
    from stateright_tpu_torch.ops.fused import FusedOut, stats_len

    frontier, ebits, _fvalid, phi, plo = args
    # G_SIZE, G_HEAD, G_TAKE, G_TAG, G_QBASE, G_LBASE, G_LEN
    gate = torch.tensor([1, 0, take, ws.step + 1, 0, 0, 0],
                        dtype=torch.int32, device=frontier.device)

    def launch():
        return FusedOut(*_cuda.fused_step(
            model, frontier, ebits, None, phi, plo, table, ring, ws,
            stats_len(model), gate=gate.data_ptr(), gate_size=1))

    def bump():
        gate[3] += 1
    return launch, bump


def time_k1(smoke, model, name: str, carry, f: int, reps: int) -> dict:
    """K1-K3 over ``f`` rows of ``carry``, gated with its pending rows
    (at most ``f``): CUDA-event ms of one step, the profiled device ms
    by kernel, a digest of the outputs ``held`` gives (the children and
    their keys on its lanes, the property and eventually bits on its
    rows, cvalid, terminal and the stats but the probe rounds
    everywhere), and K1's bound in
    bytes (the pending rows read, their outputs, the held children, every
    lane's key and flag, the ring arena reset). No plain version."""
    import torch

    from stateright_tpu_torch.ops.fused import StepWorkspace

    block, args = smoke.block_args(model, carry, f)
    take = min(carry.q_tail - carry.q_head, f)
    table0, ring0 = carry.table.clone(), carry.ring.clone()
    t_k, r_k = table0.clone(), ring0.clone()
    ws = StepWorkspace(table0.numel(), ring0.shape[0],
                       len(model.properties()), block.device)
    launch, bump = gated_launch(model, args, t_k, r_k, ws, take)

    def restore():
        t_k.copy_(table0)
        r_k.copy_(ring0)
        bump()

    out = launch()
    torch.cuda.synchronize()
    a, w = model.max_actions, model.packed_width
    lanes = f * a
    written, rows = held(smoke, model, name, args[0], take)
    h = hashlib.sha256()
    for nm in ("flat", "chi", "clo"):
        h.update(getattr(out, nm)[written].cpu().numpy().tobytes())
    for nm in ("pbits", "ebits"):
        h.update(getattr(out, nm)[rows].cpu().numpy().tobytes())
    for nm in ("cvalid", "terminal"):
        h.update(getattr(out, nm).cpu().numpy().tobytes())
    # the stats but the probe rounds (S_ROUNDS, 2: the most bucket reads
    # of one lane, which a lost CAS race can add one to)
    stats = out.stats.cpu().numpy().copy()
    stats[2] = 0
    h.update(stats.tobytes())
    n_written = int(written.sum())
    ms = smoke.cuda_ms(launch, reps, restore)
    # each kernel's median over TRACES traced launches (one trace is one
    # launch: a few per cent apart from the next)
    runs = [smoke.device_times(launch, before=restore)
            for _ in range(TRACES)]
    by_runs = [r.get("by_kernel_ms") or {} for r in runs]
    by = {k: statistics.median(r.get(k, 0.0) for r in by_runs)
          for k in by_runs[0]}
    dev = {"ours_ms": statistics.median(r.get("ours_ms") or 0.0
                                        for r in runs)}
    pcols = max(len(model.properties()), 1)
    n_rows = int(rows.sum())
    k1_bytes = (n_rows * (4 * w + 4 + 1) + n_rows * (pcols + 4 + 1)
                + n_written * 4 * w + lanes * (8 + 1)
                + ring0.shape[0] * 8)
    return {"f": f, "pending": take, "lanes": lanes, "written": n_written,
            "outputs": h.hexdigest()[:16], "step_ms": ms,
            "step_device_ms": dev.get("ours_ms"),
            "k1_device_ms": by.get("expand_kernel"),
            "by_kernel_ms": by, "k1_bytes": k1_bytes,
            "k1_bound_ms": k1_bytes / HBM_BYTES_S * 1e3}


def k1_step(smoke, cuda, tree: str, model, name: str, label: str,
            rows: int, pending: int, reps: int, rule=None):
    """K1's instantiation ``name`` at a gated step of ``rows`` rows of a
    mid-search carry of ``model`` (at least ``pending`` pending):
    :func:`time_k1`'s line with the children it builds
    (:func:`children`). Returns the line and a function to call once
    every trace is taken (traces taken after a plain version or another
    build may lose K1's record): it holds the step lane for lane to its
    plain version (``chip_smoke.py`` ``check_step``) on the lanes
    ``rule`` names (every lane: None) and reads K1's phase clocks (the
    tree's phase build, where its sources have the clocks:
    :func:`k1_phases`), and returns their line."""
    import torch

    carry = smoke.mid_search_carry(model, torch.device("cuda", 0),
                                   rows=rows, pending=pending)
    res = time_k1(smoke, model, name, carry, rows, reps)
    _block, args = smoke.block_args(model, carry, rows)
    line = {"kernel": f"K1-{name}", "model": label,
            "carry": carry_digest(carry), "width": model.packed_width,
            **res, "children": children(smoke, model, args[0],
                                        res["pending"])}

    def finish() -> dict:
        check = smoke.check_step(model, carry, rows, reps=1, active=rule,
                                 gated=True)
        phases = None
        src = os.path.join(tree, "stateright_tpu_torch", "csrc",
                           "step_common.cuh")
        with open(src) as fh:
            clocked = "SRT_K1_PHASES" in fh.read()
        if clocked:
            restore = use_phase_build(cuda, tree)
            try:
                phases = k1_phases(smoke, model, carry, rows, reps)
            finally:
                restore()
        return {"kernel": f"K1-{name}", "model": label,
                "carry": line["carry"], "plain_ms": check["plain_ms"],
                "checks": check["checks"], "phases": phases}
    return line, finish


def crash_step(smoke, cuda, tree: str, model, name: str, label: str,
               rows: int, pending: int, reps: int):
    """:func:`k1_step` of a crash instantiation, held on its active
    lanes (``chip_smoke.py`` ``crash_active``)."""
    return k1_step(smoke, cuda, tree, model, name, label, rows, pending,
                   reps, rule=smoke.crash_active(model))


def fixture_steps(smoke, cuda, tree: str, reps: int) -> tuple:
    """:func:`k1_step` at each of ``FIXTURE_STEPS``: K1-ping_pong held on
    its active lanes (``lossy_active``) where lossy, K1-timer_count on
    its own (``timer_active``, where the tree has the rule: an older
    tree's narrow K1 on every lane), the lossless K1-ping_pong on every
    lane. Returns their lines and their finishing functions."""
    lines, finish = [], []
    for label, make, name, rows, pending in FIXTURE_STEPS:
        model = make(smoke)
        rule = (smoke.lossy_active(model)
                if name in LOSSY_NAMES and lossy(model) else None)
        if name == "timer_count" and hasattr(smoke, "timer_active"):
            rule = smoke.timer_active(model)
        line, fin = k1_step(smoke, cuda, tree, model, name, label, rows,
                            pending, reps, rule=rule)
        lines.append(line)
        finish.append(fin)
    return lines, finish


#: ``--sweep``'s launches: (threads a block, blocks an SM)
SWEEP = ((64, 4), (64, 8), (96, 6), (128, 2), (128, 3), (128, 4),
         (128, 6), (128, 8), (192, 3), (256, 2), (256, 4))


#: ``--timer-sweep``'s launches of K1-timer_count: (threads a block,
#: blocks an SM)
TIMER_SWEEP = ((64, 4), (64, 8), (128, 2), (128, 4), (128, 8), (256, 2),
               (256, 4), (512, 1), (512, 2))


def sweep(reps: int, timer: bool = False) -> int:
    """K1-abd and K1-single_copy at each of ``GROUP_STEPS`` of this tree
    over the launches of ``SWEEP``; with ``timer``, K1-timer_count at its
    ``FIXTURE_STEPS`` over those of ``TIMER_SWEEP`` (``ops/_cuda.py``
    ``TIMER_THREADS``, ``TIMER_BLOCKS_PER_SM``)."""
    sys.path.insert(0, ROOT)
    import torch

    from stateright_tpu_torch.ops import _cuda

    smoke = importlib.import_module("chip_smoke")
    dev = torch.device("cuda", 0)
    info = _cuda.build()
    head = {"tree": ROOT, "card": card(), "build_s": info["seconds"]}
    knobs = (("TIMER_THREADS", "TIMER_BLOCKS_PER_SM") if timer
             else ("GROUP_THREADS", "GROUP_BLOCKS_PER_SM"))
    default = tuple(getattr(_cuda, k) for k in knobs)
    sms = _cuda.sm_count(dev)
    steps = ([st for st in FIXTURE_STEPS if st[2] == "timer_count"]
             if timer else GROUP_STEPS)
    for label, make, name, rows, pending in steps:
        model = make(smoke)
        carry = smoke.mid_search_carry(model, dev, rows=rows,
                                       pending=pending)
        for threads, per_sm in TIMER_SWEEP if timer else SWEEP:
            for k, v in zip(knobs, (threads, per_sm)):
                setattr(_cuda, k, v)
            res = time_k1(smoke, model, name, carry, rows, reps)
            geo = _cuda.k1_launch(name, _cuda.tile_geometry(
                rows, model.max_actions, sms), rows, model.packed_width,
                model.max_actions, sms)
            print(json.dumps({**head, "sweep": label,
                              "threads": threads, "per_sm": per_sm,
                              "launch": {**geo[0]._asdict(),
                                         "smem_bytes": geo[1]},
                              **{k: res[k] for k in (
                                  "pending", "outputs", "k1_device_ms",
                                  "step_device_ms", "step_ms",
                                  "k1_bound_ms")}}), flush=True)
        for k, v in zip(knobs, default):
            setattr(_cuda, k, v)
        del carry
    return 0


def run_tree(tree: str, reps: int) -> int:
    """Time the register K1s, the other K1s and K7, and the unordered
    register runs of the repository at ``tree`` (its own package, build
    and ``chip_smoke.py``) in this process."""
    sys.path.insert(0, tree)
    import torch

    import stateright_tpu_torch as pkg
    from stateright_tpu_torch.examples.paxos_packed import PackedPaxos
    from stateright_tpu_torch.ops import _cuda

    smoke = importlib.import_module("chip_smoke")
    if not smoke.__file__.startswith(tree):
        raise RuntimeError(f"imported {smoke.__file__}, not {tree}'s")
    dev = torch.device("cuda", 0)
    info = _cuda.build()
    usage = {name: smoke.ptxas_usage(info["logs"].get(lib, "")).get(name)
             for lib, name in KERNELS}
    head = {"tree": tree, "card": card(), "build_s": info["seconds"]}
    print(json.dumps({**head, "usage": {k: v for k, v in usage.items()
                                        if v is not None}}), flush=True)

    def emit(**line):
        print(json.dumps({**head, **line}), flush=True)

    makers = {"2pc7": lambda s: pkg.TwoPhaseSys(7),
              "lock9": lambda s: pkg.IncrementLock(9),
              "paxos3": lambda s: PackedPaxos(3)}
    for label, make, name, rows, pending in GROUP_STEPS + OTHER_STEPS:
        model = (make or makers[label])(smoke)
        carry = smoke.mid_search_carry(model, dev, rows=rows,
                                       pending=pending)
        digest = carry_digest(carry)
        res = time_k1(smoke, model, name, carry, rows, reps)
        emit(kernel=f"K1-{name}", model=label, carry=digest,
             width=model.packed_width, **res)
        if label in ("2pc7", "tpu_abd2"):
            app = smoke.check_append(model, carry, rows, reps)
            emit(kernel="K7", model=label, carry=digest,
                 width=model.packed_width,
                 **{k: app.get(k) for k in (
                     "lanes", "appended", "ms", "device_ms", "plain_ms",
                     "bytes", "bound_ms", "bound_by", "max_abs_err",
                     "checks")})
        del carry
    crash_checks = []
    for label, make, name, rows, pending in CRASH_STEPS:
        line, finish = crash_step(smoke, _cuda, tree, make(smoke), name,
                                  label, rows, pending, reps)
        emit(**line)
        crash_checks.append(finish)
    # the unordered register runs end to end
    path = ("fused_step", "chunk_begin", "append", "history", "hpull")
    runs = (("abd2", lambda: smoke._abd(2), smoke.PIN_ABD2),
            ("single_copy3", lambda: smoke._single_copy(3), smoke.PIN_SC3))
    keys = ("wall_s", "unique", "generated", "digest", "loop_s",
            "host_eval_s", "histories", "iterations", "graph_launches",
            "launches", "checks")
    for label, make, want in runs:
        for turn in range(2):
            res, ck = smoke.register_run(make(), path, want=want,
                                         holds=("linearizable",))
            del ck
            emit(run=label, turn=turn, **{k: res.get(k) for k in keys})

        def one(make=make):
            return make().checker().gpu_options(race=False).spawn_gpu() \
                .join()
        prof = smoke.device_times(one)
        emit(run=label, profiled=True, **{k: prof.get(k) for k in (
            "loop_s", "busy", "ours_ms", "torch_ms", "copy_ms",
            "by_kernel_ms", "by_kernel_calls", "graph_launches")})
    # the crash steps' plain versions and phase clocks, every trace taken
    for finish in crash_checks:
        emit(**finish())
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--old", help="the root of another tree of the "
                    "repository, timed before and after this one")
    ap.add_argument("--sweep", action="store_true",
                    help="time K1-abd and K1-single_copy over other "
                    "launches")
    ap.add_argument("--timer-sweep", action="store_true",
                    help="time K1-timer_count over other launches")
    ap.add_argument("--tree", help=argparse.SUPPRESS)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("torch_register_kernels: no CUDA device", file=sys.stderr)
        return 2
    if args.tree:
        return run_tree(args.tree, args.reps)
    if args.sweep or args.timer_sweep:
        return sweep(args.reps, timer=args.timer_sweep)
    print(card(), flush=True)
    trees = [ROOT] if not args.old else [
        os.path.abspath(args.old), ROOT, ROOT, os.path.abspath(args.old)]
    for tree in trees:
        cmd = [sys.executable, os.path.abspath(__file__), "--tree", tree,
               "--reps", str(args.reps)]
        rc = subprocess.run(cmd, cwd=tree).returncode
        if rc:
            return rc
    return 0


if __name__ == "__main__":
    sys.exit(main())
