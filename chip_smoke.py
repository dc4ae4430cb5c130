#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``stateright_tpu_torch``) on one
NVIDIA GPU.

    python3 chip_smoke.py

Phases, one JSON line each:

1. device  — the card (torch and ``nvidia-smi``), torch/CUDA/nvcc versions;
2. build   — the nvcc build of ``stateright_tpu_torch/csrc`` for sm_90a:
             seconds, and each kernel's registers and shared memory;
3. kernels — each kernel held against its plain torch version on the card
             at the main paths' shapes (2pc n=7, a mid-search frontier of
             12,288 and of 256 rows, a 2**20-slot table, a 2**15-slot
             ring; the owner-side probe at the received width of the
             sharded step; the symmetric steps at 2pc n=16, 82 actions,
             with both representatives) by the lane and set gates, and
             timed with CUDA events and ``torch.profiler``, with each
             kernel's own device time, bound and launch geometry
             (``parts``);
4. e2e     — ``TwoPhaseSys(7).checker().spawn_gpu().join()`` with default
             options, checked against the oracle counts, the fingerprint-set
             digest, the properties and both witness replays, with every
             kernel's launch count set to 0 before the run and read after
             it; then again from a 2**16-slot table, which grows twice;
5. e2e_sym — symmetry reduction on one card: every reachable 2pc7 state
             recounted into its 920 orbits and 9,840 reference keys
             (``orbits_2pc7``); ``TwoPhaseSys(n[, complete_symmetry=True])
             .checker().symmetry_fn(model.representative).spawn_gpu()`` at
             n=7 and n=16: the complete representative held to the JAX
             package's count, generated count and canonical-key digest,
             the reference one to its sound range at n=7, to covering
             every orbit (its enqueued original rows canonicalized by the
             complete representative) and, at n=16 (the full-width run,
             over a million reduced states), to the card's own count,
             generated count and key digest, to a repeated search record
             and the complete run's verdicts, with a profiled repeat;
             the complete one again through table growth; witnesses
             replay;
6. e2e_sharded — the same check through the sharded engine,
             ``gpu_options(mesh=<DeviceMesh>)``, on a one-rank NCCL group
             (one card), with default options and again from a 2**16-slot
             table at 512-row steps, which grows; the same launch counts,
             and a second run's search record compared row for row; then
             2pc16 under complete symmetry (``e2e_sharded_sym``), held to
             the single-chip pins.
7. models  — the other models end to end through the same entry points,
             every launch count set to 0 before each run: IncrementLock(9)
             (3,945,637 states, the full-width run: the JAX package's
             counts and digest, both properties hold, at least two
             growths: the table quadruples, 2**20 -> 2**22 -> 2**24),
             PackedLinearEquation(2, 4, 7) from a 2**14-slot
             table (65,536 states, no discovery; each growth recaptures
             the chunk's graph), PackedLinearEquation(2, 10, 14) (its
             ``solvable`` witness replays), Increment(7) and Increment(16)
             with and without symmetry reduction (the ``fin``
             counterexample replays, as long as the JAX package's), and
             through the one-rank sharded engine IncrementLock(8)
             (438,401), PackedLinearEquation(2, 4, 7), Increment(7) and
             Increment(7) under symmetry. Before them (phase
             ``kernels``) K1 of each new instantiation, with K2/K3 and
             K5, at a real mid-search step (IncrementLock(9) and
             Increment(16) with and without symmetry at 12,288 and 256
             rows, PackedLinearEquation at 256: its frontier never holds
             more), held to its plain version lane for lane.

Then a ``kernels`` line (the contract's per-kernel record), the card's name
and power limit from ``nvidia-smi``, and as the last line
``{"ok": true, "device": {...}}``. Any failed check or exception exits
non-zero before that line. It exits 2 without a CUDA device or outside a
checkout of the repository.

    python3 chip_smoke.py --ranks 4

runs the sharded engine across that many cards instead, one process per
card on one NCCL group: 2pc n=7 with the bucketed exchange and with the
ring, 2pc n=16 under complete symmetry with the bucketed exchange, and
IncrementLock(8), each held to the same counts, digest and witnesses on
every rank (phase ``e2e_ranks``). It needs that many cards.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import subprocess
import sys
import time

#: TwoPhaseSys(7) full enumeration: unique states (the oracle the JAX
#: package's engines pin) and generated transitions, from the JAX
#: package's fused device engine on the CPU:
#:   TwoPhaseSys(7).checker().tpu_options(race=False, fused=True,
#:       mode="device").spawn_tpu().join().state_count()
UNIQUE_2PC7 = 296_448
GENERATED_2PC7 = 2_744_706
#: sha256 of the sorted visited fingerprints as little-endian uint64.
#: tests/test_torch_engine.py::test_2pc7_plain_path_digest (slow) holds
#: both the port's plain path and that JAX run to all three constants
DIGEST_2PC7 = ("68bd762484aa0d7b8f3efb611f754ba2"
               "908888832a15e5df5b2c5656db338113")

#: TwoPhaseSys(16, complete_symmetry=True) under symmetry reduction
#: (``symmetry_fn(model.representative)``): the 21,335 RM-permutation
#: orbits of 2pc with 16 RMs, state_count() (the init state and 450,858
#: generated transitions) and the sha256 of the sorted canonical keys,
#: from the JAX package's fused device engine on the CPU (Pallas in
#: interpret mode, fmax=256; its staged engine gives the same), with the
#: model's property patterns made uint32 constants: at n=16 the JAX
#: package's Python-int patterns overflow JAX's scalar parsing.
#: tests/test_torch_symmetry.py::test_complete_symmetry_pins holds that
#: JAX run and the port's plain path to all three. The orbit-invariant
#: representative makes them the same for every engine and step size.
UNIQUE_2PC16_SYM = 21_335
GENERATED_2PC16_SYM = 450_859
DIGEST_2PC16_SYM = ("e8cd19b6cdc0755720449d43e37723c6"
                    "4178e70a74bc6c5bb313a4882505089f")
#: the same for TwoPhaseSys(7, complete_symmetry=True): 920 orbits
UNIQUE_2PC7_SYM = 920
GENERATED_2PC7_SYM = 8_410
DIGEST_2PC7_SYM = ("4302d7490af6f8bfb60b2c6197f14954"
                   "654cee87bde6e7dbcd38fd5d2d05b43c")
#: the sound range of the reference representative at n=7: at least
#: one key per orbit, at most the distinct representative keys over all
#: 296,448 states (phase ``orbits_2pc7`` recounts both on the card)
REF_KEYS_2PC7 = 9_840
#: TwoPhaseSys(16) under the reference representative on the card:
#: reduced states, state_count() and the sha256 of the sorted canonical
#: keys. The count depends on the engine's winner rule (ROADMAP C3): the
#: card inserts the lowest valid lane of each fresh key, which fixes it
#: at every step size (tools/torch_symmetry_counts.py on an H100 at
#: 12,288, 4,096, 1,024 and 256 rows per step), where the CPU path, with
#: the JAX package's winner rule, reaches other counts.
UNIQUE_2PC16_REF = 1_309_367
GENERATED_2PC16_REF = 23_296_759
DIGEST_2PC16_REF = ("6284d610fdbea7532587dc7e1c5b8ad8"
                    "2fa2963c47f0b7651e44f9960eeaffc3")

#: IncrementLock(n) full enumerations (both properties hold, so no run
#: stops early): unique states, state_count() and the sha256 of the
#: sorted fingerprints, from the JAX package's staged device engine on
#: the CPU:
#:   IncrementLock(n).checker().tpu_options(race=False, fused=False,
#:       mode="device").spawn_tpu().join()
#: A full enumeration's counts and set do not depend on the engine; the
#: state graph is a tree, so state_count() equals the unique count.
#: tests/test_torch_more_models.py::test_increment_lock_pins (slow) holds
#: that run, and at n=8 the port's plain path, to both.
PIN_LOCK9 = (3_945_637, 3_945_637,
             "6fbe2180605bddc081d764732c4c2817"
             "d7b550fbe76c14fcf1ffa10df3431713")
PIN_LOCK8 = (438_401, 438_401,
             "801d745277f0952a55f29a14065bc786"
             "a7199cac78aaf7a82021d8a1ae56d138")
#: the actions in the JAX package's witness of Increment(n)'s falsified
#: ``fin`` at n = 7 and 16, with and without symmetry reduction (two
#: reads, then both writes): ``len(ck.discovery("fin"))`` of
#:   Increment(n).checker()[.symmetry_fn(model.representative)]
#:       .tpu_options(race=False, fused=True, mode="device")
#:       .spawn_tpu().join()
#: A BFS finds a shortest witness whatever its engine's order, so the
#: card's has this length too.
FIN_LEN = 4
#: the same for PackedLinearEquation(2, 10, 14)'s ``solvable`` (the JAX
#: run's witness ends at (x, y) = (2, 1))
SOLVABLE_LEN = 3

#: HBM bandwidth of an H100 SXM (bytes/s) and its CUDA-core fp32 rate
#: (operations/s): NVIDIA's published peaks at 700 W. The steps do 32-bit
#: integer work, for which no peak is published beside these; it is
#: counted at the fp32 CUDA-core rate.
HBM_BYTES_S = 3.35e12
CORE_OPS_S = 67e12
#: threads per block of K3 and of K5's commit (``kCommitThreads`` of
#: stateright_tpu_torch/csrc/step_common.cuh)
COMMIT_THREADS = 64


def emit(**fields) -> None:
    print(json.dumps(fields), flush=True)


def run(cmd) -> str:
    return subprocess.run(cmd, capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip()


def fp_digest(fps) -> str:
    import numpy as np
    arr = np.array(sorted(fps), dtype=np.uint64)
    return hashlib.sha256(arr.astype("<u8").tobytes()).hexdigest()


#: this port's kernels, by the name each has in the profiler; longer
#: names first, so a name that contains another is matched as itself
_OURS = ("dedup_claim_kernel", "dedup_commit_kernel", "flat_insert_kernel",
         "expand_kernel", "claim_kernel", "commit_kernel",
         "append_count_kernel", "append_kernel", "gate_kernel",
         "chunk_begin_kernel")


def kernel_name(symbol: str):
    name = next((k for k in _OURS if k in symbol), None)
    if name == "expand_kernel" and ("true>" in symbol or "Lb1E" in symbol):
        return "expand_kernel_sym"  # the symmetric instantiation of K1
    return name


def kernel_instance(symbol: str):
    """The kernel a symbol names, K1 with its model's struct:
    ``expand_kernel[TwoPcModel]``, ``expand_kernel_sym[IncrementModel]``
    (mangled or demangled names)."""
    name = kernel_name(symbol)
    if name not in ("expand_kernel", "expand_kernel_sym"):
        return name
    m = re.search(r"expand_kernelI(\d+)", symbol)
    if m:
        model = symbol[m.end():m.end() + int(m.group(1))]
    else:
        m = re.search(r"expand_kernel<(\w+)", symbol)
        model = m.group(1) if m else "?"
    return f"{name}[{model}]"


def ptxas_usage(log: str) -> dict:
    """Registers and shared memory per kernel (each instantiation of K1
    by its model) from ``-Xptxas -v`` of one library."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line) \
            or re.search(r"Function properties for (\w+)", line)
        if m:
            name = m.group(1)
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            smem = re.search(r"(\d+) bytes smem", line)
            out[kernel_instance(name) or name] = {
                "registers": int(m.group(1)),
                "smem_bytes": int(smem.group(1)) if smem else 0}
    return out


def cuda_ms(fn, reps: int, before=None) -> float:
    """Mean device milliseconds of ``fn()`` over ``reps`` launches after
    one warm-up; ``before()`` (untimed) restores its inputs."""
    import torch
    if before:
        before()
    fn()
    total = 0.0
    for _ in range(reps):
        if before:
            before()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def device_times(fn, host_top: int = 0, before=None) -> dict:
    """Device time of one call of ``fn`` from ``torch.profiler``, split
    into this port's kernels (by name), torch's kernels, and copies and
    memsets, in milliseconds; ``None`` values when the trace holds no
    device time. ``before()`` (outside the trace) restores ``fn``'s
    inputs before each try. ``host_top`` > 0 adds the host operations
    with the most self CPU time (name, ms, calls). ``cuda_api``: the
    CUDA runtime calls of the host (``cudaLaunchKernel``,
    ``cudaGraphLaunch``, ...) as [calls, host ms]; when ``fn`` returns a
    checker, ``loop_s`` is its profile's and ``busy`` the traced device
    time over it."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    # a trace now and then holds no device time: up to three tries
    for _attempt in range(3):
        if before:
            before()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            result = fn()
            torch.cuda.synchronize()
        ours = {k: 0.0 for k in _OURS + ("expand_kernel_sym",)}
        torch_ms = copy_ms = 0.0
        seen = False
        for e in prof.key_averages():
            if e.device_type != DeviceType.CUDA:
                continue
            us = getattr(e, "self_device_time_total", None)
            if us is None:
                us = e.self_cuda_time_total
            seen = seen or us > 0
            name = kernel_name(e.key)
            if name:
                ours[name] += us / 1e3
            elif "memcpy" in e.key.lower() or "memset" in e.key.lower():
                copy_ms += us / 1e3
            else:
                torch_ms += us / 1e3
        if seen:
            break
    out = {"ours_ms": None, "torch_ms": None, "copy_ms": None,
           "by_kernel_ms": None}
    if seen:
        out = {"ours_ms": sum(ours.values()), "torch_ms": torch_ms,
               "copy_ms": copy_ms, "by_kernel_ms": ours}
    if host_top:
        cpu = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CPU]
        cpu.sort(key=lambda e: e.self_cpu_time_total, reverse=True)
        out["host_top"] = [(e.key, e.self_cpu_time_total / 1e3, e.count)
                           for e in cpu[:host_top]]
    out["cuda_api"] = {e.key: [e.count, e.self_cpu_time_total / 1e3]
                       for e in prof.key_averages()
                       if e.device_type == DeviceType.CPU
                       and e.key.startswith("cuda")}
    loop_s = (result.profile().get("loop_s")
              if hasattr(result, "profile") else None)
    if loop_s:
        out["loop_s"] = loop_s
        if seen:
            out["busy"] = (out["ours_ms"] + torch_ms + copy_ms) / (
                loop_s * 1e3)
    return out


def mid_search_carry(model, device, symmetry: bool = False,
                     rows: int = 12288, pending: int = None,
                     past_discoveries: bool = False):
    """A real mid-search state of ``model`` (2pc n=7, or n=16 under
    symmetry reduction; the other models' at their kernels' checks): the
    port's own loop run at ``rows`` rows per step until at least
    ``pending`` (default ``rows``) rows are pending. A model whose every
    property is soon discovered (Increment's ``fin``) would stop there:
    ``past_discoveries`` clears the discovery flags after each step, so
    the search goes on to a wide frontier."""
    import numpy as np
    import torch

    from stateright_tpu_torch.checker.device_loop import (B_DISC, E_ITERS,
                                                          run_chunk,
                                                          seed_carry)
    from stateright_tpu_torch.ops.hashtable import table_insert
    from stateright_tpu_torch.ops.words import from_numpy_u32

    init = model.init_states()[0]
    fp = model.fingerprint(model.representative(init) if symmetry
                           else init)
    carry = seed_carry(model, 1 << 21, 1 << 20, [model.encode(init)], 0,
                       [fp], 1 << 15, device, symmetry=symmetry)
    table_insert(carry.table,
                 from_numpy_u32(np.array([fp >> 32], np.uint32), device),
                 from_numpy_u32(np.array([fp & 0xFFFFFFFF], np.uint32),
                                device),
                 torch.ones((1,), dtype=torch.bool, device=device),
                 mask=False)
    # one iteration per chunk: the small step while at most FMAX_SMALL
    # rows are pending, else one of ``rows`` rows (the loop condition
    # also keeps the queue's margin)
    want = rows if pending is None else pending
    while carry.q_tail - carry.q_head < want:
        c = run_chunk(model, carry, fmax=rows, steps=1)
        if not c[carry.layout.ext + E_ITERS]:
            raise RuntimeError(f"the search ended before a {want}-row "
                               "frontier")
        if past_discoveries:
            carry.ctr[B_DISC:B_DISC + carry.layout.P] = 0
    return carry


def lowest_lane_wins(out, among=None) -> bool:
    """The kernel's winner rule: each inserted lane is the lowest lane of
    ``among`` (default: the lanes that carried their key to the table,
    ``dvalid``) carrying its key."""
    from stateright_tpu_torch.ops.words import pack64

    return lowest_valid_lane_wins(pack64(out.chi, out.clo),
                                  out.dvalid if among is None else among,
                                  out.inserted)


def lowest_valid_lane_wins(keys, valid, inserted) -> bool:
    """Each ``inserted`` lane is the lowest ``valid`` lane carrying its
    key (the owner-word rule of the step and the flat insert)."""
    import torch

    lanes = torch.arange(keys.shape[0], device=keys.device)
    uniq, inv = torch.unique(keys[valid], return_inverse=True)
    first = torch.full((uniq.shape[0],), keys.shape[0], dtype=torch.int64,
                       device=keys.device)
    first.scatter_reduce_(0, inv, lanes[valid], reduce="amin")
    won = first[torch.searchsorted(uniq, keys[inserted])]
    return bool((won == lanes[inserted]).all())


def bound(nbytes: int, ops: int) -> dict:
    """The least time the card could take for ``nbytes`` of device
    memory traffic and ``ops`` integer operations, and which bounds it."""
    return {"bytes": nbytes, "ops": ops,
            "bound_ms": max(nbytes / HBM_BYTES_S, ops / CORE_OPS_S) * 1e3,
            "bound_by": ("bytes" if nbytes / HBM_BYTES_S
                         >= ops / CORE_OPS_S else "operations")}


def kernel_parts(model, f: int, symmetry: bool, cc: int, by_kernel,
                 counts=None, noprobe=None) -> dict:
    """Per kernel of one step over ``f`` rows: its device ms (from
    ``by_kernel``, a profiled call), its own bound and its launch
    geometry. K1 (expand) always; with ``counts = (valid lanes, tile
    winners, tile winners that reached the table, inserted lanes)`` also
    K2 (claim) and K3 (commit) of the single-chip step; with ``noprobe =
    (valid lanes, tile winners, tile winners the ring held, claims)``
    K5's claim and commit of the probe-free step. Each kernel counts its
    own inputs read once and outputs written once, so the parts' bounds
    add up to more than the step's (K1's outputs are K2's inputs)."""
    import torch

    from stateright_tpu_torch.ops import _cuda

    w = model.packed_width
    a = model.max_actions
    lanes = f * a
    pcols = max(len(model.properties()), 1)
    by_kernel = by_kernel or {}
    tiles = _cuda.tile_geometry(
        f, a, _cuda.sm_count(torch.cuda.current_device()))
    geometry = tiles._asdict()
    # K3 and K5's commit: one block per tile, COMMIT_THREADS threads
    commit_geometry = {"threads": COMMIT_THREADS, "blocks": tiles.blocks}
    k1 = "expand_kernel_sym" if symmetry else "expand_kernel"
    parts = {k1: {
        "device_ms": by_kernel.get(k1),
        **bound(f * (4 * w + 4 + 1)                # frontier, ebits, fvalid
                + f * (pcols + 4 + 1)              # pbits, ebits, terminal
                + lanes * (4 * w + 8 + 1)          # flat, chi/clo, cvalid
                + lanes * (8 if symmetry else 0)   # ohi/olo
                + cc * 8,                          # the ring arena reset
                lanes * step_ops(model, symmetry)),
        "geometry": geometry}}
    if counts is not None:
        valid, winners, table, ins = counts
        parts["claim_kernel"] = {
            "device_ms": by_kernel.get("claim_kernel"),
            # cvalid, chi/clo, dvalid, inserted per lane; the ring per
            # tile winner; a bucket and the owner word per tile winner
            # that reaches the table; the claim, the ring arena and the
            # 8-byte claims-list entry per inserted lane; a count per
            # tile; 16 operations per valid lane for the tile dedup and
            # 12 per table probe
            **bound(lanes * 11 + (winners * 8 if cc else 0)
                    + table * (32 + 8) + ins * (8 + 8 + 8)
                    + tiles.blocks * 4,
                    valid * 16 + table * 12),
            "geometry": geometry}
        parts["commit_kernel"] = {
            "device_ms": by_kernel.get("commit_kernel"),
            # a count per tile; per claim its entry (table slot and ring
            # slot), owner word and inserted byte, and the ring arena
            # slot and the ring write
            **bound(tiles.blocks * 4
                    + ins * (8 + 8 + 1 + ((8 + 8) if cc else 0)),
                    ins * 8),
            "geometry": commit_geometry}
    if noprobe is not None:
        valid, winners, held, claims = noprobe
        parts["dedup_claim_kernel"] = {
            "device_ms": by_kernel.get("dedup_claim_kernel"),
            # cvalid, chi/clo, dvalid per lane; the ring per tile winner;
            # the arena key and owner word per winner the ring did not
            # hold; the 8-byte claims-list entry per claim; a count per
            # tile; 16 operations per valid lane for the tile dedup and 4
            # per arena probe
            **bound(lanes * 10 + (winners * 8 if cc else 0)
                    + (winners - held) * 16 + claims * 8
                    + tiles.blocks * 4,
                    valid * 16 + (winners - held) * 4),
            "geometry": geometry}
        parts["dedup_commit_kernel"] = {
            "device_ms": by_kernel.get("dedup_commit_kernel"),
            # a count per tile; per claim its cell, owner word, dvalid
            # byte and the cell's clear
            **bound(tiles.blocks * 4 + claims * (8 + 8 + 1 + 8),
                    claims * 8),
            "geometry": commit_geometry}
    return parts


def step_ops(model, symmetry: bool) -> int:
    """Integer operations per lane of K1: ~20 for the successor and ~25
    per packed word for its fingerprint (~120 at 2pc's four words), and
    under symmetry as many again: the lane's changed field moved within
    its row's representative (the row's sort, shared by its lanes, adds
    a few per lane; Increment's move picks each of its n thread words,
    ~5 operations apiece) and the second fingerprint."""
    from stateright_tpu_torch import Increment

    ops = 20 + 25 * model.packed_width
    if symmetry:
        ops += 20 + 25 * model.packed_width + (
            5 * model.n if isinstance(model, Increment) else 0)
    return ops


def block_args(model, carry, f: int, pfp=None):
    """The step inputs over ``f`` pending rows of ``carry``: frontier,
    ebits, fvalid and the frontier fingerprints (the queue's cached ones,
    or ``pfp(rows)``)."""
    import torch

    w = model.packed_width
    block = carry.q[carry.q_head:carry.q_head + f]
    take = min(carry.q_tail - carry.q_head, f)
    fvalid = torch.arange(f, device=block.device) < take
    phi, plo = (block[:, w + 1], block[:, w + 2]) if pfp is None \
        else pfp(block[:, :w])
    return block, (block[:, :w], block[:, w], fvalid, phi, plo)


def check_step(model, carry, f: int, reps: int, symmetry: bool = False,
               pfp=None) -> dict:
    """K1-K3 (one ``fused_step``, the symmetric instantiation under
    ``symmetry``) against ``fused_step_reference`` on the card over ``f``
    pending rows of ``carry``, by the set gate."""
    import numpy as np
    import torch

    from stateright_tpu_torch.ops.fused import (S_CCH, S_DEDUP, S_DISC,
                                                S_FAULT, S_INSERTED, S_OVF,
                                                S_XOVF, StepWorkspace,
                                                fused_step,
                                                fused_step_reference)
    from stateright_tpu_torch.ops.words import pack64

    w = model.packed_width
    block, args = block_args(model, carry, f, pfp)
    table0, ring0 = carry.table.clone(), carry.ring.clone()
    t_k, r_k = table0.clone(), ring0.clone()
    t_p, r_p = table0.clone(), ring0.clone()
    n_props = len(model.properties())
    ws = StepWorkspace(table0.numel(), ring0.shape[0], n_props,
                       block.device)
    k = fused_step(model, *args, t_k, r_k, ws, symmetry=symmetry)
    n_claims = int(ws.n_claims.sum())  # K2's claims, which K3 walks
    # the plain version walks its blocks one after another: it is timed
    # on this one comparison step only
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    p = fused_step_reference(model, *args, t_p, r_p, symmetry=symmetry)
    end.record()
    end.synchronize()
    plain_ms = start.elapsed_time(end)
    lane_exact = ("flat", "chi", "clo", "cvalid", "pbits", "ebits",
                  "terminal") + (("ohi", "olo") if symmetry else ())
    err = 0
    for name in lane_exact:
        a = getattr(k, name).to(torch.int64)
        b = getattr(p, name).to(torch.int64)
        if a.shape != b.shape:
            raise AssertionError(f"f={f} {name}: shape {a.shape} != {b.shape}")
        err = max(err, int((a - b).abs().max()) if a.numel() else 0)

    def inserted_keys(out):
        keys = pack64(out.chi, out.clo)[out.inserted].cpu().numpy()
        return keys, set(keys.tolist())

    kk, ks = inserted_keys(k)
    pk, ps = inserted_keys(p)
    table_k = np.sort(t_k[t_k != 0].cpu().numpy())
    table_p = np.sort(t_p[t_p != 0].cpu().numpy())
    sk, sp = k.stats.cpu().numpy(), p.stats.cpu().numpy()
    # K2's tile stage passes one lane per key and tile to the ring
    checks = {
        "lane_exact": err == 0,
        "tile_winners": int(sk[S_DEDUP]) + int(sk[S_CCH])
        == tile_key_pairs(k, k.cvalid, f, model.max_actions),
        "inserted_set": ks == ps,
        "one_lane_per_key": len(kk) == len(ks) and len(pk) == len(ps),
        "table_set": np.array_equal(table_k, table_p),
        "discoveries": np.array_equal(sk[S_DISC:], sp[S_DISC:]),
        "flags": bool((sk[S_XOVF], sk[S_OVF]) == (sp[S_XOVF], sp[S_OVF])
                      and sk[S_FAULT] == 0),
        # one claimed slot per inserted lane
        "claims": n_claims == int(sk[S_INSERTED]) == len(kk),
        "lowest_lane_wins": lowest_lane_wins(k),
        # K2's tile stage keeps the rule over every valid lane
        "lowest_valid_lane_wins": lowest_lane_wins(k, among=k.cvalid),
    }
    if not all(checks.values()):
        raise AssertionError(f"fused step f={f} disagrees with its plain "
                             f"version: {checks}")

    def restore():
        t_k.copy_(table0)
        r_k.copy_(ring0)

    def launch():
        return fused_step(model, *args, t_k, r_k, ws, symmetry=symmetry)

    ms = cuda_ms(launch, reps, restore)
    dev = device_times(launch, before=restore)
    # the bound: each input read once, each output written once, table
    # and ring traffic counted for the lanes that need it: the ring per
    # tile winner (K2's one lane per key and tile; the kernel counts the
    # winners the ring held in S_CCH, the others in S_DEDUP), a bucket
    # per winner the ring did not hold
    lanes = f * model.max_actions
    n_valid = int(k.cvalid.sum())
    n_table = int(k.dvalid.sum())
    n_win = int(sk[S_DEDUP]) + int(sk[S_CCH])
    n_ins = len(kk)
    nbytes = (f * (4 * w + 4 + 8 + 1)            # frontier, ebits, fps, fvalid
              + f * (max(n_props, 1) + 4 + 1)    # pbits, ebits, terminal
              + lanes * (4 * w + 8 + 3)          # flat, chi/clo, 3 masks
              + lanes * (8 if symmetry else 0)   # ohi/olo
              + (n_win * 8 if ring0.shape[0] else 0)  # ring probes
              + n_table * 32                     # bucket reads
              + n_ins * 16)                      # table + ring writes
    ops = lanes * step_ops(model, symmetry) + n_table * 12
    return {"f": f, "lanes": lanes, "valid": n_valid,
            "tile_winners": n_win, "to_table": n_table,
            "inserted": n_ins, "claims": n_claims, "max_abs_err": err,
            "ms": ms,
            "device_ms": dev["ours_ms"],
            "device_by_kernel_ms": dev["by_kernel_ms"],
            "plain_ms": plain_ms, **bound(nbytes, ops),
            "parts": kernel_parts(model, f, symmetry, ring0.shape[0],
                                  dev["by_kernel_ms"],
                                  (n_valid, n_win, n_table, n_ins)),
            "checks": checks}


def insert_parts(keys, valid, n_ins: int, by_kernel, mask: bool) -> dict:
    """The flat insert's kernel over ``keys`` where ``valid`` (K4, K6):
    its device ms (from ``by_kernel``, a profiled call), its own bound
    and its launch, with ``n_ins`` keys inserted (one claim each). It
    reads each lane once, a bucket per valid lane and writes the key per
    claim; with ``mask`` it also writes each lane's inserted byte, posts
    the owner word per valid lane and per claim reads it back and writes
    one inserted byte; 12 operations per probe."""
    n, n_valid = keys.shape[0], int(valid.sum())
    nbytes = n * 9 + n_valid * 32 + n_ins * 8
    if mask:
        nbytes += n + n_valid * 8 + n_ins * (8 + 1)
    return {"flat_insert_kernel": {
        "device_ms": (by_kernel or {}).get("flat_insert_kernel"),
        **bound(nbytes, n_valid * 12),
        "launch": "cooperative" if mask else "plain"}}


def insert_bound(keys, valid, n_ins: int, mask: bool) -> dict:
    """The least time of the flat insert as a function: each lane read
    once (and with ``mask`` its inserted byte written), a bucket read per
    distinct valid key and the key written per inserted lane; 16
    operations per valid lane (the dedup) and 12 per distinct key (its
    probe)."""
    import torch

    distinct = torch.unique(keys[valid]).shape[0]
    return bound(keys.shape[0] * (9 + mask) + distinct * 32 + n_ins * 8,
                 int(valid.sum()) * 16 + distinct * 12)


def check_insert(carry, reps: int) -> dict:
    """K4 against ``table_insert_reference`` on the card: the growth
    re-insert of the mid-search log into an empty 2**20-slot table, with
    every key twice in the batch. Without a mask, as the seed and growth
    call it: the table and the flags. With one: the inserted lane of each
    key is its lowest (the first copy), and a second call on an equal
    table with the same workspace gives the same mask. Both timed; the
    kernel's line carries the first (the main path's) and the masked
    call under ``mask``."""
    import numpy as np
    import torch

    from stateright_tpu_torch.ops.fused import StepWorkspace
    from stateright_tpu_torch.ops.hashtable import (make_table,
                                                    table_insert,
                                                    table_insert_reference)
    from stateright_tpu_torch.ops.words import pack64

    log = carry.log[:carry.log_n]
    hi = torch.cat([log[:, 0], log[:, 0]])
    lo = torch.cat([log[:, 1], log[:, 1]])
    valid = torch.ones((hi.shape[0],), dtype=torch.bool, device=hi.device)
    t_p = make_table(1 << 20, hi.device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    ins_p, ovf_p = table_insert_reference(t_p, hi, lo, valid)
    end.record()
    end.synchronize()
    plain_ms = start.elapsed_time(end)
    keys = pack64(hi, lo)
    pk = keys[ins_p].cpu().numpy()
    table_p = np.sort(t_p[t_p != 0].cpu().numpy())
    t_n = make_table(1 << 20, hi.device)
    none, ovf_n = table_insert(t_n, hi, lo, valid, mask=False)
    t_k = make_table(1 << 20, hi.device)
    ws = StepWorkspace(t_k.numel(), 0, 0, hi.device)
    ins_k, ovf_k = table_insert(t_k, hi, lo, valid, ws=ws)
    kk = keys[ins_k].cpu().numpy()
    table_n = np.sort(t_n[t_n != 0].cpu().numpy())
    table_k = np.sort(t_k[t_k != 0].cpu().numpy())
    t_again = make_table(1 << 20, hi.device)
    ins_again, _ovf = table_insert(t_again, hi, lo, valid, ws=ws)
    checks = {
        "table_set": np.array_equal(table_n, table_p),
        "flags": ovf_n == ovf_p and none is None,
        "inserted_set": set(kk.tolist()) == set(pk.tolist()),
        "one_lane_per_key": len(kk) == len(set(kk.tolist())) == carry.log_n,
        "table_set_mask": np.array_equal(table_k, table_p),
        "flags_mask": ovf_k == ovf_p,
        # the owner-word rule: the first copy of each key
        "lowest_lane_wins": lowest_valid_lane_wins(keys, valid, ins_k)
        and bool(ins_k[:carry.log_n].all()),
        "repeat": torch.equal(ins_again, ins_k),
    }
    if table_n.shape != table_p.shape or table_k.shape != table_p.shape:
        raise AssertionError(f"insert kernel tables hold {table_n.size} "
                             f"and {table_k.size} keys, its plain version "
                             f"{table_p.size}")
    # the largest difference of the sorted table keys' uint32 words
    words_p = table_p.view(np.uint32).astype(np.int64)
    err = max((int(np.abs(t.view(np.uint32).astype(np.int64)
                          - words_p).max()) if t.size else 0)
              for t in (table_n, table_k))
    if not all(checks.values()):
        raise AssertionError(f"insert kernel disagrees with its plain "
                             f"version: {checks}")
    n_ins = len(kk)
    out = {"n": hi.shape[0], "keys": carry.log_n, "max_abs_err": err,
           "plain_ms": plain_ms, "checks": checks}
    for mask, t in ((False, t_n), (True, t_k)):
        def launch(t=t, mask=mask):
            return table_insert(t, hi, lo, valid, ws=ws, mask=mask)

        dev = device_times(launch, before=t.zero_)
        timing = {"ms": cuda_ms(launch, reps, t.zero_),
                  "device_ms": dev["ours_ms"],
                  "device_by_kernel_ms": dev["by_kernel_ms"],
                  "torch_ms": dev["torch_ms"],
                  **insert_bound(keys, valid, n_ins, mask),
                  "parts": insert_parts(keys, valid, n_ins,
                                        dev["by_kernel_ms"], mask)}
        if mask:
            out["mask"] = timing
        else:
            out.update(timing)
    return out


def ring_hits(out, ring):
    """Valid lanes whose key the ring holds (the probe-free step drops
    them)."""
    from stateright_tpu_torch.ops.hashtable import start_bucket
    from stateright_tpu_torch.ops.words import pack64

    keys = pack64(out.chi, out.clo)
    slot = start_bucket(out.chi, out.clo, ring.shape[0])
    return out.cvalid & (ring[slot] == keys)


def tile_key_pairs(out, mask, f: int, a: int) -> int:
    """The distinct (tile, key) pairs among the ``mask``-ed lanes of a
    step over ``f`` rows of ``a`` lanes, at the card's tile geometry: the
    tile winners there are among them."""
    import torch

    from stateright_tpu_torch.ops import _cuda
    from stateright_tpu_torch.ops.words import pack64

    geo = _cuda.tile_geometry(f, a, _cuda.sm_count(out.chi.device))
    lane = torch.arange(out.chi.shape[0], device=out.chi.device)
    pairs = torch.stack([lane // (geo.rows * a), pack64(out.chi, out.clo)],
                        1)[mask]
    return torch.unique(pairs, dim=0).shape[0]


def check_noprobe(model, carry, f: int, reps: int, symmetry: bool = False,
                  pfp=None) -> dict:
    """K1 + K5 (one ``fused_step(probe=False)``, the symmetric
    instantiation under ``symmetry``) against its plain version on the
    card over ``f`` pending rows of ``carry`` and its ring: lane-exact
    outputs, scalars and discoveries; ``dvalid`` by the key-set gate (a
    subset of the valid lanes the ring does not hold, with their key set,
    one lane per key, the lowest); the ring-hit count recounted over the
    tile winners; the key arena clean after the step."""
    import torch

    from stateright_tpu_torch.ops.fused import (S_CCH, S_DEDUP, S_DISC,
                                                S_FAULT, S_INSERTED, S_OVF,
                                                S_VALID, S_XOVF,
                                                DedupWorkspace, fused_step,
                                                fused_step_reference)
    from stateright_tpu_torch.ops.words import pack64

    w = model.packed_width
    a = model.max_actions
    block, args = block_args(model, carry, f, pfp)
    args += (None, carry.ring)
    n_props = len(model.properties())
    ws = DedupWorkspace(f * a, carry.ring.shape[0], n_props, block.device)

    def launch():
        return fused_step(model, *args, ws, probe=False, symmetry=symmetry)

    k = launch()
    n_claims = int(ws.n_claims.sum())  # K5's claims, which its commit walks
    arena_clean = not bool(ws.arena.any())
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    p = fused_step_reference(model, *args, probe=False, symmetry=symmetry)
    end.record()
    end.synchronize()
    plain_ms = start.elapsed_time(end)
    err = 0
    for name in ("flat", "chi", "clo", "cvalid", "pbits", "ebits",
                 "terminal") + (("ohi", "olo") if symmetry else ()):
        x = getattr(k, name).to(torch.int64)
        y = getattr(p, name).to(torch.int64)
        if x.shape != y.shape:
            raise AssertionError(f"f={f} {name}: shape {x.shape} != {y.shape}")
        err = max(err, int((x - y).abs().max()) if x.numel() else 0)
    sk, sp = k.stats.cpu().numpy(), p.stats.cpu().numpy()
    hit = ring_hits(k, carry.ring)
    keys = pack64(k.chi, k.clo)
    live = k.cvalid & ~hit
    kd = keys[k.dvalid].cpu().numpy()
    pd = keys[p.dvalid].cpu().numpy()
    live_keys = set(keys[live].cpu().numpy().tolist())
    # K5's tile stage passes one lane per key and tile to the ring: S_CCH
    # counts those the ring holds
    n_win = tile_key_pairs(k, k.cvalid, f, a)
    n_held = tile_key_pairs(k, hit, f, a)
    checks = {
        "lane_exact": err == 0,
        "scalars": bool(all(sk[i] == sp[i] for i in (S_XOVF, S_OVF,
                                                      S_VALID))
                        and sk[S_FAULT] == 0),
        "ring_hits": int(sk[S_CCH]) == n_held,
        "discoveries": bool((sk[S_DISC:] == sp[S_DISC:]).all()),
        "dvalid_subset": bool((k.dvalid <= live).all()),
        "dvalid_key_set": set(kd.tolist()) == live_keys
        == set(pd.tolist()),
        "one_lane_per_key": len(kd) == len(set(kd.tolist())),
        "lowest_lane_wins": lowest_lane_wins(k._replace(
            dvalid=live, inserted=k.dvalid)),
        # one claimed cell per kept lane
        "claims": n_claims == int(sk[S_DEDUP]) == int(sk[S_INSERTED])
        == len(kd),
        # each claim's commit cleared its cell: no memset before a step
        "arena_clean": arena_clean,
    }
    if not all(checks.values()):
        raise AssertionError(f"probe-free step f={f} disagrees with its "
                             f"plain version: {checks}")
    ms = cuda_ms(launch, reps)
    dev = device_times(launch)
    if ws.arena.any():
        raise AssertionError(f"probe-free step f={f}: the key arena is not "
                             "clean after the timed steps")
    lanes = f * a
    n_valid = int(k.cvalid.sum())
    nbytes = (f * (4 * w + 4 + 8 + 1)            # frontier, ebits, fps, fvalid
              + f * (max(n_props, 1) + 4 + 1)    # pbits, ebits, terminal
              + lanes * (4 * w + 8 + 2)          # flat, chi/clo, 2 masks
              + lanes * (8 if symmetry else 0)   # ohi/olo
              + n_win * 8)                       # ring probes
    ops = lanes * step_ops(model, symmetry) + n_valid * 16
    return {"f": f, "lanes": lanes, "valid": n_valid,
            "tile_winners": n_win, "ring_hits": int(sk[S_CCH]),
            "ring_hits_plain": int(sp[S_CCH]), "dvalid": len(kd),
            "dvalid_plain": len(pd), "claims": n_claims,
            "max_abs_err": err, "ms": ms,
            "device_ms": dev["ours_ms"],
            "device_by_kernel_ms": dev["by_kernel_ms"],
            "memset_ms": dev["copy_ms"], "plain_ms": plain_ms,
            **bound(nbytes, ops),
            "parts": kernel_parts(model, f, symmetry, carry.ring.shape[0],
                                  dev["by_kernel_ms"],
                                  noprobe=(n_valid, n_win, n_held,
                                           n_claims)),
            "checks": checks}, k


def probe_lanes(model, carry, step):
    """The received lanes of the default one-rank sharded run: the lanes
    the probe-free step ``step`` kept, compacted to ``kmax`` rows (the
    fresh ones first). Returns ``(hi, lo, valid)``."""
    import torch

    from stateright_tpu_torch.checker.device_loop import shrink_indices
    from stateright_tpu_torch.checker.gpu import candidate_sizes

    _kraw, kmax = candidate_sizes(model, 12288, {})
    count = int(step.dvalid.sum())
    if count > kmax:  # the engine's abort handler widens it so
        kmax = min(max(kmax * 2, -(-(count + count // 4) // 256) * 256),
                   12288 * model.max_actions)
    src = shrink_indices(step.dvalid, kmax)
    return (step.chi[src], step.clo[src],
            torch.arange(kmax, device=step.chi.device) < count)


def check_probe(model, carry, step, reps: int) -> dict:
    """K6 (``probe_block``) against ``probe_block_reference`` on the card:
    the lanes the probe-free step ``step`` kept, at the received width of
    the default one-rank sharded run (``probe_lanes``), probed into a
    copy of ``carry``'s table; then the same lanes twice over, where the
    lowest lane of each fresh key must win. Each is repeated on an equal
    table with the same workspace (the same mask), and timed."""
    import numpy as np
    import torch

    from stateright_tpu_torch.ops.fused import (S_FAULT, StepWorkspace,
                                                probe_block,
                                                probe_block_reference)
    from stateright_tpu_torch.ops.words import pack64

    hi, lo, valid = probe_lanes(model, carry, step)
    out = {"n": hi.shape[0], "valid": int(valid.sum())}
    for label, (h, l_, v) in (("main", (hi, lo, valid)),
                              ("twice", (torch.cat([hi, hi]),
                                         torch.cat([lo, lo]),
                                         torch.cat([valid, valid])))):
        t_k, t_p = carry.table.clone(), carry.table.clone()
        ws = StepWorkspace(t_k.numel(), 0, 0, t_k.device)
        ins_k, ovf_k, _r = probe_block(t_k, h, l_, v, ws)
        fault = int(ws.insert_stats[S_FAULT])
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        ins_p, ovf_p, _rp = probe_block_reference(t_p, h, l_, v)
        end.record()
        end.synchronize()
        keys = pack64(h, l_)
        kk, pk = keys[ins_k].cpu().numpy(), keys[ins_p].cpu().numpy()
        table_k = np.sort(t_k[t_k != 0].cpu().numpy())
        table_p = np.sort(t_p[t_p != 0].cpu().numpy())
        t_again = carry.table.clone()
        ins_again, _o, _r = probe_block(t_again, h, l_, v, ws)
        checks = {
            "inserted_set": set(kk.tolist()) == set(pk.tolist()),
            "one_lane_per_key": len(kk) == len(set(kk.tolist())),
            "table_set": np.array_equal(table_k, table_p),
            "flags": bool(ovf_k) == bool(ovf_p) and fault == 0,
            "lowest_lane_wins": lowest_valid_lane_wins(keys, v, ins_k),
            "repeat": torch.equal(ins_again, ins_k),
        }
        if table_k.shape != table_p.shape or not all(checks.values()):
            raise AssertionError(f"owner-side probe ({label}) disagrees "
                                 f"with its plain version: {checks}")
        words_k = table_k.view(np.uint32).astype(np.int64)
        words_p = table_p.view(np.uint32).astype(np.int64)
        err = int(np.abs(words_k - words_p).max()) if words_k.size else 0

        def restore(t=t_k, t0=carry.table):
            t.copy_(t0)

        def launch(t=t_k, h=h, l_=l_, v=v, ws=ws):
            return probe_block(t, h, l_, v, ws)

        dev = device_times(launch, before=restore)
        n_ins = len(kk)
        out[label] = {"n": h.shape[0], "inserted": n_ins,
                      "max_abs_err": err,
                      "ms": cuda_ms(launch, reps, restore),
                      "device_ms": dev["ours_ms"],
                      "device_by_kernel_ms": dev["by_kernel_ms"],
                      "torch_ms": dev["torch_ms"],
                      "plain_ms": start.elapsed_time(end),
                      **insert_bound(keys, v, n_ins, True),
                      "parts": insert_parts(keys, v, n_ins,
                                            dev["by_kernel_ms"], True),
                      "checks": checks}
    main = out["main"]
    out.update({k: main[k] for k in ("ms", "device_ms", "plain_ms",
                                     "bound_ms", "bound_by", "bytes",
                                     "ops")},
               max_abs_err=max(out["main"]["max_abs_err"],
                               out["twice"]["max_abs_err"]))
    return out


def check_control(model, carry, f: int = 12288) -> dict:
    """The chunk's control kernels (``chunk_begin_kernel`` and
    ``gate_kernel``, ``csrc/chunk.cu``) against their plain versions on
    the card, from the counters of a mid-search ``carry``, under chunk
    parameters that open the gate and that shut it (no steps left, the
    generation target reached, the growth limit reached): the counter
    block bit for bit and the step's stats vector zeroed."""
    import torch

    from stateright_tpu_torch.checker.device_loop import (
        E_GATE, G_SIZE, I32_MAX, ChunkRunner, chunk_begin_reference,
        gate_reference, step_sizes)

    lay = carry.layout
    card = ChunkRunner(model, carry, f).card()
    f_small, f_large, qmargin = step_sizes(model, f)
    qlimit = carry.q.shape[0] - qmargin
    ctr0 = carry.ctr.clone()
    stats = card.bufs["stats"]
    cases = {"open": (3, I32_MAX, I32_MAX, 7),
             "no_steps": (0, I32_MAX, I32_MAX, 7),
             "target": (3, 0, I32_MAX, 7),
             "grow_limit": (3, I32_MAX, 0, 7)}
    err, checks = 0, {}
    for name, params in cases.items():
        carry.ctr.copy_(ctr0)
        stats.fill_(-1)
        card.begin(*params)
        card.launch_gate()
        k_ctr, k_stats = carry.ctr.clone(), stats.clone()
        p_ctr, p_stats = ctr0.clone(), torch.full_like(k_stats, -1)
        chunk_begin_reference(p_ctr, lay, *params)
        gate_reference(p_ctr, lay, f_small, f_large, qlimit, p_stats)
        e = int((k_ctr.long() - p_ctr.long()).abs().max())
        err = max(err, e)
        opened = int(k_ctr[lay.ext + E_GATE + G_SIZE]) != 0
        checks[name] = (e == 0 and not bool(k_stats.any())
                        and not bool(p_stats.any())
                        and opened == (name == "open"))
    if not all(checks.values()):
        raise AssertionError(f"chunk control kernels disagree with their "
                             f"plain versions: {checks}")

    def restore():
        carry.ctr.copy_(ctr0)

    def begin():
        card.begin(*cases["open"])

    begin()
    ms_gate = cuda_ms(card.launch_gate, 200)
    ms_begin = cuda_ms(begin, 200)
    dev = device_times(lambda: (begin(), card.launch_gate()), before=restore)
    p_ctr = ctr0.clone()
    plain_ms = {}
    for name, plain in (
            ("begin", lambda: chunk_begin_reference(p_ctr, lay,
                                                    *cases["open"])),
            ("gate", lambda: gate_reference(p_ctr, lay, f_small, f_large,
                                            qlimit, stats))):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        plain()
        end.record()
        end.synchronize()
        plain_ms[name] = start.elapsed_time(end)
    restore()
    # the bound: the counter block read and written once, the stats
    # vector written; a few dozen integer operations
    nbytes = 4 * (2 * lay.length + stats.shape[0])
    by = dev["by_kernel_ms"] or {}
    return {"f": f, "counters": lay.length, "max_abs_err": err,
            "ms": ms_gate, "begin_ms": ms_begin,
            "device_ms": by.get("gate_kernel"),
            "begin_device_ms": by.get("chunk_begin_kernel"),
            "plain_ms": plain_ms["gate"], "begin_plain_ms": plain_ms["begin"],
            **bound(nbytes, 64),
            "checks": checks}


def check_append(model, carry, f: int, reps: int) -> dict:
    """K7 (``append_count_kernel`` + ``append_kernel``, ``csrc/chunk.cu``)
    against its plain version on the card over a real step of ``carry``
    at ``f`` rows per large step: the gate and the gated step (K1-K3) on
    the card, then K7, or ``append_reference`` from the same counters,
    queue and log; the counter block, the queue and log rows it may write
    bit for bit. Timed with CUDA events and ``torch.profiler`` beside the
    plain version, whose torch kernels are the glue K7 replaced. The
    carry's table, ring and counters are restored afterwards."""
    import torch

    from stateright_tpu_torch.checker.device_loop import (
        B_LOG_N, B_Q_TAIL, E_FAULT, E_GATE, G_SIZE, I32_MAX, ChunkRunner,
        append_reference)
    from stateright_tpu_torch.ops.fused import S_FAULT, S_INSERTED

    lay = carry.layout
    w, a = model.packed_width, model.max_actions
    table0, ring0, ctr0 = (carry.table.clone(), carry.ring.clone(),
                           carry.ctr.clone())
    card = ChunkRunner(model, carry, f).card()
    carry.ws.step += 1
    card.begin(1, I32_MAX, I32_MAX, carry.ws.step)
    card.launch_gate()
    card.launch_steps()
    c = carry.counters()
    size = int(c[lay.ext + E_GATE + G_SIZE])
    if not size:
        raise AssertionError(f"the gate picked no step at f={f}")
    out = card.outputs(size)
    lanes = out.inserted.shape[0]
    qbase, lbase = int(c[B_Q_TAIL]), int(c[B_LOG_N])
    rows_q = slice(qbase, qbase + lanes)
    rows_l = slice(lbase, lbase + lanes)
    ctr1 = carry.ctr.clone()
    q1, log1 = carry.q[rows_q].clone(), carry.log[rows_l].clone()
    cnt = int(out.inserted.sum())
    card.launch_append()
    k = (carry.ctr.clone(), carry.q[rows_q].clone(),
         carry.log[rows_l].clone())

    def restore():
        carry.ctr.copy_(ctr1)

    def restore_all():
        restore()
        carry.q[rows_q] = q1
        carry.log[rows_l] = log1

    def plain():
        append_reference(carry.ctr, lay, carry.q, carry.log, out, a)

    restore_all()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    plain()
    end.record()
    end.synchronize()
    plain_ms = start.elapsed_time(end)
    p = (carry.ctr.clone(), carry.q[rows_q].clone(),
         carry.log[rows_l].clone())
    err = max(int((x.long() - y.long()).abs().max()) for x, y in zip(k, p))
    st = out.stats.cpu().numpy()
    checks = {
        "bit_exact": err == 0,
        "count": cnt == int(st[S_INSERTED]) == int(k[0][B_Q_TAIL]) - qbase,
        "no_fault": int(k[0][lay.ext + E_FAULT]) == 0
        and int(st[S_FAULT]) == 0,
        # rows past the appended ones are left as they were
        "rows_past_untouched": torch.equal(k[1][cnt:], q1[cnt:])
        and torch.equal(k[2][cnt:], log1[cnt:]),
    }
    if not all(checks.values()):
        raise AssertionError(f"K7 f={f} disagrees with its plain version: "
                             f"{checks} (max_abs_err {err})")
    ms = cuda_ms(card.launch_append, reps, restore)
    dev = device_times(card.launch_append, before=restore)
    glue = device_times(plain, before=restore)
    by = dev["by_kernel_ms"] or {}
    k7_ms = (None if dev["by_kernel_ms"] is None else
             by["append_count_kernel"] + by["append_kernel"])
    carry.table.copy_(table0)
    carry.ring.copy_(ring0)
    carry.ctr.copy_(ctr0)
    sym = carry.symmetry
    lc = carry.log.shape[1]
    # the bound: the inserted mask read once; per appended row its
    # successor, keys, the row's eventually-bits and the parent's keys
    # read, the queue row and the log row written
    nbytes = (lanes + cnt * (4 * w + 8 + 4 + 8 + (8 if sym else 0))
              + cnt * 4 * (w + 3 + lc))
    return {"f": f, "lanes": lanes, "appended": cnt, "max_abs_err": err,
            "ms": ms, "device_ms": k7_ms, "device_by_kernel_ms": {
                k_: by.get(k_) for k_ in ("append_count_kernel",
                                          "append_kernel")},
            "plain_ms": plain_ms, "glue_device_ms": glue["torch_ms"],
            "glue_copy_ms": glue["copy_ms"], **bound(nbytes, 4 * lanes),
            "checks": checks}


def frontier_fps(model):
    """``rows -> (hi, lo)``: the int32 fingerprints of the rows' canonical
    members under ``model``'s representative (the plain version)."""
    import torch

    from stateright_tpu_torch.ops.hash_kernel import fp64_device

    def fps(rows):
        hi, lo = fp64_device(model.packed_representative(rows))
        return hi.to(torch.int32), lo.to(torch.int32)
    return fps


def canonical_keys(model, rows, chunk: int = 1 << 20) -> set:
    """``{fp64(model.packed_representative(row))}`` over ``rows`` (int32
    ``[N, W]`` on the card), by the plain version in chunks, as Python
    ints (what ``generated_fingerprints()`` holds)."""
    import numpy as np
    import torch

    from stateright_tpu_torch.ops.hash_kernel import fp64_device
    from stateright_tpu_torch.ops.words import pack64

    parts = [torch.zeros((0,), dtype=torch.int64, device=rows.device)]
    for i in range(0, rows.shape[0], chunk):
        hi, lo = fp64_device(model.packed_representative(rows[i:i + chunk]))
        parts.append(torch.unique(pack64(hi, lo)))
    keys = torch.unique(torch.cat(parts)).cpu().numpy()
    return set(keys.view(np.uint64).tolist())


def orbits_2pc7(device) -> dict:
    """Every reachable state of 2pc n=7 (the port's loop run to the end
    on the card), and the keys both representatives give them: 920
    orbits (the complete representative's keys, whose digest is the JAX
    package's) and 9,840 distinct reference keys, the ends of the
    reference representative's sound range."""
    import numpy as np
    import torch

    from stateright_tpu_torch import TwoPhaseSys
    from stateright_tpu_torch.checker.device_loop import (E_ITERS,
                                                          run_chunk,
                                                          seed_carry)
    from stateright_tpu_torch.ops.hashtable import table_insert
    from stateright_tpu_torch.ops.words import from_numpy_u32

    model = TwoPhaseSys(7)
    init = model.init_states()[0]
    fp = model.fingerprint(init)
    carry = seed_carry(model, 1 << 21, 1 << 20, [model.encode(init)], 0,
                       [fp], 1 << 15, device)
    table_insert(carry.table,
                 from_numpy_u32(np.array([fp >> 32], np.uint32), device),
                 from_numpy_u32(np.array([fp & 0xFFFFFFFF], np.uint32),
                                device),
                 torch.ones((1,), dtype=torch.bool, device=device),
                 mask=False)
    while run_chunk(model, carry, fmax=12288, steps=64,
                    grow_limit=1 << 20)[carry.layout.ext + E_ITERS]:
        pass
    rows = carry.q[:carry.q_tail, :model.packed_width]
    orbit_keys = canonical_keys(TwoPhaseSys(7, complete_symmetry=True),
                                rows)
    ref_keys = canonical_keys(model, rows)
    checks = {
        "states": carry.q_head == carry.q_tail == UNIQUE_2PC7,
        "orbits": len(orbit_keys) == UNIQUE_2PC7_SYM,
        "orbit_digest": fp_digest(orbit_keys) == DIGEST_2PC7_SYM,
        "reference_keys": len(ref_keys) == REF_KEYS_2PC7,
    }
    if not all(checks.values()):
        raise AssertionError(f"2pc7 orbits: {checks} ({carry.q_tail} "
                             f"states, {len(orbit_keys)} orbits, "
                             f"{len(ref_keys)} reference keys)")
    return {"states": carry.q_tail, "orbits": len(orbit_keys),
            "reference_keys": len(ref_keys), "checks": checks}, orbit_keys


def end_to_end_sym(model, path_kernels, off_kernels, want=None, **opts):
    """One check of ``model`` under symmetry reduction
    (``symmetry_fn(model.representative)``) through the user entry
    point: every launch count is set to 0 before it, each of
    ``path_kernels`` must have launched and none of ``off_kernels``;
    ``want`` = (unique, state_count, canonical-key digest) pins the
    answer; the verdicts hold and both witnesses replay through the host
    model. Returns its measurements, the checker and its search record
    (the device log, or every rank's)."""
    import torch

    from stateright_tpu_torch.ops import _cuda

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for key in _cuda.LAUNCHES:
        _cuda.LAUNCHES[key] = 0
    t0 = time.perf_counter()
    builder = model.checker().symmetry_fn(model.representative)
    if opts:
        builder = builder.gpu_options(**opts)
    ck = builder.spawn_gpu().join()
    wall = time.perf_counter() - t0
    launches = dict(_cuda.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    # the search record before the mirror pulls it: the log rows
    # (canonical child, canonical parent, original child)
    record = (ck._logs if opts.get("mesh") is not None
              else [ck._mirror[0][:ck._mirror[1]]])
    unique = ck.unique_state_count()
    t1 = time.perf_counter()
    keys = ck.generated_fingerprints()
    mirror_s = time.perf_counter() - t1
    digest = fp_digest(keys)
    prof = ck.profile()
    checks = {
        "launches": all(launches[k] > 0 for k in path_kernels)
        and not any(launches[k] for k in off_kernels),
        "keys": len(keys) == unique,
        "originals": len(ck._orig_of) == unique,
    }
    if want is not None:
        checks.update(unique=unique == want[0],
                      generated=ck.state_count() == want[1],
                      digest=digest == want[2])
    ck.assert_no_discovery("consistent")
    for name in ("abort agreement", "commit agreement"):
        path = ck.assert_any_discovery(name)  # replays or raises
        checks[f"replay {name}"] = model.property(name).condition(
            model, path.last_state())
    shown = {k: (f"DeviceMesh {tuple(v.shape)} {v.device_type}"
                 if k == "mesh" else v) for k, v in opts.items()}
    mode = "complete" if model.complete_symmetry else "reference"
    if not all(checks.values()):
        raise AssertionError(
            f"2pc{model.n} {mode} symmetry {shown or 'default'}: {checks} "
            f"(unique {unique}, generated {ck.state_count()}, digest "
            f"{digest}, launches {launches})")
    keys_prof = ("engine", "syncs", "iterations", "small_iterations",
                 "grows", "capacity", "loop_s", "sync_s", "shards",
                 "chunks", "sync_stall", "capture_s", "graph_launches",
                 "exchange", "collectives", "collectives_per_iteration",
                 "kovfs", "aborts", "kmax", "gather_s", "vmax", "dmax")
    return {"model": f"TwoPhaseSys({model.n}, complete_symmetry="
                     f"{model.complete_symmetry})",
            "representative": mode, "options": shown, "wall_s": wall,
            "unique": unique, "unique_per_s": unique / wall,
            "generated": ck.state_count(), "digest": digest,
            "mirror_pull_s": mirror_s,
            **{k: prof[k] for k in keys_prof if k in prof},
            "max_memory_allocated": peak, "launches": launches,
            "checks": checks}, ck, record


def one_rank_mesh():
    """A one-rank NCCL group on card 0 and its DeviceMesh (the sharded
    engine at D = 1), over the loopback interface."""
    import socket

    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    torch.cuda.set_device(0)
    t0 = time.perf_counter()
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            rank=0, world_size=1)
    mesh = init_device_mesh("cuda", (1,), mesh_dim_names=("shards",))
    # NCCL builds its communicator at the first collective: do it here,
    # so the timed runs see a warm group
    dist.all_reduce(torch.zeros((1,), device="cuda"),
                    group=mesh.get_group("shards"))
    torch.cuda.synchronize()
    return mesh, time.perf_counter() - t0


def end_to_end(model_cls, path_kernels, **opts):
    """One full 2pc n=7 check through the user entry point, held to the
    oracle; every launch count is set to 0 before it and each of
    ``path_kernels`` must have launched. Returns its measurements and
    launch counts, and the checker."""
    import torch

    from stateright_tpu_torch.ops import _cuda

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for key in _cuda.LAUNCHES:
        _cuda.LAUNCHES[key] = 0
    t0 = time.perf_counter()
    builder = model_cls(7).checker()
    if opts:
        builder = builder.gpu_options(**opts)
    ck = builder.spawn_gpu().join()
    wall = time.perf_counter() - t0
    launches = dict(_cuda.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    unique = ck.unique_state_count()
    digest = fp_digest(ck.generated_fingerprints())
    prof = ck.profile()
    checks = {
        "unique": unique == UNIQUE_2PC7,
        "generated": ck.state_count() == GENERATED_2PC7,
        "digest": digest == DIGEST_2PC7,
        "launches": all(launches[k] > 0 for k in path_kernels),
    }
    ck.assert_no_discovery("consistent")
    for name in ("abort agreement", "commit agreement"):
        # replays through the host model or raises
        path = ck.assert_any_discovery(name)
        checks[f"replay {name}"] = ck.model().property(name).condition(
            ck.model(), path.last_state())
    shown = {k: (f"DeviceMesh {tuple(v.shape)} {v.device_type}"
                 if k == "mesh" else v) for k, v in opts.items()}
    if not all(checks.values()):
        raise AssertionError(f"2pc7 end to end {shown or 'default'}: "
                             f"{checks} (unique {unique}, generated "
                             f"{ck.state_count()}, digest {digest}, "
                             f"launches {launches})")
    keys = ("engine", "syncs", "iterations", "small_iterations", "grows",
            "loop_s", "sync_s", "mirror_s", "shards", "exchange",
            "collectives", "collectives_per_iteration", "kovfs", "aborts",
            "kmax", "gather_s", "dmax", "chunks", "sync_stall", "capture_s",
            "graph_launches", "pipeline", "chunk_steps")
    return {"options": shown, "wall_s": wall, "unique": unique,
            "unique_per_s": unique / wall, "generated": ck.state_count(),
            "digest": digest, **{k: prof[k] for k in keys if k in prof},
            "max_memory_allocated": peak, "launches": launches,
            "checks": checks}, ck


def mirror_vs_plain(card) -> dict:
    """How far the card's search record (child fp -> parent fp, in
    insertion order) is from the plain versions' on the CPU, which
    reproduce the JAX package lane for lane. The set gate already holds;
    this counts the rows where the winner rules differ (ROADMAP C1)."""
    t0 = time.perf_counter()
    cpu = card.model().checker().gpu_options(device="cpu").spawn_gpu() \
        .join()
    cpu_wall = time.perf_counter() - t0
    cpu.generated_fingerprints()  # pulls the mirror
    # the mirrors are engine-internal: this diagnostic reads them
    a, b = list(card._generated.items()), list(cpu._generated.items())
    first = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)
    return {"rows": len(a), "parents_differ": sum(
        1 for k, v in a if cpu._generated.get(k) != v),
        "first_row_differing": first, "cpu_wall_s": cpu_wall}


#: K1's new instantiations at a real mid-search step: (label, model
#: class, its arguments, symmetry, the step sizes, pending rows for the
#: search to reach, whether it goes on past its discoveries). The kernels phase
#: checks each size through both step entry points (K1-K3 and K1 + K5).
#: PackedLinearEquation's frontier never holds more than 256 rows (a
#: BFS level is one diagonal x + y = d), so the loop only takes its
#: 256-row step.
MODEL_STEPS = (
    ("increment_lock", "IncrementLock", (9,), False, (12288, 256), 12288,
     False),
    ("lineq", "PackedLinearEquation", (2, 4, 7), False, (256,), 200, False),
    ("increment", "Increment", (16,), False, (12288, 256), 12288, True),
    ("increment", "Increment", (16,), True, (12288, 256), 12288, True),
)


def _models() -> dict:
    from stateright_tpu_torch import (Increment, IncrementLock,
                                      PackedLinearEquation)
    return {"Increment": Increment, "IncrementLock": IncrementLock,
            "PackedLinearEquation": PackedLinearEquation}


def check_model_steps(device) -> dict:
    """K1 of each new instantiation (with K2/K3 and with K5) at a real
    mid-search step of its model (``MODEL_STEPS``), held to the plain
    version by ``check_step`` and ``check_noprobe``; one ``kernels`` line
    each. Returns the results by (step kernel, label, F)."""
    out = {}
    for label, cls, args, symmetry, sizes, pending, past in MODEL_STEPS:
        model = _models()[cls](*args)
        carry = mid_search_carry(model, device, symmetry=symmetry,
                                 rows=max(sizes), pending=pending,
                                 past_discoveries=past)
        for f in sizes:
            reps = 20 if f > 256 else 50
            res = check_step(model, carry, f, reps, symmetry=symmetry)
            kernel = "fused_step_sym" if symmetry else "fused_step"
            out[kernel, label, f] = res
            emit(phase="kernels", kernel=kernel, model=type(model).__name__,
                 params=list(model.cuda_spec(symmetry)[1]), **res)
            res, _ = check_noprobe(model, carry, f, reps, symmetry=symmetry)
            kernel = ("fused_step_noprobe_sym" if symmetry
                      else "fused_step_noprobe")
            out[kernel, label, f] = res
            emit(phase="kernels", kernel=kernel, model=type(model).__name__,
                 params=list(model.cuda_spec(symmetry)[1]), **res)
        del carry
    return out


def end_to_end_model(model, path_kernels, off_kernels=(), symmetry=False,
                     want=None, holds=(), witness=None, **opts):
    """One check of ``model`` through the user entry point, every launch
    count set to 0 before it: each of ``path_kernels`` must have launched
    and none of ``off_kernels``; ``want`` = (unique, state_count, digest)
    pins the answer; the properties in ``holds`` have no discovery;
    ``witness`` = (property, length): its discovery replays through the
    host model, ends where the property's condition says it should (a
    ``sometimes`` example satisfies it, an ``always`` counterexample
    violates it) and has that many actions. Returns its measurements and
    the checker."""
    import torch

    from stateright_tpu_torch.core import Expectation
    from stateright_tpu_torch.ops import _cuda

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for key in _cuda.LAUNCHES:
        _cuda.LAUNCHES[key] = 0
    t0 = time.perf_counter()
    builder = model.checker()
    if symmetry:
        builder = builder.symmetry_fn(model.representative)
    if opts:
        builder = builder.gpu_options(**opts)
    ck = builder.spawn_gpu().join()
    wall = time.perf_counter() - t0
    launches = dict(_cuda.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    unique = ck.unique_state_count()
    checks = {"launches": all(launches[k] > 0 for k in path_kernels)
              and not any(launches[k] for k in off_kernels)}
    digest = mirror_s = None
    if want is not None:
        t1 = time.perf_counter()
        digest = fp_digest(ck.generated_fingerprints())
        mirror_s = time.perf_counter() - t1
        checks.update(unique=unique == want[0],
                      generated=ck.state_count() == want[1],
                      digest=digest == want[2])
    for name in holds:
        ck.assert_no_discovery(name)
        checks[f"holds {name}"] = True
    length = None
    if witness is not None:
        name, want_len = witness
        path = ck.assert_any_discovery(name)  # replays or raises
        prop = model.property(name)
        reached = prop.condition(model, path.last_state())
        checks[f"replay {name}"] = reached == (
            prop.expectation == Expectation.SOMETIMES)
        length = len(path)
        checks["witness_length"] = length == want_len
    prof = ck.profile()
    shown = {k: (f"DeviceMesh {tuple(v.shape)} {v.device_type}"
                 if k == "mesh" else v) for k, v in opts.items()}
    label = (f"{type(model).__name__}"
             f"({', '.join(str(p) for p in model.cache_key()[1:])})"
             + (" under symmetry" if symmetry else ""))
    if not all(checks.values()):
        raise AssertionError(
            f"{label} {shown or 'default'}: {checks} (unique {unique}, "
            f"generated {ck.state_count()}, digest {digest}, witness "
            f"{length}, launches {launches})")
    keys = ("engine", "syncs", "iterations", "small_iterations", "grows",
            "capacity", "loop_s", "sync_s", "seed_s", "shards", "exchange",
            "collectives", "collectives_per_iteration", "kovfs", "aborts",
            "kmax", "gather_s", "vmax", "dmax", "chunks", "sync_stall",
            "capture_s", "captures", "graph_launches", "fmax")
    return {"model": label, "options": shown, "wall_s": wall,
            "unique": unique, "unique_per_s": unique / wall,
            "generated": ck.state_count(), "digest": digest,
            "mirror_and_digest_s": mirror_s, "witness_length": length,
            **{k: prof[k] for k in keys if k in prof},
            "max_memory_allocated": peak, "launches": launches,
            "checks": checks}, ck


def models_phase(mesh) -> dict:
    """Phase ``models``: the other models end to end on the card (see
    the module docstring); ``mesh`` is the one-rank NCCL mesh of the
    sharded runs. Returns each run's launch counts by label."""
    m = _models()
    chunk = ("chunk_begin", "chunk_gate", "append")
    single = ("fused_step", "table_insert") + chunk
    single_off = ("fused_step_sym", "fused_step_noprobe",
                  "fused_step_noprobe_sym", "probe_block")
    single_sym = ("fused_step_sym", "table_insert") + chunk
    sym_off = ("fused_step", "fused_step_noprobe", "fused_step_noprobe_sym",
               "probe_block")
    sharded = ("fused_step_noprobe", "probe_block", "table_insert")
    sharded_off = ("fused_step", "fused_step_sym",
                   "fused_step_noprobe_sym") + chunk
    sharded_sym = ("fused_step_noprobe_sym", "probe_block", "table_insert")
    sharded_sym_off = ("fused_step", "fused_step_sym",
                       "fused_step_noprobe") + chunk
    lock9, _ck = end_to_end_model(m["IncrementLock"](9), single, single_off,
                                  want=PIN_LOCK9, holds=("fin", "mutex"))
    del _ck
    # the table quadruples at each growth: 2**20 -> 2**22 -> 2**24 at
    # grow_at 0.55 (576,716 and 2,306,867 log rows)
    lock9["checks"]["growths"] = lock9["grows"] >= 2
    emit(phase="models", **lock9)
    runs = {"increment_lock": lock9}
    lineq, _ck = end_to_end_model(m["PackedLinearEquation"](2, 4, 7),
                                  single, single_off, holds=("solvable",),
                                  capacity=1 << 14)
    del _ck
    lineq["checks"].update(
        unique=lineq["unique"] == 65536, growths=lineq["grows"] >= 1,
        recaptured=lineq["captures"] == lineq["grows"] + 1)
    emit(phase="models", **lineq)
    runs["lineq"] = lineq
    res, _ck = end_to_end_model(m["PackedLinearEquation"](2, 10, 14),
                                single, single_off,
                                witness=("solvable", SOLVABLE_LEN))
    emit(phase="models", **res)
    for n in (7, 16):
        res, _ck = end_to_end_model(m["Increment"](n), single, single_off,
                                    witness=("fin", FIN_LEN))
        emit(phase="models", **res)
        runs["increment", n] = res
        res, _ck = end_to_end_model(m["Increment"](n), single_sym, sym_off,
                                    symmetry=True, witness=("fin", FIN_LEN))
        emit(phase="models", **res)
        runs["increment_sym", n] = res
    del _ck
    res, _ck = end_to_end_model(m["IncrementLock"](8), sharded, sharded_off,
                                want=PIN_LOCK8, holds=("fin", "mutex"),
                                mesh=mesh)
    emit(phase="models_sharded", **res)
    runs["sharded increment_lock"] = res
    res, _ck = end_to_end_model(m["PackedLinearEquation"](2, 4, 7), sharded,
                                sharded_off, holds=("solvable",),
                                mesh=mesh)
    res["checks"]["unique"] = res["unique"] == 65536
    emit(phase="models_sharded", **res)
    runs["sharded lineq"] = res
    res, _ck = end_to_end_model(m["Increment"](7), sharded, sharded_off,
                                witness=("fin", FIN_LEN), mesh=mesh)
    emit(phase="models_sharded", **res)
    runs["sharded increment"] = res
    res, _ck = end_to_end_model(m["Increment"](7), sharded_sym,
                                sharded_sym_off, symmetry=True,
                                witness=("fin", FIN_LEN), mesh=mesh)
    emit(phase="models_sharded", **res)
    runs["sharded increment_sym"] = res
    del _ck
    failed = [label for label, r in runs.items()
              if not all(r["checks"].values())]
    if failed:
        raise AssertionError(f"models phase: {failed}")
    return runs


def model_kernel_entries(steps: dict, runs: dict) -> list:
    """The ``kernels`` line's records of K1's new instantiations: each
    step kernel by model, with its launches on its model's run (the
    single-chip runs for ``fused_step[_sym]``, the sharded ones for
    ``fused_step_noprobe[_sym]``)."""
    fused_src = "stateright_tpu_torch/csrc/fused_step.cu"
    sharded_src = "stateright_tpu_torch/csrc/sharded_step.cu"
    runs_of = {
        ("fused_step", "increment_lock"): runs["increment_lock"],
        ("fused_step", "lineq"): runs["lineq"],
        ("fused_step", "increment"): runs["increment", 16],
        ("fused_step_sym", "increment"): runs["increment_sym", 16],
        ("fused_step_noprobe", "increment_lock"):
            runs["sharded increment_lock"],
        ("fused_step_noprobe", "lineq"): runs["sharded lineq"],
        ("fused_step_noprobe", "increment"): runs["sharded increment"],
        ("fused_step_noprobe_sym", "increment"):
            runs["sharded increment_sym"],
    }
    out = []
    for (kernel, label), run in runs_of.items():
        by_f = {f: r for (k, lab, f), r in steps.items()
                if k == kernel and lab == label}
        main = by_f[max(by_f)]
        probe = kernel in ("fused_step", "fused_step_sym")
        out.append({
            "name": f"{kernel}[{label}]", "route": "cuda",
            "source": fused_src if probe else sharded_src,
            "replaces": "stateright_tpu/ops/fused.py:259",
            "configuration": ("symmetry=True, " if "sym" in kernel else "")
            + ("probe=True" if probe else "probe=False (sharded step)"),
            "model": run["model"],
            "launches": run["launches"][kernel],
            "max_abs_err": max(r["max_abs_err"] for r in by_f.values()),
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": None,
            "by_rows": {f"f={f}": {k: r[k] for k in (
                "ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
                "max_abs_err", "parts")} for f, r in by_f.items()},
            "status": "ok"})
    return out


#: the runs of ``--ranks``: (exchange, 2pc n or "lock8" for
#: IncrementLock(8), complete symmetry or None)
RANK_CASES = (("bucket", 7, None), ("ring", 7, None), ("bucket", 16, True),
              ("bucket", "lock8", None))


def rank_run(rank: int, world: int, init: str, out_dir: str,
             device_type: str = "cuda") -> None:
    """One rank of ``--ranks``: each of ``RANK_CASES`` through the sharded
    engine on this rank's card (2pc n=7 with each exchange, then 2pc n=16
    under complete symmetry reduction); writes what its checker answers
    to ``<out_dir>/rank<rank>.json``."""
    import datetime

    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from stateright_tpu_torch import IncrementLock, TwoPhaseSys
    from stateright_tpu_torch.ops import _cuda

    cuda = device_type == "cuda"
    if cuda:
        torch.cuda.set_device(rank)
    dist.init_process_group("nccl" if cuda else "gloo", init_method=init,
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=300))
    runs = []
    try:
        mesh = init_device_mesh(device_type, (world,),
                                mesh_dim_names=("shards",))
        for exchange, n, complete in RANK_CASES:
            # NCCL sets up its peer connections at the first collective
            # of each kind: a small check first, so the timed run is warm
            TwoPhaseSys(3).checker().gpu_options(
                mesh=mesh, exchange=exchange).spawn_gpu().join()
            for key in _cuda.LAUNCHES:
                _cuda.LAUNCHES[key] = 0
            if cuda:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            model = (IncrementLock(8) if n == "lock8" else
                     TwoPhaseSys(n, complete_symmetry=bool(complete)))
            builder = model.checker().gpu_options(mesh=mesh,
                                                  exchange=exchange)
            if complete is not None:
                builder = builder.symmetry_fn(model.representative)
            ck = builder.spawn_gpu().join()
            wall = time.perf_counter() - t0
            prof = ck.profile()
            if n == "lock8":  # both properties hold
                replay = {prop: ck.discovery(prop) is None
                          for prop in ("fin", "mutex")}
            else:
                replay = {}
                for prop in ("abort agreement", "commit agreement"):
                    path = ck.assert_any_discovery(prop)  # or raises
                    replay[prop] = bool(ck.model().property(prop).condition(
                        ck.model(), path.last_state()))
            runs.append({
                "n": n, "symmetry": complete is not None,
                "exchange": prof["exchange"], "wall_s": wall,
                "unique": ck.unique_state_count(),
                "generated": ck.state_count(),
                "digest": fp_digest(ck.generated_fingerprints()),
                "replay": replay, "launches": dict(_cuda.LAUNCHES),
                "peak": (torch.cuda.max_memory_allocated() if cuda
                         else None),
                **{k: prof[k] for k in (
                    "iterations", "small_iterations", "syncs", "sync_s",
                    "collectives", "collectives_per_iteration", "kovfs",
                    "aborts", "kmax", "kb", "loop_s", "gather_s",
                    "rank_rows", "dmax", "bmax")}})
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(runs, f)


def ranks_main(world: int) -> int:
    """``--ranks N``: the sharded engine across N cards (see the module
    docstring)."""
    import socket
    import tempfile

    import torch
    import torch.multiprocessing as mp
    if not torch.cuda.is_available() or torch.cuda.device_count() < world:
        print(f"chip_smoke: --ranks {world} needs {world} CUDA devices",
              file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    try:
        from stateright_tpu_torch.ops import _cuda
    except ImportError as exc:
        print(f"chip_smoke: run from a checkout of the repository ({exc})",
              file=sys.stderr)
        return 2
    names = [torch.cuda.get_device_name(i) for i in range(world)]
    smi = run(["nvidia-smi", "--query-gpu=name,power.limit",
               "--format=csv,noheader"]).splitlines()
    emit(phase="device", names=names, nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda,
         count=torch.cuda.device_count())
    info = _cuda.build()  # once, before the ranks load it
    emit(phase="build", seconds=info["seconds"], library=info["path"])
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    out_dir = os.path.join(root, "build", "ranks")
    os.makedirs(out_dir, exist_ok=True)
    out_dir = tempfile.mkdtemp(dir=out_dir)
    mp.spawn(rank_run, args=(world, f"tcp://127.0.0.1:{port}", out_dir),
             nprocs=world, join=True)
    ranks = []
    for r in range(world):
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    for i, first in enumerate(ranks[0]):
        same = ("exchange", "unique", "generated", "digest", "replay",
                "iterations", "rank_rows")
        want = (PIN_LOCK8 if first["n"] == "lock8" else
                (UNIQUE_2PC16_SYM, GENERATED_2PC16_SYM, DIGEST_2PC16_SYM)
                if first["symmetry"] else
                (UNIQUE_2PC7, GENERATED_2PC7, DIGEST_2PC7))
        step = ("fused_step_noprobe_sym" if first["symmetry"]
                else "fused_step_noprobe")
        checks = {
            "unique": first["unique"] == want[0],
            "generated": first["generated"] == want[1],
            "digest": first["digest"] == want[2],
            "replay": all(first["replay"].values()),
            "ranks_agree": all(r[i][k] == first[k] for r in ranks
                               for k in same),
            "exchange": first["exchange"] == RANK_CASES[i][0],
            "launches": all(r[i]["launches"][step] > 0
                            and r[i]["launches"]["probe_block"] > 0
                            and r[i]["launches"]["fused_step"] == 0
                            and r[i]["launches"]["fused_step_sym"] == 0
                            for r in ranks),
        }
        wall = max(r[i]["wall_s"] for r in ranks)
        emit(phase="e2e_ranks", ranks=world, wall_s=wall,
             unique_per_s=first["unique"] / wall,
             per_rank=[{k: r[i][k] for k in (
                 "wall_s", "loop_s", "syncs", "sync_s", "collectives",
                 "peak", "launches", "gather_s")} for r in ranks],
             **{k: first[k] for k in (
                 "n", "symmetry", "exchange", "unique", "generated",
                 "digest", "iterations",
                 "small_iterations", "collectives_per_iteration", "kovfs",
                 "aborts", "kmax", "kb", "rank_rows", "dmax", "bmax")},
             checks=checks)
        if not all(checks.values()):
            raise AssertionError(f"{world}-rank {first['n']}, "
                                 f"{first['exchange']}: {checks}")
    for line in smi:
        print(line, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": names[0], "count": world}}), flush=True)
    return 0


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    try:
        from stateright_tpu_torch import TwoPhaseSys
        from stateright_tpu_torch.ops import _cuda
    except ImportError as exc:
        print(f"chip_smoke: run from a checkout of the repository ({exc})",
              file=sys.stderr)
        return 2

    name = torch.cuda.get_device_name(0)
    smi = run(["nvidia-smi", "--query-gpu=name,power.limit",
               "--format=csv,noheader"]).splitlines()[0]
    try:
        nvcc = run([_cuda._nvcc(), "--version"]).splitlines()[-1]
    except (RuntimeError, subprocess.CalledProcessError) as exc:
        nvcc = f"unavailable: {exc}"
    emit(phase="device", name=name, nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda, nvcc=nvcc,
         count=torch.cuda.device_count())

    info = _cuda.build()
    emit(phase="build", seconds=info["seconds"], library=info["path"],
         kernels={lib: ptxas_usage(log)
                  for lib, log in info["logs"].items()})

    model = TwoPhaseSys(7)
    carry = mid_search_carry(model, torch.device("cuda", 0))
    large = check_step(model, carry, 12288, reps=20)
    emit(phase="kernels", kernel="fused_step", **large)
    small = check_step(model, carry, 256, reps=50)
    emit(phase="kernels", kernel="fused_step", **small)
    ins = check_insert(carry, reps=10)
    emit(phase="kernels", kernel="table_insert", **ins)
    np_large, step = check_noprobe(model, carry, 12288, reps=20)
    emit(phase="kernels", kernel="fused_step_noprobe", **np_large)
    np_small, _ = check_noprobe(model, carry, 256, reps=50)
    emit(phase="kernels", kernel="fused_step_noprobe", **np_small)
    probe = check_probe(model, carry, step, reps=20)
    emit(phase="kernels", kernel="probe_block", **probe)
    del step
    # the chunk's kernels: the control kernels, then K7 after a real step
    # of 12,288 and of 256 rows
    control = check_control(model, carry)
    emit(phase="kernels", kernel="chunk_gate", **control)
    appends = {("plain", f): check_append(model, carry, f, reps)
               for f, reps in ((12288, 50), (256, 100))}
    for (_mode, f), res in appends.items():
        emit(phase="kernels", kernel="append", **res)
    del carry

    # the symmetric steps at the full width of 2pc n=16 (82 actions): a
    # mid-search frontier of the reference representative's search; the
    # complete representative's own search never holds more than ~1,200
    # pending rows, so it is checked on the same rows with its own
    # canonical frontier fingerprints
    sym_models = {"reference": TwoPhaseSys(16),
                  "complete": TwoPhaseSys(16, complete_symmetry=True)}
    carry16 = mid_search_carry(sym_models["reference"],
                               torch.device("cuda", 0), symmetry=True)
    sym_kernels = {"fused_step_sym": {}, "fused_step_noprobe_sym": {}}
    for mode, m16 in sym_models.items():
        pfp = None if mode == "reference" else frontier_fps(m16)
        for f, reps in ((12288, 20), (256, 50)):
            res = check_step(m16, carry16, f, reps, symmetry=True, pfp=pfp)
            sym_kernels["fused_step_sym"][mode, f] = res
            emit(phase="kernels", kernel="fused_step_sym",
                 representative=mode, **res)
            res, _ = check_noprobe(m16, carry16, f, reps, symmetry=True,
                                   pfp=pfp)
            sym_kernels["fused_step_noprobe_sym"][mode, f] = res
            emit(phase="kernels", kernel="fused_step_noprobe_sym",
                 representative=mode, **res)
    # K7 with the 6-column log, after a real symmetric step
    for f, reps in ((12288, 50), (256, 100)):
        res = appends["symmetric", f] = check_append(
            sym_models["reference"], carry16, f, reps)
        emit(phase="kernels", kernel="append", symmetry="reference", **res)
    del carry16
    # K1's instantiations for the other models, at their real mid-search
    # steps
    model_steps = check_model_steps(torch.device("cuda", 0))

    chunk_kernels = ("chunk_begin", "chunk_gate", "append")
    single = ("fused_step", "table_insert") + chunk_kernels
    default, card = end_to_end(TwoPhaseSys, single)
    emit(phase="e2e", **default)
    # the chunk: the default run (pipeline=True) and the synchronous
    # chunk loop, in turns, on this card; one sync per chunk
    chunk_runs = []
    for pipeline in (True, False, True, False):
        res, _ck = end_to_end(TwoPhaseSys, single, pipeline=pipeline)
        del _ck
        chunk_runs.append(res)
        limit = -(-res["iterations"] // 64) + 2
        res["checks"]["syncs_per_chunk"] = (res["syncs"] <= limit
                                            and res["syncs"]
                                            == res["chunks"])
        emit(phase="chunk", pipeline=pipeline, sync_limit=limit,
             **{k: res[k] for k in (
                 "wall_s", "loop_s", "chunks", "syncs", "sync_stall",
                 "sync_s", "capture_s", "graph_launches", "iterations",
                 "small_iterations", "launches", "checks")})
        if not res["checks"]["syncs_per_chunk"]:
            raise AssertionError(f"chunk run pipeline={pipeline}: "
                                 f"{res['syncs']} syncs, {res['chunks']} "
                                 f"chunks over {res['iterations']} "
                                 "iterations")
    emit(phase="mirror_vs_plain", **mirror_vs_plain(card))
    del card
    # where the device time of the run goes (a separate, profiled run)
    prof = device_times(lambda: TwoPhaseSys(7).checker().spawn_gpu().join(),
                        host_top=12)
    emit(phase="e2e_profile", engine="gpu", **prof)
    # the capacity pre-bump (capacity grows x4 until grow_at * capacity
    # exceeds one step's appends) would lift 2**16 straight to 2**20 at
    # 12,288-row steps; 512-row steps keep it, so the run grows twice
    grown, _ck = end_to_end(TwoPhaseSys, single, capacity=1 << 16,
                            fmax=512)
    emit(phase="e2e", **grown)
    if grown["grows"] != 2 or grown["digest"] != default["digest"]:
        raise AssertionError(f"growth run: {grown['grows']} growths, "
                             f"digest {grown['digest']}")

    # symmetry reduction on one card: the orbits of 2pc7 and its
    # reference representative's sound range, recounted on the card;
    # then the symmetric single-chip path
    orbits, orbit_keys7 = orbits_2pc7(torch.device("cuda", 0))
    emit(phase="orbits_2pc7", **orbits)
    single_sym = ("fused_step_sym", "table_insert") + chunk_kernels
    off_sym = ("fused_step", "fused_step_noprobe", "fused_step_noprobe_sym",
               "probe_block")
    res, ck7, _rec = end_to_end_sym(
        TwoPhaseSys(7, complete_symmetry=True), single_sym, off_sym,
        want=(UNIQUE_2PC7_SYM, GENERATED_2PC7_SYM, DIGEST_2PC7_SYM))
    emit(phase="e2e_sym", **res)
    res, ck7, _rec = end_to_end_sym(TwoPhaseSys(7), single_sym, off_sym)
    # the reference representative: a count in the sound range, and the
    # original rows it enqueued cover every orbit
    q7, tail7 = ck7._queue
    cover7 = canonical_keys(TwoPhaseSys(7, complete_symmetry=True),
                            q7[:tail7, :4])
    res["checks"].update(
        sound_range=UNIQUE_2PC7_SYM <= res["unique"] <= REF_KEYS_2PC7,
        covers_every_orbit=cover7 == orbit_keys7)
    emit(phase="e2e_sym", **res)
    if not all(res["checks"].values()):
        raise AssertionError(f"2pc7 reference symmetry: {res['checks']}")
    del ck7, q7, _rec
    sym16, ck16, _rec = end_to_end_sym(
        TwoPhaseSys(16, complete_symmetry=True), single_sym, off_sym,
        want=(UNIQUE_2PC16_SYM, GENERATED_2PC16_SYM, DIGEST_2PC16_SYM))
    emit(phase="e2e_sym", **sym16)
    orbit_keys16 = ck16.generated_fingerprints()
    verdicts16 = sorted(ck16.discoveries())
    del ck16, _rec
    # the full-width run where the kernels work: over a million
    # reduced states
    want_ref16 = (UNIQUE_2PC16_REF, GENERATED_2PC16_REF, DIGEST_2PC16_REF)
    ref16, ck16, rec16 = end_to_end_sym(TwoPhaseSys(16), single_sym,
                                        off_sym, want=want_ref16)
    emit(phase="e2e_sym", **ref16)
    again, _ck, rec_again = end_to_end_sym(TwoPhaseSys(16), single_sym,
                                           off_sym, want=want_ref16)
    del _ck
    q16, tail16 = ck16._queue
    cover16 = canonical_keys(TwoPhaseSys(16, complete_symmetry=True),
                             q16[:tail16, :4])
    checks = {
        # K2/K3's winner rule makes the search record repeat row for row
        "record_repeats": (len(rec16[0]) == len(rec_again[0])
                           and torch.equal(rec16[0], rec_again[0])),
        "covers_every_orbit": cover16 == orbit_keys16,
        "verdicts": sorted(ck16.discoveries()) == verdicts16,
    }
    emit(phase="e2e_sym_checks", representative="reference", n=16,
         rows=len(rec16[0]), enqueued=tail16, orbits=len(cover16),
         repeat_wall_s=again["wall_s"], checks=checks)
    if not all(checks.values()):
        raise AssertionError(f"2pc16 reference symmetry: {checks}")
    del ck16, q16, rec16, rec_again
    # where the device time of the full-width symmetric run goes (a
    # separate, profiled run)
    m16 = TwoPhaseSys(16)
    prof16 = device_times(lambda: m16.checker().symmetry_fn(
        m16.representative).spawn_gpu().join(), host_top=12)
    emit(phase="e2e_profile", engine="gpu", symmetry="reference", n=16,
         **prof16)
    # growth under symmetry (the 6-column log re-inserted): 16-row steps
    # keep a 2**12-slot table, which then grows twice
    grown_sym, _ck, _rec = end_to_end_sym(
        TwoPhaseSys(16, complete_symmetry=True), single_sym, off_sym,
        want=(UNIQUE_2PC16_SYM, GENERATED_2PC16_SYM, DIGEST_2PC16_SYM),
        capacity=1 << 12, fmax=16)
    emit(phase="e2e_sym", **grown_sym)
    if grown_sym["grows"] < 1:
        raise AssertionError("the symmetric growth run did not grow")
    del _ck, _rec

    # the sharded engine on a one-rank NCCL group: the probe-free step,
    # the owner-side probe, the insert kernel (seeding, growth) — and no
    # single-chip step
    import torch.distributed as dist
    mesh, nccl_init_s = one_rank_mesh()
    emit(phase="nccl", ranks=1, init_s=nccl_init_s)
    sharded = ("fused_step_noprobe", "probe_block", "table_insert")
    sh, sh_ck = end_to_end(TwoPhaseSys, sharded, mesh=mesh)
    sh["single_chip_steps"] = sh["launches"]["fused_step"]
    emit(phase="e2e_sharded", **sh)
    if sh["digest"] != default["digest"] or sh["launches"]["fused_step"]:
        raise AssertionError(f"sharded run: digest {sh['digest']}, "
                             f"{sh['launches']}")
    runs = []
    sh_prof = device_times(lambda: runs.append(
        TwoPhaseSys(7).checker().gpu_options(mesh=mesh).spawn_gpu().join()),
        host_top=12)
    # the owner-side probe's winner rule makes the record repeat
    runs[0].generated_fingerprints()  # pulls its mirror
    again = list(runs[0]._generated.items())
    first = list(sh_ck._generated.items())
    emit(phase="e2e_profile", engine="gpu-sharded",
         record_repeats=again == first, rows=len(first), **sh_prof)
    if again != first:
        raise AssertionError("the sharded search record differs between "
                             "two runs on the card")
    del sh_ck, runs
    sh_grown, _ck = end_to_end(TwoPhaseSys, sharded, mesh=mesh,
                               capacity=1 << 16, fmax=512)
    emit(phase="e2e_sharded", **sh_grown)
    if sh_grown["grows"] < 1 or sh_grown["digest"] != default["digest"]:
        raise AssertionError(f"sharded growth run: {sh_grown['grows']} "
                             f"growths, digest {sh_grown['digest']}")
    # the sharded engine under symmetry: the symmetric probe-free step,
    # the owner-side probe on canonical keys, the same 21,335 orbits
    sh_sym, _ck, _rec = end_to_end_sym(
        TwoPhaseSys(16, complete_symmetry=True),
        ("fused_step_noprobe_sym", "probe_block", "table_insert"),
        ("fused_step", "fused_step_sym", "fused_step_noprobe")
        + chunk_kernels,
        want=(UNIQUE_2PC16_SYM, GENERATED_2PC16_SYM, DIGEST_2PC16_SYM),
        mesh=mesh)
    emit(phase="e2e_sharded_sym", **sh_sym)
    del _ck, _rec
    # the other models end to end, on one card and on the one-rank mesh
    model_runs = models_phase(mesh)
    dist.destroy_process_group()

    fused_src = "stateright_tpu_torch/csrc/fused_step.cu"
    sharded_src = "stateright_tpu_torch/csrc/sharded_step.cu"
    kernels = [
        {"name": "fused_step", "route": "cuda", "source": fused_src,
         "replaces": "stateright_tpu/ops/fused.py:259",
         "launches": default["launches"]["fused_step"],
         "max_abs_err": max(large["max_abs_err"], small["max_abs_err"]),
         "ms": large["ms"], "plain_ms": large["plain_ms"],
         "bound_ms": large["bound_ms"], "bound_by": large["bound_by"],
         "library_ms": None,
         "small_step": {k: small[k] for k in ("ms", "plain_ms", "bound_ms",
                                              "bound_by")},
         "parts": {"f=12288": large["parts"], "f=256": small["parts"]},
         "status": "ok"},
        {"name": "table_insert", "route": "cuda", "source": fused_src,
         "replaces": "stateright_tpu/ops/hashtable.py:71",
         "launches": default["launches"]["table_insert"],
         "max_abs_err": ins["max_abs_err"], "ms": ins["ms"],
         "plain_ms": ins["plain_ms"], "bound_ms": ins["bound_ms"],
         "bound_by": ins["bound_by"], "library_ms": None,
         "parts": ins["parts"],
         "mask": {k: ins["mask"][k] for k in ("ms", "device_ms", "bound_ms",
                                              "bound_by", "parts")},
         "status": "ok"},
        {"name": "fused_step_noprobe", "route": "cuda",
         "source": sharded_src,
         "replaces": "stateright_tpu/ops/fused.py:259",
         "configuration": "probe=False (sharded step)",
         "launches": sh["launches"]["fused_step_noprobe"],
         "max_abs_err": max(np_large["max_abs_err"],
                            np_small["max_abs_err"]),
         "ms": np_large["ms"], "plain_ms": np_large["plain_ms"],
         "bound_ms": np_large["bound_ms"], "bound_by": np_large["bound_by"],
         "library_ms": None,
         "small_step": {k: np_small[k] for k in ("ms", "plain_ms",
                                                 "bound_ms", "bound_by")},
         "parts": {"f=12288": np_large["parts"],
                   "f=256": np_small["parts"]},
         "status": "ok"},
        {"name": "probe_block", "route": "cuda", "source": sharded_src,
         "replaces": "stateright_tpu/ops/fused.py:526",
         "launches": sh["launches"]["probe_block"],
         "max_abs_err": probe["max_abs_err"], "ms": probe["ms"],
         "plain_ms": probe["plain_ms"], "bound_ms": probe["bound_ms"],
         "bound_by": probe["bound_by"], "library_ms": None,
         "parts": {"main": probe["main"]["parts"],
                   "twice": probe["twice"]["parts"]},
         "status": "ok"},
    ]
    for kernel, launches in (("fused_step_sym",
                               ref16["launches"]["fused_step_sym"]),
                              ("fused_step_noprobe_sym",
                               sh_sym["launches"]["fused_step_noprobe_sym"])):
        runs = sym_kernels[kernel]
        large = runs["reference", 12288]
        probe = kernel == "fused_step_sym"
        kernels.append({
            "name": kernel, "route": "cuda",
            "source": fused_src if probe else sharded_src,
            "replaces": "stateright_tpu/ops/fused.py:259",
            "configuration": "symmetry=True, probe="
                             + ("True" if probe else "False (sharded step)"),
            "launches": launches,
            "max_abs_err": max(r["max_abs_err"] for r in runs.values()),
            "ms": large["ms"], "plain_ms": large["plain_ms"],
            "bound_ms": large["bound_ms"], "bound_by": large["bound_by"],
            "library_ms": None,
            "by_mode_and_rows": {
                f"{mode} f={f}": {k: r[k] for k in (
                    "ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
                    "max_abs_err", "parts")}
                for (mode, f), r in runs.items()},
            "status": "ok"})
    chunk_src = "stateright_tpu_torch/csrc/chunk.cu"
    k7 = appends["plain", 12288]
    kernels += [
        {"name": "append", "route": "cuda", "source": chunk_src,
         "replaces": "stateright_tpu/checker/device_loop.py:696",
         "launches": default["launches"]["append"],
         "max_abs_err": max(r["max_abs_err"] for r in appends.values()),
         "ms": k7["ms"], "plain_ms": k7["plain_ms"],
         "bound_ms": k7["bound_ms"], "bound_by": k7["bound_by"],
         "library_ms": None,
         "by_shape": {f"{mode} f={f}": {k: r[k] for k in (
             "lanes", "appended", "ms", "device_ms", "device_by_kernel_ms",
             "plain_ms", "glue_device_ms", "bound_ms", "bound_by",
             "max_abs_err")} for (mode, f), r in appends.items()},
         "status": "ok"},
        {"name": "chunk_gate", "route": "cuda", "source": chunk_src,
         "replaces": "stateright_tpu/checker/device_loop.py:352",
         "launches": default["launches"]["chunk_gate"],
         "max_abs_err": control["max_abs_err"], "ms": control["ms"],
         "plain_ms": control["plain_ms"], "bound_ms": control["bound_ms"],
         "bound_by": control["bound_by"], "library_ms": None,
         "device_ms": control["device_ms"], "status": "ok"},
        {"name": "chunk_begin", "route": "cuda", "source": chunk_src,
         "replaces": "stateright_tpu/checker/tpu.py:1377",
         "launches": default["launches"]["chunk_begin"],
         "max_abs_err": control["max_abs_err"], "ms": control["begin_ms"],
         "plain_ms": control["begin_plain_ms"],
         "bound_ms": control["bound_ms"],
         "bound_by": control["bound_by"], "library_ms": None,
         "device_ms": control["begin_device_ms"], "status": "ok"},
    ]
    kernels += model_kernel_entries(model_steps, model_runs)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    # the run uses one card, whatever the machine holds
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--ranks":
        sys.exit(ranks_main(int(sys.argv[2])))
    sys.exit(main())
