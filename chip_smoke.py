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
             sharded step) by the lane and set gates, and timed with CUDA
             events and ``torch.profiler``;
4. e2e     — ``TwoPhaseSys(7).checker().spawn_gpu().join()`` with default
             options, checked against the oracle counts, the fingerprint-set
             digest, the properties and both witness replays, with every
             kernel's launch count set to 0 before the run and read after
             it; then again from a 2**16-slot table, which grows twice;
5. e2e_sharded — the same check through the sharded engine,
             ``gpu_options(mesh=<DeviceMesh>)``, on a one-rank NCCL group
             (one card), with default options and again from a 2**16-slot
             table at 512-row steps, which grows; the same launch counts,
             and a second run's search record compared row for row.

Then a ``kernels`` line (the contract's per-kernel record), the card's name
and power limit from ``nvidia-smi``, and as the last line
``{"ok": true, "device": {...}}``. Any failed check or exception exits
non-zero before that line. It exits 2 without a CUDA device or outside a
checkout of the repository.

    python3 chip_smoke.py --ranks 4

runs the sharded engine across that many cards instead, one process per
card on one NCCL group: 2pc n=7 with the bucketed exchange and with the
ring, each held to the same counts, digest and witnesses on every rank
(phase ``e2e_ranks``). It needs that many cards.
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

#: HBM bandwidth of an H100 SXM (bytes/s) and its CUDA-core fp32 rate
#: (operations/s): NVIDIA's published peaks at 700 W. The steps do 32-bit
#: integer work, for which no peak is published beside these; it is
#: counted at the fp32 CUDA-core rate.
HBM_BYTES_S = 3.35e12
CORE_OPS_S = 67e12


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
_OURS = ("dedup_claim_kernel", "dedup_commit_kernel", "probe_claim_kernel",
         "probe_commit_kernel", "predup_kernel", "expand_kernel",
         "claim_kernel", "commit_kernel", "insert_kernel")


def kernel_name(symbol: str):
    return next((k for k in _OURS if k in symbol), None)


def ptxas_usage(log: str) -> dict:
    """Registers and shared memory per kernel from ``-Xptxas -v`` (the
    expand kernel is built into both libraries; the last one read is
    kept)."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line) \
            or re.search(r"Function properties for (\w+)", line)
        if m:
            name = m.group(1)
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            smem = re.search(r"(\d+) bytes smem", line)
            out[kernel_name(name) or name] = {
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


def device_times(fn, host_top: int = 0) -> dict:
    """Device time of one call of ``fn`` from ``torch.profiler``, split
    into this port's kernels (by name), torch's kernels, and copies and
    memsets, in milliseconds; ``None`` values when the trace holds no
    device time. ``host_top`` > 0 adds the host operations with the most
    self CPU time (name, ms, calls)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ours = {k: 0.0 for k in _OURS}
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
    return out


def mid_search_carry(model, device):
    """A real mid-search state of 2pc n=7: the port's own loop run until
    at least 12,288 rows are pending."""
    import numpy as np
    import torch

    from stateright_tpu_torch.checker.device_loop import (LoopStats,
                                                          seed_carry,
                                                          step_once)
    from stateright_tpu_torch.ops.expand import FMAX_SMALL
    from stateright_tpu_torch.ops.hashtable import table_insert
    from stateright_tpu_torch.ops.words import from_numpy_u32

    init = model.init_states()[0]
    fp = model.fingerprint(init)
    fa = 12288 * model.max_actions
    carry = seed_carry(model, 1 << 21, 1 << 20, [model.encode(init)], 0,
                       [fp], 1 << 15, device)
    table_insert(carry.table,
                 from_numpy_u32(np.array([fp >> 32], np.uint32), device),
                 from_numpy_u32(np.array([fp & 0xFFFFFFFF], np.uint32),
                                device),
                 torch.ones((1,), dtype=torch.bool, device=device))
    stats = LoopStats()
    while carry.q_tail - carry.q_head < 12288:
        avail = carry.q_tail - carry.q_head
        if avail == 0 or carry.q_tail > carry.q.shape[0] - fa:
            raise RuntimeError("2pc7 search ended before a 12,288-row "
                               "frontier")
        step_once(model, carry, FMAX_SMALL if avail <= FMAX_SMALL
                  else 12288, stats)
    return carry


def lowest_lane_wins(out) -> bool:
    """The kernel's winner rule: each inserted lane is the lowest lane
    that carried its key to the table."""
    import torch

    from stateright_tpu_torch.ops.words import pack64

    keys = pack64(out.chi, out.clo)
    lanes = torch.arange(keys.shape[0], device=keys.device)
    uniq, inv = torch.unique(keys[out.dvalid], return_inverse=True)
    first = torch.full((uniq.shape[0],), keys.shape[0], dtype=torch.int64,
                       device=keys.device)
    first.scatter_reduce_(0, inv, lanes[out.dvalid], reduce="amin")
    won = first[torch.searchsorted(uniq, keys[out.inserted])]
    return bool((won == lanes[out.inserted]).all())


def check_step(model, carry, f: int, reps: int) -> dict:
    """K1-K3 (one ``fused_step``) against ``fused_step_reference`` on the
    card over ``f`` pending rows of ``carry``, by the set gate."""
    import numpy as np
    import torch

    from stateright_tpu_torch.ops.fused import (S_DISC, S_OVF, S_XOVF,
                                                StepWorkspace, fused_step,
                                                fused_step_reference)
    from stateright_tpu_torch.ops.words import pack64

    w = model.packed_width
    block = carry.q[carry.q_head:carry.q_head + f]
    take = min(carry.q_tail - carry.q_head, f)
    fvalid = torch.arange(f, device=block.device) < take
    args = (block[:, :w], block[:, w], fvalid, block[:, w + 1],
            block[:, w + 2])
    table0, ring0 = carry.table.clone(), carry.ring.clone()
    t_k, r_k = table0.clone(), ring0.clone()
    t_p, r_p = table0.clone(), ring0.clone()
    n_props = len(model.properties())
    ws = StepWorkspace(table0.numel(), ring0.shape[0], n_props,
                       block.device)
    k = fused_step(model, *args, t_k, r_k, ws)
    # the plain version walks its blocks one after another: it is timed
    # on this one comparison step only
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    p = fused_step_reference(model, *args, t_p, r_p)
    end.record()
    end.synchronize()
    plain_ms = start.elapsed_time(end)
    lane_exact = ("flat", "chi", "clo", "cvalid", "pbits", "ebits",
                  "terminal")
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
    checks = {
        "lane_exact": err == 0,
        "inserted_set": ks == ps,
        "one_lane_per_key": len(kk) == len(ks) and len(pk) == len(ps),
        "table_set": np.array_equal(table_k, table_p),
        "discoveries": np.array_equal(sk[S_DISC:], sp[S_DISC:]),
        "flags": (sk[S_XOVF], sk[S_OVF]) == (sp[S_XOVF], sp[S_OVF]),
        "lowest_lane_wins": lowest_lane_wins(k),
    }
    if not all(checks.values()):
        raise AssertionError(f"fused step f={f} disagrees with its plain "
                             f"version: {checks}")

    def restore():
        t_k.copy_(table0)
        r_k.copy_(ring0)

    ms = cuda_ms(lambda: fused_step(model, *args, t_k, r_k, ws), reps,
                 restore)
    restore()
    dev = device_times(lambda: fused_step(model, *args, t_k, r_k, ws))
    # the bound: each input read once, each output written once, table
    # and ring traffic counted for this step's lanes
    lanes = f * model.max_actions
    n_valid = int(k.cvalid.sum())
    n_table = int(k.dvalid.sum())
    n_ins = len(kk)
    nbytes = (f * (4 * w + 4 + 8 + 1)            # frontier, ebits, fps, fvalid
              + f * (max(n_props, 1) + 4 + 1)    # pbits, ebits, terminal
              + lanes * (4 * w + 8 + 3)          # flat, chi/clo, 3 masks
              + n_valid * 8                      # ring probes
              + n_table * 32                     # bucket reads
              + n_ins * 16)                      # table + ring writes
    ops = lanes * 120 + n_table * 12
    bound_s = max(nbytes / HBM_BYTES_S, ops / CORE_OPS_S)
    return {"f": f, "lanes": lanes, "valid": n_valid, "to_table": n_table,
            "inserted": n_ins, "max_abs_err": err, "ms": ms,
            "device_ms": dev["ours_ms"],
            "device_by_kernel_ms": dev["by_kernel_ms"],
            "plain_ms": plain_ms, "bytes": nbytes, "ops": ops,
            "bound_ms": bound_s * 1e3,
            "bound_by": ("bytes" if nbytes / HBM_BYTES_S
                         >= ops / CORE_OPS_S else "operations"),
            "checks": checks}


def check_insert(carry, reps: int) -> dict:
    """K4 against ``table_insert_reference`` on the card: the growth
    re-insert of the mid-search log into an empty 2**20-slot table, with
    every key twice in the batch."""
    import numpy as np
    import torch

    from stateright_tpu_torch.ops.hashtable import (make_table,
                                                    table_insert,
                                                    table_insert_reference)
    from stateright_tpu_torch.ops.words import pack64

    log = carry.log[:carry.log_n]
    hi = torch.cat([log[:, 0], log[:, 0]])
    lo = torch.cat([log[:, 1], log[:, 1]])
    valid = torch.ones((hi.shape[0],), dtype=torch.bool, device=hi.device)
    t_k = make_table(1 << 20, hi.device)
    t_p = make_table(1 << 20, hi.device)
    ins_k, ovf_k = table_insert(t_k, hi, lo, valid)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    ins_p, ovf_p = table_insert_reference(t_p, hi, lo, valid)
    end.record()
    end.synchronize()
    plain_ms = start.elapsed_time(end)
    keys = pack64(hi, lo)
    kk, pk = keys[ins_k].cpu().numpy(), keys[ins_p].cpu().numpy()
    table_k = np.sort(t_k[t_k != 0].cpu().numpy())
    table_p = np.sort(t_p[t_p != 0].cpu().numpy())
    checks = {
        "inserted_set": set(kk.tolist()) == set(pk.tolist()),
        "one_lane_per_key": len(kk) == len(set(kk.tolist())) == carry.log_n,
        "table_set": np.array_equal(table_k, table_p),
        "flags": ovf_k == ovf_p,
    }
    if table_k.shape != table_p.shape:
        raise AssertionError(f"insert kernel table holds {table_k.size} "
                             f"keys, its plain version {table_p.size}")
    # the largest difference of the sorted table keys' uint32 words
    words_k = table_k.view(np.uint32).astype(np.int64)
    words_p = table_p.view(np.uint32).astype(np.int64)
    err = int(np.abs(words_k - words_p).max()) if words_k.size else 0
    if not all(checks.values()):
        raise AssertionError(f"insert kernel disagrees with its plain "
                             f"version: {checks}")
    ms = cuda_ms(lambda: table_insert(t_k, hi, lo, valid), reps,
                 lambda: t_k.zero_())
    t_k.zero_()
    dev = device_times(lambda: table_insert(t_k, hi, lo, valid))
    n = hi.shape[0]
    nbytes = n * (4 + 4 + 1 + 1) + n * 32 + carry.log_n * 8
    ops = n * 12
    return {"n": n, "keys": carry.log_n, "max_abs_err": err, "ms": ms,
            "device_ms": dev["ours_ms"], "plain_ms": plain_ms,
            "bytes": nbytes, "ops": ops,
            "bound_ms": max(nbytes / HBM_BYTES_S, ops / CORE_OPS_S) * 1e3,
            "bound_by": ("bytes" if nbytes / HBM_BYTES_S
                         >= ops / CORE_OPS_S else "operations"),
            "checks": checks}


def ring_hits(out, ring):
    """Valid lanes whose key the ring holds (the probe-free step drops
    them)."""
    from stateright_tpu_torch.ops.hashtable import start_bucket
    from stateright_tpu_torch.ops.words import pack64

    keys = pack64(out.chi, out.clo)
    slot = start_bucket(out.chi, out.clo, ring.shape[0])
    return out.cvalid & (ring[slot] == keys)


def check_noprobe(model, carry, f: int, reps: int) -> dict:
    """K1 + K5 (one ``fused_step(probe=False)``) against its plain version
    on the card over ``f`` pending rows of ``carry`` and its ring:
    lane-exact outputs, scalars and discoveries; ``dvalid`` by the key-set
    gate (a subset of the valid lanes the ring does not hold, with their
    key set, one lane per key, the lowest)."""
    import torch

    from stateright_tpu_torch.ops.fused import (S_CCH, S_DISC, S_OVF,
                                                S_VALID, S_XOVF,
                                                DedupWorkspace, _block_rows,
                                                fused_step,
                                                fused_step_reference)
    from stateright_tpu_torch.ops.words import pack64

    w = model.packed_width
    a = model.max_actions
    block = carry.q[carry.q_head:carry.q_head + f]
    take = min(carry.q_tail - carry.q_head, f)
    fvalid = torch.arange(f, device=block.device) < take
    args = (block[:, :w], block[:, w], fvalid, block[:, w + 1],
            block[:, w + 2], None, carry.ring)
    n_props = len(model.properties())
    ws = DedupWorkspace(f * a, _block_rows(f) * a, carry.ring.shape[0],
                        n_props, block.device)
    k = fused_step(model, *args, ws, probe=False)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    p = fused_step_reference(model, *args, probe=False)
    end.record()
    end.synchronize()
    plain_ms = start.elapsed_time(end)
    err = 0
    for name in ("flat", "chi", "clo", "cvalid", "pbits", "ebits",
                 "terminal"):
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
    checks = {
        "lane_exact": err == 0,
        "scalars": all(sk[i] == sp[i] for i in (S_XOVF, S_OVF, S_CCH,
                                                 S_VALID)),
        "discoveries": bool((sk[S_DISC:] == sp[S_DISC:]).all()),
        "dvalid_subset": bool((k.dvalid <= live).all()),
        "dvalid_key_set": set(kd.tolist()) == live_keys
        == set(pd.tolist()),
        "one_lane_per_key": len(kd) == len(set(kd.tolist())),
        "lowest_lane_wins": lowest_lane_wins(k._replace(
            dvalid=live, inserted=k.dvalid)),
    }
    if not all(checks.values()):
        raise AssertionError(f"probe-free step f={f} disagrees with its "
                             f"plain version: {checks}")
    ms = cuda_ms(lambda: fused_step(model, *args, ws, probe=False), reps)
    dev = device_times(lambda: fused_step(model, *args, ws, probe=False))
    lanes = f * a
    n_valid = int(k.cvalid.sum())
    nbytes = (f * (4 * w + 4 + 8 + 1)            # frontier, ebits, fps, fvalid
              + f * (max(n_props, 1) + 4 + 1)    # pbits, ebits, terminal
              + lanes * (4 * w + 8 + 2)          # flat, chi/clo, 2 masks
              + n_valid * 8)                     # ring probes
    ops = lanes * 120 + n_valid * 16
    bound_s = max(nbytes / HBM_BYTES_S, ops / CORE_OPS_S)
    return {"f": f, "lanes": lanes, "valid": n_valid,
            "ring_hits": int(sk[S_CCH]), "dvalid": len(kd),
            "dvalid_plain": len(pd), "max_abs_err": err, "ms": ms,
            "device_ms": dev["ours_ms"],
            "device_by_kernel_ms": dev["by_kernel_ms"],
            "memset_ms": dev["copy_ms"], "plain_ms": plain_ms,
            "bytes": nbytes, "ops": ops, "bound_ms": bound_s * 1e3,
            "bound_by": ("bytes" if nbytes / HBM_BYTES_S
                         >= ops / CORE_OPS_S else "operations"),
            "checks": checks}, k


def check_probe(model, carry, step, reps: int) -> dict:
    """K6 (``probe_block``) against ``probe_block_reference`` on the card:
    the lanes the probe-free step ``step`` kept, compacted to the received
    width of the default one-rank sharded run (``kmax`` rows, the fresh
    ones first), probed into a copy of ``carry``'s table; then the same
    lanes twice over, where the lowest lane of each fresh key must win."""
    import numpy as np
    import torch

    from stateright_tpu_torch.checker.device_loop import shrink_indices
    from stateright_tpu_torch.checker.gpu import candidate_sizes
    from stateright_tpu_torch.ops.fused import (StepWorkspace, probe_block,
                                                probe_block_reference)
    from stateright_tpu_torch.ops.words import pack64

    kraw, kmax = candidate_sizes(model, 12288, {})
    count = int(step.dvalid.sum())
    if count > kmax:  # the engine's abort handler widens it so
        kmax = min(max(kmax * 2, -(-(count + count // 4) // 256) * 256),
                   12288 * model.max_actions)
    src = shrink_indices(step.dvalid, kmax)
    hi, lo = step.chi[src], step.clo[src]
    valid = torch.arange(kmax, device=hi.device) < count
    out = {"n": kmax, "valid": count}
    for label, (h, l_, v) in (("main", (hi, lo, valid)),
                              ("twice", (torch.cat([hi, hi]),
                                         torch.cat([lo, lo]),
                                         torch.cat([valid, valid])))):
        t_k, t_p = carry.table.clone(), carry.table.clone()
        ws = StepWorkspace(t_k.numel(), 0, 0, t_k.device)
        ins_k, ovf_k, _r = probe_block(t_k, h, l_, v, ws)
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
        lanes = torch.arange(keys.shape[0], device=keys.device)
        uniq, inv = torch.unique(keys[v], return_inverse=True)
        first = torch.full((uniq.shape[0],), keys.shape[0],
                           dtype=torch.int64, device=keys.device)
        first.scatter_reduce_(0, inv, lanes[v], reduce="amin")
        won = first[torch.searchsorted(uniq, keys[ins_k])]
        checks = {
            "inserted_set": set(kk.tolist()) == set(pk.tolist()),
            "one_lane_per_key": len(kk) == len(set(kk.tolist())),
            "table_set": np.array_equal(table_k, table_p),
            "flags": bool(ovf_k) == bool(ovf_p),
            "lowest_lane_wins": bool((won == lanes[ins_k]).all()),
        }
        if table_k.shape != table_p.shape or not all(checks.values()):
            raise AssertionError(f"owner-side probe ({label}) disagrees "
                                 f"with its plain version: {checks}")
        words_k = table_k.view(np.uint32).astype(np.int64)
        words_p = table_p.view(np.uint32).astype(np.int64)
        err = int(np.abs(words_k - words_p).max()) if words_k.size else 0
        out[label] = {"inserted": len(kk), "max_abs_err": err,
                      "checks": checks}
        if label == "main":
            out["plain_ms"] = start.elapsed_time(end)
            table0 = carry.table

            def restore(t=t_k, t0=table0):
                t.copy_(t0)

            out["ms"] = cuda_ms(lambda: probe_block(t_k, h, l_, v, ws),
                                reps, restore)
            restore()
            dev = device_times(lambda: probe_block(t_k, h, l_, v, ws))
            out["device_ms"] = dev["ours_ms"]
            out["device_by_kernel_ms"] = dev["by_kernel_ms"]
            n_ins = len(kk)
    n = kmax
    nbytes = n * (4 + 4 + 1 + 1) + count * 32 + n_ins * 8
    ops = n * 12
    out.update(max_abs_err=max(out["main"]["max_abs_err"],
                               out["twice"]["max_abs_err"]),
               bytes=nbytes, ops=ops,
               bound_ms=max(nbytes / HBM_BYTES_S, ops / CORE_OPS_S) * 1e3,
               bound_by=("bytes" if nbytes / HBM_BYTES_S
                         >= ops / CORE_OPS_S else "operations"))
    return out


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
            "kmax", "gather_s", "dmax")
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


def rank_run(rank: int, world: int, init: str, out_dir: str, n: int = 7,
             device_type: str = "cuda") -> None:
    """One rank of ``--ranks``: TwoPhaseSys(n) through the sharded engine
    on this rank's card, with each exchange; writes what its checker
    answers to ``<out_dir>/rank<rank>.json``."""
    import datetime

    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from stateright_tpu_torch import TwoPhaseSys
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
        for exchange in ("bucket", "ring"):
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
            ck = TwoPhaseSys(n).checker().gpu_options(
                mesh=mesh, exchange=exchange).spawn_gpu().join()
            wall = time.perf_counter() - t0
            prof = ck.profile()
            replay = {}
            for prop in ("abort agreement", "commit agreement"):
                path = ck.assert_any_discovery(prop)  # replays or raises
                replay[prop] = bool(ck.model().property(prop).condition(
                    ck.model(), path.last_state()))
            runs.append({
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
        checks = {
            "unique": first["unique"] == UNIQUE_2PC7,
            "generated": first["generated"] == GENERATED_2PC7,
            "digest": first["digest"] == DIGEST_2PC7,
            "replay": all(first["replay"].values()),
            "ranks_agree": all(r[i][k] == first[k] for r in ranks
                               for k in same),
            "exchange": first["exchange"] == ("bucket", "ring")[i],
            "launches": all(r[i]["launches"]["fused_step_noprobe"] > 0
                            and r[i]["launches"]["probe_block"] > 0
                            and r[i]["launches"]["fused_step"] == 0
                            for r in ranks),
        }
        wall = max(r[i]["wall_s"] for r in ranks)
        emit(phase="e2e_ranks", ranks=world, wall_s=wall,
             unique_per_s=first["unique"] / wall,
             per_rank=[{k: r[i][k] for k in (
                 "wall_s", "loop_s", "syncs", "sync_s", "collectives",
                 "peak", "launches", "gather_s")} for r in ranks],
             **{k: first[k] for k in (
                 "exchange", "unique", "generated", "digest", "iterations",
                 "small_iterations", "collectives_per_iteration", "kovfs",
                 "aborts", "kmax", "kb", "rank_rows", "dmax", "bmax")},
             checks=checks)
        if not all(checks.values()):
            raise AssertionError(f"{world}-rank 2pc7, "
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
         kernels=ptxas_usage(info["log"]))

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
    del carry, step

    single = ("fused_step", "table_insert")
    default, card = end_to_end(TwoPhaseSys, single)
    emit(phase="e2e", **default)
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
         "status": "ok"},
        {"name": "table_insert", "route": "cuda", "source": fused_src,
         "replaces": "stateright_tpu/ops/hashtable.py:71",
         "launches": default["launches"]["table_insert"],
         "max_abs_err": ins["max_abs_err"], "ms": ins["ms"],
         "plain_ms": ins["plain_ms"], "bound_ms": ins["bound_ms"],
         "bound_by": ins["bound_by"], "library_ms": None, "status": "ok"},
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
         "status": "ok"},
        {"name": "probe_block", "route": "cuda", "source": sharded_src,
         "replaces": "stateright_tpu/ops/fused.py:526",
         "launches": sh["launches"]["probe_block"],
         "max_abs_err": probe["max_abs_err"], "ms": probe["ms"],
         "plain_ms": probe["plain_ms"], "bound_ms": probe["bound_ms"],
         "bound_by": probe["bound_by"], "library_ms": None,
         "status": "ok"},
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    # the run uses one card, whatever the machine holds
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": 1}}), flush=True)
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--ranks":
        sys.exit(ranks_main(int(sys.argv[2])))
    sys.exit(main())
