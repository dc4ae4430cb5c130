#!/usr/bin/env python3
"""What holds K1's wide (Paxos) instantiation back, on the card: its
device ms at the mid-search 8,192-row PackedPaxos(3) step (the BASELINE
workload's, ``chip_smoke.py`` ``mid_search_carry``) with one part of the
kernel changed and under other launches, one JSON line each, all on one
carry.

    python tools/torch_k1_wide_sweep.py

Variants: a copy of ``stateright_tpu_torch/csrc`` under
``build/k1_wide/<variant>/csrc`` with one change, built from there, each
in a process of its own in the order of ``ORDER`` (``base`` twice;
``nohash`` last: after it a process's traces have come back empty),
which builds the carry with the sources' kernels and then loads the
variant's in their place (``ops/_cuda.py`` ``_CSRC``):

- ``base``: the sources as they are;
- ``scalar``: each warp's staged children and the quiet lanes' copies
  of their rows written with 4-byte stores of 32 consecutive words,
  not 16-byte ones;
- ``nohash``: ``RowOut.put`` without the fingerprint's folds (every
  child's key alike: timed, not checked);
- ``noquiet``: no quiet lanes (``quiet_from`` gives the row's every
  lane): every lane stepped.

Launches (in the first ``base`` process): ``ops/_cuda.py``
``WIDE_ROWS``, ``WIDE_THREADS`` and ``WIDE_BLOCKS_PER_SM`` set before
each step (the launch is the host's: no rebuild), the first as they
are, the others at fixed rows.

The variants that compute what the sources compute, and every launch,
are held lane for lane to the plain version (``chip_smoke.check_step``).
K1's device ms comes from ``torch.profiler`` (``chip_smoke.device_times``,
one traced launch, ``--reps`` of them). Needs a CUDA device; the first
line is the card's name and power limit from ``nvidia-smi``.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEP_COMMON = "step_common.cuh"
PAXOS = "paxos.cuh"

_VEC16 = """\
    const bool vec16 =
        (width & 3) == 0 && (reinterpret_cast<uintptr_t>(a.flat) & 15) == 0;
"""
_FOLD = """\
    dst[i] = v;
    const uint32_t x = v ^ kColumnKey[i];
    h1 ^= fmix32(x * kC1_1);
    h2 ^= fmix32(x * kC1_2);
"""

#: variant -> [(file in csrc, text, replacement)], each text found once
VARIANTS = {
    "base": [],
    "scalar": [(STEP_COMMON, _VEC16, "    const bool vec16 = false;\n")],
    "nohash": [(STEP_COMMON, _FOLD, "    dst[i] = v;\n")],
    "noquiet": [(PAXOS, "return actor::zero_tail(w + net_off, E);",
                 "return E;")],
}
#: the variants that compute what the sources compute (held lane for lane)
CHECKED = ("base", "scalar", "noquiet")
ORDER = ("base", "scalar", "noquiet", "base", "nohash")
#: the launches swept with the base kernels: (rows, threads) a block;
#: None: the module's own rule
LAUNCHES = [None] + [(r, t) for t in (128, 96) for r in (32, 24, 21, 16)]


def card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()


def make_csrc(variant: str) -> str:
    """The variant's kernel sources under ``build/k1_wide``, its changes
    applied."""
    src = os.path.join(ROOT, "stateright_tpu_torch", "csrc")
    dst = os.path.join(ROOT, "build", "k1_wide", variant, "csrc")
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(src, dst)
    for name, old, new in VARIANTS[variant]:
        path = os.path.join(dst, name)
        with open(path) as fh:
            text = fh.read()
        if text.count(old) != 1:
            raise RuntimeError(f"{variant}: {name} holds the text to change "
                               f"{text.count(old)} times, not once")
        with open(path, "w") as fh:
            fh.write(text.replace(old, new))
    return dst


def use_kernels(cuda, csrc: str) -> dict:
    """Build the kernels of ``csrc`` (unless built) and load them in
    place of the loaded ones; returns the build's info."""
    from pathlib import Path
    cuda._CSRC = Path(csrc)
    cuda._LIB = None
    cuda.BUILD_INFO.clear()
    return cuda.build()


def k1_device_ms(smoke, model, carry, f: int, reps: int) -> list:
    """K1's device ms in ``reps`` traced launches of the step over ``f``
    rows of ``carry`` (its table and ring restored before each)."""
    from stateright_tpu_torch.ops.fused import StepWorkspace, fused_step

    _block, args = smoke.block_args(model, carry, f)
    table0, ring0 = carry.table.clone(), carry.ring.clone()
    t, r = table0.clone(), ring0.clone()
    ws = StepWorkspace(table0.numel(), ring0.shape[0],
                       len(model.properties()), table0.device)

    def restore():
        t.copy_(table0)
        r.copy_(ring0)

    out = []
    for _ in range(reps):
        dev = smoke.device_times(lambda: fused_step(model, *args, t, r, ws),
                                 before=restore)
        out.append((dev["by_kernel_ms"] or {}).get("expand_kernel"))
    return out


def run_variant(variant: str, reps: int, sweep: bool) -> int:
    """Time (and, where it computes what the sources compute, check) the
    variant's K1 on a carry built with the sources' kernels; with
    ``sweep`` also the launches of ``LAUNCHES``."""
    import torch

    sys.path.insert(0, ROOT)
    import chip_smoke as smoke
    from stateright_tpu_torch.examples.paxos_packed import PackedPaxos
    from stateright_tpu_torch.ops import _cuda

    head = {"card": card()}
    dev = torch.device("cuda", 0)
    model, f = PackedPaxos(3), 8192
    base = os.path.join(ROOT, "build", "k1_wide", "base", "csrc")
    use_kernels(_cuda, base)
    carry = smoke.mid_search_carry(model, dev, rows=f)
    info = use_kernels(_cuda, os.path.join(ROOT, "build", "k1_wide",
                                           variant, "csrc"))
    line = {**head, "variant": variant, "usage": smoke.ptxas_usage(
                info["logs"].get("fused_step", "")).get(
                    "expand_kernel[PaxosModel]"),
            "k1_device_ms": k1_device_ms(smoke, model, carry, f, reps)}
    if variant in CHECKED:
        try:
            line["lane_exact"] = all(smoke.check_step(
                model, carry, f, reps=1)["checks"].values())
        except AssertionError:
            line["lane_exact"] = False
    print(json.dumps(line), flush=True)
    if not sweep:
        return 0
    saved = (_cuda.WIDE_ROWS, _cuda.WIDE_THREADS, _cuda.WIDE_BLOCKS_PER_SM)
    sms = _cuda.sm_count(dev)
    for launch in LAUNCHES:
        if launch is not None:
            # fixed rows: one block an SM bounds nothing at this size
            _cuda.WIDE_ROWS, _cuda.WIDE_THREADS = launch
            _cuda.WIDE_BLOCKS_PER_SM = 1
        geo = _cuda.wide_geometry(_cuda.tile_geometry(
            f, model.max_actions, sms), f, model.max_actions, sms)
        try:
            ok = all(smoke.check_step(model, carry, f, reps=1)[
                "checks"].values())
        except AssertionError:
            ok = False
        print(json.dumps({**head, "variant": variant,
                          "rule": launch is None, "launch": geo._asdict(),
                          "smem_bytes": _cuda.wide_smem_bytes(
                              geo, model.packed_width, model.max_actions),
                          "k1_device_ms": k1_device_ms(smoke, model, carry,
                                                       f, reps),
                          "lane_exact": ok}), flush=True)
        _cuda.WIDE_ROWS, _cuda.WIDE_THREADS, _cuda.WIDE_BLOCKS_PER_SM = saved
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--variant", help=argparse.SUPPRESS)
    ap.add_argument("--sweep", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("torch_k1_wide_sweep: no CUDA device", file=sys.stderr)
        return 2
    if args.variant:
        return run_variant(args.variant, args.reps, args.sweep)
    print(card(), flush=True)
    for variant in VARIANTS:
        make_csrc(variant)
    for i, variant in enumerate(ORDER):
        cmd = [sys.executable, os.path.abspath(__file__), "--variant",
               variant, "--reps", str(args.reps)] + (
                   ["--sweep"] if i == 0 else [])
        rc = subprocess.run(cmd, cwd=ROOT).returncode
        if rc:
            return rc
    return 0


if __name__ == "__main__":
    sys.exit(main())
