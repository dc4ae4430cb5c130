"""The launches of the two kernels the Paxos path redesigned for Hopper,
on the CPU: K1's wide instantiation (``csrc/step_common.cuh``, the
``WideRow`` branch: the lanes below each row's quiet lane are stepped
densely, each child staged in shared memory and copied to ``flat`` with
coalesced stores; the quiet lanes are copies of their rows) and K8,
the history insert (``csrc/history.cu``: a grid of lookups over tiles of
rows, each tile's absent rows compacted in row order into a scratch, and
the last block to arrive inserting them in row order).

The kernels run only on a card. Here the host side that sizes their
launches is held to what the kernels assume: ``ops/_cuda.py``
``wide_geometry`` and ``wide_smem_bytes`` (the launch ``StepArgs.wide``
carries: blocks over every row, the shared memory of a block at every
configuration ``PackedPaxos.cuda_spec`` admits), the staging stride's
banks, the fingerprint's column keys, and ``history_grid``/
``history_scratch`` (every row of the largest append in one tile, every
tile taken by one block). What holds the kernels lane for lane are
``chip_smoke.py`` and ``tests/test_torch_gpu.py``, on the card. No JAX,
no process; well under a second each.
"""
import itertools

import numpy as np
import pytest
import torch

torch.set_num_threads(1)  # leave the other test workers their cores

from stateright_tpu_torch.checker.device_loop import step_sizes  # noqa: E402
from stateright_tpu_torch.examples.paxos_packed import PackedPaxos  # noqa: E402
from stateright_tpu_torch.ops import _cuda  # noqa: E402

#: the SMs of an H100 SXM, and a card of one
SMS = (132, 1)
#: the shared memory a Hopper block may take, and an SM's (with the 1 KB
#: each resident block reserves)
BLOCK_SMEM = 227 * 1024
SM_SMEM = 228 * 1024
#: every (clients, servers, slots) PackedPaxos.cuda_spec admits
CONFIGS = list(itertools.product(range(1, 8), range(1, 5), range(1, 17)))
ROWS = (1, 7, 33, 1000, 1237, 8192, 65536)


def _width(c: int, s: int, e: int) -> int:
    return s * (3 + s) + 4 * c + 4 * e + 2


def test_every_admitted_configuration_has_a_wide_kernel():
    """The widths the launch math below assumes are the models' own, and
    every configuration it covers is one ``cuda_spec`` admits."""
    for c, s, e in CONFIGS:
        m = PackedPaxos(c, server_count=s, net_capacity=e)
        assert m.cuda_spec()[1] == (c, s, e)
        assert m.packed_width == _width(c, s, e) <= _cuda.WIDE_MODELS["paxos"]
        assert m.max_actions == e


def test_column_key_table_is_the_fingerprints():
    """K1-wide folds each word with ``kColumnKey[i]`` from the constant
    table of ``csrc/step_common.cuh``: the table is ``fingerprint.py``'s
    column keys, and covers the widest row K1-wide takes."""
    import re
    from pathlib import Path

    from stateright_tpu_torch.fingerprint import col_keys
    src = (Path(_cuda.__file__).resolve().parent.parent / "csrc"
           / "step_common.cuh").read_text()
    body = re.search(r"kColumnKey\[kColumnKeys\] = \{([^}]*)\}", src).group(1)
    table = [int(v, 16) for v in re.findall(r"0x([0-9A-F]{8})u", body)]
    assert len(table) == int(re.search(
        r"constexpr int kColumnKeys = (\d+);", src).group(1))
    assert len(table) >= _cuda.WIDE_MODELS["paxos"]
    assert table == col_keys(len(table))


@pytest.mark.parametrize("sms", SMS)
def test_wide_launch_fits_shared_memory(sms):
    """At every admitted configuration and frontier size K1-wide's block
    takes at most 227 KB, at least two blocks fit an SM (three at
    PackedPaxos(3)'s 96 words), and it has at most ``WIDE_ROWS`` rows
    and ``WIDE_THREADS`` threads (a multiple of 32) over blocks that
    cover the frontier, no more of them than ``WIDE_BLOCKS_PER_SM`` an
    SM unless the row cap binds."""
    for (c, s, e), f in itertools.product(CONFIGS, ROWS):
        geo = _cuda.tile_geometry(f, e, sms)
        w = _cuda.wide_geometry(geo, f, e, sms)
        smem = _cuda.wide_smem_bytes(w, _width(c, s, e), e)
        assert smem <= BLOCK_SMEM
        assert 2 * (smem + 1024) <= SM_SMEM
        if (c, s, e) == (3, 3, 16):
            assert _cuda.WIDE_BLOCKS_PER_SM * (smem + 1024) <= SM_SMEM
        assert 1 <= w.rows <= min(geo.rows, _cuda.WIDE_ROWS)
        assert w.threads % 32 == 0 and 32 <= w.threads <= _cuda.WIDE_THREADS
        assert w.blocks * w.rows >= f > (w.blocks - 1) * w.rows
        assert (w.blocks <= _cuda.WIDE_BLOCKS_PER_SM * sms
                or w.rows == _cuda.WIDE_ROWS)


def test_wide_launch_at_the_baseline_step():
    """The mid-search 8,192-row PackedPaxos(3) step on an H100 (132 SMs)
    runs 391 blocks of 21 rows: all resident at three an SM."""
    geo = _cuda.tile_geometry(8192, 16, 132)
    w = _cuda.wide_geometry(geo, 8192, 16, 132)
    assert (w.rows, w.threads, w.blocks) == (21, 128, 391)
    assert (geo.rows, geo.blocks) == (32, 256)  # K2 and K3 keep theirs


@pytest.mark.parametrize("cfg", CONFIGS[::7] + [(3, 3, 16), (2, 4, 16)])
def test_wide_stores_are_aligned(cfg):
    """K1-wide writes 16-byte vectors where the width is a multiple of
    four words: then every lane's row of ``flat`` (a 16-byte aligned
    buffer) and every row's span of quiet lanes starts on 16 bytes, and
    a warp's store of 32 vectors covers whole children and parts of the
    next at the same vector offsets the kernel steps through. At other
    widths (every ``server_count=4`` and ``server_count=1``
    configuration) some lane's row does not start on 16 bytes, and the
    kernel writes words."""
    c, s, e = cfg
    width = _width(c, s, e)
    lanes = np.arange(4 * 32 * e)
    starts = lanes * width * 4
    if width % 4 == 0:
        assert (starts % 16 == 0).all()
        q4 = width // 4
        # the kernel's stepping (c, k4) += (32 // q4, 32 % q4) with one
        # carry: the vector j of the warp's run is child j // q4, k4 j % q4
        dc, dk = 32 // q4, 32 % q4
        for wl in range(32):
            ch, k4 = wl // q4, wl % q4
            for j in range(wl, 32 * q4, 32):
                assert (ch, k4) == divmod(j, q4)
                ch, k4 = ch + dc, k4 + dk
                if k4 >= q4:
                    ch, k4 = ch + 1, k4 - q4
    else:
        assert s in (1, 4) and (starts % 16 != 0).any()


@pytest.mark.parametrize("width", sorted(
    {_width(*cfg) for cfg in CONFIGS}
    # the ping-pong fixture's rows on the same K1 (``csrc/ping_pong.cuh``)
    | {3 + 3 * e for e in range(1, 17)}))
def test_staging_rows_keep_the_banks_apart(width):
    """A thread's staging row has an odd stride, so word ``k`` of the 32
    lanes of a warp (``RowOut.put``: every lane at the same word) lands
    in 32 distinct banks; a child's copy to ``flat`` reads 32
    consecutive words of one staging row a store, which are in 32
    distinct banks too."""
    stride = _cuda.wide_stride(width)
    assert stride % 2 == 1 and width <= stride <= width + 1
    lane = np.arange(32)
    for k in range(width):
        assert len(set(((lane * stride + k) % 32).tolist())) == 32
    for child in range(32):
        for k0 in range(0, width, 32):
            words = child * stride + k0 + lane[:min(32, width - k0)]
            assert len(set((words % 32).tolist())) == len(words)


@pytest.mark.parametrize("cfg", [(3, 3, 16), (7, 4, 16), (1, 1, 1),
                                 (2, 3, 7)])
@pytest.mark.parametrize("fmax", [8192, 1024, 16])
def test_history_grid_covers_the_largest_append(cfg, fmax):
    """K8's scratch for a chunk holds the most rows one iteration can
    append (``f_large * A``): every row count up to it fits whole tiles
    in the scratch, and the grid's blocks (the active ones: those with a
    tile, block 0 at least) take every tile exactly once."""
    c, s, e = cfg
    model = PackedPaxos(c, server_count=s, net_capacity=e)
    _f_small, f_large, _margin = step_sizes(model, fmax)
    cap = f_large * model.max_actions
    scratch = _cuda.history_scratch(cap, "cpu")
    tr = _cuda.HIST_TILE_ROWS
    assert not scratch["ctl"].any() and scratch["cap"] == cap
    for sms in SMS:
        grid = _cuda.history_grid(cap, sms)
        assert 1 <= grid <= _cuda.HIST_BLOCKS_PER_SM * sms
        for n in sorted({0, 1, tr - 1, tr, tr + 1, cap // 2, cap}):
            if n > cap:
                continue
            tiles = -(-n // tr)
            assert tiles <= scratch["tile_n"].shape[0]
            assert tiles * tr <= scratch["akey"].shape[0]
            assert tiles * tr <= scratch["arow"].shape[0]
            active = max(1, min(grid, tiles))
            taken = [t for b in range(active)
                     for t in range(b, tiles, grid)]
            assert sorted(taken) == list(range(tiles))


def _split_list(masks, e, a):
    """A numpy transcription of K1's active list for a model with crash
    lanes (``csrc/step_common.cuh``, the prologue's scan and listing):
    per row its delivery and crash counts packed in one word (deliveries
    in the low 16 bits), one inclusive scan of the packed words, the
    deliveries listed in lane order from the front, the crash and restart
    lanes after them from the deliveries' total; returns the list, the
    deliveries' count and the packed words' most in either half."""
    dmask = (1 << e) - 1
    q = np.array([bin(m & dmask).count("1")
                  | (bin(m & ~dmask & 0xFFFFFFFF).count("1") << 16)
                  for m in masks], dtype=np.int64)
    x = np.cumsum(q)
    total = int(x[-1]) if len(x) else 0
    nd = total & 0xFFFF
    nact = nd + (total >> 16)
    act = np.full(len(masks) * a, -1, dtype=np.int64)
    for i, m in enumerate(masks):
        off = int(x[i] - q[i])
        d, c = off & 0xFFFF, nd + (off >> 16)
        for lane in range(32):
            if (m >> lane) & 1:
                if lane < e:
                    act[d] = i * a + lane
                    d += 1
                else:
                    act[c] = i * a + lane
                    c += 1
    return act[:nact], nd, max(total & 0xFFFF, total >> 16)


@pytest.mark.parametrize("e,n", [(16, 3), (16, 1), (1, 8), (4, 2), (16, 8),
                                 (8, 0)])
def test_crash_active_list_puts_the_deliveries_first(e, n):
    """K1's active list with crash lanes: every active lane once, the
    deliveries (lanes below ``E``) first in lane order, then the crash
    and restart lanes in lane order; the two counts scanned in one
    packed word never carry into each other (at most 32 rows of 32
    lanes: 1,024 in either half); the wide K1 stages the list's first
    ``nact[1]`` (the deliveries) and hands the rest to its crash pass.
    Over random masks of up to 32 rows, every lane on and every lane
    off."""
    a = e + 2 * n
    rng = np.random.default_rng([e, n])
    full = (1 << a) - 1
    for rows in (1, 7, 21, 32):
        for case in range(20):
            if case == 0:
                masks = [full] * rows
            elif case == 1:
                masks = [0] * rows
            else:
                masks = [int(rng.integers(0, full + 1)) for _ in range(rows)]
            act, nd, most = _split_list(masks, e, a)
            lanes = [i * a + k for i, m in enumerate(masks)
                     for k in range(a) if (m >> k) & 1]
            want = sorted(t for t in lanes if t % a < e) + \
                sorted(t for t in lanes if t % a >= e)
            assert act.tolist() == want
            assert nd == sum(1 for t in lanes if t % a < e)
            assert most <= 32 * 32 < 1 << 16


def test_crash_wide_launch_at_the_crash_step():
    """PackedPaxos(3).crash_restart(1, actors=[0, 1, 2]) (97 words, 22
    lanes) at the smoke's mid-search 8,192-row step on an H100: 391
    blocks of 21 rows and 128 threads with 62,952 B of shared memory,
    three resident an SM (the parent's launch: the redesign keeps it); a
    thread's staging row holds the crash edit its crash pass leaves there
    (six words)."""
    model = PackedPaxos(3).crash_restart(1, actors=[0, 1, 2])
    name, _params = model.cuda_spec()
    a, w = model.max_actions, model.packed_width
    assert (name, a, w) == ("paxos_crash", 22, 97)
    wide, smem = _cuda.k1_launch(name, _cuda.tile_geometry(8192, a, 132),
                                 8192, w, a, 132)
    assert (wide.rows, wide.threads, wide.blocks) == (21, 128, 391)
    assert smem == 62952
    assert _cuda.WIDE_BLOCKS_PER_SM * (smem + 1024) <= SM_SMEM
    assert _cuda.wide_stride(w) >= 6
