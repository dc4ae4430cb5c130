"""The port's CUDA kernels against their plain torch versions, and the
engine on the card against its CPU path. Marked ``gpu``: they need a CUDA
device (the kernels have no CPU mode) and skip without one. The file
imports no JAX, so it runs where only the port is installed:

    python -m pytest --noconftest tests/test_torch_gpu.py -m gpu

(``--noconftest``: the suite's conftest configures JAX.)"""

import pathlib
import sys

import numpy as np
import pytest
import torch

from stateright_tpu_torch import TwoPhaseSys
from stateright_tpu_torch.core import Property


def _cpu(model, **opts):
    return model.checker().gpu_options(device="cpu", race=False, **opts) \
        .spawn_gpu().join()


def _reachable(model):
    seen, order, queue = set(), [], list(model.init_states())
    while queue:
        state = queue.pop()
        fp = model.fingerprint(state)
        if fp not in seen:
            seen.add(fp)
            order.append(state)
            queue.extend(model.next_states(state))
    return order


def _chip_smoke():
    """``chip_smoke.py``, whose pins the end-to-end runs are held to."""
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
    import chip_smoke
    return chip_smoke


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")


def _ring_held_tile_keys(out, ring, f, a):
    """The (tile, key) pairs, at the card's tile geometry, of the valid
    lanes whose key ``ring`` holds: the tile winners the probe-free
    step's ring probe drops, which its ``S_CCH`` counts."""
    from stateright_tpu_torch.ops import _cuda
    from stateright_tpu_torch.ops.hashtable import start_bucket
    from stateright_tpu_torch.ops.words import pack64
    keys = pack64(out.chi, out.clo)
    held = out.cvalid & (ring[start_bucket(out.chi, out.clo,
                                           ring.shape[0])] == keys)
    geo = _cuda.tile_geometry(f, a, _cuda.sm_count(keys.device))
    tile = torch.arange(keys.shape[0], device=keys.device) // (geo.rows * a)
    return torch.unique(torch.stack([tile, keys], 1)[held], dim=0).shape[0]


@pytest.mark.gpu
@pytest.mark.parametrize("n,fmax", [(4, 16), (5, 512)])
def test_kernels_match_plain_versions_on_card(n, fmax):
    _need_card()
    from stateright_tpu_torch.ops.fused import (S_DISC, fused_step,
                                                fused_step_reference)
    from stateright_tpu_torch.ops.hashtable import (make_table,
                                                    table_insert,
                                                    table_insert_reference)
    from stateright_tpu_torch.ops.words import from_numpy_u32, pack64
    from stateright_tpu_torch.ops.hash_kernel import fp64_device
    model = TwoPhaseSys(n)
    dev = torch.device("cuda")
    rng = np.random.default_rng(n)
    states = _reachable(model)
    rows = np.stack([model.encode(states[i])
                     for i in rng.integers(0, len(states), fmax)])
    block = from_numpy_u32(rows, dev)
    phi, plo = (x.to(torch.int32) for x in fp64_device(block))
    ebits = torch.zeros((fmax,), dtype=torch.int32, device=dev)
    fvalid = torch.from_numpy(rng.random(fmax) < 0.9).to(dev)
    out = {}
    for name, fn in (("kernel", fused_step), ("plain", fused_step_reference)):
        table = make_table(1 << 14, dev)
        ring = torch.zeros((1 << 10,), dtype=torch.int64, device=dev)
        res = fn(model, block, ebits, fvalid, phi, plo, table, ring)
        keys = pack64(res.chi, res.clo)
        out[name] = (res, keys[res.inserted].tolist(),
                     sorted(table[table != 0].tolist()))
    (k, kk, kt), (p, pk, pt) = out["kernel"], out["plain"]
    # the winner rule: an inserted lane is the lowest lane with its key
    keys = pack64(k.chi, k.clo)
    for lane in torch.nonzero(k.inserted).flatten().tolist():
        same = torch.nonzero(k.cvalid & (keys == keys[lane])).flatten()
        assert lane == int(same.min())
    for name in ("flat", "chi", "clo", "cvalid", "pbits", "ebits",
                 "terminal"):
        assert torch.equal(getattr(k, name), getattr(p, name)), name
    assert set(kk) == set(pk) and len(kk) == len(set(kk))
    assert kt == pt
    assert torch.equal(k.stats[S_DISC:], p.stats[S_DISC:])
    hi = torch.cat([k.chi, k.chi])
    lo = torch.cat([k.clo, k.clo])
    valid = torch.cat([k.cvalid, k.cvalid])
    tk, tp = make_table(1 << 16, dev), make_table(1 << 16, dev)
    ik, ok = table_insert(tk, hi, lo, valid)
    ip, op = table_insert_reference(tp, hi, lo, valid)
    assert ok == op and int(ik.sum()) == int(ip.sum())
    assert sorted(tk[tk != 0].tolist()) == sorted(tp[tp != 0].tolist())


@pytest.mark.gpu
def test_engine_on_card_matches_plain_path():
    _need_card()
    from stateright_tpu_torch.ops import _cuda
    launches = dict(_cuda.LAUNCHES)
    ck = TwoPhaseSys(5).checker().gpu_options(race=False).spawn_gpu().join()
    plain = _cpu(TwoPhaseSys(5))
    assert ck.unique_state_count() == 8832
    assert ck.state_count() == plain.state_count()
    assert ck.generated_fingerprints() == plain.generated_fingerprints()
    ck.assert_properties()
    # the single-chip path's kernels (the sharded engine's are below)
    assert all(_cuda.LAUNCHES[k] > launches[k]
               for k in ("fused_step", "table_insert"))


@pytest.mark.gpu
@pytest.mark.parametrize("n,fmax", [(4, 16), (5, 512)])
def test_sharded_kernels_match_plain_versions_on_card(n, fmax):
    """K5 (the probe-free step) and K6 (the owner-side probe) against
    their plain versions: lane-exact outputs and scalars, the key-set
    gate on ``dvalid``, and the lowest-lane rule of the probe."""
    _need_card()
    from stateright_tpu_torch.ops.fused import (S_CCH, S_DISC, S_VALID,
                                                S_XOVF, fused_step,
                                                fused_step_reference,
                                                probe_block,
                                                probe_block_reference)
    from stateright_tpu_torch.ops.hash_kernel import fp64_device
    from stateright_tpu_torch.ops.hashtable import (make_table,
                                                    start_bucket)
    from stateright_tpu_torch.ops.words import from_numpy_u32, pack64
    model = TwoPhaseSys(n)
    dev = torch.device("cuda")
    rng = np.random.default_rng(n)
    states = _reachable(model)
    rows = np.stack([model.encode(states[i])
                     for i in rng.integers(0, len(states), fmax)])
    block = from_numpy_u32(rows, dev)
    phi, plo = (x.to(torch.int32) for x in fp64_device(block))
    ebits = torch.zeros((fmax,), dtype=torch.int32, device=dev)
    fvalid = torch.from_numpy(rng.random(fmax) < 0.9).to(dev)
    # a ring holding some of the reachable states
    known = np.array([model.fingerprint(states[i]) for i in
                      rng.integers(0, len(states), len(states) // 2)],
                     np.uint64)
    ring = torch.zeros((1 << 10,), dtype=torch.int64, device=dev)
    khi = from_numpy_u32((known >> np.uint64(32)).astype(np.uint32), dev)
    klo = from_numpy_u32(known.astype(np.uint32), dev)
    ring[start_bucket(khi, klo, 1 << 10)] = pack64(khi, klo)
    args = (model, block, ebits, fvalid, phi, plo, None, ring)
    k = fused_step(*args, probe=False)
    p = fused_step_reference(*args, probe=False)
    for name in ("flat", "chi", "clo", "cvalid", "pbits", "ebits",
                 "terminal"):
        assert torch.equal(getattr(k, name), getattr(p, name)), name
    for i in (S_XOVF, S_VALID):
        assert int(k.stats[i]) == int(p.stats[i])
    # S_CCH counts the tile winners the ring holds (the plain version:
    # the lanes that survive its per-block pre-dedup)
    assert int(k.stats[S_CCH]) == _ring_held_tile_keys(k, ring, fmax,
                                                       model.max_actions)
    assert torch.equal(k.stats[S_DISC:], p.stats[S_DISC:])
    keys = pack64(k.chi, k.clo)
    live = k.cvalid & ~(ring[start_bucket(k.chi, k.clo, 1 << 10)] == keys)
    kd = keys[k.dvalid].tolist()
    assert bool((k.dvalid <= live).all())
    assert set(kd) == set(keys[live].tolist()) \
        == set(keys[p.dvalid].tolist())
    assert len(kd) == len(set(kd))
    for lane in torch.nonzero(k.dvalid).flatten().tolist():
        assert lane == int(torch.nonzero(live & (keys == keys[lane]))
                           .flatten().min())
    # the owner-side probe: the kept lanes twice over, into a table that
    # already holds half the reachable states
    hi, lo = torch.cat([k.chi, k.chi]), torch.cat([k.clo, k.clo])
    valid = torch.cat([k.dvalid, k.dvalid])
    out = {}
    for name, fn in (("kernel", probe_block),
                     ("plain", probe_block_reference)):
        table = make_table(1 << 14, dev)
        probe_block_reference(table, khi, klo,
                              torch.ones_like(khi, dtype=torch.bool))
        ins, ovf, _rounds = fn(table, hi, lo, valid)
        out[name] = (ins, bool(ovf), sorted(table[table != 0].tolist()))
    (ik, ok, tk), (ip, op, tp) = out["kernel"], out["plain"]
    both = pack64(hi, lo)
    assert ok == op is False and tk == tp
    assert set(both[ik].tolist()) == set(both[ip].tolist())
    assert int(ik.sum()) == len(set(both[ik].tolist()))
    for lane in torch.nonzero(ik).flatten().tolist():
        assert lane == int(torch.nonzero(valid & (both == both[lane]))
                           .flatten().min())


@pytest.mark.gpu
def test_sharded_engine_on_card_matches_plain_path():
    """The sharded engine at D = 1 on a one-rank NCCL group against the
    single-chip plain path: the same set, counts and verdicts, through
    the sharded kernels only."""
    _need_card()
    import socket

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from stateright_tpu_torch.ops import _cuda
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            rank=0, world_size=1)
    try:
        mesh = init_device_mesh("cuda", (1,), mesh_dim_names=("shards",))
        launches = dict(_cuda.LAUNCHES)
        ck = TwoPhaseSys(5).checker().gpu_options(mesh=mesh).spawn_gpu() \
            .join()
        after = dict(_cuda.LAUNCHES)
    finally:
        dist.destroy_process_group()
    plain = _cpu(TwoPhaseSys(5))
    assert ck.unique_state_count() == 8832
    assert ck.state_count() == plain.state_count()
    assert ck.generated_fingerprints() == plain.generated_fingerprints()
    ck.assert_properties()
    assert after["fused_step"] == launches["fused_step"]
    assert all(after[k] > launches[k]
               for k in ("fused_step_noprobe", "probe_block"))


SYM_CASES = [(complete, probe) for complete in (False, True)
             for probe in (True, False)]


@pytest.mark.gpu
@pytest.mark.parametrize(
    "complete,probe", SYM_CASES,
    ids=[f"{'complete' if c else 'reference'}-{'probe' if p else 'noprobe'}"
         for c, p in SYM_CASES])
def test_symmetric_steps_match_plain_versions_on_card(complete, probe):
    """The symmetric step entry points (K1's symmetric instantiation with
    K2/K3, or with K5) against their plain versions at 2pc n=5, 512
    rows: lane-exact successors, canonical and original fingerprints,
    validity and property bits; the same inserted (or kept) key set,
    one lane per key, the lowest; the same table and discoveries."""
    _need_card()
    from stateright_tpu_torch.ops import _cuda
    from stateright_tpu_torch.ops.fused import (S_CCH, S_DISC, S_VALID,
                                                S_XOVF, fused_step,
                                                fused_step_reference)
    from stateright_tpu_torch.ops.hash_kernel import fp64_device
    from stateright_tpu_torch.ops.hashtable import make_table
    from stateright_tpu_torch.ops.words import from_numpy_u32, pack64
    model = TwoPhaseSys(5, complete_symmetry=complete)
    dev = torch.device("cuda")
    rng = np.random.default_rng(7 + complete)
    states = _reachable(model)
    rows = np.stack([model.encode(states[i])
                     for i in rng.integers(0, len(states), 512)])
    block = from_numpy_u32(rows, dev)
    phi, plo = (x.to(torch.int32) for x in
                fp64_device(model.packed_representative(block)))
    ebits = torch.zeros((512,), dtype=torch.int32, device=dev)
    fvalid = torch.from_numpy(rng.random(512) < 0.9).to(dev)
    out = {}
    launches = dict(_cuda.LAUNCHES)
    for name, fn in (("kernel", fused_step), ("plain", fused_step_reference)):
        table = make_table(1 << 14, dev)
        ring = torch.zeros((1 << 10,), dtype=torch.int64, device=dev)
        res = fn(model, block, ebits, fvalid, phi, plo, table, ring,
                 probe=probe, symmetry=True)
        out[name] = (res, sorted(table[table != 0].tolist()))
    key = "fused_step_sym" if probe else "fused_step_noprobe_sym"
    assert _cuda.LAUNCHES[key] == launches[key] + 1
    (k, kt), (p, pt) = out["kernel"], out["plain"]
    for name in ("flat", "chi", "clo", "ohi", "olo", "cvalid", "pbits",
                 "ebits", "terminal"):
        assert torch.equal(getattr(k, name), getattr(p, name)), name
    assert not torch.equal(k.chi, k.ohi)  # keys are canonical
    for i in (S_XOVF, S_VALID):
        assert int(k.stats[i]) == int(p.stats[i])
    if not probe:
        ring = torch.zeros((1 << 10,), dtype=torch.int64, device=dev)
        assert int(k.stats[S_CCH]) == _ring_held_tile_keys(
            k, ring, 512, model.max_actions)
    assert torch.equal(k.stats[S_DISC:], p.stats[S_DISC:])
    keys = pack64(k.chi, k.clo)
    kk = keys[k.inserted].tolist()
    assert set(kk) == set(keys[p.inserted].tolist())
    assert len(kk) == len(set(kk))
    assert kt == pt
    live = k.dvalid if probe else k.cvalid
    for lane in torch.nonzero(k.inserted).flatten().tolist():
        assert lane == int(torch.nonzero(live & (keys == keys[lane]))
                           .flatten().min())


@pytest.mark.gpu
@pytest.mark.parametrize("complete", [False, True],
                         ids=["reference", "complete"])
def test_symmetric_engine_on_card(complete):
    """2pc n=5 under symmetry on the card: the complete representative
    gives the 314 orbits and the plain path's canonical keys; the
    reference one a count in its sound range [314, 1092] whose keys
    cover every orbit. Witnesses replay."""
    _need_card()
    from stateright_tpu_torch.ops import _cuda
    model = TwoPhaseSys(5, complete_symmetry=complete)
    launches = dict(_cuda.LAUNCHES)
    ck = model.checker().symmetry_fn(model.representative).spawn_gpu() \
        .join()
    assert _cuda.LAUNCHES["fused_step_sym"] > launches["fused_step_sym"]
    assert _cuda.LAUNCHES["fused_step"] == launches["fused_step"]
    n = ck.unique_state_count()
    full = TwoPhaseSys(5, complete_symmetry=True)
    orbit_of_key = {model.fingerprint(model.representative(s)):
                    full.fingerprint(full.representative(s))
                    for s in _reachable(model)}
    assert {orbit_of_key[k] for k in ck.generated_fingerprints()} \
        == set(orbit_of_key.values())
    if complete:
        plain = model.checker().symmetry_fn(model.representative) \
            .gpu_options(device="cpu").spawn_gpu().join()
        assert n == plain.unique_state_count() == 314
        assert ck.state_count() == plain.state_count() == 2048
        assert ck.generated_fingerprints() \
            == plain.generated_fingerprints()
    else:
        assert 314 <= n <= 1092
    ck.assert_properties()
    for name in ("abort agreement", "commit agreement"):
        path = ck.discovery(name)
        assert model.property(name).condition(model, path.last_state())


class _Strict(TwoPhaseSys):
    """TwoPhaseSys with a fourth property the kernel does not evaluate."""

    def properties(self):
        return super().properties() + [Property.always(
            "no commit", lambda _, s: 2 not in s[0])]

    def packed_properties(self, words):
        pb = super().packed_properties(words)
        rmw = words[:, 0].to(torch.int64) & 0xFFFFFFFF
        fields = (rmw[:, None] >> (2 * torch.arange(self.n))) & 3
        return torch.cat([pb, ~(fields == 2).any(1, keepdim=True)], 1)


@pytest.mark.gpu
def test_card_refuses_a_model_its_kernel_does_not_implement():
    _need_card()
    from stateright_tpu_torch.ops import _cuda
    from stateright_tpu_torch.ops.fused import fused_step
    from stateright_tpu_torch.ops.hashtable import make_table
    model = _Strict(3)
    with pytest.raises(NotImplementedError, match="CUDA step kernel"):
        model.checker().spawn_gpu()
    dev = torch.device("cuda")
    rows = torch.zeros((4, 4), dtype=torch.int32, device=dev)
    launches = _cuda.LAUNCHES["fused_step"]
    with pytest.raises(NotImplementedError, match="CUDA step kernel"):
        fused_step(model, rows, rows[:, 0], torch.ones(4, dtype=torch.bool,
                                                       device=dev),
                   rows[:, 1], rows[:, 2], make_table(64, dev))
    assert _cuda.LAUNCHES["fused_step"] == launches
    # its plain path still gives its own verdict
    ck = _cpu(model)
    assert ck.discovery_classification("no commit") == "counterexample"


def _frontier(model, f, rng, symmetry, dev):
    """``f`` reachable states of ``model`` drawn with replacement (so
    lanes share keys), with their (canonical under ``symmetry``)
    fingerprints, random eventually-bits and ~10 % invalid rows."""
    from stateright_tpu_torch.ops.hash_kernel import fp64_device
    from stateright_tpu_torch.ops.words import from_numpy_u32
    states = _reachable(model)
    rows = np.stack([model.encode(states[i])
                     for i in rng.integers(0, len(states), f)])
    block = from_numpy_u32(rows, dev)
    phi, plo = (x.to(torch.int32) for x in fp64_device(
        model.packed_representative(block) if symmetry else block))
    ebits = torch.from_numpy(rng.integers(0, 8, f).astype(np.int32)).to(dev)
    fvalid = torch.from_numpy(rng.random(f) < 0.9).to(dev)
    return block, ebits, fvalid, phi, plo


EXPAND_CASES = [(complete, probe) for complete in (None, False, True)
                for probe in (True, False)]


@pytest.mark.gpu
@pytest.mark.parametrize(
    "complete,probe", EXPAND_CASES,
    ids=[f"{'plain' if c is None else ('complete' if c else 'reference')}"
         f"-{'probe' if p else 'noprobe'}" for c, p in EXPAND_CASES])
def test_expand_lane_exact_at_ragged_frontiers(complete, probe,
                                               monkeypatch):
    """K1 over row tiles at ragged F (one row, one tile minus a row, one
    and a half tiles, 255, 257) in both instantiations, through both step
    entry points: lane for lane the plain version's successors,
    fingerprints, validity, property bits, eventually-bits and terminal
    rows, with the card's tiles and with full-size ones (as on a card of
    one SM: no shrinking), where F = 55, 255 and 257 end in a ragged tile
    of several rows."""
    _need_card()
    from stateright_tpu_torch.ops import _cuda
    from stateright_tpu_torch.ops.fused import (S_DISC, S_VALID, S_XOVF,
                                                fused_step,
                                                fused_step_reference)
    from stateright_tpu_torch.ops.hashtable import make_table
    symmetry = complete is not None
    model = TwoPhaseSys(5, complete_symmetry=bool(complete))
    dev = torch.device("cuda")
    rng = np.random.default_rng(11)
    rows = _cuda.TILE_LANES // model.max_actions
    names = ("flat", "chi", "clo", "cvalid", "pbits", "ebits",
             "terminal") + (("ohi", "olo") if symmetry else ())
    ragged = 0
    for full in (False, True):
        if full:
            monkeypatch.setattr(_cuda, "sm_count", lambda device: 1)
            monkeypatch.setattr(_cuda, "TILES_PER_SM", 1)
        for f in (1, rows - 1, rows + rows // 2, 255, 257):
            geo = _cuda.tile_geometry(f, model.max_actions,
                                      _cuda.sm_count(dev))
            ragged += geo.rows > 1 and f % geo.rows != 0
            args = _frontier(model, f, rng, symmetry, dev)
            out = []
            for fn in (fused_step, fused_step_reference):
                table = None if not probe else make_table(1 << 14, dev)
                ring = torch.zeros((1 << 10,), dtype=torch.int64,
                                   device=dev)
                out.append(fn(model, *args, table, ring, probe=probe,
                              symmetry=symmetry))
            k, p = out
            for name in names:
                assert torch.equal(getattr(k, name), getattr(p, name)), \
                    (f, geo, name)
            for i in (S_XOVF, S_VALID):
                assert int(k.stats[i]) == int(p.stats[i]), (f, geo, i)
            assert torch.equal(k.stats[S_DISC:], p.stats[S_DISC:])
    assert ragged >= 3


@pytest.mark.gpu
@pytest.mark.parametrize("complete", [None, False, True],
                         ids=["plain", "reference", "complete"])
@pytest.mark.parametrize("f", [256, 12288])
def test_claim_inserts_the_lowest_valid_lane_of_each_fresh_key(f, complete):
    """K2's tile pre-dedup and claim, and K3 over K2's claims, on a step
    where many lanes share a key (2pc5 rows drawn with replacement, half
    the keys already in the table, some in the ring), without symmetry
    and under both representatives: the inserted lanes are the lowest
    valid lane of each fresh key, one per claimed slot, with the plain
    version's key set and table; each lane that reached the table is the
    lowest valid lane of its key in its tile."""
    _need_card()
    from stateright_tpu_torch.ops import _cuda
    from stateright_tpu_torch.ops.fused import (S_FAULT, S_INSERTED,
                                                StepWorkspace, fused_step,
                                                fused_step_reference)
    from stateright_tpu_torch.ops.hashtable import (make_table,
                                                    start_bucket,
                                                    table_insert_reference)
    from stateright_tpu_torch.ops.words import from_numpy_u32, pack64
    symmetry = complete is not None
    model = TwoPhaseSys(5, complete_symmetry=bool(complete))
    dev = torch.device("cuda")
    rng = np.random.default_rng(f)
    args = _frontier(model, f, rng, symmetry, dev)
    canon = sorted({model.fingerprint(model.representative(s) if symmetry
                                      else s)
                    for s in _reachable(model)})
    known = np.array([canon[i] for i in
                      rng.choice(len(canon), len(canon) // 2,
                                 replace=False)], np.uint64)
    khi = from_numpy_u32((known >> np.uint64(32)).astype(np.uint32), dev)
    klo = from_numpy_u32(known.astype(np.uint32), dev)
    out = {}
    for name in ("kernel", "plain"):
        table = make_table(1 << 14, dev)
        table_insert_reference(table, khi, klo,
                               torch.ones_like(khi, dtype=torch.bool))
        ring = torch.zeros((1 << 10,), dtype=torch.int64, device=dev)
        half = slice(0, known.shape[0] // 2)
        ring[start_bucket(khi[half], klo[half], 1 << 10)] = \
            pack64(khi[half], klo[half])
        if name == "kernel":
            ws = StepWorkspace(table.numel(), ring.shape[0],
                               len(model.properties()), dev)
            res = fused_step(model, *args, table, ring, ws,
                             symmetry=symmetry)
        else:
            res = fused_step_reference(model, *args, table, ring,
                                       symmetry=symmetry)
        out[name] = (res, sorted(table[table != 0].tolist()))
    (k, kt), (p, pt) = out["kernel"], out["plain"]
    keys = pack64(k.chi, k.clo)
    kk = keys[k.inserted]
    assert set(kk.tolist()) == set(keys[p.inserted].tolist())
    assert kk.shape[0] == len(set(kk.tolist())) and kt == pt
    # K3 walks K2's claims: one claimed slot per inserted lane
    assert int(ws.n_claims.sum()) == int(k.stats[S_INSERTED]) \
        == kk.shape[0] and int(k.stats[S_FAULT]) == 0
    lanes = torch.arange(keys.shape[0], device=dev)
    uniq, inv = torch.unique(keys[k.cvalid], return_inverse=True)
    first = torch.full((uniq.shape[0],), keys.shape[0], dtype=torch.int64,
                       device=dev)
    first.scatter_reduce_(0, inv, lanes[k.cvalid], reduce="amin")
    won = first[torch.searchsorted(uniq, kk)]
    assert torch.equal(won, lanes[k.inserted])
    # the tile stage: one lane per key and tile, the tile's lowest
    assert bool((k.dvalid <= k.cvalid).all())
    geo = _cuda.tile_geometry(f, model.max_actions, _cuda.sm_count(dev))
    tile = lanes // (geo.rows * model.max_actions)
    tkey = tile * (1 << 20) + torch.unique(keys, return_inverse=True)[1]
    tu, tinv = torch.unique(tkey[k.cvalid], return_inverse=True)
    tfirst = torch.full((tu.shape[0],), keys.shape[0], dtype=torch.int64,
                        device=dev)
    tfirst.scatter_reduce_(0, tinv, lanes[k.cvalid], reduce="amin")
    reached = tfirst[torch.searchsorted(tu, tkey[k.dvalid])]
    assert torch.equal(reached, lanes[k.dvalid])
    assert int(k.dvalid.sum()) < int(k.cvalid.sum())


def _mid_search(model, rows, symmetry, dev):
    """A real mid-search state of ``model`` on the card: the port's own
    loop run until at least ``rows`` rows are pending."""
    from stateright_tpu_torch.checker.device_loop import (E_ITERS,
                                                          run_chunk,
                                                          seed_carry)
    from stateright_tpu_torch.ops.hashtable import table_insert
    from stateright_tpu_torch.ops.words import from_numpy_u32
    init = model.init_states()[0]
    fp = model.fingerprint(model.representative(init) if symmetry
                           else init)
    carry = seed_carry(model, 1 << 21, 1 << 20, [model.encode(init)], 0,
                       [fp], 1 << 15, dev, symmetry=symmetry)
    table_insert(carry.table,
                 from_numpy_u32(np.array([fp >> 32], np.uint32), dev),
                 from_numpy_u32(np.array([fp & 0xFFFFFFFF], np.uint32),
                                dev),
                 torch.ones((1,), dtype=torch.bool, device=dev))
    # one iteration per chunk: the small step while at most FMAX_SMALL
    # rows are pending, else one of ``rows`` rows
    while carry.q_tail - carry.q_head < rows:
        c = run_chunk(model, carry, fmax=rows, steps=1)
        assert c[carry.layout.ext + E_ITERS], \
            f"the search ended before a {rows}-row frontier"
    return carry


@pytest.mark.gpu
@pytest.mark.parametrize("n,symmetry", [(7, False), (16, True)],
                         ids=["2pc7", "2pc16-reference"])
def test_dedup_workspace_serves_steps_of_every_width(n, symmetry):
    """One ``DedupWorkspace`` for probe-free steps of 12,288, 256 and
    12,288 rows of a real mid-search frontier (2pc7; 2pc16 under the
    reference representative, 82 actions): each step's ``dvalid`` and
    counts are a fresh workspace's, and the key arena reads all zero
    after each step, so its commits cleared every cell their claims
    took and no memset is needed."""
    _need_card()
    from stateright_tpu_torch.ops.fused import (S_DEDUP, S_FAULT,
                                                DedupWorkspace, fused_step)
    model = TwoPhaseSys(n)
    dev = torch.device("cuda")
    carry = _mid_search(model, 12288, symmetry, dev)
    a, w = model.max_actions, model.packed_width
    n_props = len(model.properties())
    cc = carry.ring.shape[0]
    ws = DedupWorkspace(12288 * a, cc, n_props, dev)
    assert not bool(ws.arena.any())
    kept = 0
    for start, f in ((0, 12288), (1000, 256), (37, 12288)):
        block = carry.q[carry.q_head + start:carry.q_head + start + f]
        fvalid = (carry.q_head + start + torch.arange(f, device=dev)
                  < carry.q_tail)
        args = (model, block[:, :w], block[:, w], fvalid, block[:, w + 1],
                block[:, w + 2], None, carry.ring)
        k = fused_step(*args, ws, probe=False, symmetry=symmetry)
        fresh = fused_step(*args, DedupWorkspace(f * a, cc, n_props, dev),
                           probe=False, symmetry=symmetry)
        assert torch.equal(k.dvalid, fresh.dvalid), f
        assert torch.equal(k.stats, fresh.stats), f
        assert int(k.stats[S_FAULT]) == 0
        assert int(ws.n_claims.sum()) == int(k.stats[S_DEDUP]) \
            == int(k.dvalid.sum())
        assert not bool(ws.arena.any()), f
        kept += int(k.dvalid.sum())
    assert kept > 0


def _insert_batch(rng, n, dev):
    """``n`` fingerprints of reachable 2pc5 states drawn with replacement
    (so lanes share keys), ~20 % invalid, and a quarter of the keys
    already in a 2**16-slot table."""
    from stateright_tpu_torch.ops.hashtable import (make_table,
                                                    table_insert_reference)
    from stateright_tpu_torch.ops.words import from_numpy_u32
    model = TwoPhaseSys(5)
    fps = np.array([model.fingerprint(s) for s in _reachable(model)],
                   np.uint64)
    keys = fps[rng.integers(0, fps.shape[0], n)]
    hi = from_numpy_u32((keys >> np.uint64(32)).astype(np.uint32), dev)
    lo = from_numpy_u32(keys.astype(np.uint32), dev)
    valid = torch.from_numpy(rng.random(n) < 0.8).to(dev)
    table = make_table(1 << 16, dev)
    known = fps[::4]
    table_insert_reference(
        table,
        from_numpy_u32((known >> np.uint64(32)).astype(np.uint32), dev),
        from_numpy_u32(known.astype(np.uint32), dev),
        torch.ones((known.shape[0],), dtype=torch.bool, device=dev))
    return hi, lo, valid, table


@pytest.mark.gpu
@pytest.mark.parametrize("n", [1, 300, 20000])
def test_insert_inserts_the_lowest_valid_lane_of_each_fresh_key(n):
    """K4, the flat insert, on a batch where many lanes share a key and a
    quarter of the keys are in the table: the inserted lanes are the
    lowest valid lane of each fresh key, with the plain insert's key set
    and table."""
    _need_card()
    from stateright_tpu_torch.ops.fused import StepWorkspace
    from stateright_tpu_torch.ops.hashtable import (table_insert,
                                                    table_insert_reference)
    from stateright_tpu_torch.ops.words import pack64
    dev = torch.device("cuda")
    hi, lo, valid, table = _insert_batch(np.random.default_rng(n), n, dev)
    tk, tp = table.clone(), table.clone()
    before = set(table[table != 0].tolist())
    ik, ok = table_insert(tk, hi, lo, valid,
                          ws=StepWorkspace(tk.numel(), 0, 0, dev))
    ip, op = table_insert_reference(tp, hi, lo, valid)
    keys = pack64(hi, lo)
    assert ok == op is False
    assert set(keys[ik].tolist()) == set(keys[ip].tolist())
    assert sorted(tk[tk != 0].tolist()) == sorted(tp[tp != 0].tolist())
    want = set()
    for lane in torch.nonzero(valid).flatten().tolist():
        key = int(keys[lane])
        if key not in before:
            before.add(key)
            want.add(lane)
    assert set(torch.nonzero(ik).flatten().tolist()) == want


@pytest.mark.gpu
def test_insert_mask_repeats():
    """Two K4 calls on equal inputs (equal tables; one workspace, and a
    fresh one) give equal masks: the owner-word rule, not the race,
    picks the inserted lane."""
    _need_card()
    from stateright_tpu_torch.ops.fused import StepWorkspace
    from stateright_tpu_torch.ops.hashtable import table_insert
    dev = torch.device("cuda")
    hi, lo, valid, table = _insert_batch(np.random.default_rng(7), 50000,
                                         dev)
    ws = StepWorkspace(table.numel(), 0, 0, dev)
    masks = []
    for w in (ws, ws, StepWorkspace(table.numel(), 0, 0, dev)):
        t = table.clone()
        masks.append(table_insert(t, hi, lo, valid, ws=w)[0])
    assert int(masks[0].sum()) > 0
    assert torch.equal(masks[0], masks[1])
    assert torch.equal(masks[0], masks[2])


@pytest.mark.gpu
def test_one_workspace_serves_a_step_an_insert_and_a_step():
    """A step (K1-K3), an insert (K4) and a step again on one table and
    one ``StepWorkspace``, whose counter tags all three: no tag fault,
    each step's inserted lanes the lowest valid lane of each fresh key,
    and the table's key set the plain path's after all three."""
    _need_card()
    from stateright_tpu_torch.ops.fused import (S_FAULT, S_INSERTED,
                                                StepWorkspace, fused_step,
                                                fused_step_reference)
    from stateright_tpu_torch.ops.hashtable import (make_table,
                                                    table_insert,
                                                    table_insert_reference)
    from stateright_tpu_torch.ops.words import pack64
    model = TwoPhaseSys(5)
    dev = torch.device("cuda")
    rng = np.random.default_rng(5)
    first = _frontier(model, 512, rng, False, dev)
    second = _frontier(model, 512, rng, False, dev)
    hi, lo, valid, _t = _insert_batch(rng, 4000, dev)
    tk, tp = make_table(1 << 16, dev), make_table(1 << 16, dev)
    rk = torch.zeros((1 << 10,), dtype=torch.int64, device=dev)
    rp = rk.clone()
    ws = StepWorkspace(tk.numel(), rk.shape[0], len(model.properties()),
                       dev)
    for stage in ("step", "insert", "step"):
        if stage == "insert":
            ik, _ok = table_insert(tk, hi, lo, valid, ws=ws)
            ip, _op = table_insert_reference(tp, hi, lo, valid)
            keys = pack64(hi, lo)
            assert set(keys[ik].tolist()) == set(keys[ip].tolist())
            continue
        args = first if ws.step == 0 else second
        before = set(tk[tk != 0].tolist())
        k = fused_step(model, *args, tk, rk, ws)
        fused_step_reference(model, *args, tp, rp)
        assert int(k.stats[S_FAULT]) == 0
        assert int(ws.n_claims.sum()) == int(k.stats[S_INSERTED]) \
            == int(k.inserted.sum())
        keys = pack64(k.chi, k.clo)
        want = set()
        for lane in torch.nonzero(k.cvalid).flatten().tolist():
            key = int(keys[lane])
            if key not in before:
                before.add(key)
                want.add(lane)
        assert set(torch.nonzero(k.inserted).flatten().tolist()) == want
    assert ws.step == 3
    assert sorted(tk[tk != 0].tolist()) == sorted(tp[tp != 0].tolist())


@pytest.mark.gpu
def test_insert_without_a_mask_builds_the_plain_table():
    """K4 without a mask (the seed and growth): one pass, no owner words;
    the plain insert's table and overflow flag, and no mask."""
    _need_card()
    from stateright_tpu_torch.ops.hashtable import (table_insert,
                                                    table_insert_reference)
    dev = torch.device("cuda")
    hi, lo, valid, table = _insert_batch(np.random.default_rng(3), 30000,
                                         dev)
    tk, tp = table.clone(), table.clone()
    ik, ok, rk = table_insert(tk, hi, lo, valid, with_rounds=True,
                              mask=False)
    _ip, op = table_insert_reference(tp, hi, lo, valid)
    assert ik is None and ok == op is False and rk >= 1
    assert sorted(tk[tk != 0].tolist()) == sorted(tp[tp != 0].tolist())


@pytest.mark.gpu
def test_insert_over_several_launch_ranges_keeps_the_lowest_lane():
    """A batch wider than the resident grid's lanes runs as launches over
    consecutive lane ranges under one tag: each key twice, its copies in
    different ranges, ~20 % of lanes invalid, so some keys' lowest valid
    lane lies in a later range. The mask is the lowest valid lane of each
    key, with a mask and the table's key set as the plain insert's."""
    _need_card()
    from stateright_tpu_torch.ops.hashtable import (make_table,
                                                    table_insert,
                                                    table_insert_reference)
    from stateright_tpu_torch.ops.words import from_numpy_u32, pack64
    dev = torch.device("cuda")
    rng = np.random.default_rng(11)
    half = 1_500_000
    base = rng.integers(1, 2**63, size=half, dtype=np.int64).astype(
        np.uint64)
    keys = np.concatenate([base, base])
    hi = from_numpy_u32((keys >> np.uint64(32)).astype(np.uint32), dev)
    lo = from_numpy_u32(keys.astype(np.uint32), dev)
    valid = torch.from_numpy(rng.random(2 * half) < 0.8).to(dev)
    tk, tp = make_table(1 << 23, dev), make_table(1 << 23, dev)
    ik, ok = table_insert(tk, hi, lo, valid)
    _ip, op = table_insert_reference(tp, hi, lo, valid)
    assert ok == op is False
    assert torch.equal(torch.sort(tk[tk != 0]).values,
                       torch.sort(tp[tp != 0]).values)
    k = pack64(hi, lo)
    lanes = torch.arange(k.shape[0], device=dev)
    uniq, inv = torch.unique(k[valid], return_inverse=True)
    first = torch.full((uniq.shape[0],), k.shape[0], dtype=torch.int64,
                       device=dev)
    first.scatter_reduce_(0, inv, lanes[valid], reduce="amin")
    want = torch.zeros_like(ik)
    want[first] = True
    assert bool(want[half:].any())  # some lowest valid lanes lie late
    assert torch.equal(ik, want)


# --- the chunk on the card (csrc/chunk.cu) ---------------------------------

#: the inserted mask's density; "tile0": the first 4,096-lane tile all
#: inserted (the shared-memory stage full), 1 % after it
APPEND_CASES = [(d, s, e) for d in (0.0, 0.01, 0.5, 1.0, "tile0")
                for s in (False, True) for e in (False, True)]


@pytest.mark.gpu
@pytest.mark.parametrize(
    "density,symmetry,near_end", APPEND_CASES,
    ids=[f"d{d}-{'sym' if s else 'plain'}-{'end' if e else 'mid'}"
         for d, s, e in APPEND_CASES])
def test_append_matches_plain_version_on_random_masks(density, symmetry,
                                                      near_end):
    """K7 at each of its tile sizes against ``append_reference`` on random
    words and a random inserted mask over several of its tiles, for the
    large and the small step size (one scan state across every launch),
    at the end of the queue and log and inside them: the counter block
    (the next gate included), stats vector, queue and log bit for bit."""
    _need_card()
    from stateright_tpu_torch.checker.device_loop import (
        B_DISC, B_LOG_N, B_Q_HEAD, B_Q_TAIL, E_GATE, E_STEPS, G_LEN,
        CtrLayout, append_reference)
    from stateright_tpu_torch.ops import _cuda
    from stateright_tpu_torch.ops.fused import (S_DISC, S_INSERTED,
                                                S_VALID, FusedOut)
    from stateright_tpu_torch.ops.words import from_numpy_u32
    dev = torch.device("cuda")
    rng = np.random.default_rng([int(100 * (density if density != "tile0"
                                            else 2)), symmetry, near_end])
    # the small step spans 3 of the grid's 6 4,096-lane tiles: its tail is
    # a block past them that waits for their prefix
    f_small, f_large, a, w, n_props = 240, 600, 37, 4, 3
    lay = CtrLayout(n_props, w)
    lc = 6 if symmetry else 4
    lanes_l = f_large * a
    # one scan state per tile size (grid), kept across both step sizes
    scratch = {t: _cuda.append_scratch(lanes_l, t, dev)
               for t in _cuda.APPEND_TILES}
    for launch, (size, f) in enumerate(((2, f_large), (1, f_small)), 1):
        lanes = f * a
        qcap, logcap = 4 * lanes_l, 3 * lanes_l

        def words(*shape):
            return from_numpy_u32(rng.integers(
                0, 2**32, size=shape, dtype=np.uint64).astype(np.uint32),
                dev)

        bufs = _cuda.step_buffers(TwoPhaseSys(7), f_large, S_DISC + 3 *
                                  n_props, symmetry, dev, 1)
        for name in ("flat", "chi", "clo", "ohi", "olo", "ebits_out"):
            bufs[name].copy_(words(*bufs[name].shape))
        if density == "tile0":
            mask = rng.random(lanes_l) < 0.01
            mask[:max(_cuda.APPEND_TILES)] = True
        else:
            mask = rng.random(lanes_l) < density
        bufs["inserted"].copy_(torch.from_numpy(mask))
        cnt = int(bufs["inserted"][:lanes].sum())
        st = np.zeros(S_DISC + 3 * n_props, np.int64)
        st[S_VALID], st[S_INSERTED] = lanes, cnt
        st[S_DISC + 1], st[S_DISC + n_props + 1] = 1, 77
        bufs["stats"].copy_(torch.from_numpy(st.astype(np.int32)))
        q, log = words(qcap, w + 3), words(logcap, lc)
        head = lanes_l // 3
        qbase = qcap - lanes_l if near_end else head + f + 5
        lbase = logcap - lanes_l if near_end else 17
        ctr = torch.zeros((lay.length,), dtype=torch.int32, device=dev)
        ctr[B_Q_HEAD], ctr[B_Q_TAIL], ctr[B_LOG_N] = head, qbase, lbase
        ctr[B_DISC] = 1
        ctr[lay.ext + E_STEPS] = 9
        ctr[lay.ext + E_GATE:lay.ext + E_GATE + G_LEN] = torch.tensor(
            [size, head, f - 3, 5, qbase, lbase], dtype=torch.int32)
        live = (ctr, q, log, bufs["stats"])
        start = [t.clone() for t in live]
        out = FusedOut(
            pbits=None, ebits=bufs["ebits_out"][:f], terminal=None,
            flat=bufs["flat"][:lanes], chi=bufs["chi"][:lanes],
            clo=bufs["clo"][:lanes], cvalid=None, dvalid=None,
            inserted=bufs["inserted"][:lanes], stats=bufs["stats"],
            ohi=bufs["ohi"][:lanes], olo=bufs["olo"][:lanes])
        append_reference(ctr, lay, q, log, out, a, f_small, f_large,
                         qcap - lanes_l)
        want = [t.clone() for t in live]
        assert int(ctr[B_Q_TAIL]) == qbase + cnt
        for tile in _cuda.APPEND_TILES:
            for t, v in zip(live, start):
                t.copy_(v)
            args = _cuda.chunk_args(
                ctr=ctr, bufs=bufs, q=q, log=log, scratch=scratch[tile],
                qlimit=qcap - lanes_l, n_props=n_props, width=w,
                n_actions=a, f_small=f_small, f_large=f_large, ext=lay.ext,
                recent=lay.recent, cch=lay.cch)
            _cuda.append(args, dev)
            for name, x, y in zip(("ctr", "q", "log", "stats"), live, want):
                assert torch.equal(x, y), (size, tile, name)
            # one ticket a block and launch; the highest inserted lane
            # under this launch's epoch
            tickets, last = scratch[tile]["ticket"].tolist()
            assert tickets == launch * _cuda.append_grid(lanes_l, tile)
            ins = np.flatnonzero(mask[:lanes])
            if len(ins):
                assert last == (launch << 32) | int(ins[-1]) + 1


@pytest.mark.gpu
@pytest.mark.parametrize(
    "name,symmetry,f", [("2pc7", False, 12288), ("2pc7", False, 256),
                        ("2pc16", True, 12288), ("lock9", False, 12288)],
    ids=["2pc7-f12288", "2pc7-f256", "2pc16-ref", "lock9-f12288"])
def test_append_matches_plain_version_after_a_real_step(name, symmetry, f):
    """The chunk's start (with its gate) and the gated step (K1-K3) of a
    real mid-search iteration, then K7 or ``append_reference`` from the
    same state: the counters (the next gate included), stats vector,
    queue and log rows bit for bit, its count the step's. IncrementLock(9)
    appends 14-word queue rows."""
    _need_card()
    from stateright_tpu_torch import IncrementLock
    from stateright_tpu_torch.checker.device_loop import (
        B_Q_TAIL, E_FAULT, E_GATE, G_SIZE, I32_MAX, ChunkRunner,
        append_reference, step_sizes)
    from stateright_tpu_torch.ops.fused import S_INSERTED
    model = {"2pc7": lambda: TwoPhaseSys(7), "2pc16": lambda: TwoPhaseSys(16),
             "lock9": lambda: IncrementLock(9)}[name]()
    dev = torch.device("cuda")
    carry = _mid_search(model, 12288, symmetry, dev)
    lay = carry.layout
    f_small, f_large, qmargin = step_sizes(model, f)
    card = ChunkRunner(model, carry, f).card()
    carry.ws.step += 1
    card.begin(1, I32_MAX, I32_MAX, carry.ws.step)
    card.launch_steps()
    size = int(carry.ctr[lay.ext + E_GATE + G_SIZE])
    assert size == 2
    out = card.outputs(size)
    stats = out.stats.clone()
    start = (carry.ctr.clone(), carry.q.clone(), carry.log.clone(), stats)
    card.launch_append()
    got = (carry.ctr.clone(), carry.q.clone(), carry.log.clone(),
           out.stats.clone())
    for t, v in zip((carry.ctr, carry.q, carry.log, out.stats), start):
        t.copy_(v)
    append_reference(carry.ctr, lay, carry.q, carry.log, out,
                     model.max_actions, f_small, f_large,
                     carry.q.shape[0] - qmargin)
    for x, y in zip(got, (carry.ctr, carry.q, carry.log, out.stats)):
        assert torch.equal(x, y)
    cnt = int(out.inserted.sum())
    assert cnt == int(stats[S_INSERTED]) > 0
    assert int(got[0][B_Q_TAIL]) - int(start[0][B_Q_TAIL]) == cnt
    assert int(got[0][lay.ext + E_FAULT]) == 0
    assert int(got[0][lay.ext + E_GATE + G_SIZE]) == 0  # its one step spent
    assert not got[3].any()


@pytest.mark.gpu
def test_a_shut_gate_leaves_everything_as_it_was():
    """With the gate shut (a chunk of no steps), the gated step and K7,
    launched alone and as the captured graph, change no counter, row,
    stats word, status word or ticket."""
    _need_card()
    from stateright_tpu_torch.checker.device_loop import (
        E_GATE, G_SIZE, I32_MAX, ChunkRunner)
    model = TwoPhaseSys(7)
    dev = torch.device("cuda")
    carry = _mid_search(model, 300, False, dev)
    card = ChunkRunner(model, carry, 12288).card()
    card.begin(0, I32_MAX, I32_MAX, carry.ws.step + 1)
    assert int(carry.ctr[carry.layout.ext + E_GATE + G_SIZE]) == 0
    card.bufs["stats"].fill_(5)
    bufs = (carry.ctr, carry.q, carry.log, carry.table, card.bufs["stats"],
            card.scratch["status"], card.scratch["ticket"])
    before = [t.clone() for t in bufs]
    card.launch_steps()
    card.launch_append()
    card.graph.replay(3)
    torch.cuda.synchronize()
    for t, b in zip(bufs, before):
        assert torch.equal(t, b)


@pytest.mark.gpu
def test_graph_replays_match_plain_iterations():
    """Three replays of the captured iteration against three plain ones
    from the same state (the card's gated step, then ``append_reference``
    on its outputs): the counters (each next gate included), stats
    vector, queue and log bit for bit, so K7's ticket and status words
    carry over from one replay to the next."""
    _need_card()
    from stateright_tpu_torch.checker.device_loop import (
        E_GATE, E_ITERS, G_SIZE, I32_MAX, ChunkRunner, append_reference,
        step_sizes)
    model = TwoPhaseSys(7)
    dev = torch.device("cuda")
    carry = _mid_search(model, 12288, False, dev)
    lay = carry.layout
    f = 12288
    f_small, f_large, qmargin = step_sizes(model, f)
    card = ChunkRunner(model, carry, f).card()
    ws = carry.ws
    tag = ws.step + 1
    ws.step += 3
    card.begin(3, I32_MAX, I32_MAX, tag)
    state = (carry.ctr, carry.q, carry.log, carry.table, carry.ring,
             ws.owner, ws.disc_cand, card.bufs["stats"])
    for i in range(3):
        before = [t.clone() for t in state]
        size = int(carry.ctr[lay.ext + E_GATE + G_SIZE])
        assert size != 0
        card.launch_steps()
        append_reference(carry.ctr, lay, carry.q, carry.log,
                         card.outputs(size), model.max_actions, f_small,
                         f_large, carry.q.shape[0] - qmargin)
        plain = (carry.ctr.clone(), carry.q.clone(), carry.log.clone(),
                 card.bufs["stats"].clone())
        for t, b in zip(state, before):
            t.copy_(b)
        card.graph.replay(1)
        for x, y in zip(plain, (carry.ctr, carry.q, carry.log,
                                card.bufs["stats"])):
            assert torch.equal(x, y), i
        assert int(carry.ctr[lay.ext + E_ITERS]) == i + 1


def _record(ck):
    ck.generated_fingerprints()  # pulls the mirror
    return list(ck._generated.items())


@pytest.mark.gpu
def test_graph_replays_across_a_growth():
    """The iteration graph is captured again after each growth (new
    buffers): a run from a 2**10-slot table at 16-row steps grows twice
    and captures more graphs than the run that does not grow (counts,
    not capture seconds: a cold first capture can take longer than three
    warm ones), and its search record is the non-growing run's row for
    row (the card's lowest-lane winner rule does not depend on the
    table's layout, nor the record on where chunks end)."""
    _need_card()
    opts = dict(fmax=16, chunk_steps=4, cc_dedup=64, race=False)
    grown = TwoPhaseSys(5).checker().gpu_options(
        capacity=1 << 10, **opts).spawn_gpu().join()
    flat = TwoPhaseSys(5).checker().gpu_options(
        capacity=1 << 16, **opts).spawn_gpu().join()
    plain = _cpu(TwoPhaseSys(5), capacity=1 << 16,
                 **{k: v for k, v in opts.items() if k != "race"})
    pg, pf = grown.profile(), flat.profile()
    assert pg["grows"] == 2 and pf["grows"] == 0
    assert pg["captures"] > pf["captures"] >= 1
    assert pg["capture_s"] > 0 and pf["capture_s"] > 0
    assert pg["graph_launches"] > 0 and pg["syncs"] == pg["chunks"]
    assert _record(grown) == _record(flat)
    assert grown.unique_state_count() == 8832
    assert grown.state_count() == plain.state_count()
    assert grown.generated_fingerprints() == plain.generated_fingerprints()
    grown.assert_properties()


@pytest.mark.gpu
@pytest.mark.parametrize("chunk_steps", [1, 7, 64])
def test_pipeline_on_card_repeats_the_record(chunk_steps):
    """With the pipeline on and off, at any chunk size, the card finds
    the same search record row for row, and the plain path's set."""
    _need_card()
    runs = [TwoPhaseSys(5).checker().gpu_options(
        chunk_steps=chunk_steps, pipeline=p, race=False).spawn_gpu().join()
        for p in (True, False)]
    assert _record(runs[0]) == _record(runs[1])
    for ck in runs:
        prof = ck.profile()
        assert prof["syncs"] == prof["chunks"] \
            <= -(-prof["iterations"] // chunk_steps) + 2
        assert ck.unique_state_count() == 8832


@pytest.mark.gpu
def test_tag_stays_monotone_across_chunks_and_inserts():
    """The owner-word tag comes from the counter block: it grows by one
    per step that runs, each chunk starts above every tag handed out
    (chunks and the workspace's masked inserts share the counter), and no
    step or insert faults."""
    _need_card()
    from stateright_tpu_torch.checker.device_loop import (
        E_FAULT, E_ITERS, E_TAG, run_chunk)
    from stateright_tpu_torch.ops.hashtable import table_insert
    model = TwoPhaseSys(7)
    dev = torch.device("cuda")
    carry = _mid_search(model, 300, False, dev)
    lay = carry.layout
    rng = np.random.default_rng(3)
    last = int(carry.ws.step)
    for round_ in range(3):
        first = carry.ws.step + 1
        c = run_chunk(model, carry, fmax=12288, steps=4)
        iters = int(c[lay.ext + E_ITERS])
        assert iters > 0 and int(c[lay.ext + E_FAULT]) == 0
        assert first > last
        assert int(c[lay.ext + E_TAG]) == first + iters
        assert carry.ws.step >= first + iters - 1
        owner = carry.ws.owner[carry.ws.owner != -1]
        tags = (~(owner >> 32)) & 0xFFFFFFFF
        assert int(tags.max()) <= carry.ws.step
        # a masked insert on the same workspace takes the next tag
        hi, lo, valid, _t = _insert_batch(rng, 500, dev)
        table_insert(carry.table, hi, lo, valid, ws=carry.ws)
        last = int(carry.ws.step)


# --- the other models: LinearEquation, Increment, IncrementLock --------------

def _more_model(name):
    from stateright_tpu_torch import (Increment, IncrementLock,
                                      PackedLinearEquation)
    return {"lineq": lambda: PackedLinearEquation(2, 10, 14),
            "increment": lambda: Increment(5),
            "increment16": lambda: Increment(16),
            "increment_lock": lambda: IncrementLock(5),
            "increment_lock16": lambda: IncrementLock(16)}[name]()


MORE_CASES = [(name, sym, probe)
              for name, sym in (("lineq", False), ("increment", False),
                                ("increment", True), ("increment16", True),
                                ("increment_lock", False),
                                ("increment_lock16", False))
              for probe in (True, False)]


@pytest.mark.gpu
@pytest.mark.parametrize(
    "name,symmetry,probe", MORE_CASES,
    ids=[f"{n}{'-sym' if s else ''}-{'probe' if p else 'noprobe'}"
         for n, s, p in MORE_CASES])
def test_more_models_expand_lane_exact(name, symmetry, probe, monkeypatch):
    """K1 of each new instantiation (its width a runtime argument: 2,
    n + 1 or n + 2 words of a row array of 17 or 18) through both step
    entry points, at ragged F with the card's tiles and with full-size
    ones: lane for lane the plain version's successors, fingerprints
    (and original fingerprints under symmetry), validity, property bits,
    eventually-bits and terminal rows, on reachable rows drawn with
    replacement and on rows of small thread words (equal words, pcs
    0..5); then the inserted key set and the table, by the set gate."""
    _need_card()
    from stateright_tpu_torch.ops import _cuda
    from stateright_tpu_torch.ops.fused import (S_DISC, S_VALID, S_XOVF,
                                                fused_step,
                                                fused_step_reference)
    from stateright_tpu_torch.ops.hash_kernel import fp64_device
    from stateright_tpu_torch.ops.hashtable import make_table
    from stateright_tpu_torch.ops.words import from_numpy_u32, pack64
    model = _more_model(name)
    dev = torch.device("cuda")
    rng = np.random.default_rng(len(name))
    w = model.packed_width
    states, seen, queue = [], set(), list(model.init_states())
    while queue and len(states) < 2000:
        s = queue.pop(0)
        fp = model.fingerprint(s)
        if fp not in seen:
            seen.add(fp)
            states.append(model.encode(s))
            queue.extend(model.next_states(s))
    names = ("flat", "chi", "clo", "cvalid", "pbits", "ebits",
             "terminal") + (("ohi", "olo") if symmetry else ())
    rows_per_tile = _cuda.TILE_LANES // model.max_actions
    for full in (False, True):
        if full:
            monkeypatch.setattr(_cuda, "sm_count", lambda device: 1)
            monkeypatch.setattr(_cuda, "TILES_PER_SM", 1)
        for f in (1, rows_per_tile - 1, rows_per_tile + 3, 257, 4096):
            rows = np.stack([states[i] for i in
                             rng.integers(0, len(states), f)])
            ties = rng.random(f) < 0.3
            small = (rng.integers(0, 4, (f, w)) << 4
                     | rng.integers(0, 6, (f, w))).astype(np.uint32)
            rows[ties] = small[ties]
            block = from_numpy_u32(rows, dev)
            phi, plo = (x.to(torch.int32) for x in fp64_device(
                model.packed_representative(block) if symmetry else block))
            ebits = torch.zeros((f,), dtype=torch.int32, device=dev)
            fvalid = torch.from_numpy(rng.random(f) < 0.9).to(dev)
            out, tables = [], []
            for fn in (fused_step, fused_step_reference):
                table = make_table(1 << 16, dev)
                ring = torch.zeros((1 << 10,), dtype=torch.int64,
                                   device=dev)
                out.append(fn(model, block, ebits, fvalid, phi, plo, table,
                              ring, probe=probe, symmetry=symmetry))
                tables.append(sorted(table[table != 0].tolist()))
            k, p = out
            for nm in names:
                assert torch.equal(getattr(k, nm), getattr(p, nm)), (f, nm)
            for i in (S_XOVF, S_VALID):
                assert int(k.stats[i]) == int(p.stats[i]), (f, i)
            assert torch.equal(k.stats[S_DISC:], p.stats[S_DISC:])
            key_k = pack64(k.chi, k.clo)[k.inserted].tolist()
            key_p = pack64(p.chi, p.clo)[p.inserted].tolist()
            assert len(key_k) == len(set(key_k))
            assert set(key_k) == set(key_p)
            if probe:
                assert tables[0] == tables[1]


@pytest.mark.gpu
def test_more_models_end_to_end_on_card():
    """Each new model through ``spawn_gpu()`` on the card against its
    plain path: IncrementLock(6) (7,825 states, both properties hold),
    PackedLinearEquation(2, 4, 7) from a 2**12-slot table (65,536
    states, three growths, each recapturing the chunk's graph), and
    Increment(5) with and without symmetry (the ``fin`` counterexample
    of four actions replays)."""
    _need_card()
    from stateright_tpu_torch import (Increment, IncrementLock,
                                      PackedLinearEquation)
    from stateright_tpu_torch.ops import _cuda
    for model, opts, unique in (
            (IncrementLock(6), {}, 7825),
            (PackedLinearEquation(2, 4, 7), dict(capacity=1 << 12,
                                                 fmax=64), 65536)):
        launches = _cuda.LAUNCHES["fused_step"]
        ck = model.checker().gpu_options(race=False, **opts) \
            .spawn_gpu().join()
        plain = _cpu(model, **opts)
        assert ck.unique_state_count() == plain.unique_state_count() \
            == unique
        assert ck.state_count() == plain.state_count()
        assert ck.generated_fingerprints() == plain.generated_fingerprints()
        assert not ck.discoveries()
        assert _cuda.LAUNCHES["fused_step"] > launches
        if opts:
            assert ck.profile()["grows"] == 3
    for symmetry in (False, True):
        model = Increment(5)
        builder = model.checker().gpu_options(race=False)
        if symmetry:
            builder = builder.symmetry_fn(model.representative)
        ck = builder.spawn_gpu().join()
        path = ck.assert_any_discovery("fin")  # replays or raises
        assert not model.property("fin").condition(model, path.last_state())
        assert len(path) == 4


WIDTH_CASES = [(name, sym) for name, sym in (("increment", False),
                                             ("increment", True),
                                             ("increment_lock", False))]


@pytest.mark.gpu
@pytest.mark.parametrize("name,symmetry", WIDTH_CASES,
                         ids=["increment", "increment-sym",
                              "increment_lock"])
def test_every_width_launches_lane_exact(name, symmetry, monkeypatch):
    """K1 at every width the increment models take (n = 1..16: 2 to 17
    words for Increment, 3 to 18 for IncrementLock; LinearEquation's 2
    is above), through both step entry points, on 300 rows of small
    thread words (equal words, every pc 0..5) and reachable rows: lane
    for lane the plain version's outputs. Then n = 1 (one action: 1,024
    rows a tile, K1's largest shared-memory tile, 160 KB under symmetry)
    with full-size tiles, as on a card of one SM."""
    _need_card()
    from stateright_tpu_torch.ops import _cuda
    from stateright_tpu_torch import Increment, IncrementLock
    from stateright_tpu_torch.ops.fused import (S_DISC, fused_step,
                                                fused_step_reference)
    from stateright_tpu_torch.ops.hash_kernel import fp64_device
    from stateright_tpu_torch.ops.hashtable import make_table
    from stateright_tpu_torch.ops.words import from_numpy_u32
    dev = torch.device("cuda")
    rng = np.random.default_rng(5)
    names = ("flat", "chi", "clo", "cvalid", "pbits", "ebits",
             "terminal") + (("ohi", "olo") if symmetry else ())
    for n, f in [(n, 300) for n in range(1, 17)] + [(1, 1024)]:
        if f == 1024:
            monkeypatch.setattr(_cuda, "sm_count", lambda device: 1)
            monkeypatch.setattr(_cuda, "TILES_PER_SM", 1)
        model = (Increment if name == "increment" else IncrementLock)(n)
        w = model.packed_width
        rows = (rng.integers(0, 4, (f, w)) << 4
                | rng.integers(0, 6, (f, w))).astype(np.uint32)
        rows[:, 0] = rng.integers(0, 20, f)
        reach = [model.encode(s) for s in model.next_states(
            model.init_states()[0])]
        rows[:len(reach)] = np.stack(reach)
        block = from_numpy_u32(rows, dev)
        phi, plo = (x.to(torch.int32) for x in fp64_device(
            model.packed_representative(block) if symmetry else block))
        ebits = torch.zeros((f,), dtype=torch.int32, device=dev)
        fvalid = torch.ones((f,), dtype=torch.bool, device=dev)
        for probe in (True, False):
            k, p = (fn(model, block, ebits, fvalid, phi, plo,
                       make_table(1 << 14, dev),
                       torch.zeros((64,), dtype=torch.int64, device=dev),
                       probe=probe, symmetry=symmetry)
                    for fn in (fused_step, fused_step_reference))
            for nm in names:
                assert torch.equal(getattr(k, nm), getattr(p, nm)), (n, nm)
            assert torch.equal(k.stats[S_DISC:], p.stats[S_DISC:]), n


# --- the race and checkpoints on the card ---------------------------------

@pytest.mark.gpu
def test_race_on_card():
    """``spawn_gpu()`` races by default: IncrementLock(3) is answered by
    the host inside its budget (and on the card alone with race=False,
    through its kernels); a raced 2pc5, whoever wins, is the host BFS's
    set; a raced loser leaves no thread behind."""
    _need_card()
    from stateright_tpu_torch import IncrementLock
    from stateright_tpu_torch.checker import race
    from stateright_tpu_torch.ops import _cuda
    ck = IncrementLock(3).checker().gpu_options(capacity=1 << 14) \
        .spawn_gpu().join()
    assert isinstance(ck, race.RacingChecker)
    assert ck.unique_state_count() == 61
    assert ck.profile()["engine"] == "host"
    assert race.join_losers(timeout=60)
    launches = dict(_cuda.LAUNCHES)
    card = IncrementLock(3).checker().gpu_options(
        capacity=1 << 14, race=False).spawn_gpu().join()
    assert card.generated_fingerprints() == ck.generated_fingerprints()
    assert all(_cuda.LAUNCHES[k] > launches[k]
               for k in ("fused_step", "append", "chunk_begin"))
    raced = TwoPhaseSys(5).checker().spawn_gpu().join()
    assert raced.profile()["engine"] in ("host", "device")
    assert raced.generated_fingerprints() == \
        TwoPhaseSys(5).checker().spawn_bfs().join().generated_fingerprints()
    assert race.join_losers(timeout=60)


@pytest.mark.gpu
def test_device_error_on_card_ends_the_race(monkeypatch):
    """A chunk that fails to launch on the card makes the raced
    ``join()`` raise, although the host racer (held back until the race
    is decided, with a 60 s budget) would answer IncrementLock(3): the
    host's answer never hides a device error."""
    _need_card()
    import time

    from stateright_tpu_torch import IncrementLock
    from stateright_tpu_torch.checker import bfs, device_loop, race
    ck = IncrementLock(3).checker().gpu_options(
        capacity=1 << 14, race_budget=60.0).spawn_gpu()
    assert isinstance(ck, race.RacingChecker)
    host_run = bfs.BfsChecker._run

    def fail(*args, **kwargs):
        raise RuntimeError("injected chunk failure")

    def held(self):
        ck._decided.wait(30)
        host_run(self)

    monkeypatch.setattr(device_loop.ChunkRunner, "dispatch", fail)
    monkeypatch.setattr(bfs.BfsChecker, "_run", held)
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="injected"):
        ck.join()
    assert time.monotonic() - t0 < 20
    assert race.join_losers(timeout=60)


@pytest.mark.gpu
def test_checkpoint_resumes_on_card(tmp_path):
    """A bounded 2pc5 run on the card saved and resumed on the card: the
    full 8,832 states of the host BFS, the resume's preload through K4;
    under complete symmetry, the uninterrupted reduced set through
    K1-sym."""
    _need_card()
    from stateright_tpu_torch.ops import _cuda
    path = tmp_path / "ckpt.npz"
    partial = TwoPhaseSys(5).checker().gpu_options(
        resumable=True, fmax=64, chunk_steps=4).target_state_count(2000) \
        .spawn_gpu().join()
    assert partial.unique_state_count() < 8832
    partial.save(path)
    inserts = _cuda.LAUNCHES["table_insert"]
    resumed = TwoPhaseSys(5).checker().resume_from(path).spawn_gpu().join()
    assert resumed.unique_state_count() == 8832
    assert resumed.generated_fingerprints() == \
        TwoPhaseSys(5).checker().spawn_bfs().join().generated_fingerprints()
    assert resumed.state_count() >= partial.state_count()
    assert _cuda.LAUNCHES["table_insert"] > inserts
    resumed.assert_properties()

    def sym():
        m = TwoPhaseSys(5, complete_symmetry=True)
        return m.checker().symmetry_fn(m.representative)

    path = tmp_path / "sym.npz"
    sym().gpu_options(resumable=True, fmax=16, chunk_steps=1) \
        .target_state_count(200).spawn_gpu().join().save(path)
    steps = _cuda.LAUNCHES["fused_step_sym"]
    resumed = sym().resume_from(path).spawn_gpu().join()
    whole = sym().spawn_gpu().join()
    assert resumed.unique_state_count() == whole.unique_state_count() == 314
    assert resumed.generated_fingerprints() == whole.generated_fingerprints()
    assert _cuda.LAUNCHES["fused_step_sym"] > steps


def _paxos_rows(model, rng, f):
    """``f`` rows of a register model (Paxos, ABD, single-copy) drawn
    with replacement from the first 3,000 states of a host BFS of
    ``model``, a tenth of them with crowded networks (their children's
    sends overflow: on the ordered network a third of the channels filled
    to their depth) and a twentieth random words. A state whose network
    outgrows the encoding is not encoded, and the BFS does not go past
    it."""
    seen, states, queue = set(), [], list(model.init_states())
    while queue and len(states) < 3000:
        s = queue.pop(0)
        try:
            enc = model.encode(s)
        except ValueError:  # more envelopes than net_capacity slots
            continue
        if enc.tobytes() not in seen:
            seen.add(enc.tobytes())
            states.append(enc)
            queue.extend(model.next_states(s))
    rows = np.stack([states[i] for i in rng.integers(0, len(states), f)])
    e_cap, w = model.net_capacity, model.packed_width
    for i in np.flatnonzero(rng.random(f) < 0.1):
        if model._net_ordered:
            d, r = model.channel_depth, rows[i]
            for ch in np.flatnonzero(rng.random(model._n_chan) < 0.3):
                for j in range(int(r[model._net_off + ch]), d):
                    off = model._msgs_off + (ch * d + j) * 2
                    r[off:off + 2] = ((14 << 24) | j, j)
                r[model._net_off + ch] = d
            continue
        slots = rows[i, model._net_off:model._timer_off].reshape(e_cap, 4)
        occ = [tuple(int(x) for x in s) for s in slots if s[0] >> 16 & 1]
        for j in range(len(occ), int(rng.integers(len(occ), e_cap + 1))):
            occ.append(((1 << 16) | (7 << 8) | (20 + j), 1, 14 << 24, j))
        occ.sort(key=lambda t: (t[0], t[2], t[3]))
        slots[:] = 0
        for j, t in enumerate(occ):
            slots[j] = t
    junk = rng.random(f) < 0.05
    rows[junk] = rng.integers(0, 2 ** 32, (int(junk.sum()), w),
                              dtype=np.uint64).astype(np.uint32)
    return rows


def _k1_held(model, rows, fvalid):
    """The lanes and rows whose outputs K1's instantiation for ``model``
    writes, as bool tensors on ``fvalid``'s device: a group one
    (``_cuda.pending_rows``) steps the pending rows only, every other one
    every row; of a row's lanes those below the quiet lane (a group
    model), of non-empty channels (an edit model) or every lane. The
    children and their fingerprints are held on those lanes, the
    property and eventually bits on those rows, cvalid and terminal
    everywhere."""
    from stateright_tpu_torch.ops import _cuda
    name = model.cuda_spec()[0]
    dev = fvalid.device
    held_rows = torch.ones_like(fvalid)
    if _cuda.pending_rows(name):
        held_rows = fvalid
    lanes = held_rows.repeat_interleave(model.max_actions)
    rule = _chip_smoke().active_rule(model, name)
    if rule is not None:
        lanes = lanes & rule(torch.from_numpy(rows.astype(np.int64)).to(dev))
    return lanes, held_rows


def _hold_k1(model, k, p, rows, fvalid):
    """K1's outputs ``k`` against the plain version's ``p`` under
    :func:`_k1_held`'s rule; returns the held lanes."""
    lanes, held_rows = _k1_held(model, rows, fvalid)
    for nm in ("flat", "chi", "clo"):
        assert torch.equal(getattr(k, nm)[lanes], getattr(p, nm)[lanes]), nm
    for nm in ("pbits", "ebits"):
        assert torch.equal(getattr(k, nm)[held_rows],
                           getattr(p, nm)[held_rows]), nm
    for nm in ("cvalid", "terminal"):
        assert torch.equal(getattr(k, nm), getattr(p, nm)), nm
    return lanes


def _paxos_step_lane_exact(model, f, seed):
    """K1's paxos instantiation with K2/K3 against the plain version over
    ``f`` rows of ``_paxos_rows`` (crowded networks, junk rows, a tenth
    of the rows invalid), lane for lane on every lane (invalid and
    overflowing ones too), then the inserted key set and the table."""
    from stateright_tpu_torch.ops.fused import (S_DISC, S_VALID, S_XOVF,
                                                fused_step,
                                                fused_step_reference)
    from stateright_tpu_torch.ops.hash_kernel import fp64_device
    from stateright_tpu_torch.ops.hashtable import make_table
    from stateright_tpu_torch.ops.words import pack64, from_numpy_u32
    dev = torch.device("cuda")
    rng = np.random.default_rng(seed)
    block = from_numpy_u32(_paxos_rows(model, rng, f), dev)
    phi, plo = (x.to(torch.int32) for x in fp64_device(block))
    ebits = torch.zeros((f,), dtype=torch.int32, device=dev)
    fvalid = torch.from_numpy(rng.random(f) < 0.9).to(dev)
    out, tables = [], []
    for fn in (fused_step, fused_step_reference):
        table = make_table(1 << 18, dev)
        ring = torch.zeros((1 << 12,), dtype=torch.int64, device=dev)
        out.append(fn(model, block, ebits, fvalid, phi, plo, table, ring))
        tables.append(sorted(table[table != 0].tolist()))
    k, p = out
    for nm in ("flat", "chi", "clo", "cvalid", "pbits", "ebits",
               "terminal"):
        assert torch.equal(getattr(k, nm), getattr(p, nm)), nm
    for i in (S_XOVF, S_VALID):
        assert int(k.stats[i]) == int(p.stats[i]), i
    assert torch.equal(k.stats[S_DISC:], p.stats[S_DISC:])
    key_k = pack64(k.chi, k.clo)[k.inserted].tolist()
    key_p = pack64(p.chi, p.clo)[p.inserted].tolist()
    assert len(key_k) == len(set(key_k)) and set(key_k) == set(key_p)
    assert tables[0] == tables[1]
    return k


@pytest.mark.gpu
@pytest.mark.parametrize("clients,f", [(1, 64), (2, 1000), (3, 8192)])
def test_paxos_step_lane_exact_on_card(clients, f):
    """K1's paxos instantiation (the wide K1: rows in shared memory, each
    warp's children staged there and written as one span) with K2/K3
    against the plain version, lane for lane on every lane (invalid and
    overflowing ones too), then the inserted key set and the table; small
    and full width."""
    _need_card()
    from stateright_tpu_torch.examples.paxos_packed import PackedPaxos
    from stateright_tpu_torch.ops.fused import S_XOVF
    k = _paxos_step_lane_exact(PackedPaxos(clients), f, clients)
    if clients > 1:  # the crowded rows' sends overflow
        assert int(k.stats[S_XOVF]) == 1


@pytest.mark.gpu
@pytest.mark.parametrize("clients,servers,slots,f", [
    (2, 4, 16, 1237), (2, 3, 7, 1000), (3, 3, 5, 333), (1, 4, 3, 77)])
def test_paxos_wide_step_lane_exact_at_odd_shapes_on_card(clients, servers,
                                                          slots, f):
    """K1-wide at the shapes its warp spans find hardest, lane for lane
    on every lane against the plain version: a width that is no multiple
    of four words (PackedPaxos(2, server_count=4): 102; with 3 slots 46),
    fewer than 16 action lanes (7, 5, 3: a warp's 32 lanes span rows and
    tiles split warps), and frontiers of no multiple of 32 rows or of the
    tile, with junk rows and crowded networks whose sends overflow."""
    _need_card()
    from stateright_tpu_torch.examples.paxos_packed import PackedPaxos
    from stateright_tpu_torch.ops.fused import S_XOVF
    model = PackedPaxos(clients, server_count=servers, net_capacity=slots)
    k = _paxos_step_lane_exact(model, f, 100 + slots)
    assert int(k.stats[S_XOVF]) == 1


@pytest.mark.gpu
def test_paxos_shut_gate_leaves_everything_as_it_was():
    """On a Paxos carry with its history stage, the gated step (K1-wide,
    K2, K3), K7 and K8 with the gate shut, launched alone and as the
    captured graph, change no counter, queue or log row, table, history
    table, hidx, hdone, step output or scratch word."""
    _need_card()
    from stateright_tpu_torch.checker.device_loop import (
        E_GATE, G_SIZE, I32_MAX, ChunkRunner, run_chunk, seed_carry)
    from stateright_tpu_torch.examples.paxos_packed import PackedPaxos
    from stateright_tpu_torch.ops.hashtable import table_insert
    from stateright_tpu_torch.ops.words import from_numpy_u32
    model = PackedPaxos(2)
    dev = torch.device("cuda")
    init = model.init_states()[0]
    fp = model.fingerprint(init)
    carry = seed_carry(model, 1 << 18, 1 << 17, [model.encode(init)], 0,
                       [fp], 1 << 12, dev, hcap=1 << 10)
    table_insert(carry.table,
                 from_numpy_u32(np.array([fp >> 32], np.uint32), dev),
                 from_numpy_u32(np.array([fp & 0xFFFFFFFF], np.uint32),
                                dev),
                 torch.ones((1,), dtype=torch.bool, device=dev))
    run_chunk(model, carry, fmax=512, steps=6)
    card = ChunkRunner(model, carry, 512).card()
    card.begin(0, I32_MAX, I32_MAX, carry.ws.step + 1)
    assert int(carry.ctr[carry.layout.ext + E_GATE + G_SIZE]) == 0
    for name in ("stats", "flat", "chi", "cvalid"):
        card.bufs[name].fill_(5)
    hist = carry.hist
    bufs = (carry.ctr, carry.q, carry.log, carry.table, hist.table,
            hist.hidx, hist.hdone, card.bufs["stats"], card.bufs["flat"],
            card.bufs["chi"], card.bufs["cvalid"], card.scratch["status"],
            card.scratch["ticket"], *card.hscratch.values())
    bufs = tuple(t for t in bufs if isinstance(t, torch.Tensor))
    before = [t.clone() for t in bufs]
    card.launch_steps()
    card.launch_append()
    card.launch_history()
    card.graph.replay(3)
    torch.cuda.synchronize()
    for t, b in zip(bufs, before):
        assert torch.equal(t, b)


@pytest.mark.gpu
def test_history_kernels_match_plain_versions_on_card():
    """K8 over a queue range (as in the chunk and the rescan) and over an
    index list without appending (the re-seed), against the plain
    version: the representatives in order, their count, the table's key
    set, the overflow flag (a 4-key table overflows); K9 in both count
    modes against its plain version, bit for bit."""
    _need_card()
    from stateright_tpu_torch.checker.device_loop import (
        history_reference, hpull_reference, new_history)
    from stateright_tpu_torch.examples.paxos_packed import PackedPaxos
    from stateright_tpu_torch.ops import _cuda
    from stateright_tpu_torch.ops.words import from_numpy_u32
    model = PackedPaxos(3)
    dev = torch.device("cuda")
    rng = np.random.default_rng(8)
    rows = _paxos_rows(model, rng, 5000)
    # a history word drawn from 64 values on half the rows: many fresh
    # keys, each repeated
    sel = rng.random(len(rows)) < 0.5
    rows[sel, model._hist_off + 1] = rng.integers(0, 64, int(sel.sum()))
    w = model.packed_width
    q = torch.zeros((len(rows) + 8, w + 3), dtype=torch.int32, device=dev)
    q[:len(rows), :w] = from_numpy_u32(rows, dev)
    for hcap in (1 << 14, 4):
        k = new_history(model, hcap, len(rows), 0, dev)
        p = new_history(model, hcap, len(rows), 0, dev)
        start, end = 17, len(rows)
        h_k, ovf_k = _cuda.history_insert(q, k, start=start, end=end,
                                          append=True, h_n=3)
        idx = torch.arange(start, end, dtype=torch.int64, device=dev)
        fresh, ovf_p = history_reference(q, p, idx)
        assert ovf_k == ovf_p == (hcap == 4)
        if hcap == 4:
            continue  # which keys an overflowing insert keeps may differ
        reps = idx[fresh].to(torch.int32)
        assert h_k == 3 + reps.shape[0]
        assert torch.equal(k.hidx[3:h_k], reps)
        assert torch.equal(torch.sort(k.table[k.table != 0]).values,
                           torch.sort(p.table[p.table != 0]).values)
        # the re-seed: the representatives into a fresh table, no append
        k2 = new_history(model, hcap, len(rows), 0, dev)
        h2, ovf2 = _cuda.history_insert(q, k2, index=reps, append=False,
                                        h_n=0)
        assert (h2, ovf2) == (0, False)
        assert torch.equal(torch.sort(k2.table[k2.table != 0]).values,
                           torch.sort(p.table[p.table != 0]).values)
        assert not k2.hidx.any()
    log = torch.from_numpy(rng.integers(0, 2 ** 31, (len(rows), 4)).astype(
        np.int32)).to(dev)
    hidx = torch.from_numpy(rng.integers(1, len(rows), 300).astype(
        np.int32)).to(dev)
    for count, rows_out in ((300, 256), (40, 64)):
        out = torch.full((rows_out, w + 2), -1, dtype=torch.int32,
                         device=dev)
        _cuda.hpull(q, hidx, log, 5, 1, out, count=count)
        want = hpull_reference(q, hidx, log, 5, count, 1, rows_out)
        assert torch.equal(out, want)
        h_n = torch.tensor([5 + count], dtype=torch.int32, device=dev)
        out.fill_(-1)
        _cuda.hpull(q, hidx, log, 5, 1, out, h_n=h_n)
        assert torch.equal(out, want)


def _k8_rows(case, rng):
    """PackedPaxos(3) rows (``_paxos_rows``, 5,000) with their history
    columns set for one K8 case: ``known``, ``replays``: 64 histories;
    ``one_fresh``: 64 histories and a 65th at rows 300, 1,700, 2,900 and
    4,999 (20 tiles of 256 rows: four blocks); ``thousands``: ~2,000
    histories, each repeated; ``late_overflow``: 4 histories and a 5th
    at row 4,999 only."""
    from stateright_tpu_torch.examples.paxos_packed import PackedPaxos
    model = PackedPaxos(3)
    rows = _paxos_rows(model, rng, 5000)
    hoff, hw = model.host_property_cols
    pool = rng.integers(0, 2 ** 32, (65, hw), dtype=np.uint64).astype(
        np.uint32)
    n_hist = {"known": 64, "replays": 64, "index": 64, "one_fresh": 64,
              "late_overflow": 4}.get(case)
    if n_hist is None:  # thousands
        rows[:, hoff:hoff + hw] = pool[rng.integers(0, 64, len(rows))]
        rows[:, hoff + 1] = rng.integers(0, 2000, len(rows))
    else:
        rows[:, hoff:hoff + hw] = pool[rng.integers(0, n_hist, len(rows))]
    if case == "one_fresh":
        rows[[300, 1700, 2900, 4999], hoff:hoff + hw] = pool[64]
    if case == "late_overflow":
        rows[4999, hoff:hoff + hw] = pool[64]
    return model, rows, pool[:n_hist or 64]


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["known", "one_fresh", "thousands",
                                  "late_overflow", "index", "replays"])
def test_history_kernel_cases_on_card(case):
    """K8 (a grid of lookups, each tile's absent rows compacted in row
    order, the last block inserting them) against ``history_reference``
    over 5,000 rows from ``h_n = 3``: ``known``, every key in the table
    already (``h_n`` and ``hidx`` unchanged, ``*start`` moved to
    ``*end``); ``one_fresh``, one new key whose rows fall in four blocks
    (its lowest row is the representative); ``thousands``, ~2,000 fresh
    keys repeated over the rows (representatives in row order, the key
    set); ``late_overflow``, a full one-bucket table whose only miss is
    the last row, in the last block (the overflow flag, the gate shut,
    nothing appended); ``index``, an index list in another order with
    repeats, appended and not; ``replays``, two replays of a captured
    graph of one launch, the state restored between them (the grid's
    arrival counter resets: the second replay's tail runs too)."""
    _need_card()
    from stateright_tpu_torch.checker.device_loop import (
        G_SIZE, history_reference, new_history)
    from stateright_tpu_torch.ops import _cuda
    from stateright_tpu_torch.ops.hash_kernel import fp64_device
    from stateright_tpu_torch.ops.words import from_numpy_u32
    dev = torch.device("cuda")
    rng = np.random.default_rng(31)
    model, rows, seed_hist = _k8_rows(case, rng)
    n, w = len(rows), model.packed_width
    q = torch.zeros((n + 8, w + 3), dtype=torch.int32, device=dev)
    q[:n, :w] = from_numpy_u32(rows, dev)
    hcap = 4 if case == "late_overflow" else 1 << 14
    k = new_history(model, hcap, n, 0, dev)
    p = new_history(model, hcap, n, 0, dev)
    if case in ("known", "one_fresh", "late_overflow", "replays"):
        # the table holds the seed histories' keys
        hi, lo = fp64_device(from_numpy_u32(seed_hist, dev))
        for st in (k, p):
            _cuda.table_insert(st.table, hi, lo, torch.ones(
                (hi.shape[0],), dtype=torch.bool, device=dev), None,
                st.max_rounds, mask=False)

    def sorted_keys(st):
        return torch.sort(st.table[st.table != 0]).values

    if case == "index":
        idx = torch.from_numpy(rng.integers(0, n, 3000).astype(
            np.int64)).to(dev)
        fresh, ovf_p = history_reference(q, p, idx)
        h_k, ovf_k = _cuda.history_insert(q, k, index=idx, append=True,
                                          h_n=3)
        reps = idx[fresh].to(torch.int32)
        assert (h_k, ovf_k, ovf_p) == (3 + reps.shape[0], False, False)
        assert torch.equal(k.hidx[3:h_k], reps)
        assert torch.equal(sorted_keys(k), sorted_keys(p))
        k2 = new_history(model, hcap, n, 0, dev)
        assert _cuda.history_insert(q, k2, index=idx, append=False,
                                    h_n=3) == (3, False)
        assert not k2.hidx.any()
        assert torch.equal(sorted_keys(k2), sorted_keys(p))
        return
    start, end = 0, n
    table0 = k.table.clone()
    ctl = torch.tensor([start, end, 3, 0], dtype=torch.int32, device=dev)
    gate = torch.tensor([2, 0, 0, 0, 0, 0, 0], dtype=torch.int32,
                        device=dev)
    scratch = _cuda.history_scratch(n, dev)
    args = _cuda._hist_args(q, k, scratch)
    base = ctl.data_ptr()
    args.start, args.end, args.h_n, args.ovf = (base, base + 4, base + 8,
                                                base + 12)
    args.hidx = k.hidx.data_ptr()
    args.gate = gate.data_ptr()
    idx = torch.arange(start, end, dtype=torch.int64, device=dev)
    fresh, ovf_p = history_reference(q, p, idx)
    reps = idx[fresh].to(torch.int32)

    def check():
        got_start, got_end, h_k, ovf_k = ctl.tolist()
        assert (got_start, got_end) == (end, end)
        assert not scratch["ctl"].any()
        assert bool(ovf_k) == ovf_p == (case == "late_overflow")
        assert int(gate[G_SIZE]) == (0 if ovf_p else 2)
        if ovf_p:  # the only miss overflowed: nothing fresh to append
            assert h_k == 3 and not k.hidx.any()
            return
        assert h_k == 3 + reps.shape[0]
        assert torch.equal(k.hidx[3:h_k], reps)
        assert torch.equal(sorted_keys(k), sorted_keys(p))

    if case != "replays":
        _cuda.history(args, dev)
        torch.cuda.synchronize()
        check()
        if case == "known":
            assert reps.shape[0] == 0 and not k.hidx.any()
        if case == "one_fresh":
            assert reps.tolist() == [300]
        if case == "thousands":
            assert reps.shape[0] > 1000
        return
    # two replays of a captured graph of one launch, restored between
    _cuda.history(args, dev)  # loads the kernel outside the capture
    graph = _cuda.ChunkGraph(lambda: _cuda.history(args, dev), dev)
    for _turn in range(2):
        k.table.copy_(table0)
        k.hidx.zero_()
        ctl.copy_(torch.tensor([start, end, 3, 0], dtype=torch.int32))
        graph.replay(1)
        torch.cuda.synchronize()
        check()


@pytest.mark.gpu
@pytest.mark.parametrize("hcap", [1 << 16, 4])
def test_paxos2_end_to_end_on_card(hcap):
    """``PackedPaxos(2).checker().spawn_gpu()`` on the card alone: the
    JAX package's count and digest, ``linearizable`` holds, ``value
    chosen`` replays; K1-K3, K7, K8 and K9 launched; from a 4-key
    history table the stage grows and rescans to the same answer."""
    _need_card()
    import hashlib
    from stateright_tpu_torch.examples.paxos_packed import PackedPaxos
    from stateright_tpu_torch.ops import _cuda
    before = dict(_cuda.LAUNCHES)
    ck = PackedPaxos(2).checker().gpu_options(race=False, hcap=hcap) \
        .spawn_gpu().join()
    launched = {k: _cuda.LAUNCHES[k] - before[k] for k in before}
    fps = np.array(sorted(ck.generated_fingerprints()), dtype=np.uint64)
    digest = hashlib.sha256(fps.astype("<u8").tobytes()).hexdigest()
    assert (ck.unique_state_count(), ck.state_count(), digest) == \
        _chip_smoke().PIN_PAXOS2
    ck.assert_no_discovery("linearizable")
    ck.assert_any_discovery("value chosen")
    for name in ("fused_step", "append", "chunk_begin", "history", "hpull"):
        assert launched[name] > 0, name
    assert ck.profile()["h_n"] == 5
    if hcap == 4:
        assert ck.profile()["hgrow"] >= 1


# --- the register family (ABD on both networks, the single-copy register)

#: the register configurations of the card's K1 checks: the BASELINE's
#: ordered ABD (108 words), bench.py's abd3 (260) and tpu_abd2 (331),
#: ABD on the unordered network (82) and the single-copy register (79;
#: and with two servers, 84)
REGISTER_MODELS = {
    "abd2-ordered": lambda: _abd(2, ordered=True),
    "abd3-ordered": lambda: _abd(3, server_count=2, ordered=True,
                                 channel_depth=8),
    "abd2-s3-ordered": lambda: _abd(2, server_count=3, ordered=True,
                                    channel_depth=8),
    "abd2": lambda: _abd(2),
    "single-copy3": lambda: _single_copy(3),
    "single-copy4-2": lambda: _single_copy(4, 2),
    # crash/restart lanes: the write-once register (the group K1 with
    # crash lanes; volatile: the crash wipes the server's word) and
    # Paxos (the wide K1 with crash lanes)
    "write-once2": lambda: _write_once(2),
    "write-once4-volatile": lambda: _write_once(4, durable=False),
    "write-once7": lambda: _write_once(7, net_capacity=16, crashes=2),
    "paxos1-crash": lambda: _paxos_crash(1),
    "paxos2-crash": lambda: _paxos_crash(2),
    "paxos3-crash": lambda: _paxos_crash(3),
}


def _abd(*args, **kw):
    from stateright_tpu_torch.examples.abd_packed import PackedAbd
    return PackedAbd(*args, **kw)


def _single_copy(*args):
    from stateright_tpu_torch.examples.single_copy_packed import \
        PackedSingleCopy
    return PackedSingleCopy(*args)


def _write_once(*args, crashes=1, **kw):
    from stateright_tpu_torch.examples.write_once_packed import \
        PackedWriteOnce
    return PackedWriteOnce(*args, **kw).crash_restart(crashes, actors=[0])


def _paxos_crash(clients):
    from stateright_tpu_torch.examples.paxos_packed import PackedPaxos
    return PackedPaxos(clients).crash_restart(1, actors=[0, 1, 2])


def _crash_cases(model, rows, rng):
    """``rows`` of a model with crash lanes, a third with a crashable
    actor put down (its count at least one) and a third with one at its
    crash budget (up or down): rows whose crash lanes are spent and whose
    deliveries to the down actor wait."""
    idx = model._crash_idx
    for i in range(rows.shape[0]):
        case = rng.integers(0, 3)
        if case == 0:
            continue
        a = int(idx[rng.integers(0, len(idx))])
        cw = int(rows[i, model._crash_off])
        count = max(1, (cw >> (4 * a)) & 7) if case == 1 \
            else model.max_crashes_
        cw = (cw & ~(0xF << (4 * a))) | (count << (4 * a))
        if case == 1 or rng.random() < 0.5:
            cw |= 1 << (4 * a + 3)
        rows[i, model._crash_off] = cw
    return rows


@pytest.mark.gpu
@pytest.mark.parametrize("name,f", [
    ("abd2-ordered", 1000), ("abd3-ordered", 2048),
    ("abd2-s3-ordered", 4096), ("abd2", 1000), ("single-copy3", 1000),
    ("single-copy4-2", 333), ("write-once2", 1000),
    ("write-once4-volatile", 777), ("write-once7", 2048),
    ("paxos1-crash", 1000), ("paxos2-crash", 1000), ("paxos3-crash", 8192)])
def test_register_step_lane_exact_on_card(name, f):
    """K1's register instantiations with K2/K3 against the plain version
    over ``_paxos_rows`` (crowded networks, junk rows, a tenth of the
    rows invalid), under K1's rule (:func:`_k1_held`): the ordered
    network's (the edit K1) children and their fingerprints on every
    lane of a non-empty channel, K1 leaving an empty channel's lane
    unwritten (the plain version writes the JAX package's junk row
    there, invalid), cvalid, the properties, terminal and the flags on
    every lane; the unordered ones' (the group K1, which steps the
    pending rows only) on the pending rows' lanes below the quiet lane,
    whose rows of flat are left unwritten, the properties on the pending
    rows, cvalid, terminal and the flags everywhere. A model with crash
    lanes (rows with an actor up, down and at its crash budget,
    :func:`_crash_cases`): bit for bit on its active lanes (the junk
    rows of its other lanes, invalid and not overflowing, unwritten),
    cvalid and the flags everywhere. Then the inserted key set and the
    table."""
    _need_card()
    from stateright_tpu_torch.ops.fused import (S_DISC, S_VALID, S_XOVF,
                                                fused_step,
                                                fused_step_reference)
    from stateright_tpu_torch.ops.hash_kernel import fp64_device
    from stateright_tpu_torch.ops.hashtable import make_table
    from stateright_tpu_torch.ops.words import from_numpy_u32, pack64
    model = REGISTER_MODELS[name]()
    dev = torch.device("cuda")
    rng = np.random.default_rng(f)
    rows = _paxos_rows(model, rng, f)
    if model.max_crashes_:
        rows = _crash_cases(model, rows, rng)
    block = from_numpy_u32(rows, dev)
    phi, plo = (x.to(torch.int32) for x in fp64_device(block))
    ebits = torch.zeros((f,), dtype=torch.int32, device=dev)
    fvalid = torch.from_numpy(rng.random(f) < 0.9).to(dev)
    out, tables = [], []
    for fn in (fused_step, fused_step_reference):
        table = make_table(1 << 18, dev)
        ring = torch.zeros((1 << 12,), dtype=torch.int64, device=dev)
        out.append(fn(model, block, ebits, fvalid, phi, plo, table, ring))
        tables.append(sorted(table[table != 0].tolist()))
    k, p = out
    written = _hold_k1(model, k, p, rows, fvalid)
    assert int(written.sum()) < written.numel()  # quiet or empty lanes
    for i in (S_XOVF, S_VALID):
        assert int(k.stats[i]) == int(p.stats[i]), i
    assert torch.equal(k.stats[S_DISC:], p.stats[S_DISC:])
    if model._net_ordered or model.server_count > 2:
        assert int(k.stats[S_XOVF]) == 1  # the crowded rows overflow
    key_k = pack64(k.chi, k.clo)[k.inserted].tolist()
    key_p = pack64(p.chi, p.clo)[p.inserted].tolist()
    assert len(key_k) == len(set(key_k)) and set(key_k) == set(key_p)
    assert tables[0] == tables[1]


def _wrap_counts(model, rows, rng):
    """``rows`` with about a quarter of their occupied unordered slots
    given the count 0 or 0xFFFFFFFF: delivering the first wraps it (and
    the shift overwrites it), a send matching the second wraps it to 0."""
    e = model.net_capacity
    for i in range(rows.shape[0]):
        slots = rows[i, model._net_off:model._timer_off].reshape(e, 4)
        for j in np.flatnonzero((slots[:, 0] >> 16) & 1):
            if rng.random() < 0.25:
                slots[j, 1] = 0 if rng.random() < 0.5 else 0xFFFFFFFF
    return rows


#: the gated steps of the shared-row K1s: (model, rows, rows pending,
#: case): the group K1 at the register family's steps (PackedAbd(2)'s
#: 256-row step with 54 pending, single-copy 3's 9,954-row step with
#: ~588, 512 of 512), with no row pending, with counts that wrap, and
#: the wide (Paxos, the ping-pong fixture: lossy with drop lanes or
#: lossless, and a small network whose sends overflow) and edit (ordered
#: ABD) K1s, gated over every row of their tiles
GATED_STEPS = [
    ("abd2", 256, 54, "mixed"), ("single-copy3", 9954, 588, "mixed"),
    ("single-copy3", 512, 512, "mixed"), ("single-copy4-2", 1000, 0,
                                          "mixed"),
    ("abd2", 1000, 999, "wrap"), ("single-copy3", 333, 200, "wrap"),
    ("paxos2", 1000, 611, "mixed"), ("abd3-ordered", 1728, 500, "mixed"),
    ("abd2-ordered", 256, 0, "mixed"), ("write-once7", 256, 200, "mixed"),
    ("write-once7", 1024, 1024, "mixed"), ("write-once2", 333, 0, "wrap"),
    ("paxos3-crash", 8192, 5000, "mixed"), ("paxos2-crash", 256, 0,
                                            "wrap"),
    ("ping-pong7-lossy-dup", 8192, 5000, "mixed"),
    ("ping-pong7-lossy", 1000, 0, "mixed"), ("ping-pong7-dup", 777, 300,
                                             "mixed"),
    ("ping-pong6-e3", 333, 200, "mixed"), ("timer-count8", 256, 2, "mixed")]


@pytest.mark.gpu
@pytest.mark.parametrize("name,f,take,case", GATED_STEPS,
                         ids=[f"{n}-{f}-{t}-{c}" for n, f, t, c in
                              GATED_STEPS])
def test_shared_row_k1_gated_lane_exact_on_card(name, f, take, case):
    """A shared-row or timer K1 (with K2/K3) launched as the search
    launches it, gated with the first ``take`` of ``f`` rows pending
    (``chip_smoke.py`` ``gated_step``: a group or timer K1's blocks spread
    over the pending rows),
    against the plain version with those rows valid, under K1's rule
    (:func:`_k1_held`): the rows past ``take`` get cvalid 0 and terminal
    0 (and from a group K1 nothing else); on ``_paxos_rows`` (crowded
    networks whose sends overflow into the poison child, junk rows),
    with ``wrap`` counts that wrap on a delivery or a send. Then the
    stats, the discoveries, the inserted key set and the table."""
    _need_card()
    from stateright_tpu_torch.examples.paxos_packed import PackedPaxos
    from stateright_tpu_torch.ops.fused import (S_DISC, S_INSERTED, S_VALID,
                                                S_XOVF, StepWorkspace,
                                                fused_step_reference)
    from stateright_tpu_torch.ops.hash_kernel import fp64_device
    from stateright_tpu_torch.ops.hashtable import make_table
    from stateright_tpu_torch.ops.words import from_numpy_u32, pack64
    smoke = _chip_smoke()
    fixture = name.startswith(("ping-pong", "timer-count"))
    model = (PackedPaxos(2) if name == "paxos2" else _fixture(name)
             if fixture else REGISTER_MODELS[name]())
    dev = torch.device("cuda")
    rng = np.random.default_rng([f, take])
    rows = (_fixture_rows(model, rng, f) if fixture
            else _paxos_rows(model, rng, f))
    if case == "wrap":
        rows = _wrap_counts(model, rows, rng)
    if model.max_crashes_:
        rows = _crash_cases(model, rows, rng)
    block = from_numpy_u32(rows, dev)
    phi, plo = (x.to(torch.int32) for x in fp64_device(block))
    ebits = torch.from_numpy(rng.integers(0, 4, f).astype(np.int32)).to(dev)
    fvalid = torch.arange(f, device=dev) < take
    args = (block, ebits, fvalid, phi, plo)
    out, tables = [], []
    for gated in (True, False):
        table = make_table(1 << 18, dev)
        ring = torch.zeros((1 << 12,), dtype=torch.int64, device=dev)
        if gated:
            ws = StepWorkspace(table.numel(), ring.shape[0],
                               len(model.properties()), dev)
            launch, _gate = smoke.gated_step(model, args, table, ring, ws,
                                             take)
            out.append(launch())
        else:
            out.append(fused_step_reference(model, *args, table, ring))
        tables.append(sorted(table[table != 0].tolist()))
    k, p = out
    _hold_k1(model, k, p, rows, fvalid)
    for i in (S_XOVF, S_VALID, S_INSERTED):
        assert int(k.stats[i]) == int(p.stats[i]), i
    assert torch.equal(k.stats[S_DISC:], p.stats[S_DISC:])
    assert not k.cvalid[take * model.max_actions:].any()
    if take == 0:
        assert int(k.stats[S_VALID]) == 0
    elif fixture:
        if name == "ping-pong6-e3":
            assert int(k.stats[S_XOVF]) == 1  # its sends overflow
    elif case == "mixed" and (name == "paxos2" or model._net_ordered
                              or model.server_count > 2):
        assert int(k.stats[S_XOVF]) == 1  # the crowded rows overflow
    key_k = pack64(k.chi, k.clo)[k.inserted].tolist()
    key_p = pack64(p.chi, p.clo)[p.inserted].tolist()
    assert len(key_k) == len(set(key_k)) and set(key_k) == set(key_p)
    assert tables[0] == tables[1]


def _crash_edge_rows(model, rows, case, rng):
    """``rows`` of a model with crash lanes set up for one of
    ``CRASH_EDGES``' cases: ``every-crash`` every crashable actor up with
    no crash yet (every crash lane active, and in half the rows the
    actor's timer bit set, which a crash clears), ``every-restart`` every
    one down after a crash (every restart lane active, the deliveries to
    them waiting), ``spent`` every one up at its crash budget (no crash
    or restart lane), ``wipe`` the volatile server up with a stored value
    and its timer bit set (its crash changes three words: the value wiped,
    the timer and crash words), ``overflow`` a full network whose first
    slot is a client's Put to the server held twice (its delivery's reply
    finds no slot: the poisoned child)."""
    rows = rows.copy()
    idx = [int(a) for a in model._crash_idx]
    k = model.max_crashes_
    cw = 0
    if case == "every-restart":
        cw = sum((8 | 1) << (4 * a) for a in idx)
    elif case == "spent":
        cw = sum(k << (4 * a) for a in idx)
    rows[:, model._crash_off] = cw
    timers = sum(1 << a for a in idx)
    if case == "every-crash":
        rows[::2, model._timer_off] |= timers
    if case == "wipe":
        rows[:, 0] = rng.integers(1, 16, rows.shape[0])
        rows[:, model._timer_off] |= 1
    if case == "overflow":
        e = model.net_capacity
        for i in range(rows.shape[0]):
            slots = rows[i, model._net_off:model._timer_off].reshape(e, 4)
            slots[0] = ((1 << 16) | (1 << 8), 2, (1 << 24) | (i % 7 + 1), 0)
            for j in range(1, e):
                slots[j] = ((1 << 16) | (7 << 8) | (20 + j), 1, 14 << 24, j)
    return rows


#: the edge cases of the crash K1s: (model, rows, case)
CRASH_EDGES = [
    ("paxos3-crash", 2048, "every-crash"),
    ("paxos3-crash", 2048, "every-restart"),
    ("paxos3-crash", 2048, "spent"),
    ("write-once7", 1024, "every-crash"),
    ("write-once7", 1024, "every-restart"),
    ("write-once7", 1024, "spent"),
    ("write-once4-volatile", 777, "wipe"),
    ("write-once7", 1024, "overflow"),
    ("write-once4-volatile", 333, "overflow")]


@pytest.mark.gpu
@pytest.mark.parametrize("name,f,case", CRASH_EDGES,
                         ids=[f"{n}-{c}" for n, _f, c in CRASH_EDGES])
def test_crash_k1_edge_rows_lane_exact_on_card(name, f, case):
    """K1-paxos_crash (a delivery staged by a thread, each crash or
    restart child's edit and fingerprint by a thread and its words by a
    warp) and K1-write_once (each active lane in two phases: a thread's
    record or crash edit, then a group's child) with K2/K3 against the
    plain version on :func:`_crash_edge_rows` (every crash lane active,
    so that a Paxos block's crash children outnumber its warps; every
    restart lane; spent budgets; the volatile register's three-word
    crash child; the poisoned delivery), under K1's rule
    (:func:`_k1_held`), then the flags, the inserted key set and the
    table."""
    _need_card()
    from stateright_tpu_torch.ops import _cuda
    from stateright_tpu_torch.ops.fused import (S_DISC, S_VALID, S_XOVF,
                                                fused_step,
                                                fused_step_reference)
    from stateright_tpu_torch.ops.hash_kernel import fp64_device
    from stateright_tpu_torch.ops.hashtable import make_table
    from stateright_tpu_torch.ops.words import from_numpy_u32, pack64
    model = REGISTER_MODELS[name]()
    dev = torch.device("cuda")
    rng = np.random.default_rng([f, len(case)])
    rows = _crash_edge_rows(model, _paxos_rows(model, rng, f), case, rng)
    block = from_numpy_u32(rows, dev)
    phi, plo = (x.to(torch.int32) for x in fp64_device(block))
    ebits = torch.zeros((f,), dtype=torch.int32, device=dev)
    fvalid = torch.ones((f,), dtype=torch.bool, device=dev)
    out, tables = [], []
    for fn in (fused_step, fused_step_reference):
        table = make_table(1 << 18, dev)
        ring = torch.zeros((1 << 12,), dtype=torch.int64, device=dev)
        out.append(fn(model, block, ebits, fvalid, phi, plo, table, ring))
        tables.append(sorted(table[table != 0].tolist()))
    k, p = out
    lanes = _hold_k1(model, k, p, rows, fvalid)
    for i in (S_XOVF, S_VALID):
        assert int(k.stats[i]) == int(p.stats[i]), i
    assert torch.equal(k.stats[S_DISC:], p.stats[S_DISC:])
    key_k = pack64(k.chi, k.clo)[k.inserted].tolist()
    key_p = pack64(p.chi, p.clo)[p.inserted].tolist()
    assert len(key_k) == len(set(key_k)) and set(key_k) == set(key_p)
    assert tables[0] == tables[1]
    # the case took: its lanes active, its children as described
    a, e, n = model.max_actions, model.net_capacity, len(model._crash_idx)
    act = lanes.reshape(f, a).cpu().numpy()
    crash, restart = act[:, e:e + n], act[:, e + n:]
    if case in ("every-crash", "wipe"):
        assert crash.all() and not restart.any()
    elif case == "every-restart":
        assert restart.all() and not crash.any()
    elif case == "spent":
        assert not crash.any() and not restart.any()
    if case == "every-crash" and name.startswith("paxos"):
        wide, _smem = _cuda.k1_launch(
            "paxos_crash", _cuda.tile_geometry(f, a, _cuda.sm_count(dev)),
            f, model.packed_width, a, _cuda.sm_count(dev))
        assert wide.rows * n > wide.threads // 32
    flat = k.flat.reshape(f, a, -1).cpu().numpy().view(np.uint32)
    if case == "wipe":
        changed = (flat[:, e, :] != rows).sum(1)
        assert (changed == 3).all() and (flat[:, e, 0] == 0).all()
    if case == "overflow":
        assert int(k.stats[S_XOVF]) == 1
        poisoned = (flat[:, 0, :] == 0xDEADBEEF).all(1) & act[:, 0]
        assert poisoned.any()
        assert not k.cvalid.reshape(f, a)[torch.from_numpy(poisoned).to(
            dev), 0].any()


@pytest.mark.gpu
def test_append_history_and_pull_at_331_words_on_card():
    """bench.py's widest register row (PackedAbd(2, server_count=3,
    ordered=True, channel_depth=8): 331 words, wider than K7's block of
    256 threads): after a real gated step at 4,096 rows of a mid-search
    carry, K7 against ``append_reference`` (counters, the next gate and
    the 334-word most recent row among them, stats, queue and log bit for
    bit); K8 over the rows it appended against ``history_reference``; K9
    over them against ``hpull_reference``."""
    _need_card()
    from stateright_tpu_torch.checker.device_loop import (
        B_Q_TAIL, E_FAULT, E_GATE, G_SIZE, I32_MAX, ChunkRunner,
        append_reference, history_reference, hpull_reference, new_history,
        step_sizes)
    from stateright_tpu_torch.ops import _cuda
    from stateright_tpu_torch.ops.fused import S_INSERTED
    model = REGISTER_MODELS["abd2-s3-ordered"]()
    assert model.packed_width == 331
    dev = torch.device("cuda")
    f = 4096
    carry = _mid_search(model, f, False, dev)
    lay = carry.layout
    f_small, f_large, qmargin = step_sizes(model, f)
    card = ChunkRunner(model, carry, f).card()
    carry.ws.step += 1
    card.begin(1, I32_MAX, I32_MAX, carry.ws.step)
    card.launch_steps()
    size = int(carry.ctr[lay.ext + E_GATE + G_SIZE])
    out = card.outputs(size)
    stats = out.stats.clone()
    start = (carry.ctr.clone(), carry.q.clone(), carry.log.clone(), stats)
    tail0 = int(carry.ctr[B_Q_TAIL])
    card.launch_append()
    got = (carry.ctr.clone(), carry.q.clone(), carry.log.clone(),
           out.stats.clone())
    for t, v in zip((carry.ctr, carry.q, carry.log, out.stats), start):
        t.copy_(v)
    append_reference(carry.ctr, lay, carry.q, carry.log, out,
                     model.max_actions, f_small, f_large,
                     carry.q.shape[0] - qmargin)
    for x, y in zip(got, (carry.ctr, carry.q, carry.log, out.stats)):
        assert torch.equal(x, y)
    cnt = int(out.inserted.sum())
    assert cnt == int(stats[S_INSERTED]) > 0
    tail = int(got[0][B_Q_TAIL])
    assert tail - tail0 == cnt
    assert int(got[0][lay.ext + E_FAULT]) == 0
    # K8 and K9 over the appended 331-word rows
    q = carry.q
    k = new_history(model, 1 << 12, q.shape[0], 0, dev)
    p = new_history(model, 1 << 12, q.shape[0], 0, dev)
    h_k, ovf_k = _cuda.history_insert(q, k, start=tail0, end=tail,
                                      append=True, h_n=0)
    idx = torch.arange(tail0, tail, dtype=torch.int64, device=dev)
    fresh, ovf_p = history_reference(q, p, idx)
    reps = idx[fresh].to(torch.int32)
    assert not ovf_k and not ovf_p and h_k == reps.shape[0] > 0
    assert torch.equal(k.hidx[:h_k], reps)
    assert torch.equal(torch.sort(k.table[k.table != 0]).values,
                       torch.sort(p.table[p.table != 0]).values)
    w = model.packed_width
    outk = torch.full((256, w + 2), -1, dtype=torch.int32, device=dev)
    _cuda.hpull(q, k.hidx, carry.log, 0, 1, outk, count=h_k)
    assert torch.equal(outk, hpull_reference(q, k.hidx, carry.log, 0, h_k,
                                             1, 256))


@pytest.mark.gpu
@pytest.mark.parametrize("name,pin", [
    ("abd2-ordered", "PIN_ABD2_ORDERED"), ("abd3-ordered", "PIN_ABD3"),
    ("single-copy3", "PIN_SC3")])
def test_register_end_to_end_on_card(name, pin):
    """``spawn_gpu()`` on the card alone: the JAX package's count,
    generated count and digest (``chip_smoke.py``'s ``pin``);
    ``linearizable`` holds and ``value chosen`` replays; K1-K3, K7, K8
    and K9 launched."""
    _need_card()
    pin = getattr(_chip_smoke(), pin)
    import hashlib
    from stateright_tpu_torch.ops import _cuda
    model = REGISTER_MODELS[name]()
    before = dict(_cuda.LAUNCHES)
    ck = model.checker().gpu_options(race=False).spawn_gpu().join()
    launched = {k: _cuda.LAUNCHES[k] - before[k] for k in before}
    fps = np.array(sorted(ck.generated_fingerprints()), dtype=np.uint64)
    digest = hashlib.sha256(fps.astype("<u8").tobytes()).hexdigest()
    assert (ck.unique_state_count(), ck.state_count(), digest) == pin
    ck.assert_no_discovery("linearizable")
    path = ck.assert_any_discovery("value chosen")  # replays or raises
    assert model.property("value chosen").condition(model,
                                                    path.last_state())
    for kernel in ("fused_step", "append", "chunk_begin", "history",
                   "hpull"):
        assert launched[kernel] > 0, kernel


@pytest.mark.gpu
@pytest.mark.parametrize("name,pin", [
    ("write-once2", "PIN_WO2"), ("write-once7", "PIN_WO7"),
    ("paxos1-crash", "PIN_PAXOS1_CRASH")])
def test_crash_end_to_end_on_card(name, pin):
    """Crash/restart fault injection through ``spawn_gpu()`` on the card
    alone: the JAX package's count, generated count and digest
    (``chip_smoke.py``'s ``pin``); ``linearizable`` holds and ``value
    chosen`` replays; K1-K3, K7, K8 and K9 launched."""
    test_register_end_to_end_on_card(name, pin)


def _paxos_lossy(clients):
    from stateright_tpu_torch.examples.paxos_packed import PackedPaxos
    return PackedPaxos(clients).lossy_network(True)


def _with_counts(model, rows, rng):
    """``rows`` with the count of about a third of their occupied network
    slots raised to 2 or 3: a drop there keeps the slot, count less
    one."""
    rows = rows.copy()
    e = model.net_capacity
    for row in rows:
        net = row[model._net_off:model._net_off + 4 * e].reshape(e, 4)
        bump = (net[:, 0] != 0) & (rng.random(e) < 0.3)
        net[bump, 1] = rng.integers(2, 4, int(bump.sum()))
    return rows


@pytest.mark.gpu
@pytest.mark.parametrize("clients,f", [(1, 64), (2, 2000), (3, 8192)])
def test_lossy_paxos_k1_lane_exact_on_card(clients, f):
    """K1-paxos_lossy (a delivery staged by a thread as K1-paxos's, each
    drop child's edit and fingerprint by a thread and its words by a
    warp) with K2/K3 against the plain version on crowded, junk and
    multi-copy rows, under K1's rule (:func:`_k1_held`: the deliveries
    and drops before the network's zero tail), then the flags, the
    inserted key set and the table."""
    _need_card()
    from stateright_tpu_torch.ops.fused import (S_DISC, S_VALID, S_XOVF,
                                                fused_step,
                                                fused_step_reference)
    from stateright_tpu_torch.ops.hash_kernel import fp64_device
    from stateright_tpu_torch.ops.hashtable import make_table
    from stateright_tpu_torch.ops.words import from_numpy_u32, pack64
    model = _paxos_lossy(clients)
    dev = torch.device("cuda")
    rng = np.random.default_rng([clients, f])
    rows = _with_counts(model, _paxos_rows(model, rng, f), rng)
    block = from_numpy_u32(rows, dev)
    phi, plo = (x.to(torch.int32) for x in fp64_device(block))
    ebits = torch.zeros((f,), dtype=torch.int32, device=dev)
    fvalid = torch.from_numpy(rng.random(f) < 0.9).to(dev)
    out, tables = [], []
    for fn in (fused_step, fused_step_reference):
        table = make_table(1 << 18, dev)
        ring = torch.zeros((1 << 12,), dtype=torch.int64, device=dev)
        out.append(fn(model, block, ebits, fvalid, phi, plo, table, ring))
        tables.append(sorted(table[table != 0].tolist()))
    k, p = out
    lanes = _hold_k1(model, k, p, rows, fvalid)
    e = model.net_capacity
    # drop lanes written, with kept and shifted slots among them
    assert lanes.reshape(f, 2 * e)[:, e:].any()
    for i in (S_XOVF, S_VALID):
        assert int(k.stats[i]) == int(p.stats[i]), i
    assert torch.equal(k.stats[S_DISC:], p.stats[S_DISC:])
    key_k = pack64(k.chi, k.clo)[k.inserted].tolist()
    key_p = pack64(p.chi, p.clo)[p.inserted].tolist()
    assert len(key_k) == len(set(key_k)) and set(key_k) == set(key_p)
    assert tables[0] == tables[1]


def _fixture(name):
    from stateright_tpu_torch.actor.test_util import (PackedPingPong,
                                                      PackedTimerCount)
    return {
        "ping-pong7-lossy-dup": lambda: PackedPingPong(7, True, True),
        "ping-pong7-lossy": lambda: PackedPingPong(7, True, False),
        "ping-pong7-dup": lambda: PackedPingPong(7, False, True),
        "ping-pong7": lambda: PackedPingPong(7, False, False),
        "ping-pong6-e3": lambda: PackedPingPong(6, True, True,
                                                net_capacity=3),
        "timer-count8": lambda: PackedTimerCount(8, 4),
        "timer-count32": lambda: PackedTimerCount(32, 2),
        "timer-count32-all": lambda: PackedTimerCount(32, 2),
    }[name]()


def _fixture_rows(model, rng, f):
    """``f`` rows of a narrow fixture: states of a host BFS within the
    boundary (a state whose network outgrows the encoding skipped), drawn
    with replacement, a tenth of them random words and a tenth small
    random words (the handlers' and the network's edge cases)."""
    seen, states, queue = set(), [], list(model.init_states())
    while queue and len(states) < 3000:
        s = queue.pop(0)
        if not model.within_boundary(s):
            continue
        try:
            enc = model.encode(s)
        except ValueError:
            continue
        if enc.tobytes() not in seen:
            seen.add(enc.tobytes())
            states.append(enc)
            queue.extend(model.next_states(s))
    rows = np.stack([states[i] for i in rng.integers(0, len(states), f)])
    w = model.packed_width
    junk = rng.random(f) < 0.1
    rows[junk] = rng.integers(0, 2 ** 32, (int(junk.sum()), w),
                              dtype=np.uint64).astype(np.uint32)
    small = rng.random(f) < 0.1
    rows[small] = rng.integers(0, 8, (int(small.sum()), w),
                               dtype=np.uint64).astype(np.uint32)
    return rows.astype(np.uint32)


@pytest.mark.gpu
@pytest.mark.parametrize("name,f", [
    ("ping-pong7-lossy-dup", 8192), ("ping-pong7-lossy", 1000),
    ("ping-pong7-dup", 777), ("ping-pong7", 64), ("ping-pong6-e3", 333),
    ("timer-count8", 8192), ("timer-count32", 1237),
    ("timer-count32-all", 500)])
def test_narrow_fixture_k1_lane_exact_on_card(name, f):
    """K1-ping_pong (the four network quadrants; a small network whose
    sends overflow) and K1-timer_count (a Timeout lane per actor, up to
    32; ``-all``: every timer bit set, 33 lanes of which 32 active) with
    K2/K3 against the plain version, under K1's rule (:func:`_k1_held`):
    the lossy K1-ping_pong, on the shared-row path with drop lanes,
    writes the children, chi and clo of its active lanes
    (``chip_smoke.py`` ``lossy_active``: the deliveries and drops before
    the network's zero tail), which are held there; K1-timer_count those
    of its pending rows' Timeout lanes whose timer bit is set
    (``timer_active``), held there; the lossless K1-ping_pong writes and
    is held on every lane; cvalid and terminal everywhere, the property
    and eventually bits on the rows K1 steps. Then the flags, the
    inserted key set and the table."""
    _need_card()
    from stateright_tpu_torch.ops.fused import (S_DISC, S_VALID, S_XOVF,
                                                fused_step,
                                                fused_step_reference)
    from stateright_tpu_torch.ops.hash_kernel import fp64_device
    from stateright_tpu_torch.ops.hashtable import make_table
    from stateright_tpu_torch.ops.words import from_numpy_u32, pack64
    model = _fixture(name)
    dev = torch.device("cuda")
    rng = np.random.default_rng([f, len(name)])
    rows = _fixture_rows(model, rng, f)
    if name.endswith("-all"):
        rows[:, model._timer_off] = 0xFFFFFFFF
    block = from_numpy_u32(rows, dev)
    phi, plo = (x.to(torch.int32) for x in fp64_device(block))
    ebits = torch.from_numpy(rng.integers(0, 16, f).astype(np.int32)).to(dev)
    fvalid = torch.from_numpy(rng.random(f) < 0.9).to(dev)
    out, tables = [], []
    for fn in (fused_step, fused_step_reference):
        table = make_table(1 << 18, dev)
        ring = torch.zeros((1 << 12,), dtype=torch.int64, device=dev)
        out.append(fn(model, block, ebits, fvalid, phi, plo, table, ring))
        tables.append(sorted(table[table != 0].tolist()))
    k, p = out
    lanes = _hold_k1(model, k, p, rows, fvalid)
    if name.startswith("timer-count"):
        # the delivery lanes, and the Timeout lanes of clear timer bits
        assert int(lanes.sum()) < lanes.numel()
        if name.endswith("-all"):
            held = lanes.reshape(f, model.max_actions)[fvalid]
            assert bool(held[:, 1:].all()) and not held[:, 0].any()
    elif model.lossy_network_:
        assert int(lanes.sum()) < lanes.numel()  # lanes past the zero tail
    else:
        assert bool(lanes.all())
    for i in (S_XOVF, S_VALID):
        assert int(k.stats[i]) == int(p.stats[i]), i
    assert torch.equal(k.stats[S_DISC:], p.stats[S_DISC:])
    if name == "ping-pong6-e3":
        assert int(k.stats[S_XOVF]) == 1
    key_k = pack64(k.chi, k.clo)[k.inserted].tolist()
    key_p = pack64(p.chi, p.clo)[p.inserted].tolist()
    assert len(key_k) == len(set(key_k)) and set(key_k) == set(key_p)
    assert tables[0] == tables[1]


@pytest.mark.gpu
@pytest.mark.parametrize("name,pin,holds,found", [
    ("paxos1-lossy", "PIN_PAXOS1_LOSSY", ("linearizable",),
     ("value chosen",)),
    ("ping-pong5", "PIN_PING5", ("delta within 1",),
     ("must reach max", "can reach max")),
    ("ping-pong7", "PIN_PING7", ("delta within 1",), ("must reach max",)),
    ("timer-count3", "PIN_TIMER3", ("bounded",), ("all max",)),
    ("timer-count8", "PIN_TIMER8", ("bounded",), ("all max",))])
def test_lossy_and_timer_end_to_end_on_card(name, pin, holds, found):
    """The drop lanes, the duplicating network and the Timeout lanes
    through ``spawn_gpu()`` on the card alone: the JAX package's count,
    generated count and digest (``chip_smoke.py``'s ``pin``), the
    properties that hold, the discoveries that replay through the host
    model (a PingPong liveness witness through a ``Drop``); K1-K3 and K7
    launched (and K8, K9 for Paxos)."""
    _need_card()
    import hashlib
    from stateright_tpu_torch.actor import Drop
    from stateright_tpu_torch.actor.test_util import (PackedPingPong,
                                                      PackedTimerCount)
    from stateright_tpu_torch.ops import _cuda
    model = {"paxos1-lossy": lambda: _paxos_lossy(1),
             "ping-pong5": lambda: PackedPingPong(5, True, True),
             "ping-pong7": lambda: PackedPingPong(7, True, True),
             "timer-count3": lambda: PackedTimerCount(3, 2),
             "timer-count8": lambda: PackedTimerCount(8, 4)}[name]()
    before = dict(_cuda.LAUNCHES)
    ck = model.checker().gpu_options(race=False).spawn_gpu().join()
    launched = {k: _cuda.LAUNCHES[k] - before[k] for k in before}
    fps = np.array(sorted(ck.generated_fingerprints()), dtype=np.uint64)
    digest = hashlib.sha256(fps.astype("<u8").tobytes()).hexdigest()
    assert (ck.unique_state_count(), ck.state_count(), digest) \
        == getattr(_chip_smoke(), pin)
    for prop in holds:
        ck.assert_no_discovery(prop)
    for prop in found:
        path = ck.assert_any_discovery(prop)  # replays or raises
        if prop == "must reach max":
            assert any(isinstance(a, Drop) for a in path.into_actions())
    kernels = ("fused_step", "append", "chunk_begin") + (
        ("history", "hpull") if name.startswith("paxos") else ())
    for kernel in kernels:
        assert launched[kernel] > 0, kernel


@pytest.mark.gpu
@pytest.mark.parametrize("race", [False, None], ids=["card", "raced"])
def test_volatile_write_once_caught_through_a_crash_on_card(race):
    """A volatile write-once server loses an acknowledged write: on the
    card alone and raced as by default, the ``linearizable`` discovery's
    witness replays through the host model, holds a ``Crash`` and ends
    in a history with no serialization."""
    _need_card()
    from stateright_tpu_torch.actor.model import Crash
    model = _write_once(2, durable=False)
    builder = model.checker()
    if race is not None:
        builder = builder.gpu_options(race=race)
    ck = builder.spawn_gpu().join()
    path = ck.assert_any_discovery("linearizable")  # replays or raises
    assert any(isinstance(a, Crash) for a in path.into_actions())
    assert path.last_state().history.serialized_history() is None


@pytest.mark.gpu
def test_k1_registers_of_the_parent_instantiations_on_card():
    """The crash and drop lanes and the timer path are compile-time
    properties of their models: K1's Paxos, ABD, single-copy and
    ordered-ABD instantiations and the lossless ping-pong fixture's narrow
    K1 keep their registers (168, 96, 121, 96 and 122 on the H100
    toolchain, PERF.md), K1-timer_count on its own path takes 47 (the
    narrow K1 it replaced: 134), and none spills; the crash and lossy
    instantiations (the lossy ping-pong fixture's shared-row one among
    them) spill nothing either, and the write-once register's two-phase
    K1 stays below the 128 registers at which four of its blocks fit an
    SM."""
    _need_card()
    smoke = _chip_smoke()
    want = {"PaxosModel": 168, "AbdModel": 96, "SingleCopyModel": 121,
            "AbdOrderedModel": 96, "TimerCountModel": 47,
            "PingPongModel": 122}
    for struct, regs in want.items():
        usage = smoke.kernel_usage("fused_step", f"expand_kernel[{struct}]")
        assert usage["registers"] == regs, (struct, usage)
        assert usage["spill_store_bytes"] == 0, (struct, usage)
    for struct in ("WriteOnceModel", "PaxosCrashModel", "PaxosLossyModel",
                   "PingPongLossyModel"):
        usage = smoke.kernel_usage("fused_step", f"expand_kernel[{struct}]")
        assert usage["spill_store_bytes"] == 0, (struct, usage)
        if struct == "WriteOnceModel":
            assert usage["registers"] < 128, usage


@pytest.mark.gpu
@pytest.mark.parametrize("race", [False, None], ids=["card", "raced"])
def test_single_copy_counterexample_on_card(race):
    """Two unreplicated servers are not linearizable: on the card alone
    and raced as by default, the ``linearizable`` discovery's witness
    replays through the host model to a history with no serialization."""
    _need_card()
    model = REGISTER_MODELS["single-copy4-2"]()
    builder = model.checker()
    if race is not None:
        builder = builder.gpu_options(race=race)
    ck = builder.spawn_gpu().join()
    path = ck.assert_any_discovery("linearizable")  # replays or raises
    assert path.last_state().history.serialized_history() is None


# --- the edit K1 (ABD on the ordered network) and K7 at wide rows -------

#: the ordered register configurations of the edit K1's card checks:
#: the BASELINE's (108 words), abd3 (260), tpu_abd2 (331), a single
#: server (one send a handler) and four servers with deep channels
ORDERED_MODELS = {
    "abd2-ordered": REGISTER_MODELS["abd2-ordered"],
    "abd3-ordered": REGISTER_MODELS["abd3-ordered"],
    "abd2-s3-ordered": REGISTER_MODELS["abd2-s3-ordered"],
    "abd1x1-ordered": lambda: _abd(1, server_count=1, ordered=True),
    "abd1x4-d6-ordered": lambda: _abd(1, server_count=4, ordered=True,
                                      channel_depth=6),
}


def _edit_rows(model, rng, f, case):
    """``_paxos_rows`` (crowded channels, whose appends overflow into the
    poison child, and junk rows); ``idle``: 128 rows in a row with every
    channel empty, so whole blocks of K1 have no active lane; ``busy``:
    every channel of every row holds a message, so blocks have more
    active lanes than threads (several passes)."""
    rows = _paxos_rows(model, rng, f)
    lens = slice(model._net_off, model._net_off + model._n_chan)
    if case == "idle":
        rows[64:192, lens] = 0
    elif case == "busy":
        rows[:, lens] = np.maximum(rows[:, lens], 1)
    return rows


@pytest.mark.gpu
@pytest.mark.parametrize("name,f,case", [
    ("abd2-ordered", 1001, "mixed"), ("abd3-ordered", 1728, "mixed"),
    ("abd2-s3-ordered", 1055, "mixed"), ("abd1x1-ordered", 777, "mixed"),
    ("abd1x4-d6-ordered", 1000, "mixed"), ("abd3-ordered", 997, "idle"),
    ("abd2-s3-ordered", 8192, "busy"), ("abd3-ordered", 8192, "busy")])
def test_edit_k1_lane_exact_on_card(name, f, case):
    """The edit K1 (with K2/K3) against the plain version under its
    contract: on the lanes of non-empty channels the child's words, its
    fingerprint, cvalid and the overflow (the poison child) bit for bit;
    on the other lanes cvalid 0 and the row's fingerprint; pbits,
    ebits, terminal, the stats and discoveries everywhere; then the
    inserted key set and the table. At 108, 260 and 331 words, a single
    server and deep channels, ragged frontiers, a run of rows with no
    message (blocks with no active lane) and rows whose every channel
    holds one (more active lanes a block than its threads)."""
    _need_card()
    from stateright_tpu_torch.ops import _cuda
    from stateright_tpu_torch.ops.fused import (S_DISC, S_VALID, S_XOVF,
                                                fused_step,
                                                fused_step_reference)
    from stateright_tpu_torch.ops.hash_kernel import fp64_device
    from stateright_tpu_torch.ops.hashtable import make_table
    from stateright_tpu_torch.ops.words import from_numpy_u32, pack64
    model = ORDERED_MODELS[name]()
    dev = torch.device("cuda")
    rng = np.random.default_rng([f, len(case)])
    rows = _edit_rows(model, rng, f, case)
    a = model.max_actions
    lens = rows[:, model._net_off:model._net_off + model._n_chan]
    active = (lens != 0).reshape(-1)
    sms = _cuda.sm_count(dev)
    wide, _smem = _cuda.k1_launch("abd_ordered",
                                  _cuda.tile_geometry(f, a, sms), f,
                                  model.packed_width, a, sms)
    per_block = np.add.reduceat(active.reshape(f, a).sum(1),
                                np.arange(0, f, wide.rows))
    if case == "idle":
        assert (per_block == 0).any()
    if case == "busy":
        assert (per_block > wide.threads).any()
    block = from_numpy_u32(rows, dev)
    phi, plo = (x.to(torch.int32) for x in fp64_device(block))
    ebits = torch.zeros((f,), dtype=torch.int32, device=dev)
    fvalid = torch.from_numpy(rng.random(f) < 0.9).to(dev)
    out, tables = [], []
    for fn in (fused_step, fused_step_reference):
        table = make_table(1 << 18, dev)
        ring = torch.zeros((1 << 12,), dtype=torch.int64, device=dev)
        out.append(fn(model, block, ebits, fvalid, phi, plo, table, ring))
        tables.append(sorted(table[table != 0].tolist()))
    k, p = out
    written = torch.from_numpy(active).to(dev)
    for nm in ("flat", "chi", "clo"):
        assert torch.equal(getattr(k, nm)[written], getattr(p, nm)[written])
    # an empty channel's lane: the row's fingerprint
    rhi, rlo = fp64_device(block)
    idle = ~written.reshape(f, a)
    assert torch.equal(k.chi.reshape(f, a)[idle].long() & 0xFFFFFFFF,
                       rhi[:, None].expand(f, a)[idle])
    assert torch.equal(k.clo.reshape(f, a)[idle].long() & 0xFFFFFFFF,
                       rlo[:, None].expand(f, a)[idle])
    for nm in ("cvalid", "pbits", "ebits", "terminal"):
        assert torch.equal(getattr(k, nm), getattr(p, nm)), nm
    for i in (S_XOVF, S_VALID):
        assert int(k.stats[i]) == int(p.stats[i]), i
    assert torch.equal(k.stats[S_DISC:], p.stats[S_DISC:])
    if case == "mixed" and name != "abd1x1-ordered":
        assert int(k.stats[S_XOVF]) == 1  # the crowded rows overflow
    key_k = pack64(k.chi, k.clo)[k.inserted].tolist()
    key_p = pack64(p.chi, p.clo)[p.inserted].tolist()
    assert len(key_k) == len(set(key_k)) and set(key_k) == set(key_p)
    assert tables[0] == tables[1]


@pytest.mark.gpu
def test_ordered_register_shut_gate_leaves_everything_as_it_was():
    """On an abd3 carry (260-word rows: the edit K1, K7's wide tile and
    its history stage), the gated step, K7 and K8 with the gate shut,
    launched alone and as the captured graph, change no counter, queue
    or log row, table, history table, step output or scratch word."""
    _need_card()
    from stateright_tpu_torch.checker.device_loop import (
        E_GATE, G_SIZE, I32_MAX, ChunkRunner, run_chunk, seed_carry)
    from stateright_tpu_torch.ops import _cuda
    from stateright_tpu_torch.ops.hashtable import table_insert
    from stateright_tpu_torch.ops.words import from_numpy_u32
    model = REGISTER_MODELS["abd3-ordered"]()
    dev = torch.device("cuda")
    init = model.init_states()[0]
    fp = model.fingerprint(init)
    carry = seed_carry(model, 1 << 18, 1 << 17, [model.encode(init)], 0,
                       [fp], 1 << 12, dev, hcap=1 << 10)
    table_insert(carry.table,
                 from_numpy_u32(np.array([fp >> 32], np.uint32), dev),
                 from_numpy_u32(np.array([fp & 0xFFFFFFFF], np.uint32),
                                dev),
                 torch.ones((1,), dtype=torch.bool, device=dev))
    run_chunk(model, carry, fmax=1728, steps=6)
    card = ChunkRunner(model, carry, 1728).card()
    assert card.scratch["tile"] == _cuda.APPEND_WIDE_TILE
    card.begin(0, I32_MAX, I32_MAX, carry.ws.step + 1)
    assert int(carry.ctr[carry.layout.ext + E_GATE + G_SIZE]) == 0
    for nm in ("stats", "flat", "chi", "cvalid"):
        card.bufs[nm].fill_(5)
    hist = carry.hist
    bufs = (carry.ctr, carry.q, carry.log, carry.table, hist.table,
            hist.hidx, hist.hdone, card.bufs["stats"], card.bufs["flat"],
            card.bufs["chi"], card.bufs["cvalid"], card.scratch["status"],
            card.scratch["ticket"], *card.hscratch.values())
    bufs = tuple(t for t in bufs if isinstance(t, torch.Tensor))
    before = [t.clone() for t in bufs]
    card.launch_steps()
    card.launch_append()
    card.launch_history()
    card.graph.replay(3)
    torch.cuda.synchronize()
    for t, b in zip(bufs, before):
        assert torch.equal(t, b)


#: K7's wide-row cases: queue rows of 263 and 334 words (abd3's 260-word
#: and tpu_abd2's 331-word states), by inserted density
WIDE_APPEND_CASES = [(w, d) for w in (260, 331)
                     for d in (0.0, 0.01, 0.3, 1.0)]


@pytest.mark.gpu
@pytest.mark.parametrize("width,density", WIDE_APPEND_CASES,
                         ids=[f"w{w}-d{d}" for w, d in WIDE_APPEND_CASES])
def test_append_wide_rows_match_plain_version(width, density):
    """K7 at rows wider than its 256-thread block, on its 128-lane tile
    (``append_tile``), against ``append_reference`` on random words and
    a random inserted mask: the large step with a ragged take, then the
    small step on the large step's grid (one scan state across both
    launches), the counter block (the next gate and the 263- or
    334-word most recent row included), stats vector, queue and log bit
    for bit; then a shut gate, which changes nothing and draws no
    ticket."""
    _need_card()
    from stateright_tpu_torch.checker.device_loop import (
        B_DISC, B_LOG_N, B_Q_HEAD, B_Q_TAIL, E_GATE, E_STEPS, G_LEN,
        G_SIZE, CtrLayout, append_reference)
    from stateright_tpu_torch.ops import _cuda
    from stateright_tpu_torch.ops.fused import (S_DISC, S_INSERTED,
                                                S_VALID, FusedOut)
    from stateright_tpu_torch.ops.words import from_numpy_u32
    dev = torch.device("cuda")
    rng = np.random.default_rng([width, int(100 * density)])
    model = REGISTER_MODELS["abd2-s3-ordered" if width == 331
                            else "abd3-ordered"]()
    assert model.packed_width == width
    f_small, f_large, a, n_props = 256, 1055, model.max_actions, 2
    w = width
    lay = CtrLayout(n_props, w)
    lanes_l = f_large * a
    tile = _cuda.append_tile(lanes_l, _cuda.sm_count(dev), w)
    assert tile == _cuda.APPEND_WIDE_TILE
    scratch = _cuda.append_scratch(lanes_l, tile, dev)
    qcap, logcap = 3 * lanes_l, 3 * lanes_l

    def words(*shape):
        return from_numpy_u32(rng.integers(
            0, 2**32, size=shape, dtype=np.uint64).astype(np.uint32), dev)

    bufs = _cuda.step_buffers(model, f_large, S_DISC + 3 * n_props, False,
                              dev, 1)
    q, log = words(qcap, w + 3), words(logcap, 4)
    for launch, (size, f) in enumerate(((2, f_large), (1, f_small)), 1):
        lanes = f * a
        for nm in ("flat", "chi", "clo", "ebits_out"):
            bufs[nm].copy_(words(*bufs[nm].shape))
        mask = rng.random(lanes_l) < density
        bufs["inserted"].copy_(torch.from_numpy(mask))
        cnt = int(bufs["inserted"][:lanes].sum())
        st = np.zeros(S_DISC + 3 * n_props, np.int64)
        st[S_VALID], st[S_INSERTED] = lanes, cnt
        bufs["stats"].copy_(torch.from_numpy(st.astype(np.int32)))
        head = 1000 + launch
        qbase, lbase = head + f + 5, 17 * launch
        ctr = torch.zeros((lay.length,), dtype=torch.int32, device=dev)
        ctr[B_Q_HEAD], ctr[B_Q_TAIL], ctr[B_LOG_N] = head, qbase, lbase
        ctr[B_DISC] = 1
        ctr[lay.ext + E_STEPS] = 9
        ctr[lay.ext + E_GATE:lay.ext + E_GATE + G_LEN] = torch.tensor(
            [size, head, f - 3, 5, qbase, lbase], dtype=torch.int32)
        live = (ctr, q, log, bufs["stats"])
        start = [t.clone() for t in live]
        out = FusedOut(
            pbits=None, ebits=bufs["ebits_out"][:f], terminal=None,
            flat=bufs["flat"][:lanes], chi=bufs["chi"][:lanes],
            clo=bufs["clo"][:lanes], cvalid=None, dvalid=None,
            inserted=bufs["inserted"][:lanes], stats=bufs["stats"],
            ohi=bufs["ohi"][:lanes], olo=bufs["olo"][:lanes])
        append_reference(ctr, lay, q, log, out, a, f_small, f_large,
                         qcap - lanes_l)
        want = [t.clone() for t in live]
        assert int(ctr[B_Q_TAIL]) == qbase + cnt
        for t, v in zip(live, start):
            t.copy_(v)
        args = _cuda.chunk_args(
            ctr=ctr, bufs=bufs, q=q, log=log, scratch=scratch,
            qlimit=qcap - lanes_l, n_props=n_props, width=w, n_actions=a,
            f_small=f_small, f_large=f_large, ext=lay.ext,
            recent=lay.recent, cch=lay.cch)
        _cuda.append(args, dev)
        for nm, x, y in zip(("ctr", "q", "log", "stats"), live, want):
            assert torch.equal(x, y), (size, nm)
        tickets, last = scratch["ticket"].tolist()
        assert tickets == launch * _cuda.append_grid(lanes_l, tile)
        ins = np.flatnonzero(mask[:lanes])
        if len(ins):
            assert last == (launch << 32) | int(ins[-1]) + 1
    # a shut gate: nothing runs, nothing changes
    ctr[lay.ext + E_GATE + G_SIZE] = 0
    frozen = [t.clone() for t in (ctr, q, log, bufs["stats"],
                                  scratch["status"], scratch["ticket"])]
    _cuda.append(args, dev)
    torch.cuda.synchronize()
    for x, y in zip((ctr, q, log, bufs["stats"], scratch["status"],
                     scratch["ticket"]), frozen):
        assert torch.equal(x, y)


@pytest.mark.gpu
@pytest.mark.parametrize("name,f", [("abd3-ordered", 1728),
                                    ("abd2-s3-ordered", 1055)])
def test_wide_row_graph_replays_match_plain_iterations(name, f):
    """Two replays in a row of the captured iteration of an ordered
    register carry (the edit K1, K2, K3, K7 on its 128-lane tile, and
    K8 where the carry has a history stage) against two iterations from
    the same state with K7 replaced by its plain version (the card's
    gated step, ``append_reference`` on its outputs, then K8): the
    counters (each next gate and the most recent row included), stats
    vector, queue, log and history table bit for bit."""
    _need_card()
    from stateright_tpu_torch.checker.device_loop import (
        E_GATE, E_ITERS, G_SIZE, I32_MAX, ChunkRunner, append_reference,
        step_sizes)
    model = REGISTER_MODELS[name]()
    dev = torch.device("cuda")
    carry = _mid_search(model, f, False, dev)
    lay = carry.layout
    f_small, f_large, qmargin = step_sizes(model, f)
    card = ChunkRunner(model, carry, f).card()
    ws = carry.ws
    tag = ws.step + 1
    ws.step += 2
    card.begin(2, I32_MAX, I32_MAX, tag)
    state = [carry.ctr, carry.q, carry.log, carry.table, carry.ring,
             ws.owner, ws.disc_cand, card.bufs["stats"]]
    held = {"ctr": carry.ctr, "q": carry.q, "log": carry.log,
            "stats": card.bufs["stats"]}
    hist = carry.hist
    if hist is not None:  # the history stage, K8 in the graph
        state += [hist.table, hist.hidx, hist.hdone,
                  *card.hscratch.values()]
        held.update({"hist.table": hist.table, "hidx": hist.hidx})
    state = [t for t in state if isinstance(t, torch.Tensor)]
    for i in range(2):
        before = [t.clone() for t in state]
        size = int(carry.ctr[lay.ext + E_GATE + G_SIZE])
        assert size != 0
        card.launch_steps()
        append_reference(carry.ctr, lay, carry.q, carry.log,
                         card.outputs(size), model.max_actions, f_small,
                         f_large, carry.q.shape[0] - qmargin)
        if hist is not None:
            card.launch_history()
        plain = {k: t.clone() for k, t in held.items()}
        for t, b in zip(state, before):
            t.copy_(b)
        card.graph.replay(1)
        for k, t in held.items():
            diff = (plain[k] != t).nonzero()
            assert not diff.numel(), (i, k, diff[:8].tolist())
        assert int(carry.ctr[lay.ext + E_ITERS]) == i + 1


# --- the staged step (fused=False, sound_eventually()) ---------------------

def _staged_model(name):
    from stateright_tpu_torch import PackedPaxos
    from stateright_tpu_torch.actor.test_util import PackedPingPong
    return {"2pc5": lambda: TwoPhaseSys(5),
            "paxos1": lambda: PackedPaxos(1),
            "paxos2": lambda: PackedPaxos(2),
            "ping3": lambda: PackedPingPong(3, lossy=True, duplicating=True),
            "ping5": lambda: PackedPingPong(5, lossy=True,
                                            duplicating=True)}[name]()


@pytest.mark.gpu
@pytest.mark.parametrize("name,fmax,size,sound", [
    ("2pc5", 512, 2, False), ("2pc5", 512, 1, False),
    ("paxos2", 2048, 2, False), ("ping5", 1024, 2, True),
    ("ping5", 1024, 1, True)])
def test_staged_kernels_match_plain_versions_on_card(name, fmax, size,
                                                     sound):
    """K1 alone, KS1, KS2 and KS3 (after K4) at a mid-search step, each
    bit for bit against its plain version on the card kernel's inputs
    (``chip_smoke.check_staged_step``), under sound from a frontier
    seeded with every eventually bit pending."""
    _need_card()
    from stateright_tpu_torch.ops.expand import eventually_indices
    smoke = _chip_smoke()
    model = _staged_model(name)
    full = sum(1 << i for i in eventually_indices(model.properties()))
    carry = smoke.mid_search_carry(model, torch.device("cuda"), rows=fmax,
                                   pending=min(fmax, 600),
                                   ebits=full if sound else 0)
    res = smoke.check_staged_step(model, carry, fmax, size, sound, reps=2)
    assert all(res["checks"].values()), res["checks"]
    assert res["vcount"] > 0 and res["inserted"] > 0


@pytest.mark.gpu
def test_chunk_begin_gate_terms_match_plain_version_on_card():
    """The chunk's start both chunks launch (``chunk_begin_kernel``):
    its gate under parameters that open and shut it, with the staged
    chunk's terms (``kovf`` set, ``e_n`` past and at the edge log's
    limit), bit for bit against its plain version
    (``chip_smoke.check_control``, at TwoPhaseSys(7)'s 12,288-row
    chunk)."""
    _need_card()
    smoke = _chip_smoke()
    model = TwoPhaseSys(7)
    carry = smoke.mid_search_carry(model, torch.device("cuda"))
    res = smoke.check_control(model, carry)
    assert all(res["checks"].values()), res["checks"]


def _sym_checker(model):
    return model.checker().symmetry_fn(model.representative)


STAGED_RUNS = {
    "2pc4": (lambda: TwoPhaseSys(4).checker(),
             dict(fused=False, fmax=512, capacity=1 << 12)),
    "2pc4-kovf": (lambda: TwoPhaseSys(4).checker(),
                  dict(fused=False, fmax=512, capacity=1 << 12, kraw=256,
                       kmax=256)),
    "2pc4-kovf-kmax": (lambda: TwoPhaseSys(4).checker(),
                       dict(fused=False, fmax=512, capacity=1 << 12,
                            kraw=4096, kmax=64)),
    "2pc5-grow": (lambda: TwoPhaseSys(5).checker(),
                  dict(fused=False, fmax=16, capacity=1 << 10)),
    "2pc5-sym": (lambda: _sym_checker(TwoPhaseSys(5, complete_symmetry=True)),
                 dict(fused=False, fmax=256, capacity=1 << 12)),
    "paxos1": (lambda: _staged_model("paxos1").checker(),
               dict(fused=False, fmax=256, capacity=1 << 12)),
    "ping3-sound": (lambda: _staged_model("ping3").checker()
                    .sound_eventually(), dict(fmax=256, capacity=1 << 14)),
    "ping5-sound-grow": (lambda: _staged_model("ping5").checker()
                         .sound_eventually(),
                         dict(fmax=64, capacity=1 << 10)),
}


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(STAGED_RUNS))
def test_staged_end_to_end_matches_cpu_on_card(name):
    """The staged chunk on the card (one graph of K1, KS1, KS2, K4 of
    each size and KS3, K8 with host properties) against its plain
    versions on the CPU: the same record row for row, counts, state sets
    and discoveries;
    the kovf runs rebuild, the growth runs grow (the edge log
    too under sound), and no fused kernel launches."""
    _need_card()
    from stateright_tpu_torch.ops import _cuda
    mk, opts = STAGED_RUNS[name]
    want = mk().gpu_options(device="cpu", race=False, **opts) \
        .spawn_gpu().join()
    for k in _cuda.LAUNCHES:
        _cuda.LAUNCHES[k] = 0
    got = mk().gpu_options(race=False, **opts).spawn_gpu().join()
    assert got.unique_state_count() == want.unique_state_count()
    assert got.state_count() == want.state_count()
    assert got.generated_fingerprints() == want.generated_fingerprints()
    assert sorted(got.discoveries()) == sorted(want.discoveries())
    # the row gate: K4 marks the slot the JAX package's insert marks (KS2
    # reverses the slots), so the record is the CPU's row for row
    got._ensure_mirror()
    want._ensure_mirror()
    assert list(got._generated.items()) == list(want._generated.items())
    assert got._discovery_fps == want._discovery_fps
    launched = _cuda.LAUNCHES
    for k in ("expand", "stage", "predup", "table_insert", "staged_append",
              "chunk_begin"):
        assert launched[k] > 0, k
    assert launched["fused_step"] == launched["append"] == 0
    prof = got.profile()
    if "kovf" in name:
        assert prof["kovfs"] >= 1 and prof["captures"] > prof["kovfs"]
    if "grow" in name:
        assert prof["grows"] >= 1
    if "sound" in name:
        assert prof["e_n"] > 0 and "lasso_s" in prof
