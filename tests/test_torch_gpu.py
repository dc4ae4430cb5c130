"""The port's CUDA kernels against their plain torch versions, and the
engine on the card against its CPU path. Marked ``gpu``: they need a CUDA
device (the kernels have no CPU mode) and skip without one. The file
imports no JAX, so it runs where only the port is installed:

    python -m pytest --noconftest tests/test_torch_gpu.py -m gpu

(``--noconftest``: the suite's conftest configures JAX.)"""

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
    buffers): a run from a 2**10-slot table at 16-row steps grows, and
    its search record is the non-growing run's row for row (the card's
    lowest-lane winner rule does not depend on the table's layout, nor
    the record on where chunks end)."""
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
    assert pg["capture_s"] > pf["capture_s"] > 0
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


#: PackedPaxos(2): unique states, state_count() and the sha256 of the
#: sorted fingerprints (chip_smoke.py PIN_PAXOS2: the JAX package's host
#: BFS; tests/test_torch_paxos.py holds the port's plain path to it)
PIN_PAXOS2 = (16_668, 32_971,
              "184fdb02ebca156876cc206a2c39ce2c"
              "c11186fb868ec1b3c6b1fdf63b516971")


def _paxos_rows(model, rng, f):
    """``f`` rows drawn with replacement from the first 3,000 states of a
    host BFS of ``model``, a tenth of them with crowded networks (their
    children's sends overflow) and a twentieth random words."""
    seen, states, queue = set(), [], list(model.init_states())
    while queue and len(states) < 3000:
        s = queue.pop(0)
        enc = model.encode(s)
        if enc.tobytes() not in seen:
            seen.add(enc.tobytes())
            states.append(enc)
            queue.extend(model.next_states(s))
    rows = np.stack([states[i] for i in rng.integers(0, len(states), f)])
    e_cap, w = model.net_capacity, model.packed_width
    for i in np.flatnonzero(rng.random(f) < 0.1):
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


@pytest.mark.gpu
@pytest.mark.parametrize("clients,f", [(1, 64), (2, 1000), (3, 8192)])
def test_paxos_step_lane_exact_on_card(clients, f):
    """K1's paxos instantiation (the wide K1: rows in shared memory, the
    child written word by word) with K2/K3 against the plain version,
    lane for lane on every lane (invalid and overflowing ones too), then
    the inserted key set and the table; small and full width."""
    _need_card()
    from stateright_tpu_torch.examples.paxos_packed import PackedPaxos
    from stateright_tpu_torch.ops.fused import (S_DISC, S_VALID, S_XOVF,
                                                fused_step,
                                                fused_step_reference)
    from stateright_tpu_torch.ops.hash_kernel import fp64_device
    from stateright_tpu_torch.ops.hashtable import make_table
    from stateright_tpu_torch.ops.words import from_numpy_u32, pack64
    model = PackedPaxos(clients)
    dev = torch.device("cuda")
    rng = np.random.default_rng(clients)
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
    if clients > 1:  # the crowded rows' sends overflow
        assert int(k.stats[S_XOVF]) == 1
    assert torch.equal(k.stats[S_DISC:], p.stats[S_DISC:])
    key_k = pack64(k.chi, k.clo)[k.inserted].tolist()
    key_p = pack64(p.chi, p.clo)[p.inserted].tolist()
    assert len(key_k) == len(set(key_k)) and set(key_k) == set(key_p)
    assert tables[0] == tables[1]


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
    assert (ck.unique_state_count(), ck.state_count(), digest) == PIN_PAXOS2
    ck.assert_no_discovery("linearizable")
    ck.assert_any_discovery("value chosen")
    for name in ("fused_step", "append", "chunk_begin", "history", "hpull"):
        assert launched[name] > 0, name
    assert ck.profile()["h_n"] == 5
    if hcap == 4:
        assert ck.profile()["hgrow"] >= 1
