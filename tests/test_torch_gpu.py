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
    return model.checker().gpu_options(device="cpu", **opts) \
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
    ck = TwoPhaseSys(5).checker().spawn_gpu().join()
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
    for i in (S_XOVF, S_CCH, S_VALID):
        assert int(k.stats[i]) == int(p.stats[i])
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
