"""The port's fused step (plain version) and chunk loop against the JAX
package's Pallas step kernel (interpret mode) and chunk program, started
from the same mid-search state: a JAX run's carry brought across with
``carry_from_numpy``. Every output must match lane for lane (exact:
integer and bit arithmetic)."""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)  # leave the other test workers their cores

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from stateright_tpu.checker import device_loop as jdl  # noqa: E402
from stateright_tpu.models import twopc as jtwopc  # noqa: E402
from stateright_tpu.ops.fused import build_fused_block_fn  # noqa: E402
from stateright_tpu.ops.hashtable import plan_insert_host  # noqa: E402
from stateright_tpu_torch.checker.device_loop import (  # noqa: E402
    B_GEN, carry_from_numpy, carry_to_numpy, run_chunk)
from stateright_tpu_torch.models.twopc import TwoPhaseSys  # noqa: E402
from stateright_tpu_torch.ops.fused import (  # noqa: E402
    S_CCH, S_DEDUP, S_DISC, S_INSERTED, S_OVF, S_ROUNDS, S_VALID, S_XOVF,
    fused_step)
from stateright_tpu_torch.ops.words import (  # noqa: E402
    from_numpy_u32, keys_to_numpy, to_numpy_u32)

JaxTwoPhaseSys = jtwopc.TwoPhaseSys

CAPACITY = 1 << 14  # the log must hold one full-width append
QCAP = 1 << 15
GROW_LIMIT = 2000


def _jax_chunk(n, fmax, cc, steps):
    return jdl.build_chunk_fn(
        JaxTwoPhaseSys(n), QCAP, CAPACITY, fmax,
        fmax * JaxTwoPhaseSys(n).max_actions, fused=True,
        fused_interpret=True, cc=cc)


def _jax_mid_search(n, fmax, cc, steps):
    """A JAX fused-engine state after ``steps`` loop iterations."""
    model = JaxTwoPhaseSys(n)
    init = model.init_states()[0]
    fp = model.fingerprint(init)
    carry = jdl.seed_carry(
        model, QCAP, CAPACITY, [model.encode(init)], np.uint32(0),
        steps=steps, init_fps=[fp],
        table_plan=(plan_insert_host([fp], CAPACITY), [fp]))
    carry, rhi, rlo, _stats = _jax_chunk(n, fmax, cc, steps)(
        carry, jnp.zeros((cc,), jnp.uint32), jnp.zeros((cc,), jnp.uint32),
        np.int32(2**31 - 1), np.int32(GROW_LIMIT), np.int32(0))
    return jax.device_get(carry), np.asarray(rhi), np.asarray(rlo)


CASES = [(3, 16, 64, 6), (4, 16, 1 << 15, 10), (4, 512, 64, 6),
         (4, 512, 1 << 15, 8)]


@pytest.fixture(scope="module", params=CASES,
                ids=[f"n{n}-f{f}-cc{cc}" for n, f, cc, _s in CASES])
def mid(request):
    n, fmax, cc, steps = request.param
    carry, rhi, rlo = _jax_mid_search(n, fmax, cc, steps)
    assert int(carry.q_tail) > int(carry.q_head) > 1  # mid-search
    return n, fmax, cc, steps, carry, rhi, rlo


def test_carry_round_trip(mid):
    *_rest, carry, rhi, rlo = mid
    back = carry_to_numpy(carry_from_numpy(carry, rhi, rlo))
    for name in ("q", "key_hi", "key_lo", "disc_hit", "disc_hi",
                 "disc_lo"):
        np.testing.assert_array_equal(back[name], np.asarray(
            getattr(carry, name)), err_msg=name)
    np.testing.assert_array_equal(back["log"], np.asarray(carry.log)[:, :4])
    np.testing.assert_array_equal(back["ring_hi"], rhi)
    np.testing.assert_array_equal(back["ring_lo"], rlo)
    for name in ("q_head", "q_tail", "log_n"):
        assert back[name] == int(getattr(carry, name))


def test_fused_step_matches_pallas_kernel(mid):
    n, fmax, cc, _steps, carry, rhi, rlo = mid
    jm, tm = JaxTwoPhaseSys(n), TwoPhaseSys(n)
    width = tm.packed_width
    q = np.asarray(carry.q)
    rng = np.random.default_rng(fmax + cc)
    # a frontier straddling expanded and pending rows: its children are
    # in the table, in the ring, and fresh
    start = max(0, int(carry.q_head) - fmax // 2)
    rows = q[start:start + fmax]
    fvalid = (rng.random(fmax) < 0.9) \
        & (start + np.arange(fmax) < int(carry.q_tail))
    fn = build_fused_block_fn(jm, fmax, CAPACITY, probe=True,
                              interpret=True, props=True, cc=cc)
    want = fn(jnp.asarray(rows[:, :width]), jnp.asarray(rows[:, width]),
              jnp.asarray(fvalid), jnp.asarray(carry.key_hi),
              jnp.asarray(carry.key_lo),
              pfp=(jnp.asarray(rows[:, width + 1]),
                   jnp.asarray(rows[:, width + 2])),
              ring=(jnp.asarray(rhi), jnp.asarray(rlo)))
    port = carry_from_numpy(carry, rhi, rlo)
    block = from_numpy_u32(rows)
    got = fused_step(tm, block[:, :width], block[:, width],
                     torch.from_numpy(fvalid), block[:, width + 1],
                     block[:, width + 2], port.table, port.ring)
    for name in ("pbits", "ebits", "terminal", "flat", "chi", "clo", "ohi",
                 "olo", "cvalid", "dvalid", "inserted"):
        g = getattr(got, name)
        g = g.numpy() if g.dtype == torch.bool else to_numpy_u32(g)
        np.testing.assert_array_equal(g, np.asarray(getattr(want, name)),
                                      err_msg=name)
    th, tl = keys_to_numpy(port.table)
    np.testing.assert_array_equal(th, np.asarray(want.key_hi))
    np.testing.assert_array_equal(tl, np.asarray(want.key_lo))
    rh, rl = keys_to_numpy(port.ring)
    np.testing.assert_array_equal(rh, np.asarray(want.ring_hi))
    np.testing.assert_array_equal(rl, np.asarray(want.ring_lo))
    st = to_numpy_u32(got.stats)
    assert [bool(st[S_XOVF]), bool(st[S_OVF]), int(st[S_ROUNDS]),
            int(st[S_CCH])] == [bool(want.xovf), bool(want.ovf),
                                int(want.rounds), int(want.cch)]
    assert (st[S_VALID], st[S_DEDUP], st[S_INSERTED]) == (
        np.asarray(want.cvalid).sum(), np.asarray(want.dvalid).sum(),
        np.asarray(want.inserted).sum())
    p = len(tm.properties())
    np.testing.assert_array_equal(st[S_DISC:S_DISC + p],
                                  np.asarray(want.disc_hit))
    np.testing.assert_array_equal(st[S_DISC + p:S_DISC + 2 * p],
                                  np.asarray(want.disc_hi))
    np.testing.assert_array_equal(st[S_DISC + 2 * p:],
                                  np.asarray(want.disc_lo))
    assert int(np.asarray(want.inserted).sum()) > 0


def test_chunk_continues_like_jax(mid):
    # both packages run the next chunk from the same carry: queue, log,
    # table, ring and discovery registers must stay identical
    n, fmax, cc, steps, carry, rhi, rlo = mid
    port = carry_from_numpy(carry, rhi, rlo)
    jcarry, jrhi, jrlo, _stats = _jax_chunk(n, fmax, cc, steps)(
        carry._replace(steps=np.int32(steps), gen=np.int32(0)),
        jnp.asarray(rhi), jnp.asarray(rlo), np.int32(2**31 - 1),
        np.int32(GROW_LIMIT), np.int32(0))
    jcarry = jax.device_get(jcarry)
    counters = run_chunk(TwoPhaseSys(n), port, fmax=fmax, steps=steps,
                         grow_limit=GROW_LIMIT, target_remaining=2**31 - 1)
    assert int(counters[B_GEN]) == int(jcarry.gen)
    got = carry_to_numpy(port)
    for name in ("q_head", "q_tail", "log_n"):
        assert got[name] == int(getattr(jcarry, name)), name
    t = got["q_tail"]
    np.testing.assert_array_equal(got["q"][:t], np.asarray(jcarry.q)[:t])
    ln = got["log_n"]
    np.testing.assert_array_equal(got["log"][:ln],
                                  np.asarray(jcarry.log)[:ln, :4])
    for name in ("key_hi", "key_lo", "disc_hit", "disc_hi", "disc_lo"):
        np.testing.assert_array_equal(got[name],
                                      np.asarray(getattr(jcarry, name)),
                                      err_msg=name)
    np.testing.assert_array_equal(got["ring_hi"], np.asarray(jrhi))
    np.testing.assert_array_equal(got["ring_lo"], np.asarray(jrlo))
