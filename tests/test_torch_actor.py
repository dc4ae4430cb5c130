"""The port's actor layer against the JAX package's: the copied host side
(the actor model, the network semantics, the register client and the
linearizability tester) and the batched device functions of
``actor/packed.py`` and ``actor/packed_register.py`` (the network's
consume and send, the register client's step, the history record hooks),
bit for bit on inputs made from a numpy seed. Integer outputs are held
exactly."""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)  # leave the other test workers their cores

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from stateright_tpu.actor import Network as JNetwork  # noqa: E402
from stateright_tpu.examples.paxos import PaxosModelCfg as JCfg  # noqa: E402
from stateright_tpu.examples.paxos_packed import \
    PackedPaxos as JPaxos  # noqa: E402
from stateright_tpu_torch.actor import packed as tpacked  # noqa: E402
from stateright_tpu_torch.actor import Network  # noqa: E402
from stateright_tpu_torch.examples.paxos import PaxosModelCfg  # noqa: E402
from stateright_tpu_torch.examples.paxos_packed import \
    PackedPaxos  # noqa: E402
from stateright_tpu_torch.semantics import (  # noqa: E402
    LinearizabilityTester, Read, ReadOk, Register, Write, WriteOk)

OCC = 1 << 16


def _slots(rng, n, e_cap, fill):
    """``n`` sorted networks of ``e_cap`` slots, the first ``fill[i]``
    occupied by distinct envelopes (small fields, so sends often match
    one), the rest zero: uint32 ``[n, e_cap, 4]``."""
    out = np.zeros((n, e_cap, 4), np.uint32)
    for i in range(n):
        envs = set()
        while len(envs) < fill[i]:
            envs.add((OCC | int(rng.integers(0, 5)) << 8
                      | int(rng.integers(0, 6)),
                      int(rng.integers(0, 3)) << 24
                      | int(rng.integers(0, 3)),
                      int(rng.integers(0, 2))))
        for j, (hdr, m0, m1) in enumerate(sorted(envs)):
            out[i, j] = (hdr, int(rng.integers(1, 4)), m0, m1)
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_net_consume_and_send_match_jax(seed):
    rng = np.random.default_rng(seed)
    e_cap, n = 8, 96
    # empty, sparse, full and one-short-of-full networks
    fill = rng.choice([0, 1, 3, e_cap - 1, e_cap], n)
    slots = _slots(rng, n, e_cap, fill)
    e = rng.integers(0, e_cap, n)
    src = rng.integers(0, 5, n)
    dst = np.where(rng.random(n) < 0.05, 300, rng.integers(0, 6, n))
    msg = np.stack([rng.integers(0, 3, n) << 24 | rng.integers(0, 3, n),
                    rng.integers(0, 2, n)], 1).astype(np.uint32)
    valid = rng.random(n) < 0.8
    jm = JPaxos(1)  # any model: the network helpers read net_capacity
    jm.net_capacity, jm._sw = e_cap, 4
    for dup in (False, True):
        jm._net_dup = dup
        want_c = np.stack([np.asarray(jm._net_consume(jnp.asarray(s), k))
                           for s, k in zip(slots, e)])
        got_c = tpacked.net_consume(torch.from_numpy(slots.astype(np.int64)),
                                    torch.from_numpy(e))
        assert np.array_equal(got_c.numpy().astype(np.uint32), want_c)
        want = [jm._net_send(jnp.asarray(s), jnp.uint32(a), jnp.uint32(b),
                             jnp.asarray(m), jnp.bool_(v))
                for s, a, b, m, v in zip(slots, src, dst, msg, valid)]
        got, ovf = tpacked.net_send(
            torch.from_numpy(slots.astype(np.int64)), torch.from_numpy(src),
            torch.from_numpy(dst), torch.from_numpy(msg.astype(np.int64)),
            torch.from_numpy(valid), dup=dup)
        assert np.array_equal(got.numpy().astype(np.uint32),
                              np.stack([np.asarray(w[0]) for w in want]))
        assert np.array_equal(ovf.numpy(),
                              np.array([bool(w[1]) for w in want]))


def _reachable_rows(model, limit):
    seen, rows, queue = set(), [], list(model.init_states())
    while queue and len(rows) < limit:
        s = queue.pop(0)
        enc = model.encode(s)
        key = enc.tobytes()
        if key in seen:
            continue
        seen.add(key)
        rows.append(enc)
        queue.extend(model.next_states(s))
    return np.stack(rows)


@pytest.mark.parametrize("clients", [2, 3])
def test_register_hooks_and_client_step_match_jax(clients):
    tm, jm = PackedPaxos(clients), JPaxos(clients)
    rng = np.random.default_rng(clients)
    rows = _reachable_rows(tm, 300)
    hist = rows[:, tm._hist_off:]
    # invalid histories too: the valid bit cleared on a third of them
    hist[rng.random(len(hist)) < 0.3, 0] = 0
    n = len(hist)
    s = tm.server_count
    src = rng.integers(0, s + clients + 1, n)
    dst = rng.integers(0, s + clients + 1, n)
    mtype = rng.integers(1, 6, n)
    msg = np.stack([mtype << 24 | rng.integers(0, 4, n) << 12
                    | rng.integers(0, 16, n), np.zeros(n, np.int64)],
                   1).astype(np.uint32)
    th = torch.from_numpy(hist.astype(np.int64))
    ts, td = torch.from_numpy(src), torch.from_numpy(dst)
    tmsg = torch.from_numpy(msg.astype(np.int64))
    for name in ("packed_record_in", "packed_record_out"):
        got = getattr(tm, name)(th, ts, td, tmsg).numpy().astype(np.uint32)
        want = np.stack([np.asarray(getattr(jm, name)(
            jnp.asarray(h), jnp.uint32(a), jnp.uint32(b), jnp.asarray(m)))
            for h, a, b, m in zip(hist, src, dst, msg)])
        assert np.array_equal(got, want), name
    # the client step on client words from the reachable rows
    words = rows[:, tm._actor_off[s]]
    index = s + rng.integers(0, clients, n)
    word, changed, sends = tm._client_step(
        torch.from_numpy(index), torch.from_numpy(words.astype(np.int64)),
        ts, tmsg)
    for i in range(n):
        jw, jc, js = jm._client_step(jnp.uint32(index[i]),
                                     jnp.asarray(words[i:i + 1]),
                                     jnp.uint32(src[i]), jnp.asarray(msg[i]))
        assert int(word[i]) == int(jw[0]) and bool(changed[i]) == bool(jc)
        for (d, m, v), (jd, jmsg, jv) in zip(sends, js):
            assert bool(v[i]) == bool(jv)
            assert int(d[i]) == int(jd)
            assert np.array_equal(m[i].numpy(), np.asarray(jmsg))


def test_host_actor_model_matches_jax_state_for_state():
    """The copied host side: the plain ActorModel Paxos of both packages
    reaches the same states (by the packed encoding of each state)."""
    jm = JCfg(client_count=1, server_count=3,
              network=JNetwork.new_unordered_nonduplicating()).into_model()
    tm = PaxosModelCfg(client_count=1, server_count=3,
                       network=Network.new_unordered_nonduplicating()) \
        .into_model()
    jp, tp = JPaxos(1), PackedPaxos(1)

    def space(model, packed):
        seen, queue = set(), list(model.init_states())
        while queue:
            s = queue.pop()
            key = packed.encode(s).tobytes()
            if key not in seen:
                seen.add(key)
                queue.extend(model.next_states(s))
        return seen

    # each package's plain model, encoded by its own packed model
    assert space(jm, jp) == space(tm, tp)
    assert len(space(tm, tp)) == 265


def _histories(rng, n):
    """``n`` random register histories: up to three threads, each
    invoking a write of its own value then a read whose returned value
    is drawn from the initial one and the writes, in a random
    interleaving of invocations and returns (some left in flight)."""
    out = []
    for _ in range(n):
        t = LinearizabilityTester(Register('\0'))
        todo = {}
        for thread in range(int(rng.integers(1, 4))):
            todo[thread] = [
                ("inv", Write(chr(ord('A') + thread))), ("ret", WriteOk()),
                ("inv", Read()),
                ("ret", ReadOk(['\0', 'A', 'B', 'C'][int(rng.integers(4))]))]
            del todo[thread][int(rng.integers(2, 5)):]
        while todo:
            thread = list(todo)[int(rng.integers(len(todo)))]
            kind, x = todo[thread].pop(0)
            (t.on_invoke if kind == "inv" else t.on_return)(thread, x)
            if not todo[thread]:
                del todo[thread]
        out.append(t)
    return out


def test_linearizability_tester_matches_jax():
    from stateright_tpu.semantics import (
        LinearizabilityTester as JTester, Read as JRead, ReadOk as JReadOk,
        Register as JRegister, Write as JWrite, WriteOk as JWriteOk)
    rng = np.random.default_rng(5)
    conv = {Write: lambda o: JWrite(o.value), Read: lambda o: JRead(),
            WriteOk: lambda o: JWriteOk(),
            ReadOk: lambda o: JReadOk(o.value)}
    outcomes = set()
    for t in _histories(rng, 60):
        j = JTester(JRegister('\0'))
        j._valid = t._valid
        for tid, entries in t._history.items():
            j._history[tid] = [(dict(lc), conv[type(op)](op),
                                conv[type(ret)](ret))
                               for lc, op, ret in entries]
        for tid, (lc, op) in t._in_flight.items():
            j._in_flight[tid] = (dict(lc), conv[type(op)](op))
        got, want = t.serialized_history(), j.serialized_history()
        assert (got is None) == (want is None)
        outcomes.add(got is None)
        if got is not None:
            def shown(history):
                return [(type(op).__name__, getattr(op, "value", None),
                         type(ret).__name__, getattr(ret, "value", None))
                        for op, ret in history]
            assert shown(got) == shown(want)
    assert outcomes == {True, False}  # linearizable histories and not
