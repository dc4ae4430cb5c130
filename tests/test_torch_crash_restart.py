"""Crash/restart fault injection on the port against the JAX package: the
write-once register's semantics and actors, the host ``ActorModel``'s
crash semantics (the counts of ``tests/test_crash_restart.py``), the
plain batched step's crash and restart lanes lane for lane against the
JAX package's ``_packed_step_unordered`` (junk rows included, on
reachable rows and rows with an actor down or at its crash budget), the
host/device contract (``validate_packed_model``), the GPU engine on the
CPU (the plain versions of K1-K3, K7, K8 and K9): the durable write-once
register's 51 states with the JAX host BFS's fingerprints, the volatile
one caught through a ``Crash``, the row gate against the JAX package's
staged engine, Paxos(1) under crashes against its pin; ``cuda_spec`` and
what it refuses; the CLI; and a run that loads no JAX. Inputs come from
a numpy seed and host BFS frontiers; every integer output is held
exactly (tolerance 0)."""

import hashlib
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(1)  # leave the other test workers their cores

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from stateright_tpu.actor import write_once_register as jwo  # noqa: E402
from stateright_tpu.examples.paxos_packed import \
    PackedPaxos as JPaxos  # noqa: E402
from stateright_tpu.examples.single_copy_packed import \
    PackedSingleCopy as JSingleCopy  # noqa: E402
from stateright_tpu.examples.write_once_packed import \
    PackedWriteOnce as JWriteOnce  # noqa: E402
from stateright_tpu.semantics import sequential_consistency as jsc  # noqa
from stateright_tpu.semantics import vec as jvec  # noqa: E402
from stateright_tpu.semantics import write_once_register as jwsem  # noqa
from stateright_tpu_torch.actor import ActorModel, Id, Network, Out  # noqa
from stateright_tpu_torch.actor import write_once_register as wo  # noqa
from stateright_tpu_torch.actor.core import Actor, Down  # noqa: E402
from stateright_tpu_torch.actor.model import (Crash, Deliver,  # noqa: E402
                                              Restart, Timeout)
from stateright_tpu_torch.core import Expectation  # noqa: E402
from stateright_tpu_torch.examples.paxos_packed import \
    PackedPaxos  # noqa: E402
from stateright_tpu_torch.examples.single_copy_packed import \
    PackedSingleCopy  # noqa: E402
from stateright_tpu_torch.examples.write_once_packed import \
    PackedWriteOnce  # noqa: E402
from stateright_tpu_torch.models.packed import \
    validate_packed_model  # noqa: E402
from stateright_tpu_torch.semantics import (LinearizabilityTester,  # noqa
                                            SequentialConsistencyTester,
                                            VecSpec, WORegister, WriteFail)
from stateright_tpu_torch.semantics import register as reg  # noqa: E402
from stateright_tpu_torch.semantics import vec  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent

#: PackedPaxos(1).crash_restart(1, actors=[0, 1, 2]): unique states,
#: state_count() and the sha256 of the sorted fingerprints (chip_smoke.py
#: PIN_PAXOS1_CRASH, from the JAX package's host BFS on the CPU); the
#: test holds the port to the constant and leaves the JAX run to the
#: pin's own check, keeping this file cheap
PIN_PAXOS1_CRASH = (7_155, 24_049,
                    "a9224227a226031d2f4f2de3c2401a86"
                    "4dcb761fb655fd229ab03fbb45b0bed3")


def _chip_smoke():
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    return chip_smoke


def _digest(fps) -> str:
    arr = np.array(sorted(fps), dtype=np.uint64)
    return hashlib.sha256(arr.astype("<u8").tobytes()).hexdigest()


def _cpu(model, **opts):
    return model.checker().gpu_options(device="cpu", race=False, **opts) \
        .spawn_gpu().join()


# --- the semantics and actor copies ---------------------------------------

def _ops(rng, n):
    """``n`` random write-once register operations with their returns,
    as ``(kind, value, ret, ret_val)`` tuples (:func:`_wo_op` makes each
    package's objects of them)."""
    vals = [None, "A", "B", "C"]
    out = []
    for _ in range(n):
        kind = int(rng.integers(0, 2))
        value = vals[1 + int(rng.integers(0, 3))]
        ret = int(rng.integers(0, 3))
        ret_val = vals[int(rng.integers(0, 4))]
        out.append((kind, value, ret, ret_val))
    return out


def _wo_op(sem, kind, value, ret, ret_val):
    if kind == 0:
        op = sem.Write(value)
        r = sem.WriteOk() if ret == 0 else (
            sem.WriteFail() if ret == 1 else sem.ReadOk(ret_val))
    else:
        op = sem.Read()
        r = sem.ReadOk(ret_val) if ret else sem.WriteOk()
    return op, r


class _Sem:
    """A package's register vocabulary with its write-once failure."""

    def __init__(self, register, write_once):
        self.Write, self.Read = register.Write, register.Read
        self.WriteOk, self.ReadOk = register.WriteOk, register.ReadOk
        self.WriteFail = write_once.WriteFail
        self.WORegister = write_once.WORegister


def test_wo_register_spec_is_the_jax_packages():
    """``WORegister``'s ``invoke`` and ``is_valid_step`` on random
    operation sequences from a seed, against the JAX package's."""
    from stateright_tpu.semantics import register as jreg
    from stateright_tpu_torch.semantics import write_once_register as wsem
    ours, theirs = _Sem(reg, wsem), _Sem(jreg, jwsem)
    rng = np.random.default_rng(17)
    for _ in range(200):
        a, b = ours.WORegister(), theirs.WORegister()
        for kind, value, ret, ret_val in _ops(rng, 6):
            op_a, r_a = _wo_op(ours, kind, value, ret, ret_val)
            op_b, r_b = _wo_op(theirs, kind, value, ret, ret_val)
            assert (a.clone().is_valid_step(op_a, r_a)
                    == b.clone().is_valid_step(op_b, r_b))
            assert repr(a.invoke(op_a)) == repr(b.invoke(op_b))
            assert repr(a) == repr(b)
    assert WriteFail() == WriteFail() and WORegister() == WORegister(None)


def test_copied_testers_are_the_jax_packages():
    """The copied sequential-consistency tester and stack spec: the same
    verdicts on random histories (from a seed) as the JAX package's."""
    from stateright_tpu.semantics import register as jreg
    from stateright_tpu_torch.semantics import register as preg
    rng = np.random.default_rng(3)
    for _ in range(100):
        ta = SequentialConsistencyTester(preg.Register("\0"))
        tb = jsc.SequentialConsistencyTester(jreg.Register("\0"))
        for _ in range(6):
            thread = int(rng.integers(0, 3))
            invoke = rng.random() < 0.5
            write = rng.random() < 0.5
            v = "AB"[int(rng.integers(0, 2))]
            rv = "\0AB"[int(rng.integers(0, 3))]
            for tester, r in ((ta, preg), (tb, jreg)):
                try:
                    if invoke:
                        tester.on_invoke(thread, r.Write(v) if write
                                         else r.Read())
                    else:
                        tester.on_return(thread, r.WriteOk() if write
                                         else r.ReadOk(rv))
                except ValueError:
                    pass
        assert ((ta.serialized_history() is None)
                == (tb.serialized_history() is None))
        assert ta.is_consistent() == tb.is_consistent()
    sa, sb = VecSpec(), jvec.VecSpec()
    for step in range(20):
        x = int(rng.integers(0, 3))
        op_a = vec.Push(x) if step % 3 else vec.Pop()
        op_b = jvec.Push(x) if step % 3 else jvec.Pop()
        assert repr(sa.invoke(op_a)) == repr(sb.invoke(op_b))
        assert repr(sa) == repr(sb)


def test_write_once_actors_are_the_jax_packages():
    """The write-once client and server (``WORegisterClient``,
    ``WORegisterServer``) and the history hooks, message for message
    against the JAX package's, with a ``PutFail`` in the vocabulary."""
    from stateright_tpu.actor.core import Id as JId, Out as JOut
    from stateright_tpu.examples.write_once_packed import \
        WriteOnceActor as JServer
    from stateright_tpu_torch.examples.write_once_packed import \
        WriteOnceActor

    def sends(out):
        return [(int(c.dst), repr(c.msg)) for c in out]

    for index in (1, 2, 3):
        a, b = wo.WORegisterClient(2, 1), jwo.WORegisterClient(2, 1)
        oa, ob = Out(), JOut()
        sa, sb = a.on_start(Id(index), oa), b.on_start(JId(index), ob)
        assert repr(sa) == repr(sb) and sends(oa) == sends(ob)
        for msg_a, msg_b in ((wo.PutOk(sa.awaiting), jwo.PutOk(sb.awaiting)),
                             (wo.PutFail(sa.awaiting),
                              jwo.PutFail(sb.awaiting)),
                             (wo.GetOk(sa.awaiting, "A"),
                              jwo.GetOk(sb.awaiting, "A"))):
            oa, ob = Out(), JOut()
            na = a.on_msg(Id(index), sa, Id(0), msg_a, oa)
            nb = b.on_msg(JId(index), sb, JId(0), msg_b, ob)
            assert repr(na) == repr(nb) and sends(oa) == sends(ob)
    for durable in (None, "A"):
        sa_ = wo.WORegisterServer(WriteOnceActor())
        sb_ = jwo.WORegisterServer(JServer())
        st_a = sa_.on_start(Id(0), Out())
        st_b = sb_.on_start(JId(0), JOut())
        for va, vb in ((wo.Put(1, "A"), jwo.Put(1, "A")),
                       (wo.Put(2, "B"), jwo.Put(2, "B")),
                       (wo.Get(3), jwo.Get(3))):
            oa, ob = Out(), JOut()
            na = sa_.on_msg(Id(0), st_a, Id(1), va, oa)
            nb = sb_.on_msg(JId(0), st_b, JId(1), vb, ob)
            assert repr(na) == repr(nb) and sends(oa) == sends(ob)
            st_a, st_b = na or st_a, nb or st_b
        assert repr(sa_.durable(Id(0), st_a)) == repr(
            sb_.durable(JId(0), st_b))
        assert durable is None or repr(sa_.on_restart(Id(0), durable, Out())) \
            == repr(sb_.on_restart(JId(0), durable, JOut()))


# --- the host ActorModel's crash semantics (tests/test_crash_restart.py) --

class VolatileWOServer(Actor):
    """Unreplicated write-once server keeping its value in volatile
    memory only — the deliberately buggy variant."""

    def on_start(self, id, o):
        return None  # unwritten

    def on_msg(self, id, state, src, msg, o):
        if isinstance(msg, wo.Put):
            if state is None or state == msg.value:
                o.send(src, wo.PutOk(msg.request_id))
                return msg.value if state is None else None
            o.send(src, wo.PutFail(msg.request_id))
            return None
        if isinstance(msg, wo.Get):
            o.send(src, wo.GetOk(msg.request_id, state))
            return None
        return None


class DurableWOServer(VolatileWOServer):
    """The fixed variant: the register value is on stable storage."""

    def durable(self, id, state):
        return state

    def on_restart(self, id, durable, o):
        return durable


def wo_model(server, client_count: int = 1) -> ActorModel:
    model = ActorModel(cfg=None,
                       init_history=LinearizabilityTester(WORegister()))
    model.actor(wo.WORegisterServer(server))
    for _ in range(client_count):
        model.actor(wo.WORegisterClient(put_count=1, server_count=1))
    return (model
            .init_network(Network.new_unordered_nonduplicating())
            .property(Expectation.ALWAYS, "linearizable",
                      lambda _, state:
                      state.history.serialized_history() is not None)
            .record_msg_in(wo.record_returns)
            .record_msg_out(wo.record_invocations))


class TestHostSemantics:
    def test_crash_wipes_volatile_state_and_timer(self):
        class TimerHolder(Actor):
            def on_start(self, id, o):
                o.set_timer((0.0, 0.0))
                return 7

        model = ActorModel().actor(TimerHolder()).crash_restart(1)
        init = model.init_states()[0]
        assert init.is_timer_set == (True,) and init.crashes == (0,)
        crashed = model.next_state(init, Crash(Id(0)))
        assert crashed.actor_states == (Down(None),)
        assert crashed.is_timer_set == (False,)
        assert crashed.crashes == (1,)
        actions = []
        model.actions(crashed, actions)
        assert actions == [Restart(Id(0))]

    def test_restart_reruns_on_start_by_default(self):
        class Sender(Actor):
            def on_start(self, id, o):
                o.send(Id(9), "hello")  # undeliverable: sits in network
                return "up"

        model = (ActorModel().actor(Sender())
                 .init_network(Network.new_unordered_nonduplicating())
                 .crash_restart(1))
        init = model.init_states()[0]
        crashed = model.next_state(init, Crash(Id(0)))
        restarted = model.next_state(crashed, Restart(Id(0)))
        assert restarted.actor_states == ("up",)
        assert len(restarted.network) == 2

    def test_down_actor_takes_no_deliveries_or_timeouts(self):
        model = wo_model(VolatileWOServer()).crash_restart(1, actors=[0])
        init = model.init_states()[0]
        crashed = model.next_state(init, Crash(Id(0)))
        actions = []
        model.actions(crashed, actions)
        assert not any(isinstance(a, Deliver) and int(a.dst) == 0
                       for a in actions)
        assert not any(isinstance(a, Timeout) for a in actions)
        assert len(crashed.network) == 1
        env = next(iter(crashed.network.iter_deliverable()))
        assert model.next_state(
            crashed, Deliver(src=env.src, dst=env.dst, msg=env.msg)) \
            is None

    def test_crashable_restricts_eligible_actors(self):
        model = wo_model(VolatileWOServer()).crash_restart(1, actors=[0])
        actions = []
        model.actions(model.init_states()[0], actions)
        assert [a for a in actions if isinstance(a, Crash)] == \
            [Crash(Id(0))]

    def test_no_crash_config_is_bit_identical(self):
        model = wo_model(VolatileWOServer())
        init = model.init_states()[0]
        assert init.crashes is None
        actions = []
        model.actions(init, actions)
        assert not any(isinstance(a, (Crash, Restart)) for a in actions)

    def test_volatile_server_caught_and_durable_safe(self):
        ck = wo_model(VolatileWOServer()).crash_restart(
            1, actors=[0]).checker().spawn_bfs().join()
        actions = ck.assert_any_discovery("linearizable").into_actions()
        assert any(isinstance(a, Crash) for a in actions)
        assert any(isinstance(a, Restart) for a in actions)
        bfs = wo_model(DurableWOServer()).crash_restart(
            1, actors=[0]).checker().spawn_bfs().join()
        dfs = wo_model(DurableWOServer()).crash_restart(
            1, actors=[0]).checker().spawn_dfs().join()
        bfs.assert_properties()
        assert bfs.generated_fingerprints() == dfs.generated_fingerprints()


# --- the plain step's crash and restart lanes -----------------------------

#: the configurations of the lane-for-lane checks: the write-once
#: register durable and volatile (its server's crash wipes the value),
#: at the widest write-once instantiation (7 clients, 16 slots, two
#: crashes), every actor crashable (the clients' words wiped), Paxos(1)
#: under crashes, and the single-copy register (every actor crashable)
LANE_CASES = {
    "write-once-2": lambda m: m(2).crash_restart(1, actors=[0]),
    "write-once-2-volatile": lambda m: m(2, durable=False).crash_restart(
        1, actors=[0]),
    "write-once-7x16-k2": lambda m: m(7, net_capacity=16).crash_restart(
        2, actors=[0]),
    "write-once-2-all": lambda m: m(2, durable=False).crash_restart(1),
    "paxos-1": lambda m: m(1).crash_restart(1, actors=[0, 1, 2]),
    "single-copy-2": lambda m: m(2).crash_restart(1),
}


def _pair(case):
    make = LANE_CASES[case]
    if case.startswith("write-once"):
        return make(PackedWriteOnce), make(JWriteOnce)
    if case.startswith("paxos"):
        return make(PackedPaxos), make(JPaxos)
    return make(PackedSingleCopy), make(JSingleCopy)


def _reachable(model, limit):
    seen, rows, queue = set(), [], list(model.init_states())
    while queue and len(rows) < limit:
        state = queue.pop(0)
        row = np.asarray(model.encode(state), dtype=np.uint32)
        if row.tobytes() in seen:
            continue
        seen.add(row.tobytes())
        rows.append(row)
        queue.extend(model.next_states(state))
    return np.stack(rows)


def _downed(model, rows, rng):
    """Copies of ``rows`` with a crashable actor put down (its count at
    least one) or at its crash budget: deliveries to it wait, its crash
    lane is spent, its restart lane live."""
    out = rows.copy()
    idx = model._crash_idx
    for i in range(out.shape[0]):
        a = int(idx[rng.integers(0, len(idx))])
        cw = int(out[i, model._crash_off])
        budget = rng.random() < 0.5
        count = model.max_crashes_ if budget else max(1, (cw >> 4 * a) & 7)
        cw = (cw & ~(0xF << 4 * a)) | (count << 4 * a)
        if not budget or rng.random() < 0.5:
            cw |= 1 << (4 * a + 3)
        out[i, model._crash_off] = cw
    return out


@pytest.mark.parametrize("case", list(LANE_CASES))
def test_packed_step_crash_lanes_are_the_jax_packages(case):
    """The plain step, crash and restart lanes included, lane for lane
    against the JAX package's ``packed_step`` (vmapped): every child's
    words (the junk rows of invalid lanes too), ``valid`` and
    ``overflow``, on reachable rows and on rows with an actor down or at
    its crash budget."""
    model, jmodel = _pair(case)
    assert (model.packed_width, model.max_actions) == \
        (jmodel.packed_width, jmodel.max_actions)
    rng = np.random.default_rng(len(case))
    rows = _reachable(model, 120)
    rows = np.concatenate([rows, _downed(model, rows, rng)])
    s, v, o = model.packed_step(torch.from_numpy(rows.astype(np.int64)))
    js, jv, jo = jax.vmap(jmodel.packed_step)(jnp.asarray(rows))
    assert np.array_equal(s.numpy(), np.asarray(js).astype(np.int64))
    assert np.array_equal(v.numpy(), np.asarray(jv))
    assert np.array_equal(o.numpy(), np.asarray(jo))
    e, n_cr = model.net_capacity, len(model._crash_idx)
    assert v.numpy()[:, e:e + n_cr].any() and v.numpy()[:, e + n_cr:].any()


@pytest.mark.parametrize("make,want", [
    (lambda: PackedWriteOnce(1, durable=True).crash_restart(1, actors=[0]),
     15),
    (lambda: PackedWriteOnce(1, durable=False).crash_restart(1, actors=[0]),
     21),
    (lambda: PackedPaxos(1).crash_restart(1, actors=[0, 1, 2]), 600)],
    ids=["write-once-durable", "write-once-volatile", "paxos-prefix"])
def test_packed_contract_counts(make, want):
    """``validate_packed_model``: the crash lanes agree with the host
    model's successors on every reachable state, at the JAX package's
    counts (``tests/test_crash_restart.py``)."""
    max_states = 600 if want == 600 else 100
    assert validate_packed_model(make(), max_states=max_states) == want


# --- the GPU engine on the CPU --------------------------------------------

def test_durable_write_once_on_the_gpu_engine():
    """51 states with the JAX package's host BFS's fingerprints,
    ``linearizable`` holding and ``value chosen`` found."""
    def mk(cls):
        return cls(2, durable=True).crash_restart(1, actors=[0])
    want = mk(JWriteOnce).checker().spawn_bfs().join()
    got = _cpu(mk(PackedWriteOnce), capacity=1 << 12)
    assert got.unique_state_count() == want.unique_state_count() == 51
    assert got.state_count() == want.state_count()
    assert got.generated_fingerprints() == want.generated_fingerprints()
    assert set(got.discoveries()) == {"value chosen"}
    got.assert_properties()


@pytest.mark.parametrize("race", [False, True], ids=["engine", "raced"])
def test_volatile_write_once_is_caught_through_a_crash(race):
    """The lost acknowledged write: the witness replays through the host
    model, holds a ``Crash`` and ends in a history with no
    serialization."""
    model = PackedWriteOnce(2, durable=False).crash_restart(1, actors=[0])
    ck = model.checker().gpu_options(device="cpu", race=race,
                                     capacity=1 << 12).spawn_gpu().join()
    path = ck.assert_any_discovery("linearizable")
    assert any(isinstance(a, Crash) for a in path.into_actions())
    assert path.last_state().history.serialized_history() is None


ROW_GATE = [dict(fmax=16, capacity=1 << 12, cc_dedup=64, chunk_steps=8),
            dict(fmax=256, capacity=1 << 12, cc_dedup=64, chunk_steps=64)]


@pytest.mark.parametrize("opts", ROW_GATE, ids=["f16", "f256"])
@pytest.mark.parametrize("durable", [True, False],
                         ids=["durable", "volatile"])
def test_write_once_row_gate_against_jax_staged_engine(opts, durable):
    """Every shape knob set on both sides; the JAX package runs the
    model on its staged engine (its fused kernel has no history stage):
    the same search record row for row, counts and discoveries."""
    opts = dict(opts, pipeline=False)

    def mk(cls):
        return cls(2, durable=durable).crash_restart(1, actors=[0])
    want = mk(JWriteOnce).checker().tpu_options(
        race=False, fused=False, mode="device", **opts).spawn_tpu().join()
    got = _cpu(mk(PackedWriteOnce), **opts)
    want._ensure_mirror()
    got._ensure_mirror()
    assert got.unique_state_count() == want.unique_state_count()
    assert got.state_count() == want.state_count()
    assert list(got._generated.items()) == list(want._generated.items())
    assert got._discovery_fps == want._discovery_fps


def test_paxos1_under_crashes_on_the_gpu_engine():
    """PackedPaxos(1) under ``crash_restart(1, actors=[0, 1, 2])``: its
    pin (the JAX package's host BFS's count, generated count and
    digest, which chip_smoke.py holds the card to), ``linearizable``
    holding and ``value chosen`` found."""
    assert _chip_smoke().PIN_PAXOS1_CRASH == PIN_PAXOS1_CRASH
    ck = _cpu(PackedPaxos(1).crash_restart(1, actors=[0, 1, 2]),
              capacity=1 << 15, fmax=1024)
    assert (ck.unique_state_count(), ck.state_count(),
            _digest(ck.generated_fingerprints())) == PIN_PAXOS1_CRASH
    ck.assert_no_discovery("linearizable")
    ck.assert_any_discovery("value chosen")


def test_write_once_pins_are_the_jax_packages():
    """chip_smoke.py's write-once pins are the JAX package's host BFS's
    counts and digests."""
    smoke = _chip_smoke()
    for pin, model in (
            (smoke.PIN_WO2, JWriteOnce(2).crash_restart(1, actors=[0])),
            (smoke.PIN_WO7, JWriteOnce(7, net_capacity=16).crash_restart(
                2, actors=[0]))):
        ck = model.checker().spawn_bfs().join()
        assert (ck.unique_state_count(), ck.state_count(),
                _digest(ck.generated_fingerprints())) == pin
        ck.assert_no_discovery("linearizable")


# --- cuda_spec: what the card takes and refuses ---------------------------

class _OwnRecovery(PackedWriteOnce):
    def packed_on_restart(self, actors, aidx):
        return super().packed_on_restart(actors, aidx)


def test_cuda_spec_names_the_crash_instantiations():
    name, params = PackedWriteOnce(2).crash_restart(
        1, actors=[0]).cuda_spec()
    assert (name, params) == ("write_once", (2, 1, 8, 1, 1, 0, 1, 0))
    name, params = PackedWriteOnce(7, durable=False, net_capacity=16) \
        .crash_restart(2).cuda_spec()
    assert name == "write_once" and params[3:6] == (2, 8, 0x76543210)
    assert params[6:] == (0, 0)  # nothing durable
    assert PackedWriteOnce(2).cuda_spec()[1] == (2, 1, 8, 0, 0, 0, 0, 0)
    name, params = PackedPaxos(3).crash_restart(
        1, actors=[0, 1, 2]).cuda_spec()
    assert name == "paxos_crash"
    assert params == (3, 3, 16, 1, 3, 0x210, (1 << 18) - 1, 0)
    assert PackedPaxos(3).cuda_spec() == ("paxos", (3, 3, 16))


def _ordered_crash():
    from stateright_tpu_torch.examples.abd_packed import PackedAbd
    return PackedAbd(1, ordered=True).crash_restart(1, actors=[0, 1])


def _timers():
    model = PackedWriteOnce(2).crash_restart(1, actors=[0])
    model.device_timers = True
    return model


@pytest.mark.parametrize("make,symmetry,match", [
    (_ordered_crash, False, "crash"),
    (lambda: PackedWriteOnce(2).lossy_network(True).crash_restart(
        1, actors=[0]), False, "lossy"),
    (_timers, False, "timers"),
    (lambda: PackedWriteOnce(2).crash_restart(1, actors=[0]), True,
     "packed_representative"),
    (lambda: PackedPaxos(1).crash_restart(1), True,
     "packed_representative"),
    (lambda: _OwnRecovery(2).crash_restart(1, actors=[0]), False,
     "overrides packed_on_restart"),
    (lambda: PackedSingleCopy(2).crash_restart(1), False, "crash")],
    ids=["ordered", "lossy", "timers", "symmetry", "paxos-symmetry",
         "own-recovery", "single-copy"])
def test_cuda_spec_refuses(make, symmetry, match):
    with pytest.raises(NotImplementedError, match=match):
        make().cuda_spec(symmetry)


def test_too_many_crashes_are_refused():
    with pytest.raises(NotImplementedError, match="k <= 7"):
        PackedWriteOnce(1).crash_restart(8, actors=[0])


def test_crash_on_the_ordered_network_keeps_the_jax_message():
    with pytest.raises(NotImplementedError, match="spawn_bfs"):
        _ordered_crash().max_actions


# --- the CLI and the imports ----------------------------------------------

def test_cli(capsys):
    from stateright_tpu_torch.examples import write_once_packed
    assert write_once_packed.main(["check", "2"]) == 0
    out = capsys.readouterr().out
    assert "durable server, 2 clients, max_crashes=1" in out
    assert "51" in out
    assert write_once_packed.main(["check-gpu", "2", "volatile", "--cpu",
                                   "--no-race"]) == 0
    out = capsys.readouterr().out
    assert "linearizable" in out and "volatile" in out
    assert write_once_packed.main(["check-gpu", "1", "no-crash",
                                   "--cpu"]) == 0
    assert "max_crashes=0" in capsys.readouterr().out
    assert write_once_packed.main([]) == 2


def test_crash_run_loads_no_jax():
    code = (
        "import sys\n"
        "from stateright_tpu_torch.examples.write_once_packed import "
        "PackedWriteOnce\n"
        "ck = PackedWriteOnce(2, durable=False).crash_restart(1, "
        "actors=[0]).checker().gpu_options(device='cpu', race=False)"
        ".spawn_gpu().join()\n"
        "assert ck.discovery('linearizable') is not None\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'stateright_tpu'))\n"
        "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                   timeout=300)
