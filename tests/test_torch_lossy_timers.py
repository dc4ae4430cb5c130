"""The lossy drop lanes, the duplicating network and the device timers on
the port against the JAX package: the plain batched step's drop and
Timeout lanes lane for lane against the JAX package's ``packed_step``
(both unordered networks, the ordered network's Timeout lanes, crashes
stacked on drops and on timers; reachable, crowded and random rows), the
host/device contract (``validate_packed_model``, the counts the JAX
package's tests pin), the GPU engine on the CPU (the plain versions of
K1-K3, K7, K8 and K9): the set gate at lossy Paxos(1) and
TimerCount(3, 2), the row gate at PingPong(5) against the JAX package's
fused engine; the pins ``chip_smoke.py`` holds the card to; what
``cuda_spec`` names and refuses; and a lossy run that loads no JAX.
Inputs come from a numpy seed and host BFS frontiers; every integer
output is held exactly (tolerance 0)."""

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

from stateright_tpu.actor import Network as JNetwork  # noqa: E402
from stateright_tpu.actor import test_util as jtu  # noqa: E402
from stateright_tpu.examples.paxos_packed import \
    PackedPaxos as JPaxos  # noqa: E402
from stateright_tpu.examples.single_copy_packed import \
    PackedSingleCopy as JSingleCopy  # noqa: E402
from stateright_tpu.fingerprint import fp64_words as jfp64_words  # noqa
from stateright_tpu_torch.actor import (Drop, Envelope, Id,  # noqa: E402
                                        Network, Timeout)
from stateright_tpu_torch.actor import test_util as tu  # noqa: E402
from stateright_tpu_torch.examples.abd_packed import PackedAbd  # noqa
from stateright_tpu_torch.examples.paxos_packed import \
    PackedPaxos  # noqa: E402
from stateright_tpu_torch.examples.single_copy_packed import \
    PackedSingleCopy  # noqa: E402
from stateright_tpu_torch.examples.write_once_packed import \
    PackedWriteOnce  # noqa: E402
from stateright_tpu_torch.models.packed import \
    validate_packed_model  # noqa: E402
from stateright_tpu_torch.ops import _cuda  # noqa: E402
from stateright_tpu_torch.ops.hash_kernel import fp64_device  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent


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


def _reachable_rows(model, limit):
    """Up to ``limit`` encoded states of a host BFS of ``model`` within
    its boundary (a state whose network outgrows the encoding is
    skipped)."""
    seen, rows, queue = set(), [], list(model.init_states())
    while queue and len(rows) < limit:
        s = queue.pop(0)
        if not model.within_boundary(s):
            continue
        try:
            enc = model.encode(s)
        except ValueError:
            continue
        if enc.tobytes() in seen:
            continue
        seen.add(enc.tobytes())
        rows.append(enc)
        queue.extend(model.next_states(s))
    return np.stack(rows).astype(np.uint32)


def _crowded(model, rows, rng, k):
    """``k`` of ``rows`` with every empty network slot filled with an
    envelope of an unknown type and random counts on about half the
    occupied ones: sends there overflow, drops keep or shift slots."""
    out = rows[rng.choice(len(rows), k)].copy()
    e, sw = model.net_capacity, model._sw
    for j, row in enumerate(out):
        net = row[model._net_off:model._timer_off].reshape(e, sw)
        for s in range(e):
            if not net[s, 0] and j % 2:
                net[s, 0] = (1 << 16) | (1 << 8) | 0
                net[s, 1] = 1
                net[s, 2] = 0xF00 | s
            elif net[s, 0] and rng.random() < 0.5:
                net[s, 1] = rng.integers(1, 4)
        # keep the sorted layout's invariant: the empties last
        occ = net[:, 0] != 0
        net[:] = np.concatenate([net[occ], net[~occ]])
    return out


def _same_step(tm, jm, seed, limit=200, crowd=True):
    """The batched step against the JAX package's ``packed_step`` on
    every lane (junk and invalid lanes too), over a host BFS frontier,
    crowded rows and random words; the properties, and the fingerprints
    of the valid children (the JAX package's ``fp64_words`` of their
    words: a random row's child need not be a state's canonical
    encoding). Returns ``(valid, overflow)``."""
    rng = np.random.default_rng(seed)
    rows = _reachable_rows(tm, limit)
    junk = rng.integers(0, 2 ** 32, size=(24, tm.packed_width),
                        dtype=np.uint64).astype(np.uint32)
    parts = [rows, junk]
    if crowd:
        parts.append(_crowded(tm, rows, rng, 40))
    rows = np.concatenate(parts)
    x = torch.from_numpy(rows.astype(np.int64))
    succ, valid, ovf = tm.packed_step(x)
    js, jv, jo = jax.vmap(jm.packed_step)(jnp.asarray(rows))
    assert np.array_equal(succ.numpy().astype(np.uint32), np.asarray(js))
    assert np.array_equal(valid.numpy(), np.asarray(jv))
    assert np.array_equal(ovf.numpy(), np.asarray(jo))
    assert np.array_equal(tm.packed_properties(x).numpy(), np.asarray(
        jax.vmap(jm.packed_properties)(jnp.asarray(rows))))
    flat = succ.reshape(-1, tm.packed_width)
    sel = valid.reshape(-1)
    hi, lo = fp64_device(flat[sel][:60])
    want = [jfp64_words(r.tolist())
            for r in flat[sel][:60].numpy().astype(np.uint32)]
    assert [(h << 32) | low for h, low in zip(hi.tolist(),
                                               lo.tolist())] == want
    return valid.numpy(), ovf.numpy()


class _OrderedTimers(tu.PackedTimerCount):
    """TimerCount on the ordered network: the Timeout lanes after one
    delivery lane a channel (the JAX package's ``_packed_step_ordered``
    ``:664-692``)."""

    def __init__(self, n, max_nat):
        super().__init__(n, max_nat)
        self.init_network(Network.new_ordered())
        self.finalize_layout()


class _JOrderedTimers(jtu.PackedTimerCount):
    def __init__(self, n, max_nat):
        super().__init__(n, max_nat)
        self.init_network(JNetwork.new_ordered())
        self.finalize_layout()


#: (the port's model, the JAX package's) of each configuration whose plain
#: step is held lane for lane
STEPS = {
    "ping-pong-lossy-dup": lambda: (tu.PackedPingPong(5, True, True),
                                    jtu.PackedPingPong(5, True, True)),
    "ping-pong-lossy": lambda: (tu.PackedPingPong(5, True, False),
                                jtu.PackedPingPong(5, True, False)),
    "ping-pong-dup": lambda: (tu.PackedPingPong(5, False, True),
                              jtu.PackedPingPong(5, False, True)),
    "ping-pong": lambda: (tu.PackedPingPong(5, False, False),
                          jtu.PackedPingPong(5, False, False)),
    "ping-pong-lossy-dup-e3": lambda: (
        tu.PackedPingPong(6, True, True, net_capacity=3),
        jtu.PackedPingPong(6, True, True, net_capacity=3)),
    "single-copy-2-lossy": lambda: (
        PackedSingleCopy(2).lossy_network(True),
        JSingleCopy(2).lossy_network(True)),
    "paxos-1-lossy": lambda: (PackedPaxos(1).lossy_network(True),
                              JPaxos(1).lossy_network(True)),
    "timer-count-2x3": lambda: (tu.PackedTimerCount(2, 3),
                                jtu.PackedTimerCount(2, 3)),
    "timer-count-ordered": lambda: (_OrderedTimers(2, 3),
                                    _JOrderedTimers(2, 3)),
    "timer-count-crash": lambda: (
        tu.PackedTimerCount(2, 2).crash_restart(2),
        jtu.PackedTimerCount(2, 2).crash_restart(2)),
    "ping-pong-lossy-crash": lambda: (
        tu.PackedPingPong(2, duplicating=False).lossy_network(True)
        .crash_restart(1),
        jtu.PackedPingPong(2, duplicating=False).lossy_network(True)
        .crash_restart(1)),
}


@pytest.mark.parametrize("config", list(STEPS))
def test_plain_step_is_the_jax_packages_lane_for_lane(config):
    """The drop lanes on both unordered networks, the Timeout lanes on
    the unordered and the ordered network, and crashes stacked on drops
    and on timers (``cr_base`` past both), against the JAX package's
    ``packed_step``; every lane kind is valid somewhere."""
    tm, jm = STEPS[config]()
    assert (tm.packed_width, tm.max_actions) == (jm.packed_width,
                                                 jm.max_actions)
    crowd = not tm._net_ordered and tm.net_capacity > 1
    valid, ovf = _same_step(tm, jm, seed=len(config), crowd=crowd)
    a, e = tm.max_actions, (tm._n_chan if tm._net_ordered
                            else tm.net_capacity)
    base = e * (2 if tm.lossy_network_ else 1)
    assert valid[:, :e].any() or tm.device_timers
    if tm.lossy_network_:
        assert valid[:, e:2 * e].any()
        assert not ovf[:, e:2 * e].any()
    if tm.device_timers:
        assert valid[:, base:base + len(tm.actor_widths)].any()
    if tm.max_crashes_:
        assert valid[:, a - 2 * len(tm._crash_idx):].any()
    if config == "ping-pong-lossy-dup-e3":
        assert ovf.any()


def test_drop_lanes_remove_or_consume():
    """A drop on the duplicating network removes the envelope outright
    (``net_remove``); on the non-duplicating one it takes one copy
    (``net_consume``): a count above one stays in place."""
    for dup in (True, False):
        model = tu.PackedPingPong(5, True, dup)
        row = model.encode(model.init_states()[0]).astype(np.int64)
        off = model._net_off
        row[off + 1] = 3  # three copies of Ping(0)
        succ, valid, _ = model.packed_step(torch.from_numpy(row)[None])
        drop = succ[0, model.net_capacity].numpy()
        assert valid[0, model.net_capacity]
        if dup:
            assert not drop[off:off + 3].any()
        else:
            assert drop[off + 1] == 2
            assert np.array_equal(drop[off:off + 1], row[off:off + 1])


def test_noop_keep_handler_is_a_self_loop():
    """A Timeout is never pruned as a no-op: a handler that changes
    nothing and keeps its timer yields the row itself, valid, on both
    packages (``tests/test_packed_timers.py``
    ``test_noop_keep_handler_matches_host_selfloop``)."""
    class _Idle(tu.PackedTimerCount):
        def packed_on_timeout(self, actors, aidx):
            n = actors.shape[0]
            yes = torch.ones((n,), dtype=torch.bool)
            return actors, torch.zeros_like(yes), [tu._no_send(
                n, self.msg_width, actors.device)], yes

    class _JIdle(jtu.PackedTimerCount):
        def packed_on_timeout(self, actors, aidx):
            new, changed, sends, keep = super().packed_on_timeout(actors,
                                                                  aidx)
            return actors, jnp.bool_(False), sends, jnp.bool_(True)

    tm, jm = _Idle(2, 3), _JIdle(2, 3)
    row = tm.encode(tm.init_states()[0])
    succ, valid, _ = tm.packed_step(torch.from_numpy(
        row.astype(np.int64))[None])
    js, jv, _ = jm.packed_step(jnp.asarray(row))
    assert np.array_equal(succ[0].numpy().astype(np.uint32), np.asarray(js))
    assert np.array_equal(valid[0].numpy(), np.asarray(jv))
    for a in (1, 2):
        assert valid[0, a] and np.array_equal(succ[0, a].numpy(), row)


@pytest.mark.parametrize("make,max_states,count", [
    (lambda: tu.PackedPingPong(5, lossy=True, duplicating=True), 5000,
     4_094),
    (lambda: tu.PackedPingPong(5, lossy=False, duplicating=False), 100, 11),
    (lambda: tu.PackedPingPong(5, lossy=False, duplicating=True), 100, 11),
    (lambda: tu.PackedPingPong(5, lossy=True, duplicating=False), 100, 22),
    (lambda: tu.PackedTimerCount(2, 3), 100, 16),
    (lambda: tu.PackedTimerCount(2, 2).crash_restart(2), 200, 49),
], ids=["lossy-dup", "lossless", "dup", "lossy", "timers", "timers-crash"])
def test_contract_counts_are_the_jax_tests(make, max_states, count):
    """The host/device contract over the whole space, with the counts the
    JAX package's tests pin (``tests/test_packed_pingpong.py``,
    ``tests/test_packed_timers.py``, ``tests/test_crash_restart.py``)."""
    assert validate_packed_model(make(), max_states=max_states) == count


def test_set_gate_lossy_paxos1():
    """Lossy Paxos(1) on the GPU engine's CPU path: the JAX device
    engine's count, ``state_count()`` and digest (``chip_smoke.py``
    ``PIN_PAXOS1_LOSSY``), ``linearizable`` holding, ``value chosen``
    replayed."""
    smoke = _chip_smoke()
    ck = _cpu(PackedPaxos(1).lossy_network(True), fmax=256)
    assert (ck.unique_state_count(), ck.state_count(),
            _digest(ck.generated_fingerprints())) == smoke.PIN_PAXOS1_LOSSY
    ck.assert_no_discovery("linearizable")
    ck.assert_any_discovery("value chosen")


def test_set_gate_timer_count():
    smoke = _chip_smoke()
    ck = _cpu(tu.PackedTimerCount(3, 2), fmax=16)
    assert (ck.unique_state_count(), ck.state_count(),
            _digest(ck.generated_fingerprints())) == smoke.PIN_TIMER3
    ck.assert_no_discovery("bounded")
    path = ck.assert_any_discovery("all max")
    assert all(isinstance(a, Timeout) for a in path.into_actions())


@pytest.mark.parametrize("make,pin", [
    (lambda m: m.PackedPingPong(5, lossy=True, duplicating=True),
     "PIN_PING5"),
    (lambda m: m.PackedPingPong(5, lossy=False, duplicating=False),
     "PIN_PING5_LOSSLESS"),
    (lambda m: m.PackedTimerCount(3, 2), "PIN_TIMER3"),
], ids=["ping-pong-5", "ping-pong-5-lossless", "timer-count-3"])
def test_pins_are_the_jax_packages(make, pin):
    """The pins ``chip_smoke.py`` holds the card to are the JAX
    package's: its host BFS gives these counts and this digest."""
    ck = make(jtu).checker().spawn_bfs().join()
    assert (ck.unique_state_count(), ck.state_count(),
            _digest(ck.generated_fingerprints())) \
        == getattr(_chip_smoke(), pin)


def test_lossy_paxos1_pin_is_the_jax_packages():
    ck = JPaxos(1).lossy_network(True).checker().spawn_bfs().join()
    assert (ck.unique_state_count(), ck.state_count(),
            _digest(ck.generated_fingerprints())) \
        == _chip_smoke().PIN_PAXOS1_LOSSY


ROW_GATE = dict(fmax=64, capacity=1 << 12, cc_dedup=256, chunk_steps=4,
                pipeline=False)


def test_ping_pong_row_gate_against_jax_fused_engine():
    """PingPong(5), lossy and duplicating, on both engines with every
    shape knob set (the JAX engine's size memo could otherwise move its
    defaults): the same search record row for row, the same
    discoveries, the drop witness the JAX test pins."""
    want = jtu.PackedPingPong(5, lossy=True, duplicating=True).checker() \
        .tpu_options(race=False, fused=True, mode="device",
                     **ROW_GATE).spawn_tpu().join()
    got = _cpu(tu.PackedPingPong(5, lossy=True, duplicating=True),
               **ROW_GATE)
    want._ensure_mirror()
    got._ensure_mirror()
    assert got.unique_state_count() == want.unique_state_count() == 4_094
    assert got.state_count() == want.state_count()
    assert list(got._generated.items()) == list(want._generated.items())
    assert got._discovery_fps == want._discovery_fps
    got.assert_no_discovery("delta within 1")
    path = got.assert_any_discovery("must reach max")
    assert any(isinstance(a, Drop) for a in path.into_actions())
    got.assert_discovery("must reach max", [
        Drop(Envelope(src=Id(0), dst=Id(1), msg=tu.Ping(0)))])


def test_lossless_ping_pong_on_the_cpu_path():
    ck = _cpu(tu.PackedPingPong(5, lossy=False, duplicating=False),
              fmax=16)
    assert (ck.unique_state_count(), ck.state_count(),
            _digest(ck.generated_fingerprints())) \
        == _chip_smoke().PIN_PING5_LOSSLESS
    ck.assert_no_discovery("delta within 1")
    ck.assert_no_discovery("must reach max")
    ck.assert_any_discovery("can reach max")


@pytest.mark.parametrize("make", [
    lambda: tu.PackedPingPong(4, lossy=True, duplicating=True),
    lambda: tu.PackedPingPong(4, lossy=True, duplicating=False),
    lambda: tu.PackedPingPong(4, lossy=False, duplicating=True),
    lambda: tu.PackedTimerCount(3, 3),
], ids=["lossy-dup", "lossy", "dup", "timer-count"])
def test_needed_lanes_hold_every_valid_lane(make):
    """``chip_smoke.py`` ``lossy_active``, the lanes the narrow K1s'
    bounds count, names every lane whose child is valid or overflows,
    and none of the deliveries or drops past the network's zero tail or
    the Timeout lanes of actors whose timer is off."""
    model = make()
    rows = _reachable_rows(model, 200)
    rows = np.concatenate([rows, _crowded(model, rows,
                                          np.random.default_rng(7), 40)])
    x = torch.from_numpy(rows.astype(np.int64))
    _succ, valid, ovf = model.packed_step(x)
    need = _chip_smoke().lossy_active(model)(x).reshape(valid.shape)
    assert not (valid & ~need).any() and not (ovf & ~need).any()
    assert not need.all()


def test_cuda_spec_names_the_new_instantiations():
    for model, spec in (
            (PackedPaxos(2).lossy_network(True), ("paxos_lossy", (2, 3, 16))),
            (tu.PackedPingPong(5, True, True), ("ping_pong", (5, 16, 1, 1))),
            (tu.PackedPingPong(7, False, False, net_capacity=8),
             ("ping_pong", (7, 8, 0, 0))),
            (tu.PackedTimerCount(8, 4), ("timer_count", (8, 4)))):
        assert model.cuda_spec() == spec
        assert _cuda.step_entry(model, False) == spec
        assert spec[0] in _cuda.SINGLE_CHIP_MODELS
        names = {e[0] for lib in _cuda._ENTRIES.values() for e in lib}
        assert f"srt_fused_step_{spec[0]}" in names
        assert f"srt_dedup_step_{spec[0]}" not in names
    assert _cuda.row_words("paxos_lossy") == 128
    assert PackedPaxos(2).lossy_network(True).max_actions == 32


class _OwnDeliver(tu.PackedPingPong):
    def packed_deliver(self, actors, src, dst, msg):
        return super().packed_deliver(actors, src, dst, msg)


class _OwnTimeout(tu.PackedTimerCount):
    def packed_on_timeout(self, actors, aidx):
        return super().packed_on_timeout(actors, aidx)


def _timers(model):
    model.device_timers = True
    return model


@pytest.mark.parametrize("make,match", [
    (lambda: PackedAbd(2).lossy_network(True), "lossy"),
    (lambda: PackedSingleCopy(2).lossy_network(True), "lossy"),
    (lambda: PackedAbd(2, ordered=True).lossy_network(True), "lossy"),
    (lambda: PackedWriteOnce(2).lossy_network(True), "lossy"),
    (lambda: PackedWriteOnce(2).lossy_network(True).crash_restart(
        1, actors=[0]), "lossy"),
    (lambda: PackedPaxos(1).lossy_network(True).crash_restart(1), "lossy"),
    (lambda: _timers(PackedPaxos(1)), "timers"),
    (lambda: _dup_single_copy(), "duplicating"),
    (lambda: tu.PackedPingPong(5, True, True).crash_restart(1), "crash"),
    (lambda: _timers(tu.PackedPingPong(5)), "timers"),
    (lambda: tu.PackedPingPong(5, net_capacity=17), "16 network slots"),
    (lambda: _OwnDeliver(5), "overrides packed_deliver"),
    (lambda: tu.PackedTimerCount(2, 2).lossy_network(True), "lossy"),
    (lambda: tu.PackedTimerCount(2, 2).crash_restart(1), "crash"),
    (lambda: tu.PackedTimerCount(33, 2), "32 actors"),
    (lambda: _OwnTimeout(2, 2), "overrides packed_on_timeout"),
], ids=["abd", "single-copy", "abd-ordered", "write-once",
        "write-once-crash", "paxos-crash", "paxos-timers",
        "single-copy-dup", "ping-pong-crash", "ping-pong-timers",
        "ping-pong-wide", "ping-pong-subclass", "timer-lossy",
        "timer-crash", "timer-wide", "timer-subclass"])
def test_cuda_spec_refuses(make, match):
    """What the card refuses: ABD, the single-copy and the write-once
    register on a lossy network (they check on the CPU), lossy together
    with crashes (PackedWriteOnce(2) lossy under ``crash_restart``: 16 +
    16 + 2 = 34 lanes), Timeout lanes on a register model, the
    duplicating network for register models, and the fixtures' own
    limits; each message names what is refused."""
    with pytest.raises(NotImplementedError, match=match):
        make().cuda_spec()


def _dup_single_copy():
    model = PackedSingleCopy(2)
    model.init_network(Network.new_unordered_duplicating())
    model.finalize_layout()
    return model


def test_lossy_registers_still_check_on_the_cpu():
    """ABD lossy is refused on the card but runs its plain version on the
    CPU, to the JAX package's host BFS."""
    from stateright_tpu.examples.abd_packed import PackedAbd as JAbd
    want = JAbd(1).lossy_network(True).checker().spawn_bfs().join()
    ck = _cpu(PackedAbd(1).lossy_network(True), fmax=64)
    assert ck.unique_state_count() == want.unique_state_count()
    assert ck.generated_fingerprints() == want.generated_fingerprints()


def test_lossy_run_loads_no_jax():
    code = (
        "import sys\n"
        "from stateright_tpu_torch.examples.paxos_packed import "
        "PackedPaxos\n"
        "from stateright_tpu_torch.actor.test_util import (PackedPingPong,"
        " PackedTimerCount)\n"
        "ck = PackedPaxos(1).lossy_network(True).checker().gpu_options("
        "device='cpu', race=False, fmax=256).spawn_gpu().join()\n"
        "assert ck.unique_state_count() == 2378\n"
        "ck = PackedPingPong(5, lossy=True).checker().gpu_options("
        "device='cpu', race=False, fmax=256).spawn_gpu().join()\n"
        "assert ck.unique_state_count() == 4094\n"
        "ck = PackedTimerCount(3, 2).checker().gpu_options("
        "device='cpu', race=False).spawn_gpu().join()\n"
        "assert ck.unique_state_count() == 27\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'stateright_tpu'))\n"
        "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                   timeout=300)


@pytest.mark.slow
def test_lossy_paxos2_pin_on_the_cpu_path():
    """Lossy Paxos(2) in full on the CPU: ``PIN_PAXOS2_LOSSY``, the JAX
    package's device engine's (minutes)."""
    ck = _cpu(PackedPaxos(2).lossy_network(True), capacity=1 << 22)
    assert (ck.unique_state_count(), ck.state_count(),
            _digest(ck.generated_fingerprints())) \
        == _chip_smoke().PIN_PAXOS2_LOSSY
    ck.assert_no_discovery("linearizable")
    ck.assert_any_discovery("value chosen")

