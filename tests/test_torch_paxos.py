"""PackedPaxos on the port against the JAX package: the packed layout and
codec, the plain batched step, properties and record hooks bit for bit,
the host-evaluated ``linearizable`` property, the host BFS, and the GPU
engine on the CPU (the plain versions of K1-K3, K7, K8 and K9) with its
history stage — row for row against the JAX package's staged engine at
Paxos(1), the JAX digest at Paxos(2), a forced history growth, a failing
``linearizable`` whose witness replays, and the options and
configurations that raise. Inputs come from a numpy seed and host BFS
frontiers; every integer output is held exactly."""

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

from stateright_tpu.examples.paxos_packed import \
    PackedPaxos as JPaxos  # noqa: E402
from stateright_tpu_torch import TwoPhaseSys  # noqa: E402
from stateright_tpu_torch.actor import Id, Network  # noqa: E402
from stateright_tpu_torch.actor.register import GetOk  # noqa: E402
from stateright_tpu_torch.checker.device_loop import (  # noqa: E402
    history_reference, hpull_reference, new_history)
from stateright_tpu_torch.examples.paxos import PaxosActor  # noqa: E402
from stateright_tpu_torch.examples.paxos_packed import (  # noqa: E402
    T_GET, PackedPaxos)
from stateright_tpu_torch.ops.hash_kernel import fp64_device  # noqa: E402
from stateright_tpu_torch.ops.words import M32  # noqa: E402

#: PackedPaxos(2): unique states (the Rust crate's paxos.rs:291),
#: state_count() and the sha256 of the sorted fingerprints (chip_smoke.py
#: PIN_PAXOS2)
PIN_PAXOS2 = (16_668, 32_971,
              "184fdb02ebca156876cc206a2c39ce2c"
              "c11186fb868ec1b3c6b1fdf63b516971")


ROOT = pathlib.Path(__file__).resolve().parent.parent


def _chip_smoke():
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    return chip_smoke


def _digest(fps) -> str:
    arr = np.array(sorted(fps), dtype=np.uint64)
    return hashlib.sha256(arr.astype("<u8").tobytes()).hexdigest()


def _cpu(model, **opts):
    opts = {"device": "cpu", "race": False, **opts}
    return model.checker().gpu_options(**opts).spawn_gpu().join()


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


def _crowded(model, rows, rng, k):
    """``k`` rows of ``rows`` with their networks filled up to or near
    the slot count by envelopes to a missing actor (never delivered, but
    they take slots), re-sorted: the sends of their children overflow."""
    e_cap = model.net_capacity
    out = []
    for r in rows[rng.choice(len(rows), k)]:
        r = r.copy()
        slots = r[model._net_off:model._timer_off].reshape(e_cap, 4)
        occ = [tuple(int(x) for x in s) for s in slots if s[0] & (1 << 16)]
        for j in range(len(occ), int(rng.integers(len(occ), e_cap + 1))):
            occ.append(((1 << 16) | (7 << 8) | (20 + j), 1, 14 << 24, j))
        occ.sort(key=lambda t: (t[0], t[2], t[3]))
        slots[:] = 0
        for j, t in enumerate(occ):
            slots[j] = t
        out.append(r)
    return np.stack(out)


@pytest.mark.parametrize("clients", [1, 2, 3])
def test_layout_and_codec_match_jax(clients):
    tm, jm = PackedPaxos(clients), JPaxos(clients)
    for attr in ("packed_width", "max_actions", "_actor_off", "_net_off",
                 "_timer_off", "_hist_off", "history_width", "max_sends",
                 "host_property_cols", "host_property_indices"):
        assert getattr(tm, attr) == getattr(jm, attr), attr
    assert tm.packed_width == {1: 88, 2: 92, 3: 96}[clients]
    rows = _reachable_rows(tm, 400)
    for r in rows:
        state = tm.decode(r)
        assert np.array_equal(tm.encode(state), r)
        assert np.array_equal(jm.encode(jm.decode(r)), r)
        assert tm.fingerprint(state) == jm.fingerprint(jm.decode(r))


@pytest.mark.parametrize("clients", [1, 2, 3])
def test_plain_step_properties_and_hooks_match_jax(clients):
    """The batched step (with the register dispatch, the Paxos server
    step, the history record hooks and the network's consume and send),
    the properties and the fingerprints, lane for lane and on every lane
    (invalid and overflowing ones too), over a host BFS frontier, rows
    with nearly full networks and random words."""
    tm, jm = PackedPaxos(clients), JPaxos(clients)
    rng = np.random.default_rng(40 + clients)
    rows = _reachable_rows(tm, 300)
    junk = rng.integers(0, 2 ** 32, size=(32, tm.packed_width),
                        dtype=np.uint64).astype(np.uint32)
    rows = np.concatenate([rows, _crowded(tm, rows, rng, 48), junk])
    succ, valid, ovf = tm.packed_step(torch.from_numpy(rows.astype(
        np.int64)))
    js, jv, jo = jax.vmap(jm.packed_step)(jnp.asarray(rows))
    assert np.array_equal(succ.numpy().astype(np.uint32), np.asarray(js))
    assert np.array_equal(valid.numpy(), np.asarray(jv))
    assert np.array_equal(ovf.numpy(), np.asarray(jo))
    if clients > 1:
        assert ovf.any()  # the crowded rows overflow
    props = tm.packed_properties(torch.from_numpy(rows.astype(np.int64)))
    assert np.array_equal(props.numpy(), np.asarray(
        jax.vmap(jm.packed_properties)(jnp.asarray(rows))))
    flat = succ.reshape(-1, tm.packed_width)
    hi, lo = fp64_device(flat)
    want = [jm.fingerprint(jm.decode(r)) for r in
            flat[valid.reshape(-1)].numpy().astype(np.uint32)[:50]]
    sel = valid.reshape(-1)
    got = [(h << 32) | lo_ for h, lo_ in zip(hi[sel][:50].tolist(),
                                             lo[sel][:50].tolist())]
    assert got == want


def test_linearizable_agrees_on_every_history_of_paxos1():
    tm, jm = PackedPaxos(1), JPaxos(1)
    rows = _reachable_rows(tm, 10_000)
    assert len(rows) == 265
    hists = {r[tm._hist_off:].tobytes(): r for r in rows}
    fn = tm.host_property_fns["linearizable"]
    jfn = jm.host_property_fns["linearizable"]
    for r in hists.values():
        want = jfn(r)
        assert fn(r) == want
        # and the full host property on the decoded state
        state = tm.decode(r)
        assert tm.properties()[0].condition(tm, state) == want
    assert tm.host_property_key_block(rows) == [
        jm.host_property_key(r) for r in rows]


@pytest.mark.parametrize("clients,unique", [(1, 265), (2, 16_668)])
def test_host_bfs_counts(clients, unique):
    ck = PackedPaxos(clients).checker().spawn_bfs().join()
    assert ck.unique_state_count() == unique
    ck.assert_no_discovery("linearizable")
    ck.assert_any_discovery("value chosen")


ROW_GATE = [dict(fmax=16, capacity=1 << 12, cc_dedup=64, chunk_steps=8),
            dict(fmax=256, capacity=1 << 12, cc_dedup=64, chunk_steps=64)]


@pytest.mark.parametrize("opts", ROW_GATE, ids=["f16", "f256"])
def test_paxos1_row_gate_against_jax_staged_engine(opts):
    """Every shape knob set on both sides (the JAX engine's size memo
    could otherwise move its defaults); the JAX package runs Paxos on
    its staged engine (its fused kernel has no history stage)."""
    opts = dict(opts, pipeline=False)
    want = JPaxos(1).checker().tpu_options(
        race=False, fused=False, mode="device", **opts).spawn_tpu().join()
    got = _cpu(PackedPaxos(1), **opts)
    want._ensure_mirror()
    got._ensure_mirror()
    assert got.unique_state_count() == want.unique_state_count() == 265
    assert got.state_count() == want.state_count()
    assert list(got._generated.items()) == list(want._generated.items())
    assert got._discovery_fps == want._discovery_fps
    got.assert_no_discovery("linearizable")


@pytest.mark.parametrize("engine", ["bfs", "staged"])
def test_paxos_pins_are_the_jax_packages(engine):
    """The Paxos(2) pins that chip_smoke.py and the card tests hold the
    card to are the JAX package's own: its host BFS and its staged
    device engine on the CPU give these counts and this digest, and the
    staged engine evaluates ``HISTORIES_PAXOS2`` distinct histories."""
    smoke = _chip_smoke()
    assert smoke.PIN_PAXOS2 == PIN_PAXOS2
    builder = JPaxos(2).checker()
    if engine == "bfs":
        ck = builder.spawn_bfs().join()
    else:
        ck = builder.tpu_options(race=False, fused=False,
                                 mode="device").spawn_tpu().join()
        assert len(ck._host_prop_cache) == smoke.HISTORIES_PAXOS2
    assert (ck.unique_state_count(), ck.state_count(),
            _digest(ck.generated_fingerprints())) == PIN_PAXOS2
    ck.assert_no_discovery("linearizable")
    ck.assert_any_discovery("value chosen")


@pytest.mark.slow
def test_paxos3_histories_pin_is_the_jax_packages():
    """The BASELINE workload's distinct histories that chip_smoke.py
    pins: the JAX package's staged engine on the CPU, at bench.py's
    size and budget, evaluates ``HISTORIES_PAXOS3`` of them (~10 s)."""
    smoke = _chip_smoke()
    ck = JPaxos(3).checker().tpu_options(
        race=False, fused=False, mode="device", capacity=1 << 21) \
        .target_state_count(smoke.PAXOS3_TARGET).spawn_tpu().join()
    assert ck.unique_state_count() >= 500_000
    assert len(ck._host_prop_cache) == smoke.HISTORIES_PAXOS3
    ck.assert_no_discovery("linearizable")
    ck.assert_any_discovery("value chosen")


@pytest.mark.parametrize("hcap", [1 << 16, 4], ids=["default", "hcap4"])
def test_paxos2_pin_and_history_growth(hcap):
    """The full Paxos(2) space with the JAX digest, from the default
    history table and from one of 4 keys, which grows (and rescans the
    overflowing span) without losing a representative: the same
    distinct histories, logged and evaluated once each."""
    ck = _cpu(PackedPaxos(2), fmax=1024, hcap=hcap)
    assert (ck.unique_state_count(), ck.state_count(),
            _digest(ck.generated_fingerprints())) == PIN_PAXOS2
    ck.assert_no_discovery("linearizable")
    path = ck.assert_any_discovery("value chosen")  # replays
    model = ck.model()
    assert model.property("value chosen").condition(model,
                                                    path.last_state())
    prof = ck.profile()
    assert prof["h_n"] == prof["histories"] == \
        _chip_smoke().HISTORIES_PAXOS2
    if hcap == 4:
        assert prof["hgrow"] >= 1


def test_history_stage_plain_versions():
    """K8's plain version keeps the lowest row of each fresh key (in row
    order), refuses keys already in the table, and reports overflow past
    ``h_rounds``; K9's gathers rows and witness keys."""
    model = PackedPaxos(2)
    rows = _reachable_rows(model, 2000)
    w = model.packed_width
    q = torch.zeros((len(rows) + 4, w + 3), dtype=torch.int32)
    q[:len(rows), :w] = torch.from_numpy(rows.view(np.int32))
    hist = new_history(model, 1 << 8, 64, 0, "cpu")
    idx = torch.arange(len(rows), dtype=torch.int64)
    fresh, ovf = history_reference(q, hist, idx)
    keys = [r[model._hist_off:].tobytes() for r in rows]
    first = {}
    for i, k in enumerate(keys):
        first.setdefault(k, i)
    assert not ovf
    assert idx[fresh].tolist() == sorted(first.values())
    again, _ = history_reference(q, hist, idx)
    assert not again.any()
    tiny = new_history(model, 4, 64, 0, "cpu")
    full, ovf = history_reference(q, tiny, idx)
    assert ovf and int(full.sum()) == 4  # one bucket, then overflow
    log = torch.arange(2 * len(q), dtype=torch.int32).reshape(-1, 2)
    hidx = torch.tensor(sorted(first.values())[1:], dtype=torch.int32)
    out = hpull_reference(q, hidx, log, 1, 3, 1, 8)
    assert out.shape == (8, w + 2)
    for i in range(3):
        r = int(hidx[1 + i])
        assert torch.equal(out[i, :w], q[r, :w])
        assert torch.equal(out[i, w:], log[r - 1])
    assert not out[3:].any()


def test_checkpoint_of_a_paxos_run_resumes_to_the_pin(tmp_path):
    """A bounded run with host-evaluated properties saves and resumes:
    the resumed run starts an empty history stage at its frontier (the
    states before it were evaluated before the checkpoint) and ends at
    the full space with the JAX digest and the same verdicts."""
    model = PackedPaxos(2)
    opts = dict(fmax=256, race=False, device="cpu")
    part = model.checker().gpu_options(resumable=True, **opts) \
        .target_state_count(5000).spawn_gpu().join()
    assert part.unique_state_count() < PIN_PAXOS2[0]
    part.save(tmp_path / "paxos.npz")
    ck = model.checker().gpu_options(**opts).resume_from(
        tmp_path / "paxos.npz").spawn_gpu().join()
    assert (ck.unique_state_count(), ck.state_count(),
            _digest(ck.generated_fingerprints())) == PIN_PAXOS2
    ck.assert_no_discovery("linearizable")
    ck.assert_any_discovery("value chosen")


class _WholeRowHost(TwoPhaseSys):
    """2pc with ``consistent`` (which holds) host-evaluated on the whole
    row: every state is its own history, so the host must evaluate each
    explored state once."""

    host_property_indices = (2,)


@pytest.mark.parametrize("target", [50, 235])
@pytest.mark.parametrize("hcap", [4, 1 << 16], ids=["hcap4", "default"])
def test_every_explored_state_is_evaluated(target, hcap):
    """A bounded run whose last chunk overflows the history table still
    rescans it before it stops (the JAX package's order): no explored
    state escapes the host evaluation."""
    ck = _WholeRowHost(4).checker().target_state_count(target) \
        .gpu_options(device="cpu", race=False, hcap=hcap, fmax=16,
                     capacity=1 << 14).spawn_gpu().join()
    prof = ck.profile()
    assert prof["histories"] == ck.unique_state_count()
    assert prof["h_n"] == ck.unique_state_count() - 1  # all but the init
    ck.assert_no_discovery("consistent")


class _EagerActor(PaxosActor):
    """A Paxos server that answers a Get before its decision with the
    initial value: a read after a completed write may return it, which
    is not linearizable."""

    def on_msg(self, id, state, src, msg, o):
        from stateright_tpu_torch.actor.register import Get
        if isinstance(msg, Get) and not state.is_decided:
            o.send(src, GetOk(msg.request_id, '\0'))
            return None
        return super().on_msg(id, state, src, msg, o)


class _EagerPaxos(PackedPaxos):
    """:class:`_EagerActor` on the host and in the plain step."""

    def __init__(self, client_count):
        self._init_register(
            client_count, 3,
            server_actor=lambda i: _EagerActor(
                [Id(j) for j in range(3) if j != i]),
            server_width=6, net_capacity=16, max_sends=3)

    def _server_step(self, sid, w, src, msg):
        new_w, changed, sends = super()._server_step(sid, w, src, msg)
        decided = ((w[:, 0] >> 16) & 1) != 0
        eager = ~decided & ((msg[:, 0] >> 24) == T_GET)
        a = (msg[:, 0] >> 12) & 0xFFF
        getok = torch.stack([((4 << 24) | (a << 12)) & M32,
                             torch.zeros_like(a)], dim=1)
        d, m, v = sends[0]
        sends[0] = (torch.where(eager, src, d),
                    torch.where(eager[:, None], getok, m), v | eager)
        return new_w, changed, sends


def test_failing_linearizable_is_found_and_replays():
    model = _EagerPaxos(2)
    ck = _cpu(model, fmax=256)
    path = ck.assert_any_discovery("linearizable")  # replays or raises
    assert path.last_state().history.serialized_history() is None
    host = model.checker().spawn_bfs().join()
    assert host.discovery("linearizable") is not None
    # the card runs PackedPaxos's own device functions only
    with pytest.raises(NotImplementedError, match="_server_step"):
        model.cuda_spec()


def test_options_that_raise():
    with pytest.raises(ValueError, match="power of two"):
        PackedPaxos(1).checker().gpu_options(device="cpu", hcap=6) \
            .spawn_gpu()
    with pytest.raises(NotImplementedError, match="host-evaluated"):
        PackedPaxos(1).checker().gpu_options(device="cpu",
                                             mesh=object()).spawn_gpu()
    with pytest.raises(NotImplementedError, match="staged"):
        PackedPaxos(1).checker().gpu_options(device="cpu", fused=False) \
            .spawn_gpu()


def _ordered():
    m = PackedPaxos(1)
    m.init_network(Network.new_ordered())
    m.finalize_layout()
    return m


def _timers():
    m = PackedPaxos(1)
    m.device_timers = True
    return m


@pytest.mark.parametrize("configure,match", [
    (_ordered, "ordered network"),
    (lambda: PackedPaxos(1).lossy_network(True), "lossy"),
    (_timers, "timers"),
    (lambda: PackedPaxos(1).crash_restart(1), "paxos_crash"),
], ids=["ordered", "lossy", "timers", "crash"])
def test_unported_configurations_raise(configure, match):
    """What the card refuses. The ordered network has a plain step since
    the register slice: the ordered PackedPaxos(1) (168 words, 16
    channels) checks on the CPU to the JAX package's host BFS (99
    states, the same fingerprints), while the card, which has no Paxos
    instantiation on FIFO channels, still refuses it. The crash/restart
    lanes are ported: PackedPaxos(1) under ``crash_restart(1)`` (every
    actor crashable) checks on the CPU to the JAX package's host BFS,
    and ``cuda_spec`` names its instantiation, ``paxos_crash``. The
    lossy drop lanes and the timers raise everywhere."""
    model = configure()
    if model.max_crashes_:
        assert model.cuda_spec()[0] == match
        want = JPaxos(1).crash_restart(1).checker().spawn_bfs().join()
        ck = _cpu(model, fmax=256)
        assert ck.unique_state_count() == want.unique_state_count()
        assert ck.state_count() == want.state_count()
        assert ck.generated_fingerprints() == want.generated_fingerprints()
        ck.assert_no_discovery("linearizable")
        ck.assert_any_discovery("value chosen")
        return
    if model._net_ordered:
        assert (model.packed_width, model.max_actions) == (168, 16)
        with pytest.raises(NotImplementedError, match=match):
            model.cuda_spec()
        from stateright_tpu.actor import Network as JNetwork
        jm = JPaxos(1)
        jm.init_network(JNetwork.new_ordered())
        jm.finalize_layout()
        want = jm.checker().spawn_bfs().join()
        ck = _cpu(model, fmax=64)
        assert ck.unique_state_count() == want.unique_state_count() == 99
        assert ck.generated_fingerprints() == want.generated_fingerprints()
        ck.assert_no_discovery("linearizable")
        return
    with pytest.raises(NotImplementedError, match=match):
        model.packed_step(torch.from_numpy(
            model.encode(model.init_states()[0]).astype(np.int64)[None]))
    with pytest.raises(NotImplementedError, match=match):
        model.cuda_spec()
    # the GPU engine on the CPU raises from the step, not a wrong answer
    with pytest.raises(NotImplementedError, match=match):
        _cpu(model)


def test_cuda_spec_names_the_paxos_instantiation():
    assert PackedPaxos(3).cuda_spec() == ("paxos", (3, 3, 16))
    with pytest.raises(NotImplementedError, match="packed_representative"):
        PackedPaxos(2).cuda_spec(symmetry=True)


def test_raced_default_entry_point_agrees():
    ck = PackedPaxos(1).checker().gpu_options(device="cpu").spawn_gpu() \
        .join()
    assert ck.unique_state_count() == 265
    assert ck.profile()["engine"] in ("host", "device")
    ck.assert_no_discovery("linearizable")
    ck.assert_any_discovery("value chosen")


def test_cli_check_and_check_gpu(capsys):
    from stateright_tpu_torch.examples import paxos, paxos_packed
    assert paxos.main(["check", "1"]) == 0
    out = capsys.readouterr().out
    assert "unique=265" in out.replace(" ", "") or "265" in out
    assert paxos.main(["check-gpu", "1", "--cpu", "--no-race"]) == 0
    out = capsys.readouterr().out
    assert "265" in out and "value chosen" in out
    assert paxos_packed.main(["check", "1"]) == 0
    assert "265" in capsys.readouterr().out
    assert paxos.main(["explore"]) == 2


def test_paxos_run_loads_no_jax():
    code = (
        "import sys\n"
        "from stateright_tpu_torch.examples.paxos_packed import "
        "PackedPaxos\n"
        "ck = PackedPaxos(1).checker().gpu_options(device='cpu', "
        "race=False).spawn_gpu().join()\n"
        "assert ck.unique_state_count() == 265\n"
        "ck.discovery('value chosen')\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'stateright_tpu'))\n"
        "assert not bad, bad\n")
    import pathlib
    root = pathlib.Path(__file__).resolve().parent.parent
    subprocess.run([sys.executable, "-c", code], cwd=root, check=True,
                   timeout=300)

