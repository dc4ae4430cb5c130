"""The register family on the port against the JAX package: ABD on both
networks and the single-copy register — the packed layouts and codecs,
the plain batched steps (the ordered network's FIFO channels among
them), properties and record hooks bit for bit, the host BFS counts, the
GPU engine on the CPU (the plain versions of K1-K3, K7, K8 and K9) with
the JAX digests, the row gate against the JAX package's staged engine,
the single-copy linearizability counterexample, the loud overflow, the
CUDA instantiations ``cuda_spec`` names and refuses, and the CLIs.
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

from stateright_tpu.examples.abd_packed import \
    PackedAbd as JAbd  # noqa: E402
from stateright_tpu.examples.single_copy_packed import \
    PackedSingleCopy as JSingleCopy  # noqa: E402
from stateright_tpu_torch.checker.gpu import EncodingOverflow  # noqa: E402
from stateright_tpu_torch.examples.abd_packed import PackedAbd  # noqa: E402
from stateright_tpu_torch.examples.single_copy_packed import \
    PackedSingleCopy  # noqa: E402
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
    opts = {"device": "cpu", "race": False, "fmax": 256, **opts}
    return model.checker().gpu_options(**opts).spawn_gpu().join()


def _reachable_rows(model, limit):
    """Up to ``limit`` encoded states of a host BFS of ``model`` (a state
    whose network outgrows the encoding is skipped)."""
    seen, rows, queue = set(), [], list(model.init_states())
    while queue and len(rows) < limit:
        s = queue.pop(0)
        try:
            enc = model.encode(s)
        except ValueError:
            continue
        if enc.tobytes() in seen:
            continue
        seen.add(enc.tobytes())
        rows.append(enc)
        queue.extend(model.next_states(s))
    return np.stack(rows)


def _crowded(model, rows, rng, k):
    """``k`` rows of ``rows`` whose networks are filled up: on the
    ordered network a third of the channels to their depth, on the
    unordered one the slots, by messages of an unknown type (never
    delivered to effect, but they take room): the sends of their
    children overflow."""
    out = []
    for r in rows[rng.choice(len(rows), k)]:
        r = r.copy()
        if model._net_ordered:
            d = model.channel_depth
            for ch in np.flatnonzero(rng.random(model._n_chan) < 0.3):
                for j in range(int(r[model._net_off + ch]), d):
                    off = model._msgs_off + (ch * d + j) * 2
                    r[off:off + 2] = ((14 << 24) | j, j)
                r[model._net_off + ch] = d
        else:
            e_cap = model.net_capacity
            slots = r[model._net_off:model._timer_off].reshape(e_cap, 4)
            occ = [tuple(int(x) for x in s) for s in slots
                   if s[0] & (1 << 16)]
            for j in range(len(occ), e_cap):
                occ.append(((1 << 16) | (7 << 8) | (20 + j), 1, 14 << 24, j))
            occ.sort(key=lambda t: (t[0], t[2], t[3]))
            for j, t in enumerate(occ):
                slots[j] = t
        out.append(r)
    return np.stack(out)


ABD_SHAPES = [(c, s, ordered, d) for c in (2, 3) for s in (2, 3)
              for ordered, d in ((False, 4), (True, 4), (True, 8))]
SC_SHAPES = [(c, s) for c in (2, 3, 4) for s in (1, 2)]
#: the shapes whose steps are held to the JAX package's (each compiles a
#: JAX step of its own): both networks, both depths, 2 and 3 servers,
#: the BASELINE's, bench.py's widest (331 words) and its single-copy
#: counterexample configuration
ABD_STEP_SHAPES = [(2, 2, False, 4), (2, 2, True, 4), (3, 2, True, 8),
                   (2, 3, True, 8), (3, 3, False, 4)]
SC_STEP_SHAPES = [(3, 1), (2, 2), (4, 2)]


def _abd_pair(c, s, ordered, d):
    kw = dict(server_count=s, ordered=ordered, channel_depth=d)
    return PackedAbd(c, **kw), JAbd(c, **kw)


LAYOUT = ("packed_width", "max_actions", "_actor_off", "_net_off",
          "_timer_off", "_hist_off", "history_width", "max_sends",
          "host_property_cols", "host_property_indices")
ORDERED_LAYOUT = ("_n_chan", "_msgs_off", "ordered_channels")


def _same_layout_and_codec(tm, jm, limit):
    for attr in LAYOUT + (ORDERED_LAYOUT if tm._net_ordered else ()):
        assert getattr(tm, attr) == getattr(jm, attr), attr
    if tm._net_ordered:
        for attr in ("_chan_src", "_chan_dst", "_chan_lut"):
            assert np.array_equal(getattr(tm, attr), getattr(jm, attr))
    rows = _reachable_rows(tm, limit)
    for r in rows:
        state = tm.decode(r)
        assert np.array_equal(tm.encode(state), r)
        assert np.array_equal(jm.encode(jm.decode(r)), r)
        assert tm.fingerprint(state) == jm.fingerprint(jm.decode(r))


@pytest.mark.parametrize("c,s,ordered,d", ABD_SHAPES)
def test_abd_layout_and_codec_match_jax(c, s, ordered, d):
    tm, jm = _abd_pair(c, s, ordered, d)
    _same_layout_and_codec(tm, jm, 150)


@pytest.mark.parametrize("c,s", SC_SHAPES)
def test_single_copy_layout_and_codec_match_jax(c, s):
    _same_layout_and_codec(PackedSingleCopy(c, s), JSingleCopy(c, s), 150)


def test_register_widths():
    """The configurations of the BASELINE and bench.py: 108, 260 and
    331 words on the ordered network, 82 and 79 on the unordered."""
    assert PackedAbd(2, ordered=True).packed_width == 108
    assert PackedAbd(3, ordered=True, channel_depth=8).packed_width == 260
    wide = PackedAbd(2, server_count=3, ordered=True, channel_depth=8)
    assert (wide.packed_width, wide.max_actions) == (331, 18)
    assert PackedAbd(2).packed_width == 82
    assert PackedSingleCopy(3).packed_width == 79


def _same_step(tm, jm, seed, limit=250):
    """The batched step (register dispatch, server step, record hooks,
    network), the properties and the fingerprints of the valid children
    against the JAX package's, on every lane (the empty channels' junk
    lanes, invalid and overflowing ones too), over a host BFS frontier,
    crowded rows and random words."""
    rng = np.random.default_rng(seed)
    rows = _reachable_rows(tm, limit)
    junk = rng.integers(0, 2 ** 32, size=(24, tm.packed_width),
                        dtype=np.uint64).astype(np.uint32)
    rows = np.concatenate([rows, _crowded(tm, rows, rng, 40), junk])
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
    want = [jm.fingerprint(jm.decode(r))
            for r in flat[sel][:60].numpy().astype(np.uint32)]
    assert [(h << 32) | low for h, low in zip(hi.tolist(),
                                               lo.tolist())] == want
    return ovf


@pytest.mark.parametrize("c,s,ordered,d", ABD_STEP_SHAPES)
def test_abd_plain_step_properties_and_hooks_match_jax(c, s, ordered, d):
    tm, jm = _abd_pair(c, s, ordered, d)
    ovf = _same_step(tm, jm, 10 * c + s + d)
    # the crowded rows overflow (a lone send on a full multiset takes the
    # slot its delivery freed)
    assert ovf.any() == (ordered or s > 2)


@pytest.mark.parametrize("c,s", SC_STEP_SHAPES)
def test_single_copy_plain_step_properties_and_hooks_match_jax(c, s):
    _same_step(PackedSingleCopy(c, s), JSingleCopy(c, s), 70 + c + s)


def test_empty_channel_lane_is_the_jax_junk_row():
    """An empty channel's lane delivers its zero head: the child is the
    row with that channel's length wrapped to 0xFFFFFFFF, invalid, as in
    the JAX package (K1 leaves it unwritten)."""
    model = PackedAbd(2, ordered=True)
    row = model.encode(model.init_states()[0])
    succ, valid, ovf = model.packed_step(torch.from_numpy(
        row.astype(np.int64))[None])
    lens = row[model._net_off:model._net_off + model._n_chan]
    for ch in np.flatnonzero(lens == 0):
        want = row.astype(np.int64)
        want[model._net_off + ch] = 0xFFFFFFFF
        assert np.array_equal(succ[0, ch].numpy(), want)
        assert not valid[0, ch] and not ovf[0, ch]


def test_record_hooks_match_jax():
    """``packed_record_out``/``packed_record_in`` over random histories
    and messages, lane for lane."""
    tm, jm = PackedAbd(3), JAbd(3)
    rng = np.random.default_rng(3)
    n, hw = 400, tm.history_width
    hist = rng.integers(0, 2 ** 32, (n, hw), dtype=np.uint64)
    hist[:, 0] = rng.integers(0, 2, n)
    for t in range(tm.client_count):  # in-flight flags on and off
        hist[:, 3 + 3 * t] &= np.where(rng.random(n) < 0.5,
                                       np.uint64(0x7FFFFFFF),
                                       np.uint64(0xFFFFFFFF))
    hist = hist.astype(np.uint32)
    ids = rng.integers(0, 6, n).astype(np.uint32)
    msg = np.stack([(rng.integers(1, 5, n) << 24)
                    | rng.integers(0, 2 ** 16, n),
                    rng.integers(0, 16, n)], 1).astype(np.uint32)
    h, i, m = (torch.from_numpy(a.astype(np.int64)) for a in (hist, ids,
                                                              msg))
    for name in ("packed_record_out", "packed_record_in"):
        got = getattr(tm, name)(h, i, i, m).numpy().astype(np.uint32)
        want = jax.vmap(getattr(jm, name))(jnp.asarray(hist),
                                           jnp.asarray(ids),
                                           jnp.asarray(ids),
                                           jnp.asarray(msg))
        assert np.array_equal(got, np.asarray(want)), name


@pytest.mark.parametrize("make,unique", [
    (lambda: PackedAbd(2), 544),
    (lambda: PackedAbd(2, ordered=True), 564),
    (lambda: PackedSingleCopy(3), 4243)], ids=["abd2", "abd2-ordered",
                                               "single-copy3"])
def test_host_bfs_counts(make, unique):
    ck = make().checker().spawn_bfs().join()
    assert ck.unique_state_count() == unique
    ck.assert_no_discovery("linearizable")
    ck.assert_any_discovery("value chosen")


PINS = {"abd2": "PIN_ABD2", "abd2-ordered": "PIN_ABD2_ORDERED",
        "single-copy3": "PIN_SC3", "abd3": "PIN_ABD3"}
MODELS = {"abd2": lambda m: m(2), "single-copy3": lambda m: m(3),
          "abd2-ordered": lambda m: m(2, ordered=True),
          "abd3": lambda m: m(3, server_count=2, ordered=True,
                              channel_depth=8)}


@pytest.mark.parametrize("name", ["abd2", "abd2-ordered", "single-copy3",
                                  "abd3"])
def test_register_pins_are_the_jax_packages(name):
    """The pins chip_smoke.py holds the card to are the JAX package's
    host BFS: unique states, state_count() and the digest (abd3 takes
    ~10 s)."""
    jcls = JSingleCopy if name == "single-copy3" else JAbd
    ck = MODELS[name](jcls).checker().spawn_bfs().join()
    assert (ck.unique_state_count(), ck.state_count(),
            _digest(ck.generated_fingerprints())) \
        == getattr(_chip_smoke(), PINS[name])
    ck.assert_no_discovery("linearizable")
    ck.assert_any_discovery("value chosen")


@pytest.mark.parametrize("name", ["abd2", "abd2-ordered", "single-copy3"])
def test_gpu_engine_on_cpu_gives_the_jax_digest(name):
    """The GPU engine on the CPU (the kernels' plain versions, the
    history stage) against the JAX package's count, generated count and
    digest; ``linearizable`` holds and ``value chosen`` replays."""
    cls = PackedSingleCopy if name == "single-copy3" else PackedAbd
    model = MODELS[name](cls)
    ck = _cpu(model)
    assert (ck.unique_state_count(), ck.state_count(),
            _digest(ck.generated_fingerprints())) \
        == getattr(_chip_smoke(), PINS[name])
    ck.assert_no_discovery("linearizable")
    path = ck.assert_any_discovery("value chosen")  # replays or raises
    assert model.property("value chosen").condition(model,
                                                    path.last_state())
    prof = ck.profile()
    assert prof["h_n"] == prof["histories"] > 1


ROW_GATE = dict(fmax=16, capacity=1 << 12, cc_dedup=64, chunk_steps=8,
                pipeline=False)


def test_ordered_abd_row_gate_against_jax_staged_engine():
    """PackedAbd(2, ordered=True) on the GPU engine on the CPU against
    the JAX package's staged engine (host-evaluated properties run
    there), every shape knob set on both sides: the same states in the
    same order and the same discoveries."""
    want = JAbd(2, ordered=True).checker().tpu_options(
        race=False, fused=False, mode="device", **ROW_GATE) \
        .spawn_tpu().join()
    got = _cpu(PackedAbd(2, ordered=True), **ROW_GATE)
    want._ensure_mirror()
    got._ensure_mirror()
    assert got.unique_state_count() == want.unique_state_count() == 564
    assert got.state_count() == want.state_count()
    assert list(got._generated.items()) == list(want._generated.items())
    assert got._discovery_fps == want._discovery_fps


@pytest.mark.parametrize("race", [False, True], ids=["card", "raced"])
def test_single_copy_counterexample_is_found_and_replays(race):
    """Two unreplicated servers are not linearizable: the JAX package's
    host BFS finds it at 26 states; the GPU engine on the CPU (alone,
    and raced as by default) reports a ``linearizable`` discovery whose
    witness replays through the host model to a history with no
    serialization."""
    host = JSingleCopy(2, 2).checker().spawn_bfs().join()
    assert host.unique_state_count() == 26
    assert host.discovery("linearizable") is not None
    model = PackedSingleCopy(2, 2)
    ck = _cpu(model, race=race)
    path = ck.assert_any_discovery("linearizable")  # replays or raises
    assert path.last_state().history.serialized_history() is None
    assert not model.property("linearizable").condition(model,
                                                        path.last_state())


def _undeclared():
    model = PackedAbd(2, ordered=True)
    model.ordered_channels = [ch for ch in model.register_channels()
                              if ch != (0, 2)]  # server 0 -> client 0
    model.finalize_layout()
    return model


@pytest.mark.parametrize("make", [
    lambda: PackedAbd(2, ordered=True, channel_depth=1), _undeclared],
    ids=["full-channel", "undeclared-channel"])
def test_overflow_is_loud(make):
    """A send into a full channel, or into one the model does not
    declare, is an encoding overflow: the engine raises (never a quietly
    smaller state space), as the JAX package's does."""
    with pytest.raises(EncodingOverflow, match="capacity overflow"):
        _cpu(make())
    jmodel = JAbd(2, ordered=True, channel_depth=1)
    with pytest.raises(RuntimeError, match="capacity overflow"):
        jmodel.checker().tpu_options(race=False, fused=False,
                                     mode="device").spawn_tpu().join()


def test_cuda_spec_names_the_instantiations():
    assert PackedAbd(2).cuda_spec() == ("abd", (2, 2, 16))
    assert PackedAbd(2, ordered=True).cuda_spec() == (
        "abd_ordered", (2, 2, 4))
    assert PackedAbd(2, server_count=3, ordered=True,
                     channel_depth=8).cuda_spec() == (
        "abd_ordered", (2, 3, 8))
    assert PackedSingleCopy(4, 2).cuda_spec() == ("single_copy", (4, 2, 16))


class _OwnServer(PackedAbd):
    def _server_step(self, sid, w, src, msg):
        return super()._server_step(sid, w, src, msg)


class _OwnBoundary(PackedSingleCopy):
    def packed_boundary(self, words):
        return super().packed_boundary(words)


def _lossy():
    return PackedAbd(2, ordered=True).lossy_network(True)


def _timers():
    model = PackedSingleCopy(2)
    model.device_timers = True
    return model


@pytest.mark.parametrize("make,match", [
    (lambda: _OwnServer(2, ordered=True), "overrides _server_step"),
    (lambda: _OwnBoundary(2), "overrides packed_boundary"),
    (lambda: PackedAbd(2, server_count=4, ordered=True, channel_depth=8),
     "352 packed words"),
    (_undeclared, "register_channels"),
    (_lossy, "lossy"),
    (_timers, "timers"),
    (lambda: PackedSingleCopy(2).crash_restart(1), "crash"),
], ids=["subclass-step", "subclass-boundary", "too-wide", "channels",
        "lossy", "timers", "crash"])
def test_cuda_spec_refuses(make, match):
    with pytest.raises(NotImplementedError, match=match):
        make().cuda_spec()


def test_cuda_spec_refuses_symmetry():
    for model in (PackedAbd(2), PackedAbd(2, ordered=True),
                  PackedSingleCopy(2)):
        with pytest.raises(NotImplementedError,
                           match="packed_representative"):
            model.cuda_spec(symmetry=True)


def test_unported_lanes_still_raise_in_the_plain_step():
    """The lossy drop lanes are ported: the lossy PackedSingleCopy(2)
    steps lane for lane as the JAX package's ``packed_step`` (its
    ``cuda_spec`` still refuses it: no instantiation of the single-copy
    register has drop lanes). Timers on a model without a
    ``packed_on_timeout`` still raise from the plain step, naming them.
    The crash/restart lanes are ported: PackedSingleCopy(2) under
    ``crash_restart(1)`` (every actor crashable) steps lane for lane as
    the JAX package's (its ``cuda_spec`` refuses it too), on the first
    states of its host BFS, with crowded rows and random words."""
    model = _timers()
    row = model.encode(model.init_states()[0]).astype(np.int64)
    with pytest.raises(NotImplementedError, match="timers"):
        model.packed_step(torch.from_numpy(row)[None])
    _same_step(PackedSingleCopy(2).lossy_network(True),
               JSingleCopy(2).lossy_network(True), seed=11, limit=120)
    _same_step(PackedSingleCopy(2).crash_restart(1),
               JSingleCopy(2).crash_restart(1), seed=13, limit=120)


def test_clis(capsys):
    from stateright_tpu_torch.examples import (abd_packed,
                                               linearizable_register,
                                               single_copy_packed,
                                               single_copy_register)
    assert abd_packed.main(["check", "2", "ordered"]) == 0
    assert "ordered network" in capsys.readouterr().out
    assert abd_packed.main(["check-gpu", "2", "--cpu", "--no-race"]) == 0
    out = capsys.readouterr().out
    assert "544" in out and "value chosen" in out
    assert single_copy_packed.main(["check", "3"]) == 0
    assert "4243" in capsys.readouterr().out.replace(",", "")
    assert single_copy_packed.main(["check-gpu", "2", "2", "--cpu"]) == 0
    assert "linearizable" in capsys.readouterr().out
    assert linearizable_register.main(["check", "1"]) == 0
    assert single_copy_register.main(["check", "2"]) == 0
    out = capsys.readouterr().out
    assert "93" in out
    assert abd_packed.main([]) == 2
    assert single_copy_register.main(["explore"]) == 2
    assert linearizable_register.main(["spawn"]) == 2


def test_register_run_loads_no_jax():
    code = (
        "import sys\n"
        "from stateright_tpu_torch.examples.abd_packed import PackedAbd\n"
        "from stateright_tpu_torch.examples.single_copy_packed import "
        "PackedSingleCopy\n"
        "ck = PackedAbd(2, ordered=True).checker().gpu_options("
        "device='cpu', race=False, fmax=256).spawn_gpu().join()\n"
        "assert ck.unique_state_count() == 564\n"
        "ck = PackedSingleCopy(2, 2).checker().gpu_options("
        "device='cpu', race=False).spawn_gpu().join()\n"
        "assert ck.discovery('linearizable') is not None\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'stateright_tpu'))\n"
        "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                   timeout=300)
