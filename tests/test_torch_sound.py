"""``CheckerBuilder.sound_eventually()`` on the port, on the CPU: the node
key (``fingerprint.fp64_node``, ``ops/hash_kernel.py``
``fp64_node_device`` and the kernels' ``csrc/fold.cuh`` ``fp64_node``)
against the JAX package's; the GPU engine's staged step with node keys,
the cross-edge log and the lasso sweep (plain versions) against the JAX
package's device engine — PackedPingPong's node counts, fingerprint sets
and discoveries, the ``PackedDGraph`` lasso fixtures of
``tests/test_sound_eventually.py``; the host BFS and DFS sound modes; the
combinations that still raise. The card runs these in
``tests/test_torch_gpu.py`` and ``chip_smoke.py`` (phase ``staged``)."""

import ctypes
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(1)  # leave the other test workers their cores

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from stateright_tpu.fingerprint import (  # noqa: E402
    fp64_node as jfp64_node)
from stateright_tpu.actor.test_util import (  # noqa: E402
    PackedPingPong as JPing)
from stateright_tpu.core import Property as JProperty  # noqa: E402
from stateright_tpu.models import fixtures as jfix  # noqa: E402
from stateright_tpu.ops import hash_kernel as jhk  # noqa: E402
from stateright_tpu_torch import TwoPhaseSys  # noqa: E402
from stateright_tpu_torch.actor.test_util import PackedPingPong  # noqa: E402
from stateright_tpu_torch.core import Property  # noqa: E402
from stateright_tpu_torch.fingerprint import fp64_node  # noqa: E402
from stateright_tpu_torch.models.fixtures import (  # noqa: E402
    DGraph, PackedDGraph)
from stateright_tpu_torch.ops.hash_kernel import (  # noqa: E402
    fp64_node_device)
from stateright_tpu_torch.ops.words import from_numpy_u32  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
CSRC = ROOT / "stateright_tpu_torch" / "csrc"


# --- the node key -------------------------------------------------------------

PINS = [(0, 0), (1, 1), (0xFFFFFFFFFFFFFFFF, 0xFFFFFFFF),
        (0x0123456789ABCDEF, 5), (0xDEADBEEF00000001, 0x80000000)]


def _random_keys(n=4096, seed=3):
    rng = np.random.default_rng(seed)
    fps = rng.integers(0, 2**64, n, dtype=np.uint64)
    eb = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    eb[: n // 2] &= np.uint32(7)  # small masks, as properties give
    return fps, eb


def test_fp64_node_is_the_jax_packages():
    fps, eb = _random_keys(512)
    for fp, mask in PINS + list(zip(fps.tolist(), eb.tolist())):
        assert fp64_node(fp, mask) == jfp64_node(fp, mask)


def test_fp64_node_device_is_the_jax_packages():
    """The plain version of the kernels' node key, bit for bit against
    the JAX package's ``fp64_node_device`` and the host ``fp64_node``."""
    fps, eb = _random_keys()
    hi = (fps >> np.uint64(32)).astype(np.uint32)
    lo = fps.astype(np.uint32)
    got_hi, got_lo = fp64_node_device(from_numpy_u32(hi),
                                      from_numpy_u32(lo), from_numpy_u32(eb))
    want_hi, want_lo = jhk.fp64_node_device(jnp.asarray(hi), jnp.asarray(lo),
                                            jnp.asarray(eb))
    np.testing.assert_array_equal(got_hi.numpy(), np.asarray(want_hi))
    np.testing.assert_array_equal(got_lo.numpy(), np.asarray(want_lo))
    for k in range(0, 4096, 257):
        want = fp64_node(int(fps[k]), int(eb[k]))
        assert (int(got_hi[k]) << 32) | int(got_lo[k]) == want


_HARNESS = r"""
#define __device__
#define __host__
#define __forceinline__ inline
#include "fold.cuh"
extern "C" void node_keys(const uint32_t* hi, const uint32_t* lo,
                          const uint32_t* eb, uint32_t* out, int n) {
  for (int i = 0; i < n; ++i) fp64_node(hi[i], lo[i], eb[i], out[2 * i],
                                        out[2 * i + 1]);
}
"""


def test_kernels_fp64_node_is_bit_equal(tmp_path):
    """``csrc/fold.cuh`` ``fp64_node``, the device function KS1 and KS2
    take their node keys from, compiled on the host and held to the host
    ``fp64_node`` (and so to the JAX package's) on random keys and
    pins."""
    src = tmp_path / "node.cc"
    src.write_text(_HARNESS)
    lib = tmp_path / "libnode.so"
    subprocess.run(["g++", "-O2", "-std=c++17", "-shared", "-fPIC",
                    f"-I{CSRC}", "-o", str(lib), str(src)], check=True)
    dll = ctypes.CDLL(str(lib))
    fps, eb = _random_keys(1024, seed=5)
    fps = np.concatenate([fps, np.asarray([p[0] for p in PINS], np.uint64)])
    eb = np.concatenate([eb, np.asarray([p[1] for p in PINS], np.uint32)])
    hi = np.ascontiguousarray((fps >> np.uint64(32)).astype(np.uint32))
    lo = np.ascontiguousarray(fps.astype(np.uint32))
    out = np.zeros((len(fps), 2), np.uint32)
    ptr = ctypes.POINTER(ctypes.c_uint32)
    dll.node_keys(hi.ctypes.data_as(ptr), lo.ctypes.data_as(ptr),
                  eb.ctypes.data_as(ptr), out.ctypes.data_as(ptr),
                  len(fps))
    for k in range(len(fps)):
        key = (int(out[k, 0]) << 32) | int(out[k, 1])
        assert key == fp64_node(int(fps[k]), int(eb[k]))


# --- PackedPingPong under sound on the GPU engine's plain versions -------------

PING = [(3, 269, 906), (5, 4_349, 23_286)]


def _ping_sound(n, **opts):
    return (PackedPingPong(n, lossy=True, duplicating=True).checker()
            .sound_eventually().gpu_options(device="cpu", race=False,
                                            **opts).spawn_gpu().join())


@pytest.mark.parametrize("n,nodes,generated", PING, ids=["n3", "n5"])
def test_ping_pong_nodes_sets_and_discoveries_are_jaxs(n, nodes, generated):
    """PingPong on the lossy, duplicating network under
    ``sound_eventually()``: the node count (269 at 3, 4,349 at 5), the
    generated transitions and the state fingerprint set equal the JAX
    package's device engine with the same knobs; both discover ``can
    reach max``, ``must reach max`` and ``must exceed max``, with the
    same witnesses, which replay through the host model; the cross-edge
    log fills and the lasso sweep runs at exhaustion."""
    knobs = dict(fmax=256, capacity=1 << 14, kraw=4096, kmax=4096)
    got = _ping_sound(n, **knobs)
    want = (JPing(n, lossy=True, duplicating=True).checker()
            .sound_eventually().tpu_options(race=False, **knobs)
            .spawn_tpu().join())
    assert got.unique_state_count() == want.unique_state_count() == nodes
    assert got.state_count() == want.state_count() == generated
    assert got.generated_fingerprints() == want.generated_fingerprints()
    names = ["can reach max", "must exceed max", "must reach max"]
    assert sorted(got.discoveries()) == sorted(want.discoveries()) == names
    assert got._discovery_fps == want._discovery_fps
    model = got.model()
    for name in names:
        path = got.discovery(name)  # replays through the host model
        prop = model.property(name)
        if name == "can reach max":
            assert prop.condition(model, path.last_state())
        else:  # an eventually property never held along the witness
            assert not any(prop.condition(model, s)
                           for s in path.into_states())
    prof = got.profile()
    assert prof["staged"] is True and prof["e_n"] > 0
    assert "lasso_s" in prof and prof["lasso_nodes"] > 0


def test_sound_default_knobs_and_growth_keep_the_count():
    """The default sizes, and a table of 2**10 that grows (the log's
    node keys re-inserted) with a small edge log that grows too: the
    same 4,349 nodes and state set."""
    flat = _ping_sound(5)
    grown = _ping_sound(5, capacity=1 << 10, fmax=64)
    assert grown.profile()["grows"] >= 1 and grown.profile()["egrows"] >= 1
    assert flat.unique_state_count() == grown.unique_state_count() == 4_349
    assert flat.generated_fingerprints() == grown.generated_fingerprints()
    assert sorted(flat.discoveries()) == sorted(grown.discoveries())


# --- the lasso fixtures (tests/test_sound_eventually.py TestDeviceSound) ------

def eventually_odd(prop_cls=Property):
    return prop_cls.eventually("odd", lambda _, s: s % 2 == 1)


def _device(graph):
    return (graph.checker().sound_eventually()
            .gpu_options(device="cpu", race=False, capacity=1 << 10, fmax=16)
            .spawn_gpu().join())


def _graph(cls, *paths, prop=None):
    g = cls.with_property(prop or eventually_odd())
    for p in paths:
        g = g.with_path(list(p))
    return g


def _jax_device(*paths):
    g = _graph(jfix.PackedDGraph, *paths, prop=eventually_odd(JProperty))
    return (g.checker().sound_eventually()
            .tpu_options(capacity=1 << 10, fmax=16, race=False)
            .spawn_tpu().join())


LASSO = {
    "rejoin": ([0, 2, 4], [1, 4, 6]),
    "pure_cycle": ([0, 2, 4, 2],),
    "cross_edge": ([0, 2, 4, 2], [0, 4]),
    "disjoint_branches": ([0, 2, 4], [0, 4, 2]),
}


@pytest.mark.parametrize("name", list(LASSO))
def test_device_lasso_fixtures(name):
    """The DAG rejoin (node keys), the pure cycle, the cycle entered
    through a cross edge and the one spanning two sibling branches (the
    edge log and the sweep): found, never through an odd state, the
    cycles ending with a lap, and each the JAX package's witness."""
    paths = LASSO[name]
    c = _device(_graph(PackedDGraph, *paths))
    states = c.assert_any_discovery("odd").into_states()
    assert not any(s % 2 == 1 for s in states)
    if name == "rejoin":
        assert states[-1] == 6
    elif name != "disjoint_branches":
        assert states[-1] in (2, 4) and states.count(states[-1]) >= 2
    want = _jax_device(*paths)
    assert states == want.assert_any_discovery("odd").into_states()
    assert c.unique_state_count() == want.unique_state_count()


def test_device_satisfied_cycle_not_reported():
    _device(_graph(PackedDGraph, [0, 1, 2, 0])).assert_properties()


def test_device_no_false_positives_and_host_parity():
    paths = ([1], [2, 3], [2, 6, 7], [4, 9, 10])
    g = _graph(PackedDGraph, *paths)
    c = _device(g)
    c.assert_properties()
    host = g.checker().sound_eventually().spawn_bfs().join()
    assert c.generated_fingerprints() == host.generated_fingerprints()
    assert c.unique_state_count() == host.unique_state_count()


# --- the host engines (tests/test_sound_eventually.py TestHostSound) ----------

def _host(engine, *paths, sound=True):
    b = _graph(DGraph, *paths).checker()
    if sound:
        b = b.sound_eventually()
    return getattr(b, f"spawn_{engine}")().join()


def _jhost(engine, *paths, sound=True):
    g = _graph(jfix.DGraph, *paths, prop=eventually_odd(JProperty))
    b = g.checker()
    if sound:
        b = b.sound_eventually()
    return getattr(b, f"spawn_{engine}")().join()


@pytest.mark.parametrize("engine", ["bfs", "dfs"])
def test_host_rejoin_counterexample(engine):
    """The reference's documented miss (default) and its fix (sound), as
    the JAX package's engines give them."""
    paths = LASSO["rejoin"]
    assert _host(engine, *paths, sound=False).discovery("odd") is None
    c = _host(engine, *paths)
    states = c.assert_any_discovery("odd").into_states()
    assert states[-1] == 6 and not any(s % 2 == 1 for s in states)
    assert states == _jhost(engine, *paths).discovery("odd").into_states()


def test_host_bfs_still_misses_pure_cycle():
    assert _host("bfs", *LASSO["pure_cycle"]).discovery("odd") is None
    assert _jhost("bfs", *LASSO["pure_cycle"]).discovery("odd") is None


@pytest.mark.parametrize("name", ["pure_cycle", "cross_edge",
                                  "disjoint_branches"])
def test_host_dfs_lassos(name):
    """The DFS's on-path lasso and its sweep at exhaustion (the cross
    edge and the disjoint branches), each the JAX package's witness."""
    paths = LASSO[name]
    if name == "pure_cycle":
        assert _host("dfs", *paths, sound=False).discovery("odd") is None
    c = _host("dfs", *paths)
    states = c.assert_any_discovery("odd").into_states()
    assert not any(s % 2 == 1 for s in states)
    assert states == _jhost("dfs", *paths).discovery("odd").into_states()


def test_host_no_false_positives_and_node_counts():
    for engine in ("bfs", "dfs"):
        _host(engine, [1], [2, 3], [2, 6, 7], [4, 9, 10]).assert_properties()
    _host("dfs", [0, 1, 2, 0]).assert_properties()
    c = _host("bfs", [1, 4, 3], [0, 4, 3])
    c.assert_properties()
    assert len(c.generated_fingerprints()) == 4
    assert c.unique_state_count() == 6


# --- what still raises -------------------------------------------------------

class _SoundHostProps(TwoPhaseSys):
    host_property_indices = (0,)

    def properties(self):
        return super().properties() + [
            Property.eventually("never", lambda _m, _s: False)]


def test_guarded_combinations_raise():
    ping = PackedPingPong(3, lossy=True, duplicating=True)
    with pytest.raises(NotImplementedError, match="host-evaluated"):
        _SoundHostProps(3).checker().sound_eventually().gpu_options(
            device="cpu", race=False).spawn_gpu()
    with pytest.raises(NotImplementedError, match="mesh"):
        ping.checker().sound_eventually().gpu_options(
            device="cpu", mesh=object()).spawn_gpu()
    with pytest.raises(NotImplementedError, match="checkpoints"):
        ping.checker().sound_eventually().gpu_options(
            device="cpu", race=False, resumable=True).spawn_gpu()
    with pytest.raises(NotImplementedError, match="checkpoints"):
        ping.checker().sound_eventually().resume_from("x.npz").gpu_options(
            device="cpu", race=False).spawn_gpu()
    with pytest.raises(NotImplementedError, match="fallback"):
        ping.checker().sound_eventually().gpu_options(
            device="cpu", race=False, fused="auto").spawn_gpu()
    with pytest.raises(ValueError, match="fused=True"):
        ping.checker().sound_eventually().gpu_options(
            device="cpu", race=False, fused=True).spawn_gpu()


def test_sound_without_eventually_properties_is_the_plain_run():
    """TwoPhaseSys has no eventually property: ``sound_eventually()``
    changes nothing (the JAX package's rule), on the GPU engine and the
    host engines."""
    plain = TwoPhaseSys(3).checker().gpu_options(device="cpu",
                                                 race=False).spawn_gpu()
    sound = TwoPhaseSys(3).checker().sound_eventually().gpu_options(
        device="cpu", race=False).spawn_gpu()
    assert plain.join().unique_state_count() == 288
    assert sound.join().generated_fingerprints() == \
        plain.generated_fingerprints()
    assert "staged" not in sound.profile()
    for engine in ("bfs", "dfs"):
        ck = getattr(TwoPhaseSys(3).checker().sound_eventually(),
                     f"spawn_{engine}")().join()
        assert ck.unique_state_count() == 288


def test_ping7_sound_pin_is_the_jax_packages():
    """The pin ``chip_smoke.py`` holds the card's sound PingPong(7) run
    to: the JAX package's device engine on the CPU at the port's default
    staged sizes gives 69,629 nodes, 511,986 transitions, the state set
    of the plain run (PIN_PING7's digest) and the three discoveries."""
    import hashlib
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    want = JPing(7, lossy=True, duplicating=True).checker() \
        .sound_eventually().tpu_options(race=False, kraw=123_360,
                                        kmax=123_360).spawn_tpu().join()
    arr = np.array(sorted(want.generated_fingerprints()), dtype=np.uint64)
    digest = hashlib.sha256(arr.astype("<u8").tobytes()).hexdigest()
    assert (want.unique_state_count(), want.state_count(), digest) == \
        chip_smoke.PIN_PING7_SOUND
    assert tuple(sorted(want.discoveries())) == chip_smoke.PING7_SOUND_FOUND
    from stateright_tpu_torch.checker.gpu import auto_fmax, candidate_sizes
    ping = PackedPingPong(7, lossy=True, duplicating=True)
    assert candidate_sizes(ping, auto_fmax(ping), {}, True) == (123_360,
                                                                123_360)


def test_staged_and_sound_runs_load_no_jax():
    """The new modules (the staged step, the lasso sweep, the fixtures)
    in a process of their own: a sound run with its sweep and a staged
    run that rebuilds on kovf load neither JAX nor the JAX package."""
    code = (
        "import sys\n"
        "from stateright_tpu_torch import TwoPhaseSys\n"
        "from stateright_tpu_torch.actor.test_util import PackedPingPong\n"
        "from stateright_tpu_torch.models.fixtures import PackedDGraph\n"
        "ck = PackedPingPong(3, lossy=True, duplicating=True).checker()"
        ".sound_eventually().gpu_options(device='cpu', race=False)"
        ".spawn_gpu().join()\n"
        "assert ck.unique_state_count() == 269, ck.unique_state_count()\n"
        "assert 'lasso_s' in ck.profile()\n"
        "ck = TwoPhaseSys(3).checker().gpu_options(device='cpu', "
        "race=False, fused=False, kraw=256, kmax=256).spawn_gpu()"
        ".join()\n"
        "assert ck.unique_state_count() == 288\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'stateright_tpu'))\n"
        "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                   timeout=300)


def test_a_sound_checkpoint_is_refused_naming_its_roadmap_item(tmp_path):
    """A checkpoint the JAX package wrote under ``sound_eventually()``
    (node keys in its mirror) is refused on resume, naming the ROADMAP
    item, rather than read as a plain one."""
    path = tmp_path / "ping3_sound.npz"
    JPing(3, lossy=True, duplicating=True).checker().sound_eventually() \
        .tpu_options(race=False, resumable=True).target_state_count(200) \
        .spawn_tpu().join().save(path)
    resumed = PackedPingPong(3, lossy=True, duplicating=True).checker() \
        .resume_from(path).gpu_options(device="cpu", race=False) \
        .spawn_gpu()
    with pytest.raises(RuntimeError, match="ROADMAP A11"):
        resumed.join()
