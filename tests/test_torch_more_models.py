"""The port's other packed models — ``PackedLinearEquation``,
``Increment`` (with its symmetry) and ``IncrementLock`` — against the
JAX package's, on the CPU: the host/device contract
(``validate_packed_model``); the plain ``packed_step``,
``packed_properties`` and ``packed_representative`` against the JAX
model's vmapped functions on the same rows, bit for bit (integer
arithmetic: tolerance 0); the row gate against the JAX fused engine with
every shape knob set on both sides; the one-rank sharded engine on a
gloo CPU mesh against the JAX sharded fused engine; witnesses; the
refusals; and the import boundary. The card-only tests are in
test_torch_gpu.py."""

import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

torch.set_num_threads(1)  # leave the other test workers their cores

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

from stateright_tpu.examples import increment as jinc  # noqa: E402
from stateright_tpu.examples import increment_lock as jlock  # noqa: E402
from stateright_tpu.models import packed as jpacked  # noqa: E402
from stateright_tpu_torch import (Increment, IncrementLock,  # noqa: E402
                                  PackedLinearEquation)
from stateright_tpu_torch.models.packed import (  # noqa: E402
    validate_packed_model)
from stateright_tpu_torch.ops import _cuda  # noqa: E402
from stateright_tpu_torch.ops.words import (from_numpy_u32,  # noqa: E402
                                            to_numpy_u32)

ROOT = pathlib.Path(__file__).resolve().parent.parent

#: (port model, JAX model) pairs by name
PAIRS = {
    "lineq247": (lambda: PackedLinearEquation(2, 4, 7),
                 lambda: jpacked.PackedLinearEquation(2, 4, 7)),
    "lineq_big_c": (lambda: PackedLinearEquation(3, 5, 10 ** 9),
                    lambda: jpacked.PackedLinearEquation(3, 5, 10 ** 9)),
    "inc1": (lambda: Increment(1), lambda: jinc.Increment(1)),
    "inc3": (lambda: Increment(3), lambda: jinc.Increment(3)),
    "inc16": (lambda: Increment(16), lambda: jinc.Increment(16)),
    "lock1": (lambda: IncrementLock(1), lambda: jlock.IncrementLock(1)),
    "lock3": (lambda: IncrementLock(3), lambda: jlock.IncrementLock(3)),
    "lock16": (lambda: IncrementLock(16), lambda: jlock.IncrementLock(16)),
}


def _cpu(builder, **opts):
    """The device engine alone on the CPU (no host race)."""
    return builder.gpu_options(device="cpu", race=False, **opts) \
        .spawn_gpu().join()


def _rows(model, rng) -> np.ndarray:
    """Reachable rows (a host BFS, up to 300), rows of small thread
    words (equal words and every pc 0..5: the ties a sort meets) and
    uniformly random words."""
    states, seen, queue = [], set(), list(model.init_states())
    while queue and len(states) < 300:
        s = queue.pop(0)
        enc = tuple(model.encode(s).tolist())
        if enc not in seen:
            seen.add(enc)
            states.append(enc)
            queue.extend(model.next_states(s))
    w = model.packed_width
    ties = (rng.integers(0, 4, (128, w)) << 4
            | rng.integers(0, 6, (128, w))).astype(np.uint32)
    ties[:, 0] = rng.integers(0, 300, 128)
    noise = rng.integers(0, 1 << 32, (64, w), dtype=np.uint64)
    return np.concatenate([np.array(states, np.uint32), ties,
                           noise.astype(np.uint32)])


@pytest.mark.parametrize("name", ["lineq247", "inc3", "lock3", "lock1"])
def test_validate_packed_model(name):
    model = PAIRS[name][0]()
    assert validate_packed_model(model) >= {"lineq247": 2000, "inc3": 84,
                                            "lock3": 61, "lock1": 5}[name]


@pytest.mark.parametrize("name", list(PAIRS))
def test_plain_functions_equal_jax_bit_for_bit(name):
    model, jmodel = PAIRS[name][0](), PAIRS[name][1]()
    rows = _rows(model, np.random.default_rng(len(name)))
    t = from_numpy_u32(rows)
    succ, valid = model.packed_step(t)[:2]
    jsucc, jvalid = jax.vmap(jmodel.packed_step)(jnp.asarray(rows))
    assert np.array_equal(to_numpy_u32(succ), np.asarray(jsucc))
    assert np.array_equal(valid.numpy(), np.asarray(jvalid))
    props = model.packed_properties(t)
    jprops = jax.vmap(jmodel.packed_properties)(jnp.asarray(rows))
    assert np.array_equal(props.numpy(), np.asarray(jprops))
    if hasattr(jmodel, "packed_representative"):
        canon = model.packed_representative(t)
        jcanon = jax.vmap(jmodel.packed_representative)(jnp.asarray(rows))
        assert np.array_equal(to_numpy_u32(canon), np.asarray(jcanon))


@pytest.mark.parametrize("kind", ["increment", "increment_lock"])
def test_plain_functions_equal_jax_at_every_width(kind):
    """n = 1..16: every packed width the kernels take (2 to 17 words for
    Increment, 3 to 18 for IncrementLock), on rows of small thread words
    and random words."""
    rng = np.random.default_rng(16)
    for n in range(1, 17):
        if kind == "increment":
            model, jmodel = Increment(n), jinc.Increment(n)
        else:
            model, jmodel = IncrementLock(n), jlock.IncrementLock(n)
        w = model.packed_width
        rows = (rng.integers(0, 4, (96, w)) << 4
                | rng.integers(0, 6, (96, w))).astype(np.uint32)
        rows[:16] = rng.integers(0, 1 << 32, (16, w), dtype=np.uint64)
        t, j = from_numpy_u32(rows), jnp.asarray(rows)
        succ, valid = model.packed_step(t)[:2]
        jsucc, jvalid = jax.vmap(jmodel.packed_step)(j)
        assert np.array_equal(to_numpy_u32(succ), np.asarray(jsucc)), n
        assert np.array_equal(valid.numpy(), np.asarray(jvalid)), n
        assert np.array_equal(model.packed_properties(t).numpy(), np.asarray(
            jax.vmap(jmodel.packed_properties)(j))), n
        if kind == "increment":
            assert np.array_equal(
                to_numpy_u32(model.packed_representative(t)),
                np.asarray(jax.vmap(jmodel.packed_representative)(j))), n


def test_increment_representative_agrees_with_host_on_ties():
    """Rows where two threads hold equal words, and children whose
    changed thread's word ties another: the batched canonical rows equal
    ``encode(representative(s))``."""
    model = Increment(4)
    states = [(5, ((3, 2), (3, 2), (0, 1), (3, 2))),
              (1, ((0, 3), (1, 2), (0, 3), (0, 1))),
              (0, ((0, 1),) * 4)]
    for s in list(states):
        states.extend(model.next_states(s))
    rows = from_numpy_u32(np.stack([model.encode(s) for s in states]))
    want = np.stack([model.encode(model.representative(s)) for s in states])
    assert np.array_equal(to_numpy_u32(model.packed_representative(rows)),
                          want)


#: every knob the engines size by, explicit on both sides
KNOBS = dict(fmax=16, capacity=1 << 12, cc_dedup=64, chunk_steps=8,
             pipeline=True)
ROW_GATE = {
    "lock4": (lambda: IncrementLock(4), lambda: jlock.IncrementLock(4),
              False, KNOBS, 257),
    "lock5": (lambda: IncrementLock(5), lambda: jlock.IncrementLock(5),
              False, KNOBS, 1301),
    "inc3": (lambda: Increment(3), lambda: jinc.Increment(3), False, KNOBS,
             None),
    "inc3_sym": (lambda: Increment(3), lambda: jinc.Increment(3), True,
                 KNOBS, None),
    # 64-row steps keep the 2**12 table, which grows to 2**18
    "lineq_grow": (lambda: PackedLinearEquation(2, 4, 7),
                   lambda: jpacked.PackedLinearEquation(2, 4, 7), False,
                   dict(fmax=64, capacity=1 << 12, cc_dedup=1 << 10,
                        chunk_steps=64, pipeline=True), 65536),
}


def _builder(model, symmetry):
    b = model.checker()
    return b.symmetry_fn(model.representative) if symmetry else b


@pytest.mark.parametrize("name", list(ROW_GATE))
def test_row_gate_against_jax_fused_engine(name):
    make, jmake, symmetry, knobs, unique = ROW_GATE[name]
    want = _builder(jmake(), symmetry).tpu_options(
        race=False, fused=True, mode="device", **knobs).spawn_tpu().join()
    got = _cpu(_builder(make(), symmetry), **knobs)
    want._ensure_mirror()
    got._ensure_mirror()
    if unique is not None:
        assert got.unique_state_count() == unique
    assert got.unique_state_count() == want.unique_state_count()
    assert got.state_count() == want.state_count()
    assert list(got._generated.items()) == list(want._generated.items())
    assert dict(got._orig_of) == dict(want._orig_of)
    assert got._discovery_fps == want._discovery_fps
    if name == "lineq_grow":
        assert got.profile()["grows"] == 3
        assert got.discovery("solvable") is None
    model = got.model()
    for prop, path in got.discoveries().items():  # replays or raises
        assert len(path) == len(want.discovery(prop))
        holds = model.property(prop).condition(model, path.last_state())
        assert holds == (prop == "solvable")


def test_increment_fin_counterexample_replays():
    """``fin`` is falsifiable by design: the run stops at a witness of
    four actions (two reads, then both writes), with or without
    symmetry, as the JAX engine's."""
    for symmetry in (False, True):
        model = Increment(4)
        ck = _cpu(_builder(model, symmetry))
        path = ck.assert_any_discovery("fin")
        assert not model.property("fin").condition(model, path.last_state())
        assert len(path) == 4
        assert [a[0] for a in path.into_actions()] == ["Read", "Read",
                                                       "Write", "Write"]


def test_lineq_solvable_witness():
    ck = _cpu(PackedLinearEquation(2, 10, 14).checker())
    path = ck.assert_any_discovery("solvable")
    assert path.last_state() == (2, 1) and len(path) == 3


# --- the one-rank sharded engine on a gloo CPU mesh -------------------------

SHARDED = {
    "lock4": (lambda: IncrementLock(4), lambda: jlock.IncrementLock(4),
              False, 257),
    "lock5": (lambda: IncrementLock(5), lambda: jlock.IncrementLock(5),
              False, 1301),
    "inc3": (lambda: Increment(3), lambda: jinc.Increment(3), False, None),
    "inc3_sym": (lambda: Increment(3), lambda: jinc.Increment(3), True,
                 None),
    "lineq": (lambda: PackedLinearEquation(2, 4, 7),
              lambda: jpacked.PackedLinearEquation(2, 4, 7), False, 65536),
}


@pytest.fixture(scope="module")
def mesh1():
    """A one-rank gloo group on an in-memory store."""
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        yield init_device_mesh("cpu", (1,), mesh_dim_names=("shards",))
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("name", list(SHARDED))
def test_one_rank_sharded_engine_against_jax(mesh1, name):
    make, jmake, symmetry, unique = SHARDED[name]
    model = make()
    knobs = dict(capacity=1 << 12, fmax=64, cc_dedup=1 << 10,
                 kraw=64 * model.max_actions, kmax=64 * model.max_actions)
    jmesh = Mesh(np.array(jax.devices()[:1]), ("shards",))
    want = _builder(jmake(), symmetry).tpu_options(
        mesh=jmesh, fused=True, race=False, **knobs).spawn_tpu().join()
    got = _builder(model, symmetry).gpu_options(mesh=mesh1, **knobs) \
        .spawn_gpu().join()
    if unique is not None:
        assert got.unique_state_count() == unique
    assert got.unique_state_count() == want.unique_state_count()
    assert got.state_count() == want.state_count()
    assert got.generated_fingerprints() == want.generated_fingerprints()
    assert list(got._generated.items()) == list(want._generated.items())
    assert got._discovery_fps == want._discovery_fps
    for prop, path in got.discoveries().items():  # replays or raises
        assert len(path) == len(want.discovery(prop))


# --- refusals and the kernels' names --------------------------------------

def test_increment_lock_under_symmetry_raises_on_both_packages():
    for model in (IncrementLock(3), jlock.IncrementLock(3)):
        builder = model.checker().symmetry_fn(model.representative)
        with pytest.raises(NotImplementedError,
                           match="packed_representative"):
            if isinstance(model, IncrementLock):
                builder.gpu_options(device="cpu").spawn_gpu()
            else:
                builder.tpu_options(race=False).spawn_tpu()
    with pytest.raises(NotImplementedError, match="packed_representative"):
        IncrementLock(3).cuda_spec(symmetry=True)


class _FastLock(IncrementLock):
    def packed_step(self, words):
        return super().packed_step(words)


class _LooseInc(Increment):
    def packed_representative(self, words):
        return super().packed_representative(words)


class _TwoProps(PackedLinearEquation):
    def properties(self):
        return super().properties() * 2


@pytest.mark.parametrize("model,symmetry,what", [
    (_FastLock(3), False, "overrides packed_step"),
    (_LooseInc(3), True, "overrides packed_representative"),
    (_TwoProps(2, 4, 7), False, "changes the properties"),
])
def test_card_refuses_a_subclass_its_kernel_does_not_run(model, symmetry,
                                                         what):
    builder = _builder(model, symmetry)
    with pytest.raises(NotImplementedError, match=what):
        builder.gpu_options(device="cuda").spawn_gpu()
    if isinstance(model, _FastLock):  # its plain version still runs
        assert _cpu(builder).unique_state_count() == 61


@pytest.mark.parametrize("model,symmetry,spec,entry", [
    (PackedLinearEquation(2, 4, 7), False, ("lineq", (2, 4, 7)),
     "lineq"),
    (PackedLinearEquation(258, -1, 10 ** 9), False,
     ("lineq", (2, 255, 256)), "lineq"),
    (Increment(16), False, ("increment", (16,)), "increment"),
    (Increment(7), True, ("increment", (7,)), "increment_sym"),
    (IncrementLock(9), False, ("increment_lock", (9,)), "increment_lock"),
])
def test_cuda_spec_names_and_parameters(model, symmetry, spec, entry):
    assert model.cuda_spec(symmetry) == spec
    assert _cuda.step_entry(model, symmetry) == (entry, spec[1])
    # every parameter is passed as a C int
    assert all(-2 ** 31 <= p < 2 ** 31 for p in spec[1])
    names = {e[0] for lib in _cuda._ENTRIES.values() for e in lib}
    assert {f"srt_fused_step_{entry}", f"srt_dedup_step_{entry}"} <= names


def test_step_entry_refuses_unknown_names():
    # (paxos, ABD and the write-once register have step kernels since
    # their own slices; no model has lossy drop lanes on the card yet)
    class _Other(PackedLinearEquation):
        def cuda_spec(self, symmetry=False):
            return "single_copy_lossy", (3,)
    with pytest.raises(NotImplementedError, match="single_copy_lossy"):
        _cuda.step_entry(_Other(1, 2, 3), False)
    with pytest.raises(NotImplementedError, match="under symmetry"):
        _cuda.step_entry(type("_Sym", (PackedLinearEquation,), {
            "cuda_spec": lambda self, symmetry=False: ("lineq", (1, 2, 3))
        })(1, 2, 3), True)


def test_examples_cli(capsys):
    # check runs the host DFS as the JAX package's does, and prints its
    # Done. line (the JAX package's: 61 states, all unique)
    from stateright_tpu_torch.examples import increment, increment_lock
    assert increment_lock.main(["check", "3"]) == 0
    done = [ln for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("Done.")]
    assert len(done) == 1 and done[0].startswith(
        "Done. states=61, unique=61, sec=")
    assert increment.main(["explore", "2"]) == 2
    assert increment_lock.main(["check-gpu", "3", "--cpu"]) == 0
    assert increment.main(["check-gpu-sym", "2", "--cpu"]) == 0


def test_examples_cli_no_race(capsys):
    # check-gpu --no-race runs the device engine alone (race=False)
    from stateright_tpu_torch.examples import increment_lock
    from stateright_tpu_torch.examples import parse_args
    assert parse_args(["check-gpu", "4", "--no-race", "--cpu"]) == (
        "check-gpu", 4, {"race": False, "device": "cpu"})
    assert increment_lock.main(["check-gpu", "3", "--cpu",
                                "--no-race"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert [ln for ln in out if ln.startswith("Done.")][0].startswith(
        "Done. states=61, unique=61, sec=")
    assert any(ln.startswith("# engine=gpu ") for ln in out), out


# --- the import boundary --------------------------------------------------

def test_new_modules_import_no_jax():
    files = [ROOT / "stateright_tpu_torch" / p for p in (
        "examples/__init__.py", "examples/increment.py",
        "examples/increment_lock.py", "models/packed.py")]
    code = (
        "import sys\n"
        "from stateright_tpu_torch import IncrementLock, Increment\n"
        "ck = IncrementLock(3).checker().gpu_options(device='cpu')"
        ".spawn_gpu().join()\n"
        "assert ck.unique_state_count() == 61\n"
        "m = Increment(3)\n"
        "ck = m.checker().symmetry_fn(m.representative)"
        ".gpu_options(device='cpu').spawn_gpu().join()\n"
        "ck.discovery('fin')\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'stateright_tpu'))\n"
        "assert not bad, bad\n")
    for path in files:
        assert "import jax" not in path.read_text()
        assert "stateright_tpu." not in path.read_text().replace(
            "stateright_tpu_torch", "")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                   timeout=300)


# --- the pins of chip_smoke.py ------------------------------------------

@pytest.mark.slow
def test_increment_lock_pins():
    """The counts and fingerprint-set digests chip_smoke.py holds the
    card to, from the JAX package's staged device engine on the CPU, and
    from the port's plain path at n = 8."""
    import hashlib
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    def digest(fps):
        arr = np.array(sorted(fps), dtype=np.uint64)
        return hashlib.sha256(arr.astype("<u8").tobytes()).hexdigest()

    for n, want in ((8, chip_smoke.PIN_LOCK8), (9, chip_smoke.PIN_LOCK9)):
        ref = jlock.IncrementLock(n).checker().tpu_options(
            race=False, fused=False, mode="device").spawn_tpu().join()
        assert (ref.unique_state_count(), ref.state_count(),
                digest(ref.generated_fingerprints())) == want
    ck = _cpu(IncrementLock(8).checker())
    assert (ck.unique_state_count(), ck.state_count(),
            digest(ck.generated_fingerprints())) == chip_smoke.PIN_LOCK8
