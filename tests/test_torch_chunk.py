"""The chunk on the device (``stateright_tpu_torch/checker/device_loop.py``)
on the CPU, where its kernels run their plain versions: K7's plain
version (``append_reference``) against the JAX package's own compaction,
candidate assembly and appends; the loop condition against a transcription
of the JAX package's ``make_cond``; ``target_state_count`` and the
pipeline against the JAX fused engine; pipeline parity; ``profile()``.
The row gate over chunk sizes and the pipeline is
``tests/test_torch_engine.py::test_row_gate_against_jax_fused_engine``;
the card's kernels are held to these plain versions in
``tests/test_torch_gpu.py``."""

import math

import numpy as np
import pytest
import torch

torch.set_num_threads(1)  # leave the other test workers their cores

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from stateright_tpu.checker import device_loop as jdl  # noqa: E402
from stateright_tpu.models import twopc as jtwopc  # noqa: E402
from stateright_tpu.ops import expand as jexp  # noqa: E402
from stateright_tpu_torch import IncrementLock, TwoPhaseSys  # noqa: E402
from stateright_tpu_torch.checker.device_loop import (  # noqa: E402
    B_DISC, B_GEN, B_LOG_N, B_OVF, B_Q_HEAD, B_Q_TAIL, B_VMAX, E_FAULT,
    E_GATE, E_GROW, E_ITERS, E_STEPS, E_TAG, E_TARGET, G_HEAD, G_LBASE,
    G_LEN, G_QBASE, G_SIZE, G_TAG, G_TAKE, I32_MAX, CtrLayout,
    append_reference,
    chunk_begin_reference, gate_reference, iteration_reference, run_chunk,
    seed_carry, step_sizes)
from stateright_tpu_torch.ops.fused import (  # noqa: E402
    S_DISC, S_INSERTED, S_VALID, FusedOut, stats_len)
from stateright_tpu_torch.ops.hashtable import (  # noqa: E402
    table_insert_reference)
from stateright_tpu_torch.ops.words import (  # noqa: E402
    from_numpy_u32, to_numpy_u32)

JaxTwoPhaseSys = jtwopc.TwoPhaseSys

# --- K7's plain version against the JAX package's functions ---------------

APPEND_CASES = [(d, s, e) for d in (0.0, 0.01, 0.5, 1.0)
                for s in (False, True) for e in (False, True)]


@pytest.mark.parametrize(
    "density,symmetry,near_end", APPEND_CASES,
    ids=[f"d{d}-{'sym' if s else 'plain'}-{'end' if e else 'mid'}"
         for d, s, e in APPEND_CASES])
def test_append_matches_jax_compaction_and_appends(density, symmetry,
                                                   near_end):
    """One step's appends: the JAX fused step's ``shrink_indices``, then
    ``assemble_candidates``, then the two ``dynamic_update_slice``s, on
    random words and a random inserted mask, against ``append_reference``
    over the same words; exact (integer words). At the end of the
    buffers the appends start where the loop condition last lets them
    (q_tail = qcap - F*A), where JAX's full-width block still fits."""
    rng = np.random.default_rng(
        [int(density * 100), int(symmetry), int(near_end)])
    f, a, w, n_props = 40, 7, 4, 3
    lanes = f * a
    qcap, logcap = 5 * lanes, 4 * lanes
    lc = 6 if symmetry else 4

    def words(*shape):
        return rng.integers(0, 2**32, size=shape, dtype=np.uint64) \
            .astype(np.uint32)

    q0, log0 = words(qcap, w + 3), words(logcap, lc)
    flat, ebits = words(lanes, w), words(f)
    chi, clo, ohi, olo = (words(lanes) for _ in range(4))
    inserted = rng.random(lanes) < density
    if density == 1.0:
        assert inserted.all()
    cnt = int(inserted.sum())
    head, take = 3 * lanes // 4, f - 5
    qbase = qcap - lanes if near_end else head + f + 17
    lbase = logcap - lanes if near_end else 101

    # the JAX fused step's appends (stateright_tpu/checker/device_loop.py)
    src3 = jdl.shrink_indices(jnp.asarray(inserted), lanes)
    cand, log_off = jexp.assemble_candidates(
        jnp.asarray(flat), jnp.repeat(jnp.asarray(ebits), a),
        jnp.asarray(chi), jnp.asarray(clo),
        jnp.repeat(jnp.asarray(q0[head:head + f, w + 1]), a),
        jnp.repeat(jnp.asarray(q0[head:head + f, w + 2]), a),
        jnp.asarray(ohi), jnp.asarray(olo), w, symmetry, False)
    n_all = cand[src3]
    jq = np.asarray(jax.lax.dynamic_update_slice(
        jnp.asarray(q0), n_all[:, :w + 3], (qbase, 0)))
    jlog = np.asarray(jax.lax.dynamic_update_slice(
        jnp.asarray(log0), n_all[:, log_off:log_off + lc], (lbase, 0)))

    # the port's: the gate and the step's outputs, then K7's plain version
    lay = CtrLayout(n_props, w)
    ctr = torch.zeros((lay.length,), dtype=torch.int32)
    ctr[B_Q_HEAD], ctr[B_Q_TAIL], ctr[B_LOG_N] = head, qbase, lbase
    ctr[B_GEN], ctr[B_VMAX] = 1000, 10**6
    ctr[B_DISC] = 1                      # property 0 already discovered
    ctr[B_DISC + n_props], ctr[B_DISC + 2 * n_props] = 11, 12
    x = lay.ext
    ctr[x + E_STEPS], ctr[x + E_TAG] = 5, 40
    ctr[x + E_GATE:x + E_GATE + G_LEN] = torch.tensor(
        [2, head, take, 40, qbase, lbase], dtype=torch.int32)
    stats = np.zeros(S_DISC + 3 * n_props, np.int64)
    stats[S_VALID], stats[S_INSERTED] = 5 * cnt + 1, cnt
    stats[S_DISC:S_DISC + 2] = 1         # properties 0 and 1 hit
    stats[S_DISC + n_props:S_DISC + n_props + 2] = (21, 22)
    stats[S_DISC + 2 * n_props:S_DISC + 2 * n_props + 2] = (31, 32)
    t = {k: from_numpy_u32(v, "cpu") for k, v in dict(
        flat=flat, ebits=ebits, chi=chi, clo=clo, ohi=ohi, olo=olo).items()}
    out = FusedOut(pbits=None, ebits=t["ebits"], terminal=None,
                   flat=t["flat"], chi=t["chi"], clo=t["clo"], cvalid=None,
                   dvalid=None, inserted=torch.from_numpy(inserted),
                   stats=torch.from_numpy(stats.astype(np.int32)),
                   ohi=t["ohi"] if symmetry else t["chi"],
                   olo=t["olo"] if symmetry else t["clo"])
    q, log = from_numpy_u32(q0, "cpu"), from_numpy_u32(log0, "cpu")
    append_reference(ctr, lay, q, log, out, a, 0, f, qcap - lanes)

    got_q, got_log = to_numpy_u32(q), to_numpy_u32(log)
    np.testing.assert_array_equal(got_q[:qbase + cnt], jq[:qbase + cnt])
    np.testing.assert_array_equal(got_log[:lbase + cnt], jlog[:lbase + cnt])
    # past the appended rows nothing is written (JAX's full-width block
    # writes rows there that later appends overwrite)
    np.testing.assert_array_equal(got_q[qbase + cnt:], q0[qbase + cnt:])
    np.testing.assert_array_equal(got_log[lbase + cnt:],
                                  log0[lbase + cnt:])
    c = ctr.numpy()
    assert (c[B_Q_HEAD], c[B_Q_TAIL], c[B_LOG_N]) == (
        head + take, qbase + cnt, lbase + cnt)
    assert c[B_GEN] == 1000 + 5 * cnt + 1
    assert c[B_VMAX] == 10**6
    recent = (np.asarray(n_all)[cnt - 1, :w + 3] if cnt
              else np.zeros(w + 3, np.uint32))
    np.testing.assert_array_equal(
        c[lay.recent:lay.cch].astype(np.uint32), recent)
    # the sticky first hit: property 0 keeps its register, 1 takes the
    # step's, 2 stays clear
    np.testing.assert_array_equal(c[B_DISC:B_DISC + 3 * n_props],
                                  [1, 1, 0, 11, 22, 0, 12, 32, 0])
    assert (c[x + E_STEPS], c[x + E_TAG], c[x + E_ITERS],
            c[x + E_FAULT]) == (4, 41, 1, 0)


def test_append_flags_a_count_the_step_disagrees_with():
    """K7 sets the fault flag when its count is not the step's
    S_INSERTED, and a closed gate appends nothing."""
    lay = CtrLayout(0, 4)
    f, a = 2, 3
    ins = torch.tensor([0, 1, 0, 1, 1, 0], dtype=torch.bool)
    zeros = torch.zeros((f * a,), dtype=torch.int32)
    out = FusedOut(pbits=None, ebits=torch.zeros((f,), dtype=torch.int32),
                   terminal=None, flat=torch.zeros((f * a, 4),
                                                   dtype=torch.int32),
                   chi=zeros, clo=zeros, cvalid=None, dvalid=None,
                   inserted=ins,
                   stats=torch.tensor([0, 0, 0, 0, 6, 6, 2, 0],
                                      dtype=torch.int32),
                   ohi=zeros, olo=zeros)
    q = torch.zeros((32, 7), dtype=torch.int32)
    log = torch.zeros((32, 4), dtype=torch.int32)
    ctr = torch.zeros((lay.length,), dtype=torch.int32)
    x = lay.ext
    append_reference(ctr, lay, q, log, out, a, 0, f, 32)  # the gate is shut
    assert not ctr.any() and not q.any()
    ctr[B_Q_TAIL] = 2
    ctr[x + E_GATE:x + E_GATE + G_LEN] = torch.tensor([2, 0, 2, 1, 2, 0])
    append_reference(ctr, lay, q, log, out, a, 0, f, 32)
    assert ctr[B_Q_TAIL] == 5 and ctr[x + E_FAULT] == 1


# --- the loop condition -------------------------------------------------

def _seeded(n: int, qcap: int, cap: int = 1 << 12, symmetry=False,
            model=None):
    model = TwoPhaseSys(n) if model is None else model
    init = model.init_states()[0]
    fp = model.fingerprint(init)
    carry = seed_carry(model, qcap, cap, [model.encode(init)], 0, [fp],
                       64, "cpu", symmetry=symmetry)
    table_insert_reference(
        carry.table, from_numpy_u32(np.array([fp >> 32], np.uint32), "cpu"),
        from_numpy_u32(np.array([fp & 0xFFFFFFFF], np.uint32), "cpu"),
        torch.ones((1,), dtype=torch.bool))
    return model, carry


def _jax_condition_holds(c, lay, target, grow_limit, qlimit, gen) -> bool:
    """The JAX package's make_cond (stateright_tpu/checker/device_loop.py)
    over a counter block, without the steps budget."""
    avail = c[B_Q_TAIL] - c[B_Q_HEAD]
    return bool(avail > 0 and not c[B_OVF] and gen < target
                and c[B_LOG_N] < grow_limit and c[B_Q_TAIL] <= qlimit
                and not c[B_DISC:B_DISC + lay.P].all())


@pytest.mark.parametrize("stop", ["grow_limit", "target", "queue",
                                  "steps"])
def test_chunk_stops_where_the_jax_condition_does(stop):
    """One chunk against single-iteration chunks under a transcription
    of the JAX loop condition, stopped by the log's growth limit, the
    generation target, the queue's margin or the steps budget: the same
    counters, queue and log."""
    fmax = 16
    qcap = {"queue": 1200}.get(stop, 1 << 13)
    grow_limit = 180 if stop == "grow_limit" else 1 << 12
    target = 700 if stop == "target" else 2**31 - 1
    steps = 9 if stop == "steps" else 64
    model, whole = _seeded(4, qcap)
    c = run_chunk(model, whole, fmax=fmax, steps=steps, grow_limit=grow_limit,
                  target_remaining=target)
    _, single = _seeded(4, qcap)
    lay = single.layout
    qlimit = qcap - step_sizes(model, fmax)[2]
    gen = iterations = 0
    while iterations < steps:
        before = single.counters()
        if not _jax_condition_holds(before, lay, target, grow_limit, qlimit,
                                    gen):
            break
        one = run_chunk(model, single, fmax=fmax, steps=1,
                        grow_limit=grow_limit, target_remaining=2**31 - 1)
        assert one[lay.ext + E_ITERS] == 1
        gen += int(one[B_GEN])
        iterations += 1
    assert iterations == c[lay.ext + E_ITERS] > 0
    assert gen == c[B_GEN]
    # the carry (the per-chunk counters differ: they are each chunk's)
    got = single.counters()
    for part in (slice(B_Q_HEAD, B_LOG_N + 1), slice(B_DISC, lay.cch)):
        np.testing.assert_array_equal(got[part], c[part])
    t = int(c[B_Q_TAIL])
    assert torch.equal(single.q[:t], whole.q[:t])
    assert torch.equal(single.log, whole.log)
    # the chunk stopped for its reason: one more iteration is refused
    again = run_chunk(model, whole, fmax=fmax, steps=1,
                      grow_limit=grow_limit,
                      target_remaining=max(target - int(c[B_GEN]), 0))
    assert again[lay.ext + E_ITERS] == (1 if stop == "steps" else 0)


# --- the gate: at the chunk's start and in K7's tail ------------------------

#: the chunk parameters (steps, target_remaining, grow_limit) of
#: chip_smoke.py's check_control: one set that opens the gate, three that
#: shut it
GATE_PARAMS = {"open": (3, I32_MAX, I32_MAX),
               "no_steps": (0, I32_MAX, I32_MAX),
               "target": (3, 0, I32_MAX), "grow_limit": (3, I32_MAX, 0)}


def _gate_of(ctr, lay) -> list:
    x = lay.ext + E_GATE
    return ctr[x:x + G_LEN].tolist()


def _transcribed_gate(c, lay, f_small, f_large, qlimit) -> list:
    """The gate from a transcription of the JAX package's make_cond with
    the chunk's steps budget, and the step-size rule of its
    small/large/small window loops."""
    x = lay.ext
    head, tail = int(c[B_Q_HEAD]), int(c[B_Q_TAIL])
    avail = tail - head
    go = (c[x + E_STEPS] > 0 and not c[x + E_FAULT]
          and _jax_condition_holds(c, lay, c[x + E_TARGET], c[x + E_GROW],
                                   qlimit, c[B_GEN]))
    small = 0 < f_small and avail <= f_small
    f = f_small if small else f_large
    return [(1 if small else 2) if go else 0, head, min(avail, f),
            int(c[x + E_TAG]), tail, int(c[B_LOG_N])]


@pytest.mark.parametrize("case", list(GATE_PARAMS))
def test_chunk_begin_leaves_the_gate_of_its_counters(case):
    """The plain ``chunk_begin`` writes the chunk's parameters, zeroes
    the per-chunk counters and the stats vector, and leaves the gate
    that ``gate_reference`` gives on the counters it leaves (and the
    transcribed JAX condition): open only under the open parameters."""
    fmax = 512
    model, carry = _seeded(5, 1 << 15, 1 << 15)
    run_chunk(model, carry, fmax=fmax, steps=3)
    lay = carry.layout
    f_small, f_large, qmargin = step_sizes(model, fmax)
    qlimit = carry.q.shape[0] - qmargin
    ctr = carry.ctr.clone()
    stats = torch.full((stats_len(model),), -1, dtype=torch.int32)
    gate = chunk_begin_reference(ctr, lay, *GATE_PARAMS[case], 7, f_small,
                                 f_large, qlimit, stats)
    c = ctr.numpy()
    x = lay.ext
    assert (c[x + E_STEPS], c[x + E_TAG], c[x + E_ITERS], c[B_GEN]) == (
        GATE_PARAMS[case][0], 7, 0, 0)
    assert not stats.any()
    assert _gate_of(ctr, lay) == gate
    assert gate == gate_reference(ctr.clone(), lay, f_small, f_large,
                                  qlimit)
    assert gate == _transcribed_gate(c, lay, f_small, f_large, qlimit)
    assert (gate[G_SIZE] != 0) == (case == "open")
    # the counters the gate does not read are the carry's
    np.testing.assert_array_equal(c[B_Q_HEAD:B_LOG_N + 1],
                                  carry.counters()[B_Q_HEAD:B_LOG_N + 1])


TAIL_CASES = {"2pc3": (lambda: TwoPhaseSys(3), 16, 287),
              "2pc5": (lambda: TwoPhaseSys(5), 512, 8831),
              "lock3": (lambda: IncrementLock(3), 16, 60)}


@pytest.mark.parametrize("name", list(TAIL_CASES))
def test_append_tail_gate_is_the_gate_of_the_updated_carry(name):
    """After every plain append of a whole search (one chunk), the gate
    it left equals ``gate_reference`` (and the transcribed JAX condition)
    on the counters it updated, the next iteration runs the step it
    picked, and the last one is shut with the queue drained."""
    make, fmax, log_rows = TAIL_CASES[name]
    model, carry = _seeded(0, 1 << 15, 1 << 15, model=make())
    lay = carry.layout
    f_small, f_large, qmargin = step_sizes(model, fmax)
    qlimit = carry.q.shape[0] - qmargin
    chunk_begin_reference(carry.ctr, lay, 10**6, I32_MAX, I32_MAX, 1,
                          f_small, f_large, qlimit)
    sizes = set()
    while True:
        gate = _gate_of(carry.ctr, lay)
        if not iteration_reference(model, carry, fmax):
            break
        sizes.add(gate[G_SIZE])
        c = carry.counters()
        # the step the gate picked: its rows taken, its tag spent
        assert c[B_Q_HEAD] == gate[G_HEAD] + gate[G_TAKE]
        assert c[lay.ext + E_TAG] == gate[G_TAG] + 1
        assert (c[B_Q_TAIL] - gate[G_QBASE] == c[B_LOG_N] - gate[G_LBASE]
                >= 0)
        tail_gate = _gate_of(carry.ctr, lay)
        assert tail_gate == gate_reference(carry.ctr.clone(), lay, f_small,
                                           f_large, qlimit)
        assert tail_gate == _transcribed_gate(c, lay, f_small, f_large,
                                              qlimit)
    c = carry.counters()
    assert _gate_of(carry.ctr, lay)[G_SIZE] == 0
    assert c[B_Q_HEAD] == c[B_Q_TAIL] and c[B_LOG_N] == log_rows
    assert sizes == ({1, 2} if f_small else {2})


@pytest.mark.parametrize("stop", ["steps", "target", "grow_limit", "done"])
def test_a_shut_gate_stays_shut(stop):
    """A chunk stopped by its steps, its generation target, its growth
    limit or the end of the search leaves a shut gate; further
    iterations with nothing changed run no step, change no counter, row
    or gate, and the gate recomputed on those counters is still shut."""
    fmax = 16
    model, carry = _seeded(4, 1 << 13)
    kw = {"steps": dict(steps=5), "target": dict(steps=64,
                                                 target_remaining=300),
          "grow_limit": dict(steps=64, grow_limit=150),
          "done": dict(steps=10**4)}[stop]
    c = run_chunk(model, carry, fmax=fmax, **kw)
    lay = carry.layout
    assert c[lay.ext + E_ITERS] > 0
    f_small, f_large, qmargin = step_sizes(model, fmax)
    qlimit = carry.q.shape[0] - qmargin
    state = (carry.ctr.clone(), carry.q.clone(), carry.log.clone())
    assert _gate_of(carry.ctr, lay)[G_SIZE] == 0
    for _ in range(3):
        assert not iteration_reference(model, carry, fmax)
    for before, now in zip(state, (carry.ctr, carry.q, carry.log)):
        assert torch.equal(before, now)
    assert gate_reference(carry.ctr.clone(), lay, f_small, f_large,
                          qlimit)[G_SIZE] == 0
    if stop == "done":
        assert c[B_Q_HEAD] == c[B_Q_TAIL] and c[B_LOG_N] == 1567


@pytest.mark.parametrize("lanes,sms,tile", [
    (454_656, 132, 4096), (1_007_616, 132, 4096), (110_592, 132, 1024),
    (196_608, 132, 1024), (9_472, 132, 1024), (454_656, 8, 4096),
    (100_000, 20, 4096)])
def test_append_tile_keeps_three_tiles_for_four_sms(lanes, sms, tile):
    """K7's tile size: the larger of 4,096 and 1,024 lanes that gives at
    least three tiles for every four SMs (2pc7, 2pc16, then
    IncrementLock(9) and Increment(16) at 12,288 rows on 132 SMs), the
    smallest when none does; its grid is one block a tile and the
    tail."""
    from stateright_tpu_torch.ops import _cuda
    assert _cuda.append_tile(lanes, sms) == tile
    assert _cuda.append_grid(lanes, tile) == -(-lanes // tile) + 1


@pytest.mark.parametrize("rows,tile,fits", [
    (600, 1024, True), (600, 4096, True), (1200, 1024, False),
    (1200, 4096, False), (601, 4096, True)],
    ids=["own-1024", "own-4096", "more-rows-1024", "more-rows-4096",
         "same-grid-4096"])
def test_chunk_args_takes_the_tile_of_its_scratch(rows, tile, fits):
    """K7's scan state fixes its grid (a launch's epoch is its tickets
    over its blocks): ``chunk_args`` takes the tile size from the scratch
    and refuses a scratch made for another grid, whose blocks would split
    over two epochs and wait forever; a tile K7 lacks is refused when
    the scratch is made."""
    from stateright_tpu_torch.ops import _cuda
    f_large, a, w, n_props = 600, TwoPhaseSys(7).max_actions, 4, 3
    cpu = torch.device("cpu")
    lay = CtrLayout(n_props, w)
    bufs = _cuda.step_buffers(TwoPhaseSys(7), f_large, S_DISC + 3 * n_props,
                              False, cpu, 1)
    scratch = _cuda.append_scratch(rows * a, tile, cpu)
    assert scratch["status"].shape[0] == _cuda.append_grid(rows * a, tile)

    def args():
        return _cuda.chunk_args(
            ctr=torch.zeros((lay.length,), dtype=torch.int32),
            bufs=bufs, q=torch.zeros((64, w + 3), dtype=torch.int32),
            log=torch.zeros((64, 4), dtype=torch.int32), scratch=scratch,
            qlimit=32, n_props=n_props, width=w, n_actions=a, f_small=0,
            f_large=f_large, ext=lay.ext, recent=lay.recent, cch=lay.cch)
    if fits:
        assert args().tile_lanes == tile
    else:
        with pytest.raises(ValueError, match="do not fit"):
            args()
    with pytest.raises(ValueError, match="no 2048-lane tile"):
        _cuda.append_scratch(f_large * a, 2048, cpu)


# --- the engine: target_state_count, the pipeline, profile() -------------

def _port(model, **opts):
    builder = model.checker()
    target = opts.pop("target", None)
    if target is not None:
        builder = builder.target_state_count(target)
    return builder.gpu_options(device="cpu", race=False, **opts) \
        .spawn_gpu().join()


def _jax(model, **opts):
    builder = model.checker()
    target = opts.pop("target", None)
    if target is not None:
        builder = builder.target_state_count(target)
    return builder.tpu_options(race=False, fused=True, mode="device",
                               **opts).spawn_tpu().join()


TARGET_CASES = [(k, p) for k in (1, 4) for p in (False, True)]


@pytest.mark.parametrize("chunk_steps,pipeline", TARGET_CASES,
                         ids=[f"k{k}-{'pipeline' if p else 'sync'}"
                              for k, p in TARGET_CASES])
def test_target_state_count_matches_jax(chunk_steps, pipeline):
    """A generation target stops both engines after the same chunks:
    the budget a chunk gets is the host's count at its dispatch, which
    lags one chunk under the pipeline, so the overshoot is JAX's."""
    opts = dict(fmax=16, capacity=1 << 12, cc_dedup=64, target=500,
                chunk_steps=chunk_steps, pipeline=pipeline)
    want = _jax(JaxTwoPhaseSys(5), **opts)
    got = _port(TwoPhaseSys(5), **opts)
    assert got.state_count() == want.state_count() >= 500
    assert got.unique_state_count() == want.unique_state_count() < 8832


PARITY_CASES = [(3, None), (4, None), (4, True), (5, False)]


@pytest.mark.parametrize("n,complete", PARITY_CASES,
                         ids=["2pc3", "2pc4", "2pc4-complete",
                              "2pc5-reference"])
def test_pipeline_parity(n, complete):
    """The pipeline changes when the host learns things, never what the
    search finds: the same unique counts, fingerprint sets, discoveries
    and witness paths with it on and off (the single-chip 2pc case of
    tests/test_pipeline_parity.py), with and without symmetry
    reduction."""
    def run(pipeline):
        model = TwoPhaseSys(n, complete_symmetry=bool(complete))
        builder = model.checker()
        if complete is not None:
            builder = builder.symmetry_fn(model.representative)
        return builder.gpu_options(device="cpu", fmax=64, capacity=1 << 14,
                                   chunk_steps=4, pipeline=pipeline,
                                   race=False).spawn_gpu().join()

    on, off = run(True), run(False)
    assert on.unique_state_count() == off.unique_state_count()
    assert on.state_count() == off.state_count()
    assert on.generated_fingerprints() == off.generated_fingerprints()
    assert set(on.discoveries()) == set(off.discoveries())
    for name, path in on.discoveries().items():
        assert path.into_actions() == off.discoveries()[name] \
            .into_actions()
    assert on.profile()["pipeline"] and not off.profile()["pipeline"]


PROFILE_CASES = [(k, p, cap) for k in (1, 8, 64) for p in (False, True)
                 for cap in (1 << 12, 1 << 16)]


@pytest.mark.parametrize(
    "chunk_steps,pipeline,capacity", PROFILE_CASES,
    ids=[f"k{k}-{'pipeline' if p else 'sync'}-c{c.bit_length() - 1}"
         for k, p, c in PROFILE_CASES])
def test_profile_counts_one_sync_per_chunk(chunk_steps, pipeline,
                                           capacity):
    """One sync per chunk, and no more chunks than the iterations need:
    full chunks, one cut short by each growth and by the end, and with
    the pipeline one speculative chunk (no iteration) drained at each
    growth and at the end. A 2**12-slot table at 16-row steps grows and
    keeps the count."""
    ck = _port(TwoPhaseSys(5), fmax=16, capacity=capacity,
               chunk_steps=chunk_steps, pipeline=pipeline)
    prof = ck.profile()
    assert ck.unique_state_count() == 8832 and ck.state_count() == 58146
    ck.assert_properties()
    grows = prof["grows"]
    assert (grows > 0) == (capacity == 1 << 12)
    assert prof["syncs"] == prof["chunks"]
    bound = math.ceil(prof["iterations"] / chunk_steps) + grows + 1
    if pipeline:
        bound += grows + 1
    assert prof["chunks"] <= bound
    # 16-row steps are below FMAX_SMALL: one step size
    assert prof["iterations"] > 0 and prof["small_iterations"] == 0
    assert prof["chunk_steps"] == chunk_steps
    assert prof["graph_launches"] == 0 and prof["capture_s"] == 0.0
