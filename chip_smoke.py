#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``stateright_tpu_torch``) on one
NVIDIA GPU.

    python3 chip_smoke.py

Phases, one JSON line each:

1. device  — the card (torch and ``nvidia-smi``), torch/CUDA/nvcc versions;
2. build   — the nvcc build of ``stateright_tpu_torch/csrc`` for sm_90a:
             seconds, and each kernel's registers and shared memory;
   race    — the host race on the main path (``spawn_gpu()`` races a
             budgeted host BFS against the card by default):
             IncrementLock(3) raced (61 states, won by the host, its wall),
             the host BFS alone and the card alone (``race=False``: K1-K3, K4 and K7
             launched); TwoPhaseSys(7) raced (won by the card, the pinned
             count and digest) against ``race=False`` in turns, walls and
             ``loop_s``; a chunk that fails to launch ends the race
             (``join()`` raises, the host's answer held back);
             TwoPhaseSys(3) raced against ``spawn_bfs()``'s set;
             ``increment_lock check-gpu 3`` in fresh processes, raced
             and ``--no-race`` in turns (the cold-start walls; these run
             last, after phase ``paxos``: once another process has used
             the card, this one's profiler traces lose their device
             time);
   checkpoint — TwoPhaseSys(7) bounded at 100,000 generated states with
             ``resumable=True``, saved, resumed on the card to the pinned
             count and digest (a witness through the stitched mirror;
             K4 launched on the preload, the checkpoint's whole mirror,
             and held against its plain version and timed there, with
             ``seed_s``, the file's size and ``save()``'s seconds); then
             TwoPhaseSys(16, complete_symmetry=True) resumed to its exact
             21,335 keys and digest through K1-sym;
3. kernels — each kernel held against its plain torch version on the card
             at the main paths' shapes (2pc n=7, a mid-search frontier of
             12,288 and of 256 rows, a 2**20-slot table, a 2**15-slot
             ring; the owner-side probe at the received width of the
             sharded step; the symmetric steps at 2pc n=16, 82 actions,
             with both representatives) by the lane and set gates, and
             timed with CUDA events and ``torch.profiler``, with each
             kernel's own device time, bound and launch geometry
             (``parts``); the chunk's start (``chunk_begin_kernel`` with
             the chunk's first gate) under parameters that open and shut
             the gate, and K7 (``append_kernel``, with the carry update
             and the next gate) after a real step of 2pc7 at 12,288 and
             256 rows and of 2pc16 (6-column log), bit for bit;
4. e2e     — ``TwoPhaseSys(7).checker().spawn_gpu().join()`` with default
             options, checked against the oracle counts, the fingerprint-set
             digest, the properties and both witness replays, with every
             kernel's launch count set to 0 before the run and read after
             it, and 7 kernel nodes a replay of the chunk's graph (K1-K3
             of both step sizes and K7: by the launch counts and by the
             trace of a profiled run); then again from a 2**16-slot
             table, which grows twice;
5. e2e_sym — symmetry reduction on one card: every reachable 2pc7 state
             recounted into its 920 orbits and 9,840 reference keys
             (``orbits_2pc7``); ``TwoPhaseSys(n[, complete_symmetry=True])
             .checker().symmetry_fn(model.representative).spawn_gpu()`` at
             n=7 and n=16: the complete representative held to the JAX
             package's count, generated count and canonical-key digest,
             the reference one to its sound range at n=7, to covering
             every orbit (its enqueued original rows canonicalized by the
             complete representative) and, at n=16 (the full-width run,
             over a million reduced states), to the card's own count,
             generated count and key digest, to a repeated search record
             and the complete run's verdicts, with a profiled repeat;
             the complete one again through table growth; witnesses
             replay;
6. e2e_sharded — the same check through the sharded engine,
             ``gpu_options(mesh=<DeviceMesh>)``, on a one-rank NCCL group
             (one card), with default options and again from a 2**16-slot
             table at 512-row steps, which grows; the same launch counts,
             and a second run's search record compared row for row; then
             2pc16 under complete symmetry (``e2e_sharded_sym``), held to
             the single-chip pins.
7. models  — the other models end to end through the same entry points,
             every launch count set to 0 before each run: IncrementLock(9)
             (3,945,637 states, the full-width run: the JAX package's
             counts and digest, both properties hold, at least two
             growths: the table quadruples, 2**20 -> 2**22 -> 2**24),
             PackedLinearEquation(2, 4, 7) from a 2**14-slot
             table (65,536 states, no discovery; each growth recaptures
             the chunk's graph), PackedLinearEquation(2, 10, 14) (its
             ``solvable`` witness replays), Increment(7) and Increment(16)
             with and without symmetry reduction (the ``fin``
             counterexample replays, as long as the JAX package's), and
             through the one-rank sharded engine IncrementLock(8)
             (438,401), PackedLinearEquation(2, 4, 7), Increment(7) and
             Increment(7) under symmetry. Before them (phase
             ``kernels``) K1 of each new instantiation, with K2/K3 and
             K5, at a real mid-search step (IncrementLock(9) and
             Increment(16) with and without symmetry at 12,288 and 256
             rows, PackedLinearEquation at 256: its frontier never holds
             more), held to its plain version lane for lane, and K7 after
             the 12,288-row steps of IncrementLock(9) and Increment(16)
             (14- and 20-word queue rows).

8. paxos   — PackedPaxos on the card: its kernels right after the
             build (phase ``kernels`` with ``model: PackedPaxos``), the
             runs last (phase ``paxos``). K1's paxos instantiation
             (``csrc/paxos.cuh``, the wide K1 over ``ops/_cuda.py``
             ``wide_geometry``, its registers and no spill) with K2/K3
             at a mid-search 8,192-row step of
             PackedPaxos(3), lane for lane; K8 (``history_kernel``) over
             the rows the next step appends, from the search's own
             table, from an empty one and keyed by the actor words
             (fresh keys, repeated within the step), and in index mode
             (the re-seed: no append), and K9 (``hpull_kernel``) at a
             256-row window, bit for bit; K1's and K8's lines carry
             the parent tree's device ms as copied from another run
             (``PARENT_MS``, ``parent_device_ms_copied``) beside their
             own; PackedPaxos(2) in full
             with ``race=False`` from the
             default ``hcap`` and from ``hcap=4`` (history growth and the
             rescan): 16,668 states, the JAX package's digest
             (``PIN_PAXOS2``), ``linearizable`` holds over its 5 distinct
             histories, ``value chosen`` replays; the BASELINE workload
             (7 distinct histories, as the JAX package's; PackedPaxos(3),
             ``capacity=1<<21``, ``race=False``,
             ``target_state_count(500_000)``) with its rates, walls, host
             evaluation, distinct histories, memory and (a profiled
             repeat) the device's busy share; and PackedPaxos(3) through
             the default raced entry point.
9. registers — the register family on the card: its kernels right
             after the Paxos kernels (phase ``kernels`` with ``model`` and
             ``instantiation``), the runs after phase ``paxos`` (phase
             ``registers``). K1's ``abd_ordered`` (``csrc/abd.cuh``
             ``AbdOrderedModel``, the edit K1) at mid-search steps of
             PackedAbd(2, ordered=True) (108 words, the BASELINE's
             "linearizable-register check 2 ordered"), PackedAbd(3,
             server_count=2, ordered=True, channel_depth=8) (260, bench.py
             tpu_abd3) and PackedAbd(2, server_count=3, ordered=True,
             channel_depth=8) (331, tpu_abd2), ``abd`` (PackedAbd(2),
             unordered: the group K1) and ``single_copy``
             (PackedSingleCopy(3), at 9,954 rows with ~588 pending and
             at 512 all pending, and PackedSingleCopy(4) at 9,475 all
             pending: the group K1), each at a step size its run
             launches (``REGISTER_STEPS``), gated as the search launches
             it (``gated_step``), under K1's lane rule (the children
             and their fingerprints held on the lanes of non-empty
             channels, or below the quiet lane; the group K1 steps only
             the pending rows: there only, and the property bits on
             them; cvalid and terminal everywhere: ``active_rule``),
             with K2/K3, its
             launch, registers and no spill; at 331 words K7 after a real gated
             step, K8 and K9, at 260 words K7 (its 128-lane tile for rows
             wider than its 256-thread block). The K1 checks' plain
             versions run after
             the runs (at tpu_abd2's 1,055-row and single-copy's
             9,954- and 9,475-row steps they take tens of seconds, and later traces
             would lose their device time). The runs, with
             ``race=False``:
             PackedAbd(2, ordered=True) (564, ``PIN_ABD2_ORDERED``),
             abd3 in full (36,213 / 63,053, ``PIN_ABD3``, with a profiled
             repeat), PackedAbd(2) (544) and PackedSingleCopy(3) (4,243,
             the BASELINE's "single-copy-register check 3"), each with
             the JAX package's digest, ``linearizable`` holding and
             ``value chosen`` replaying; PackedSingleCopy(4, 2) (bench.py
             race_single_copy) raced as by default and with
             ``race=False``: ``linearizable`` discovered, its witness
             replaying to a history with no serialization; tpu_abd2
             bounded at ``ABD2_TARGET`` generated states, as bench.py
             does (its full space is far larger).
10. crash  — crash/restart fault injection on the card: its kernels right
             after the register kernels (phase ``kernels`` with ``model``
             and ``instantiation``), the runs after phase ``registers``
             (phase ``crash``). K1's ``write_once`` (``csrc/
             write_once.cuh``, the group K1 with crash lanes) at
             PackedWriteOnce(7, net_capacity=16).crash_restart(2,
             actors=[0]) (96 words, 18 lanes) at the 256-row step its
             run launches (~200 pending) and at 1,024 rows all pending,
             and ``paxos_crash`` (``csrc/paxos.cuh`` ``PaxosCrashModel``,
             the wide K1 with crash lanes) at a mid-search 8,192-row step
             of PackedPaxos(3).crash_restart(1, actors=[0, 1, 2]) (97
             words, 22 lanes), each gated, under the active-lane rule
             (``crash_active``: bit for bit on the active lanes, cvalid
             everywhere), with K2/K3, registers, spills, and the
             registers of the parent's K1 instantiations beside them;
             the runs: PackedWriteOnce(2) durable (51, ``PIN_WO2``),
             ``linearizable`` holding, ``value chosen`` found;
             PackedWriteOnce(2, durable=False) raced and with
             ``race=False``: ``linearizable`` discovered, its witness
             replaying through a ``Crash`` to a history with no
             serialization; PackedWriteOnce(7, net_capacity=16) under
             ``crash_restart(2)`` (8,965, ``PIN_WO7``); PackedPaxos(1)
             under ``crash_restart(1, actors=[0, 1, 2])`` (7,155,
             ``PIN_PAXOS1_CRASH``); PackedPaxos(3) under the same
             crashes at the BASELINE size (``capacity=1<<21``,
             ``race=False``, bounded at ``PAXOS3_TARGET``: its full space
             is too large for the JAX package's host BFS), with a
             profiled repeat.
11. lossy  — the lossy drop lanes, the duplicating network and the
             device timers on the card: its kernels right after the
             crash kernels (phase ``kernels`` with ``model`` and
             ``instantiation``), the runs after phase ``crash`` (phase
             ``lossy``). K1's ``paxos_lossy`` (``csrc/paxos.cuh``
             ``PaxosLossyModel``, the wide K1 with drop lanes) at a
             mid-search 8,192-row step of PackedPaxos(2).lossy_network(
             True) (92 words, 32 lanes) and ``ping_pong``
             (``csrc/ping_pong.cuh`` ``PingPongLossyModel``, the wide K1
             with drop lanes) at an 8,192-row frontier of
             PackedPingPong(7, lossy=True, duplicating=True) (51 words,
             32 lanes) and at the widest level (2 rows) of
             PackedPingPong(7, lossy=True, duplicating=False), each
             under its active-lane rule (``lossy_active``),
             ``timer_count`` (``csrc/timer_count.cuh``, K1's timer path,
             ``step_common.cuh`` ``TimerRow``) at an 8,192-row frontier
             of PackedTimerCount(8, 4) (12 words, 9 lanes) and at its
             run's 256-row small step, held on its active lanes
             (``timer_active``: the Timeout lanes whose timer bit is
             set), and the lossless ``ping_pong`` (``PingPongModel``, the
             narrow K1) at the 1-row levels of PackedPingPong(7,
             lossy=False) on both networks, held on every lane (its bound
             counting the lanes ``lossy_active`` names, the children the
             step needs), each gated, with K2/K3,
             registers and spills, and the registers of every
             earlier K1 instantiation beside them (``REGISTERS``: held
             unchanged, no spill); the runs, each ``race=False``:
             lossy PackedPaxos(2) (954,508, ``PIN_PAXOS2_LOSSY``:
             ``linearizable`` holding through K8, ``value chosen``
             replayed); PackedPingPong(5) and (7), lossy and duplicating
             (``PIN_PING5``, ``PIN_PING7``: "delta within 1" holding,
             "must reach max" found with a witness that replays through a
             ``Drop``, the canonical ``[Drop(Envelope(Id(0), Id(1),
             Ping(0)))]`` accepted by ``assert_discovery``);
             PackedPingPong(5) lossless and non-duplicating
             (``PIN_PING5_LOSSLESS``: 11 states);
             PackedTimerCount(8, 4) (``PIN_TIMER8``: "bounded" holding,
             "all max" found).
12. staged — the staged step (``gpu_options(fused=False)``,
             ``sound_eventually()``; ``ops/staged.py``): its kernels
             right after the lossy kernels (phase ``kernels`` with
             ``staged``), the runs after phase ``lossy`` (phase
             ``staged``). K1 alone (``srt_expand_<model>``) held to
             ``expand_frontier``, then KS1 (``stage_kernel``), KS2
             (``predup_kernel``) and KS3 (``staged_append_kernel``,
             after K4 inserted KS2's slots), each bit for bit against its
             plain version on the card kernel's own inputs, at a
             mid-search 8,192-row PackedPaxos(3) step and its 256-row
             small step, and under sound at PackedPingPong(7, lossy,
             duplicating)'s 7,710-row step and 256-row small step from a
             frontier seeded with every eventually bit pending, each
             timed beside its plain version, its bound and, for KS1,
             ``torch.nonzero``; the chunk's start is ``chunk_begin``
             (phase ``chunk``), its gate's staged terms held in phase
             ``kernels``. The
             runs, each ``race=False`` with every launch count set to 0:
             the BASELINE workload with ``fused=False`` (the JAX
             package's staged counts and digest, ``PIN_PAXOS3_STAGED``;
             K1, KS1-KS3, K4 and K8 launched, no K2/K3/K7; profiled);
             TwoPhaseSys(7) with ``fused=False`` and its candidate
             buffers too small (``kraw``/``kmax`` of 4,096: rebuilt on
             kovf; 296,448, the fused
             digest); PackedPingPong(7, lossy, duplicating) under
             ``sound_eventually()`` (``PIN_PING7_SOUND``: 69,629 nodes,
             its three discoveries replayed, cross edges logged, the
             lasso swept), profiled beside its plain fused run.

Then a ``kernels`` line (the contract's per-kernel record), the card's name
and power limit from ``nvidia-smi``, and as the last line
``{"ok": true, "device": {...}}``. Any failed check or exception exits
non-zero before that line. It exits 2 without a CUDA device or outside a
checkout of the repository.

    python3 chip_smoke.py --ranks 4

runs the sharded engine across that many cards instead, one process per
card on one NCCL group: 2pc n=7 with the bucketed exchange and with the
ring, 2pc n=16 under complete symmetry with the bucketed exchange, and
IncrementLock(8), each held to the same counts, digest and witnesses on
every rank (phase ``e2e_ranks``). It needs that many cards.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import subprocess
import sys
import threading
import time

#: TwoPhaseSys(7) full enumeration: unique states (the oracle the JAX
#: package's engines pin) and generated transitions, from the JAX
#: package's fused device engine on the CPU:
#:   TwoPhaseSys(7).checker().tpu_options(race=False, fused=True,
#:       mode="device").spawn_tpu().join().state_count()
UNIQUE_2PC7 = 296_448
GENERATED_2PC7 = 2_744_706
#: sha256 of the sorted visited fingerprints as little-endian uint64.
#: tests/test_torch_engine.py::test_2pc7_plain_path_digest (slow) holds
#: both the port's plain path and that JAX run to all three constants
DIGEST_2PC7 = ("68bd762484aa0d7b8f3efb611f754ba2"
               "908888832a15e5df5b2c5656db338113")

#: TwoPhaseSys(16, complete_symmetry=True) under symmetry reduction
#: (``symmetry_fn(model.representative)``): the 21,335 RM-permutation
#: orbits of 2pc with 16 RMs, state_count() (the init state and 450,858
#: generated transitions) and the sha256 of the sorted canonical keys,
#: from the JAX package's fused device engine on the CPU (Pallas in
#: interpret mode, fmax=256; its staged engine gives the same), with the
#: model's property patterns made uint32 constants: at n=16 the JAX
#: package's Python-int patterns overflow JAX's scalar parsing.
#: tests/test_torch_symmetry.py::test_complete_symmetry_pins holds that
#: JAX run and the port's plain path to all three. The orbit-invariant
#: representative makes them the same for every engine and step size.
UNIQUE_2PC16_SYM = 21_335
GENERATED_2PC16_SYM = 450_859
DIGEST_2PC16_SYM = ("e8cd19b6cdc0755720449d43e37723c6"
                    "4178e70a74bc6c5bb313a4882505089f")
#: the same for TwoPhaseSys(7, complete_symmetry=True): 920 orbits
UNIQUE_2PC7_SYM = 920
GENERATED_2PC7_SYM = 8_410
DIGEST_2PC7_SYM = ("4302d7490af6f8bfb60b2c6197f14954"
                   "654cee87bde6e7dbcd38fd5d2d05b43c")
#: the sound range of the reference representative at n=7: at least
#: one key per orbit, at most the distinct representative keys over all
#: 296,448 states (phase ``orbits_2pc7`` recounts both on the card)
REF_KEYS_2PC7 = 9_840
#: TwoPhaseSys(16) under the reference representative on the card:
#: reduced states, state_count() and the sha256 of the sorted canonical
#: keys. The count depends on the engine's winner rule (ROADMAP C3): the
#: card inserts the lowest valid lane of each fresh key, which fixes it
#: at every step size (tools/torch_symmetry_counts.py on an H100 at
#: 12,288, 4,096, 1,024 and 256 rows per step), where the CPU path, with
#: the JAX package's winner rule, reaches other counts.
UNIQUE_2PC16_REF = 1_309_367
GENERATED_2PC16_REF = 23_296_759
DIGEST_2PC16_REF = ("6284d610fdbea7532587dc7e1c5b8ad8"
                    "2fa2963c47f0b7651e44f9960eeaffc3")

#: IncrementLock(n) full enumerations (both properties hold, so no run
#: stops early): unique states, state_count() and the sha256 of the
#: sorted fingerprints, from the JAX package's staged device engine on
#: the CPU:
#:   IncrementLock(n).checker().tpu_options(race=False, fused=False,
#:       mode="device").spawn_tpu().join()
#: A full enumeration's counts and set do not depend on the engine; the
#: state graph is a tree, so state_count() equals the unique count.
#: tests/test_torch_more_models.py::test_increment_lock_pins (slow) holds
#: that run, and at n=8 the port's plain path, to both.
PIN_LOCK9 = (3_945_637, 3_945_637,
             "6fbe2180605bddc081d764732c4c2817"
             "d7b550fbe76c14fcf1ffa10df3431713")
PIN_LOCK8 = (438_401, 438_401,
             "801d745277f0952a55f29a14065bc786"
             "a7199cac78aaf7a82021d8a1ae56d138")
#: the actions in the JAX package's witness of Increment(n)'s falsified
#: ``fin`` at n = 7 and 16, with and without symmetry reduction (two
#: reads, then both writes): ``len(ck.discovery("fin"))`` of
#:   Increment(n).checker()[.symmetry_fn(model.representative)]
#:       .tpu_options(race=False, fused=True, mode="device")
#:       .spawn_tpu().join()
#: A BFS finds a shortest witness whatever its engine's order, so the
#: card's has this length too.
FIN_LEN = 4
#: the same for PackedLinearEquation(2, 10, 14)'s ``solvable`` (the JAX
#: run's witness ends at (x, y) = (2, 1))
SOLVABLE_LEN = 3

#: PackedPaxos(2) full enumeration (the north-star oracle, the Rust
#: crate's paxos.rs:291): unique states, state_count() and the sha256 of
#: the sorted fingerprints, from the JAX package's host BFS on the CPU:
#:   PackedPaxos(2).checker().spawn_bfs().join()
#: tests/test_torch_paxos.py::test_paxos_pins_are_the_jax_packages holds
#: the JAX package's host BFS and staged device engine to all three (a
#: full enumeration's set does not depend on the engine), and the
#: port's plain path is held to them beside it.
PIN_PAXOS2 = (16_668, 32_971,
              "184fdb02ebca156876cc206a2c39ce2c"
              "c11186fb868ec1b3c6b1fdf63b516971")
#: the distinct histories (host_property_key values) of PackedPaxos(2)'s
#: full space, and of PackedPaxos(3) at the BASELINE budget: the JAX
#: package's staged engine evaluates this many (its memo's size; the
#: same test). Every one is reached within 10 BFS levels, far inside
#: the budget, so the pin does not depend on the engine's order.
HISTORIES_PAXOS2 = 5
HISTORIES_PAXOS3 = 7
#: the actions of the shortest ``value chosen`` witness of PackedPaxos(2)
#: (a BFS finds a shortest one whatever its order)
CHOSEN_LEN_PAXOS2 = 8
#: the BASELINE workload (BASELINE.json "states/sec explored (paxos check
#: 3)", bench.py's device run): PackedPaxos(3), capacity 2**21,
#: race=False, target_state_count(500_000) generated transitions
PAXOS3_TARGET = 500_000

#: The register family's full enumerations: unique states, state_count()
#: and the sha256 of the sorted fingerprints, from the JAX package's host
#: BFS on the CPU, e.g. for ``abd3``:
#:   PackedAbd(3, server_count=2, ordered=True, channel_depth=8)
#:       .checker().spawn_bfs().join()
#: (the BASELINE's "linearizable-register check 2 ordered" is
#: PackedAbd(2, ordered=True); bench.py's tpu_abd3 the one above).
#: tests/test_torch_registers.py::test_register_pins_are_the_jax_packages
#: holds the JAX package's host BFS to each, and the port's plain path
#: beside it. In each ``linearizable`` holds and ``value chosen`` is found.
PIN_ABD2_ORDERED = (564, 813,
                    "ee7dfeba8696ab0e7dac96583d234fbb"
                    "542c6d286be8d42653c644f87f84fe89")
PIN_ABD3 = (36_213, 63_053,
            "3b3f0567885b11e3c52fc2fb593e40c2"
            "7c252198aa5def2add3df754b329ddae")
PIN_ABD2 = (544, 875,
            "74b6c987508fdbd9cd9cba2f48e0c02a"
            "4623bc189fd1e6312a2295b52b6cf57f")
PIN_SC3 = (4_243, 6_778,
           "e6f3f5ee7973c27783c1c04047915d50"
           "4cbb55032810666063cdcdc30a01f323")
#: Crash/restart fault injection (phase ``crash``): full enumerations,
#: unique states, state_count() and the sha256 of the sorted
#: fingerprints, from the JAX package's host BFS on the CPU:
#:   PackedWriteOnce(2, durable=True).crash_restart(1, actors=[0])
#:       .checker().spawn_bfs().join()
#: (``linearizable`` holds, ``value chosen`` is found);
#: tests/test_torch_crash_restart.py holds the port's plain path to the
#: JAX package's host BFS at this model and to the pin at Paxos(1)
PIN_WO2 = (51, 87,
           "605985bd5b408583268f0b7dd154b0a6"
           "3832b58f0d31ed96c7f89a62b5a1c2c7")
#:   PackedWriteOnce(7, durable=True, net_capacity=16).crash_restart(
#:       2, actors=[0]).checker().spawn_bfs().join()
PIN_WO7 = (8_965, 29_146,
           "26762366cb6780b3fc6dadafef35b80c"
           "274a94c0729903957650b8d7ce7cb8a4")
#:   PackedPaxos(1).crash_restart(1, actors=[0, 1, 2]).checker()
#:       .spawn_bfs().join()
PIN_PAXOS1_CRASH = (7_155, 24_049,
                    "a9224227a226031d2f4f2de3c2401a86"
                    "4dcb761fb655fd229ab03fbb45b0bed3")
#: The lossy network, the duplicating network and the device timers
#: (phase ``lossy``): full enumerations from the JAX package's device
#: engine on the CPU, ``model.checker().tpu_options(capacity=1 << 22,
#: race=False).spawn_tpu().join()``:
#:   PackedPaxos(2).lossy_network(True) (92 words, 32 lanes;
#:       ``linearizable`` holds, ``value chosen`` is found, 8 states)
PIN_PAXOS2_LOSSY = (954_508, 5_060_177,
                    "7e116ed5541dd3c1fe19959bc1c78979"
                    "293813429d83672c30b03c641cc33057")
#:   PackedPaxos(1).lossy_network(True)
PIN_PAXOS1_LOSSY = (2_378, 8_197,
                    "19c4e123f9b145ff44ac9a828f1160be"
                    "90beb24a48dda1e72aab5e9791bb54ef")
#:   PackedPingPong(5, lossy=True, duplicating=True) (51 words, 32 lanes)
PIN_PING5 = (4_094, 21_505,
             "bbe0d91b137fa4dbb62d765dabbd48b4"
             "232775ed819c5efb7d1a1376cbe558a7")
#:   PackedPingPong(7, lossy=True, duplicating=True) (16 envelopes: the
#:       most E = 16 holds)
PIN_PING7 = (65_534, 475_137,
             "97e53213de167f83c0716e62c048ae7f"
             "f30f0d248586cd545bd48de5020308df")
#:   PackedPingPong(7, lossy=True, duplicating=True) under
#:       sound_eventually(): 69,629 (state, pending eventually-bits)
#:       nodes over the same 65,534 states (PIN_PING7's digest), from the
#:       JAX package's device engine on the CPU,
#:       ``.checker().sound_eventually().tpu_options(race=False, kraw=
#:       123360, kmax=123360)``: its staged step's default sizes
PIN_PING7_SOUND = (69_629, 511_986, PIN_PING7[2])
PING7_SOUND_FOUND = ("can reach max", "must exceed max", "must reach max")
#:   PackedPingPong(5, lossy=False, duplicating=False)
PIN_PING5_LOSSLESS = (11, 11,
                      "07737048bb05540f514330e8bf91d6cb"
                      "ab6ecd62e0355beb61373f13eeaa824d")
#:   PackedTimerCount(3, 2)
PIN_TIMER3 = (27, 55,
              "07eb4129d42b12ebb7385a09070cba0d"
              "4953f9585596a8a4f8b15504b01c7e14")
#:   PackedTimerCount(8, 4) (12 words, 9 lanes)
PIN_TIMER8 = (390_625, 2_500_001,
              "3dc5f3f241d3c926de2a723af1bb73dc"
              "27be4acc200d40dad456e436179bdc83")

#: the BASELINE workload on the staged step (phase ``staged``): the JAX
#: package's staged device engine on the CPU, ``PackedPaxos(3).checker()
#: .tpu_options(race=False, fused=False, mode="device", capacity=1 << 21,
#: kraw=40960, kmax=20480).target_state_count(PAXOS3_TARGET)`` (its
#: default sizes at 8,192-row steps, set so that no earlier run's size
#: memo moves them)
PIN_PAXOS3_STAGED = (531_488, 1_002_122,
                     "a207fd11121dbed1aa1f0a4264fe4497"
                     "bb439e608aaa0479cf99e7dc4ec75af0")
#: TwoPhaseSys(7)'s staged run with candidate buffers below its steps'
#: lanes (~20,000 valid at 12,288 rows): its first large step overflows
#: them, commits nothing and the chunk is rebuilt (``handle_kovf``)
STAGED_2PC7_KOVF = {"kraw": 4096, "kmax": 4096}

#: bench.py's widest register row: tpu_abd2, PackedAbd(2,
#: server_count=3, ordered=True, channel_depth=8), 331 words, bounded
#: there at this many generated states
ABD2_TARGET = 100_000

#: the parent tree's device ms (``torch.profiler``) of the two kernels
#: this tree redesigned, at this script's shapes: K1's paxos
#: instantiation at the mid-search 8,192-row PackedPaxos(3) step and K8
#: over the 15,085 rows of the next one (all keys known), copied from a
#: run of ``tools/torch_paxos_kernels.py --old`` on an H100 80GB HBM3 at
#: 700 W, both trees in turns in one call (the parent's two turns). The
#: phase lines carry them as ``parent_device_ms_copied``; the
#: ``kernels`` line, which holds this run's measurements, does not.
PARENT_MS = {"expand_kernel": (0.251268, 0.248941),
             "history": (0.077313, 0.077319)}

#: HBM bandwidth of an H100 SXM (bytes/s) and its CUDA-core fp32 rate
#: (operations/s): NVIDIA's published peaks at 700 W. The steps do 32-bit
#: integer work, for which no peak is published beside these; it is
#: counted at the fp32 CUDA-core rate.
HBM_BYTES_S = 3.35e12
CORE_OPS_S = 67e12
#: threads per block of K3 and of K5's commit (``kCommitThreads`` of
#: stateright_tpu_torch/csrc/step_common.cuh)
COMMIT_THREADS = 64


def emit(**fields) -> None:
    print(json.dumps(fields), flush=True)


def run(cmd) -> str:
    return subprocess.run(cmd, capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip()


def zero_launches() -> None:
    """Set every kernel's launch count to 0, once no retired racer (a
    raced run's loser, which may still be draining a chunk) is alive to
    add to them."""
    from stateright_tpu_torch.checker import race
    from stateright_tpu_torch.ops import _cuda

    if not race.join_losers():
        raise AssertionError("a raced run's loser is still running")
    for key in _cuda.LAUNCHES:
        _cuda.LAUNCHES[key] = 0


def fp_digest(fps) -> str:
    import numpy as np
    arr = np.array(sorted(fps), dtype=np.uint64)
    return hashlib.sha256(arr.astype("<u8").tobytes()).hexdigest()


#: this port's kernels, by the name each has in the profiler; longer
#: names first, so a name that contains another is matched as itself
_OURS = ("dedup_claim_kernel", "dedup_commit_kernel", "flat_insert_kernel",
         "staged_append_kernel", "stage_kernel",
         "predup_kernel", "expand_kernel", "claim_kernel", "commit_kernel",
         "append_kernel", "chunk_begin_kernel", "history_kernel",
         "hpull_kernel")


def kernel_name(symbol: str):
    name = next((k for k in _OURS if k in symbol), None)
    if name == "expand_kernel" and ("true>" in symbol or "Lb1E" in symbol):
        return "expand_kernel_sym"  # the symmetric instantiation of K1
    return name


def kernel_instance(symbol: str):
    """The kernel a symbol names, K1 with its model's struct:
    ``expand_kernel[TwoPcModel]``, ``expand_kernel_sym[IncrementModel]``,
    K7 with its lanes a thread and threads: ``append_kernel[1x128]``
    (mangled or demangled names)."""
    name = kernel_name(symbol)
    if name == "append_kernel":  # K7 by lanes a thread and threads
        m = re.search(r"append_kernelILi(\d+)ELi(\d+)E", symbol) \
            or re.search(r"append_kernel<(\d+), (\d+)>", symbol)
        return f"{name}[{m.group(1)}x{m.group(2)}]" if m else name
    if name not in ("expand_kernel", "expand_kernel_sym"):
        return name
    m = re.search(r"expand_kernelI(\d+)", symbol)
    if m:
        model = symbol[m.end():m.end() + int(m.group(1))]
    else:
        m = re.search(r"expand_kernel<(\w+)", symbol)
        model = m.group(1) if m else "?"
    return f"{name}[{model}]"


def ptxas_usage(log: str) -> dict:
    """Registers, shared memory and spills per kernel (each
    instantiation of K1 by its model) from ``-Xptxas -v`` of one
    library."""
    out, name, spill = {}, None, {}
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line) \
            or re.search(r"Function properties for (\w+)", line)
        if m:
            name = m.group(1)
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and name:
            spill[name] = [int(g) for g in m.groups()]
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            smem = re.search(r"(\d+) bytes smem", line)
            frame, stores, loads = spill.get(name, (0, 0, 0))
            out[kernel_instance(name) or name] = {
                "registers": int(m.group(1)),
                "smem_bytes": int(smem.group(1)) if smem else 0,
                "stack_bytes": frame, "spill_store_bytes": stores,
                "spill_load_bytes": loads}
    return out


def kernel_usage(library: str, kernel: str) -> dict:
    """Registers, shared memory and spills of ``kernel`` (a
    :func:`kernel_instance` name) in ``library``'s build, from ptxas."""
    from stateright_tpu_torch.ops import _cuda

    return ptxas_usage(_cuda.build()["logs"].get(library, "")).get(kernel)


def cuda_ms(fn, reps: int, before=None) -> float:
    """Mean device milliseconds of ``fn()`` over ``reps`` launches after
    one warm-up; ``before()`` (untimed) restores its inputs."""
    import torch
    if before:
        before()
    fn()
    total = 0.0
    for _ in range(reps):
        if before:
            before()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def device_times(fn, host_top: int = 0, before=None) -> dict:
    """Device time of one call of ``fn`` from ``torch.profiler``, split
    into this port's kernels (by name), torch's kernels, and copies and
    memsets, in milliseconds; ``None`` values when the trace holds no
    device time. ``before()`` (outside the trace) restores ``fn``'s
    inputs before each try. ``host_top`` > 0 adds the host operations
    with the most self CPU time (name, ms, calls). ``cuda_api``: the
    CUDA runtime calls of the host (``cudaLaunchKernel``,
    ``cudaGraphLaunch``, ...) as [calls, host ms]; when ``fn`` returns a
    checker, ``loop_s`` is its profile's and ``busy`` the traced device
    time over it."""
    import gc

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    # a trace now and then holds no device time, or (seen once, in a run
    # whose first allocation took 62 ms inside the trace) none of a
    # chunk's graph replays: up to three tries. Earlier phases' checkers
    # are collected first, so the run reuses their cached memory
    for _attempt in range(3):
        gc.collect()
        if before:
            before()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            result = fn()
            torch.cuda.synchronize()
        ours = {k: 0.0 for k in _OURS + ("expand_kernel_sym",)}
        calls = dict.fromkeys(ours, 0)
        torch_ms = copy_ms = 0.0
        seen = False
        for e in prof.key_averages():
            if e.device_type != DeviceType.CUDA:
                continue
            us = getattr(e, "self_device_time_total", None)
            if us is None:
                us = e.self_cuda_time_total
            seen = seen or us > 0
            name = kernel_name(e.key)
            if name:
                ours[name] += us / 1e3
                calls[name] += e.count
            elif "memcpy" in e.key.lower() or "memset" in e.key.lower():
                copy_ms += us / 1e3
            else:
                torch_ms += us / 1e3
        # a chunk's run replays its graph, each replay K7 once: a trace
        # with fewer K7 records than replays lost the graph's kernels;
        # a step's K2 never runs without its K1: a trace with K2 and no
        # K1 lost K1's record
        replays = (result.profile().get("graph_launches", 0)
                   if hasattr(result, "profile") else 0)
        k1_lost = calls["claim_kernel"] > 0 and not (
            calls["expand_kernel"] or calls["expand_kernel_sym"])
        appends = calls["append_kernel"] + calls["staged_append_kernel"]
        if seen and appends >= replays and not k1_lost:
            break
    out = {"ours_ms": None, "torch_ms": None, "copy_ms": None,
           "by_kernel_ms": None, "by_kernel_calls": None}
    if seen:
        out = {"ours_ms": sum(ours.values()), "torch_ms": torch_ms,
               "copy_ms": copy_ms, "by_kernel_ms": ours,
               "by_kernel_calls": calls}
    if host_top:
        cpu = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CPU]
        cpu.sort(key=lambda e: e.self_cpu_time_total, reverse=True)
        out["host_top"] = [(e.key, e.self_cpu_time_total / 1e3, e.count)
                           for e in cpu[:host_top]]
    out["cuda_api"] = {e.key: [e.count, e.self_cpu_time_total / 1e3]
                       for e in prof.key_averages()
                       if e.device_type == DeviceType.CPU
                       and e.key.startswith("cuda")}
    prof = result.profile() if hasattr(result, "profile") else {}
    for key in ("graph_launches", "captures"):
        if key in prof:
            out[key] = prof[key]
    loop_s = prof.get("loop_s")
    if loop_s:
        out["loop_s"] = loop_s
        if seen:
            out["busy"] = (out["ours_ms"] + torch_ms + copy_ms) / (
                loop_s * 1e3)
    return out


def mid_search_carry(model, device, symmetry: bool = False,
                     rows: int = 12288, pending: int = None,
                     past_discoveries: bool = False, ebits: int = 0):
    """A real mid-search state of ``model`` (2pc n=7, or n=16 under
    symmetry reduction; the other models' at their kernels' checks): the
    port's own loop run at ``rows`` rows per step until at least
    ``pending`` (default ``rows``) rows are pending. A model whose every
    property is soon discovered (Increment's ``fin``) would stop there:
    ``past_discoveries`` clears the discovery flags after each step, so
    the search goes on to a wide frontier. ``ebits``: the init state's
    pending eventually-bits (0: none)."""
    import numpy as np
    import torch

    from stateright_tpu_torch.checker.device_loop import (B_DISC, E_ITERS,
                                                          run_chunk,
                                                          seed_carry)
    from stateright_tpu_torch.ops.hashtable import table_insert
    from stateright_tpu_torch.ops.words import from_numpy_u32

    init = model.init_states()[0]
    fp = model.fingerprint(model.representative(init) if symmetry
                           else init)
    carry = seed_carry(model, 1 << 21, 1 << 20, [model.encode(init)], ebits,
                       [fp], 1 << 15, device, symmetry=symmetry)
    table_insert(carry.table,
                 from_numpy_u32(np.array([fp >> 32], np.uint32), device),
                 from_numpy_u32(np.array([fp & 0xFFFFFFFF], np.uint32),
                                device),
                 torch.ones((1,), dtype=torch.bool, device=device),
                 mask=False)
    # one iteration per chunk: the small step while at most FMAX_SMALL
    # rows are pending, else one of ``rows`` rows (the loop condition
    # also keeps the queue's margin)
    want = rows if pending is None else pending
    while carry.q_tail - carry.q_head < want:
        c = run_chunk(model, carry, fmax=rows, steps=1)
        if not c[carry.layout.ext + E_ITERS]:
            raise RuntimeError(f"the search ended before a {want}-row "
                               "frontier")
        if past_discoveries:
            carry.ctr[B_DISC:B_DISC + carry.layout.P] = 0
    return carry


def lowest_lane_wins(out, among=None) -> bool:
    """The kernel's winner rule: each inserted lane is the lowest lane of
    ``among`` (default: the lanes that carried their key to the table,
    ``dvalid``) carrying its key."""
    from stateright_tpu_torch.ops.words import pack64

    return lowest_valid_lane_wins(pack64(out.chi, out.clo),
                                  out.dvalid if among is None else among,
                                  out.inserted)


def lowest_valid_lane_wins(keys, valid, inserted) -> bool:
    """Each ``inserted`` lane is the lowest ``valid`` lane carrying its
    key (the owner-word rule of the step and the flat insert)."""
    import torch

    lanes = torch.arange(keys.shape[0], device=keys.device)
    uniq, inv = torch.unique(keys[valid], return_inverse=True)
    first = torch.full((uniq.shape[0],), keys.shape[0], dtype=torch.int64,
                       device=keys.device)
    first.scatter_reduce_(0, inv, lanes[valid], reduce="amin")
    won = first[torch.searchsorted(uniq, keys[inserted])]
    return bool((won == lanes[inserted]).all())


def bound(nbytes: int, ops: int) -> dict:
    """The least time the card could take for ``nbytes`` of device
    memory traffic and ``ops`` integer operations, and which bounds it."""
    return {"bytes": nbytes, "ops": ops,
            "bound_ms": max(nbytes / HBM_BYTES_S, ops / CORE_OPS_S) * 1e3,
            "bound_by": ("bytes" if nbytes / HBM_BYTES_S
                         >= ops / CORE_OPS_S else "operations")}


def kernel_parts(model, f: int, symmetry: bool, cc: int, by_kernel,
                 counts=None, noprobe=None, written=None,
                 stepped=None) -> dict:
    """Per kernel of one step over ``f`` rows: its device ms (from
    ``by_kernel``, a profiled call), its own bound and its launch
    geometry. K1 (expand) always; with ``counts = (valid lanes, tile
    winners, tile winners that reached the table, inserted lanes)`` also
    K2 (claim) and K3 (commit) of the single-chip step; with ``noprobe =
    (valid lanes, tile winners, tile winners the ring held, claims)``
    K5's claim and commit of the probe-free step. Each kernel counts its
    own inputs read once and outputs written once, so the parts' bounds
    add up to more than the step's (K1's outputs are K2's inputs).
    ``written``: the lanes whose children K1 writes (an edit model's
    active lanes; default every lane); ``stepped``: the rows K1 reads
    and writes keys and bits for (a group model's pending rows; default
    every row; every lane's cvalid and every row's terminal are written
    either way)."""
    import torch

    from stateright_tpu_torch.ops import _cuda

    w = model.packed_width
    a = model.max_actions
    lanes = f * a
    if written is None:
        written = lanes
    rows = f if stepped is None else stepped
    pcols = max(len(model.properties()), 1)
    by_kernel = by_kernel or {}
    tiles = _cuda.tile_geometry(
        f, a, _cuda.sm_count(torch.cuda.current_device()))
    geometry = tiles._asdict()
    # K3 and K5's commit: one block per tile, COMMIT_THREADS threads
    commit_geometry = {"threads": COMMIT_THREADS, "blocks": tiles.blocks}
    k1 = "expand_kernel_sym" if symmetry else "expand_kernel"
    parts = {k1: {
        "device_ms": by_kernel.get(k1),
        **bound(rows * (4 * w + 4 + 1)             # frontier, ebits, fvalid
                + rows * (pcols + 4) + f           # pbits, ebits, terminal
                + written * 4 * w                  # flat
                + rows * a * 8 + lanes             # chi/clo, cvalid
                + rows * a * (8 if symmetry else 0)  # ohi/olo
                + cc * 8,                          # the ring arena reset
                written * step_ops(model, symmetry)),
        "geometry": geometry}}
    if counts is not None:
        valid, winners, table, ins = counts
        parts["claim_kernel"] = {
            "device_ms": by_kernel.get("claim_kernel"),
            # cvalid, chi/clo, dvalid, inserted per lane; the ring per
            # tile winner; a bucket and the owner word per tile winner
            # that reaches the table; the claim, the ring arena and the
            # 8-byte claims-list entry per inserted lane; a count per
            # tile; 16 operations per valid lane for the tile dedup and
            # 12 per table probe
            **bound(lanes * 11 + (winners * 8 if cc else 0)
                    + table * (32 + 8) + ins * (8 + 8 + 8)
                    + tiles.blocks * 4,
                    valid * 16 + table * 12),
            "geometry": geometry}
        parts["commit_kernel"] = {
            "device_ms": by_kernel.get("commit_kernel"),
            # a count per tile; per claim its entry (table slot and ring
            # slot), owner word and inserted byte, and the ring arena
            # slot and the ring write
            **bound(tiles.blocks * 4
                    + ins * (8 + 8 + 1 + ((8 + 8) if cc else 0)),
                    ins * 8),
            "geometry": commit_geometry}
    if noprobe is not None:
        valid, winners, held, claims = noprobe
        parts["dedup_claim_kernel"] = {
            "device_ms": by_kernel.get("dedup_claim_kernel"),
            # cvalid, chi/clo, dvalid per lane; the ring per tile winner;
            # the arena key and owner word per winner the ring did not
            # hold; the 8-byte claims-list entry per claim; a count per
            # tile; 16 operations per valid lane for the tile dedup and 4
            # per arena probe
            **bound(lanes * 10 + (winners * 8 if cc else 0)
                    + (winners - held) * 16 + claims * 8
                    + tiles.blocks * 4,
                    valid * 16 + (winners - held) * 4),
            "geometry": geometry}
        parts["dedup_commit_kernel"] = {
            "device_ms": by_kernel.get("dedup_commit_kernel"),
            # a count per tile; per claim its cell, owner word, dvalid
            # byte and the cell's clear
            **bound(tiles.blocks * 4 + claims * (8 + 8 + 1 + 8),
                    claims * 8),
            "geometry": commit_geometry}
    return parts


def step_ops(model, symmetry: bool) -> int:
    """Integer operations per lane of K1: ~20 for the successor and ~25
    per packed word for its fingerprint (~120 at 2pc's four words), and
    under symmetry as many again: the lane's changed field moved within
    its row's representative (the row's sort, shared by its lanes, adds
    a few per lane; Increment's move picks each of its n thread words,
    ~5 operations apiece) and the second fingerprint."""
    from stateright_tpu_torch import Increment

    ops = 20 + 25 * model.packed_width
    if symmetry:
        ops += 20 + 25 * model.packed_width + (
            5 * model.n if isinstance(model, Increment) else 0)
    return ops


def block_args(model, carry, f: int, pfp=None):
    """The step inputs over ``f`` pending rows of ``carry``: frontier,
    ebits, fvalid and the frontier fingerprints (the queue's cached ones,
    or ``pfp(rows)``)."""
    import torch

    w = model.packed_width
    block = carry.q[carry.q_head:carry.q_head + f]
    take = min(carry.q_tail - carry.q_head, f)
    fvalid = torch.arange(f, device=block.device) < take
    phi, plo = (block[:, w + 1], block[:, w + 2]) if pfp is None \
        else pfp(block[:, :w])
    return block, (block[:, :w], block[:, w], fvalid, phi, plo)


def gated_step(model, args, table, ring, ws, take: int):
    """``fused_step`` as the search launches it inside a chunk: gated,
    over the rows of ``args`` (``block_args``'s) with the first ``take``
    pending (the gate's; ``fvalid`` unused), under the tag in the gate.
    Returns ``(launch, gate)``: ``launch()`` runs one step (a
    ``FusedOut``); ``gate`` is the int32 gate on the card (bump its
    ``G_TAG`` before a repeat, so each launch has its own owner-word
    tag)."""
    import torch

    from stateright_tpu_torch.checker.device_loop import (G_SIZE, G_TAG,
                                                          G_TAKE)
    from stateright_tpu_torch.ops import _cuda
    from stateright_tpu_torch.ops.fused import FusedOut, stats_len

    frontier, ebits, _fvalid, phi, plo = args
    gate = torch.zeros((7,), dtype=torch.int32, device=frontier.device)
    gate[G_SIZE], gate[G_TAKE], gate[G_TAG] = 1, take, ws.step + 1

    def launch():
        return FusedOut(*_cuda.fused_step(
            model, frontier, ebits, None, phi, plo, table, ring, ws,
            stats_len(model), gate=gate.data_ptr(), gate_size=1))
    return launch, gate


def check_step(model, carry, f: int, reps: int, symmetry: bool = False,
               pfp=None, active=None, defer: bool = False,
               gated: bool = False, needed=None):
    """K1-K3 (one ``fused_step``, the symmetric instantiation under
    ``symmetry``) against ``fused_step_reference`` on the card over ``f``
    rows of ``carry`` (its pending ones valid), by the set gate.
    ``active(frontier)`` (a group or edit model's rule) gives the lanes
    whose children K1 writes (bool ``[f * A]``): flat, chi and clo are
    held there only, every other output on every lane; a group
    instantiation (``_cuda.pending_rows``) writes only the pending rows'
    outputs: flat, chi and clo are held on the written lanes of pending
    rows, pbits and ebits on pending rows, cvalid and terminal on every
    lane and row, and its bound (``pending_bound``) counts those.
    ``needed(frontier)`` (a kernel that writes every lane, of a model
    whose step needs fewer lanes' children) gives the lanes the bound
    counts, in place of ``active``'s, while every lane is held.
    ``gated`` launches the step as the search does (:func:`gated_step`:
    the pending rows a prefix passed as the gate's ``take``). The kernel
    is timed (CUDA events, then a trace) before its plain version runs:
    a plain version of tens of seconds spoils the traces taken after
    it. ``defer`` returns, once the kernel is timed, a function that
    runs the plain version and returns the check; it holds copies of the
    step's inputs, not ``carry``."""
    from stateright_tpu_torch.checker.device_loop import G_TAG
    from stateright_tpu_torch.ops.fused import StepWorkspace, fused_step

    block, args = block_args(model, carry, f, pfp)
    table0, ring0 = carry.table.clone(), carry.ring.clone()
    t_k, r_k = table0.clone(), ring0.clone()
    ws = StepWorkspace(table0.numel(), ring0.shape[0],
                       len(model.properties()), block.device)
    gate = None
    if gated:
        take = min(carry.q_tail - carry.q_head, f)
        launch, gate = gated_step(model, args, t_k, r_k, ws, take)
    else:
        def launch():
            return fused_step(model, *args, t_k, r_k, ws, symmetry=symmetry)
    k = launch()
    n_claims = int(ws.n_claims.sum())  # K2's claims, which K3 walks
    t_after = t_k.clone()

    def restore():
        t_k.copy_(table0)
        r_k.copy_(ring0)
        if gate is not None:
            gate[G_TAG] += 1

    ms = cuda_ms(launch, reps, restore)
    dev = device_times(launch, before=restore)
    if defer:
        args = tuple(x.clone() for x in args)

    def finish():
        return _step_against_plain(model, f, symmetry, active, args, k,
                                   n_claims, t_after, ms, dev, table0, ring0,
                                   needed)
    return finish if defer else finish()


def _step_against_plain(model, f, symmetry, active, args, k, n_claims,
                        t_k, ms, dev, table0, ring0, needed=None) -> dict:
    """The rest of :func:`check_step`: the plain version on a copy of
    the table and ring the kernel's step started from, held against the
    kernel's outputs ``k`` (and its table after the step, ``t_k``), and
    the bound."""
    import numpy as np
    import torch

    from stateright_tpu_torch.ops import _cuda
    from stateright_tpu_torch.ops.fused import (S_CCH, S_DEDUP, S_DISC,
                                                S_FAULT, S_INSERTED, S_OVF,
                                                S_XOVF, fused_step_reference)
    from stateright_tpu_torch.ops.words import pack64

    w = model.packed_width
    n_props = len(model.properties())
    t_p, r_p = table0.clone(), ring0.clone()
    # the plain version walks its blocks one after another: it is timed
    # on this one comparison step only
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    p = fused_step_reference(model, *args, t_p, r_p, symmetry=symmetry)
    end.record()
    end.synchronize()
    plain_ms = start.elapsed_time(end)
    lane_exact = ("flat", "chi", "clo", "cvalid", "pbits", "ebits",
                  "terminal") + (("ohi", "olo") if symmetry else ())
    written = None if active is None else active(args[0])
    need = None if needed is None else needed(args[0])
    rows_held = None  # every row
    pend_rows = not symmetry and _cuda.pending_rows(model.cuda_spec()[0])
    if pend_rows:
        # K1 steps the pending rows only
        rows_held = args[2]
        lanes_held = rows_held.repeat_interleave(model.max_actions)
        written = lanes_held if written is None else written & lanes_held
        need = None if need is None else need & lanes_held
    err = 0
    for name in lane_exact:
        a = getattr(k, name).to(torch.int64)
        b = getattr(p, name).to(torch.int64)
        if a.shape != b.shape:
            raise AssertionError(f"f={f} {name}: shape {a.shape} != {b.shape}")
        if written is not None and name in ("flat", "chi", "clo"):
            a, b = a[written], b[written]
        if rows_held is not None and name in ("pbits", "ebits"):
            a, b = a[rows_held], b[rows_held]
        err = max(err, int((a - b).abs().max()) if a.numel() else 0)

    def inserted_keys(out):
        keys = pack64(out.chi, out.clo)[out.inserted].cpu().numpy()
        return keys, set(keys.tolist())

    kk, ks = inserted_keys(k)
    pk, ps = inserted_keys(p)
    table_k = np.sort(t_k[t_k != 0].cpu().numpy())
    table_p = np.sort(t_p[t_p != 0].cpu().numpy())
    sk, sp = k.stats.cpu().numpy(), p.stats.cpu().numpy()
    # K2's tile stage passes one lane per key and tile to the ring
    checks = {
        "lane_exact": err == 0,
        "tile_winners": int(sk[S_DEDUP]) + int(sk[S_CCH])
        == tile_key_pairs(k, k.cvalid, f, model.max_actions),
        "inserted_set": ks == ps,
        "one_lane_per_key": len(kk) == len(ks) and len(pk) == len(ps),
        "table_set": np.array_equal(table_k, table_p),
        "discoveries": np.array_equal(sk[S_DISC:], sp[S_DISC:]),
        "flags": bool((sk[S_XOVF], sk[S_OVF]) == (sp[S_XOVF], sp[S_OVF])
                      and sk[S_FAULT] == 0),
        # one claimed slot per inserted lane
        "claims": n_claims == int(sk[S_INSERTED]) == len(kk),
        "lowest_lane_wins": lowest_lane_wins(k),
        # K2's tile stage keeps the rule over every valid lane
        "lowest_valid_lane_wins": lowest_lane_wins(k, among=k.cvalid),
    }
    if not all(checks.values()):
        raise AssertionError(f"fused step f={f} disagrees with its plain "
                             f"version: {checks}")
    # the bound: each input read once, each output written once, table
    # and ring traffic counted for the lanes that need it: the ring per
    # tile winner (K2's one lane per key and tile; the kernel counts the
    # winners the ring held in S_CCH, the others in S_DEDUP), a bucket
    # per winner the ring did not hold
    lanes = f * model.max_actions
    n_valid = int(k.cvalid.sum())
    n_table = int(k.dvalid.sum())
    n_win = int(sk[S_DEDUP]) + int(sk[S_CCH])
    n_ins = len(kk)
    if need is None:
        need = written  # the lanes the bound counts
    n_written = lanes if need is None else int(need.sum())

    cc = ring0.shape[0]

    def step_bytes(rows, n_w):
        # ``rows`` of the f stepped (read, their keys and bits written),
        # ``n_w`` children written; every lane's masks and every row's
        # terminal written whatever is stepped
        a = model.max_actions
        return (rows * (4 * w + 4 + 8 + 1)        # frontier, ebits, fps,
                                                  # fvalid
                + rows * (max(n_props, 1) + 4)    # pbits, ebits
                + f                               # terminal
                + n_w * 4 * w                     # flat
                + rows * a * 8                    # chi/clo
                + f * a * 3                       # cvalid, dvalid, inserted
                + rows * a * (8 if symmetry else 0)  # ohi/olo
                + cc * 8                          # the ring arena K1 resets
                + (n_win * 8 if cc else 0)        # ring probes
                + n_table * 32                    # bucket reads
                + n_ins * 16)                     # table + ring writes
    nbytes = step_bytes(f, n_written)
    ops = n_written * step_ops(model, symmetry) + n_table * 12
    # the same with only the pending rows stepped: the least work of the
    # search's own step, a group K1's (``_cuda.pending_rows``)
    pending = int(args[2].sum())
    pw = (pending * model.max_actions if need is None
          else int(need[:pending * model.max_actions].sum()))
    pending_bound = {"rows": pending, "written": pw,
                     **bound(step_bytes(pending, pw),
                             pw * step_ops(model, symmetry) + n_table * 12)}
    return {"f": f, "lanes": lanes, "written": n_written, "valid": n_valid,
            "tile_winners": n_win, "to_table": n_table,
            "inserted": n_ins, "claims": n_claims, "max_abs_err": err,
            "ms": ms,
            "device_ms": dev["ours_ms"],
            "device_by_kernel_ms": dev["by_kernel_ms"],
            "plain_ms": plain_ms, **bound(nbytes, ops),
            "pending_bound": pending_bound,
            "parts": kernel_parts(model, f, symmetry, cc,
                                  dev["by_kernel_ms"],
                                  (n_valid, n_win, n_table, n_ins),
                                  written=n_written,
                                  stepped=pending if pend_rows else None),
            "checks": checks}


def insert_parts(keys, valid, n_ins: int, by_kernel, mask: bool) -> dict:
    """The flat insert's kernel over ``keys`` where ``valid`` (K4, K6):
    its device ms (from ``by_kernel``, a profiled call), its own bound
    and its launch, with ``n_ins`` keys inserted (one claim each). It
    reads each lane once, a bucket per valid lane and writes the key per
    claim; with ``mask`` it also writes each lane's inserted byte, posts
    the owner word per valid lane and per claim reads it back and writes
    one inserted byte; 12 operations per probe."""
    n, n_valid = keys.shape[0], int(valid.sum())
    nbytes = n * 9 + n_valid * 32 + n_ins * 8
    if mask:
        nbytes += n + n_valid * 8 + n_ins * (8 + 1)
    return {"flat_insert_kernel": {
        "device_ms": (by_kernel or {}).get("flat_insert_kernel"),
        **bound(nbytes, n_valid * 12),
        "launch": "cooperative" if mask else "plain"}}


def insert_bound(keys, valid, n_ins: int, mask: bool) -> dict:
    """The least time of the flat insert as a function: each lane read
    once (and with ``mask`` its inserted byte written), a bucket read per
    distinct valid key and the key written per inserted lane; 16
    operations per valid lane (the dedup) and 12 per distinct key (its
    probe)."""
    import torch

    distinct = torch.unique(keys[valid]).shape[0]
    return bound(keys.shape[0] * (9 + mask) + distinct * 32 + n_ins * 8,
                 int(valid.sum()) * 16 + distinct * 12)


def check_insert(carry, reps: int) -> dict:
    """K4 against ``table_insert_reference`` on the card: the growth
    re-insert of the mid-search log into an empty 2**20-slot table, with
    every key twice in the batch. Without a mask, as the seed and growth
    call it: the table and the flags. With one: the inserted lane of each
    key is its lowest (the first copy), and a second call on an equal
    table with the same workspace gives the same mask. Both timed; the
    kernel's line carries the first (the main path's) and the masked
    call under ``mask``."""
    import numpy as np
    import torch

    from stateright_tpu_torch.ops.fused import StepWorkspace
    from stateright_tpu_torch.ops.hashtable import (make_table,
                                                    table_insert,
                                                    table_insert_reference)
    from stateright_tpu_torch.ops.words import pack64

    log = carry.log[:carry.log_n]
    hi = torch.cat([log[:, 0], log[:, 0]])
    lo = torch.cat([log[:, 1], log[:, 1]])
    valid = torch.ones((hi.shape[0],), dtype=torch.bool, device=hi.device)
    t_p = make_table(1 << 20, hi.device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    ins_p, ovf_p = table_insert_reference(t_p, hi, lo, valid)
    end.record()
    end.synchronize()
    plain_ms = start.elapsed_time(end)
    keys = pack64(hi, lo)
    pk = keys[ins_p].cpu().numpy()
    table_p = np.sort(t_p[t_p != 0].cpu().numpy())
    t_n = make_table(1 << 20, hi.device)
    none, ovf_n = table_insert(t_n, hi, lo, valid, mask=False)
    t_k = make_table(1 << 20, hi.device)
    ws = StepWorkspace(t_k.numel(), 0, 0, hi.device)
    ins_k, ovf_k = table_insert(t_k, hi, lo, valid, ws=ws)
    kk = keys[ins_k].cpu().numpy()
    table_n = np.sort(t_n[t_n != 0].cpu().numpy())
    table_k = np.sort(t_k[t_k != 0].cpu().numpy())
    t_again = make_table(1 << 20, hi.device)
    ins_again, _ovf = table_insert(t_again, hi, lo, valid, ws=ws)
    checks = {
        "table_set": np.array_equal(table_n, table_p),
        "flags": ovf_n == ovf_p and none is None,
        "inserted_set": set(kk.tolist()) == set(pk.tolist()),
        "one_lane_per_key": len(kk) == len(set(kk.tolist())) == carry.log_n,
        "table_set_mask": np.array_equal(table_k, table_p),
        "flags_mask": ovf_k == ovf_p,
        # the owner-word rule: the first copy of each key
        "lowest_lane_wins": lowest_valid_lane_wins(keys, valid, ins_k)
        and bool(ins_k[:carry.log_n].all()),
        "repeat": torch.equal(ins_again, ins_k),
    }
    if table_n.shape != table_p.shape or table_k.shape != table_p.shape:
        raise AssertionError(f"insert kernel tables hold {table_n.size} "
                             f"and {table_k.size} keys, its plain version "
                             f"{table_p.size}")
    # the largest difference of the sorted table keys' uint32 words
    words_p = table_p.view(np.uint32).astype(np.int64)
    err = max((int(np.abs(t.view(np.uint32).astype(np.int64)
                          - words_p).max()) if t.size else 0)
              for t in (table_n, table_k))
    if not all(checks.values()):
        raise AssertionError(f"insert kernel disagrees with its plain "
                             f"version: {checks}")
    n_ins = len(kk)
    out = {"n": hi.shape[0], "keys": carry.log_n, "max_abs_err": err,
           "plain_ms": plain_ms, "checks": checks}
    for mask, t in ((False, t_n), (True, t_k)):
        def launch(t=t, mask=mask):
            return table_insert(t, hi, lo, valid, ws=ws, mask=mask)

        dev = device_times(launch, before=t.zero_)
        timing = {"ms": cuda_ms(launch, reps, t.zero_),
                  "device_ms": dev["ours_ms"],
                  "device_by_kernel_ms": dev["by_kernel_ms"],
                  "torch_ms": dev["torch_ms"],
                  **insert_bound(keys, valid, n_ins, mask),
                  "parts": insert_parts(keys, valid, n_ins,
                                        dev["by_kernel_ms"], mask)}
        if mask:
            out["mask"] = timing
        else:
            out.update(timing)
    return out


def ring_hits(out, ring):
    """Valid lanes whose key the ring holds (the probe-free step drops
    them)."""
    from stateright_tpu_torch.ops.hashtable import start_bucket
    from stateright_tpu_torch.ops.words import pack64

    keys = pack64(out.chi, out.clo)
    slot = start_bucket(out.chi, out.clo, ring.shape[0])
    return out.cvalid & (ring[slot] == keys)


def tile_key_pairs(out, mask, f: int, a: int) -> int:
    """The distinct (tile, key) pairs among the ``mask``-ed lanes of a
    step over ``f`` rows of ``a`` lanes, at the card's tile geometry: the
    tile winners there are among them."""
    import torch

    from stateright_tpu_torch.ops import _cuda
    from stateright_tpu_torch.ops.words import pack64

    geo = _cuda.tile_geometry(f, a, _cuda.sm_count(out.chi.device))
    lane = torch.arange(out.chi.shape[0], device=out.chi.device)
    pairs = torch.stack([lane // (geo.rows * a), pack64(out.chi, out.clo)],
                        1)[mask]
    return torch.unique(pairs, dim=0).shape[0]


def check_noprobe(model, carry, f: int, reps: int, symmetry: bool = False,
                  pfp=None) -> dict:
    """K1 + K5 (one ``fused_step(probe=False)``, the symmetric
    instantiation under ``symmetry``) against its plain version on the
    card over ``f`` pending rows of ``carry`` and its ring: lane-exact
    outputs, scalars and discoveries; ``dvalid`` by the key-set gate (a
    subset of the valid lanes the ring does not hold, with their key set,
    one lane per key, the lowest); the ring-hit count recounted over the
    tile winners; the key arena clean after the step."""
    import torch

    from stateright_tpu_torch.ops.fused import (S_CCH, S_DEDUP, S_DISC,
                                                S_FAULT, S_INSERTED, S_OVF,
                                                S_VALID, S_XOVF,
                                                DedupWorkspace, fused_step,
                                                fused_step_reference)
    from stateright_tpu_torch.ops.words import pack64

    w = model.packed_width
    a = model.max_actions
    block, args = block_args(model, carry, f, pfp)
    args += (None, carry.ring)
    n_props = len(model.properties())
    ws = DedupWorkspace(f * a, carry.ring.shape[0], n_props, block.device)

    def launch():
        return fused_step(model, *args, ws, probe=False, symmetry=symmetry)

    k = launch()
    n_claims = int(ws.n_claims.sum())  # K5's claims, which its commit walks
    arena_clean = not bool(ws.arena.any())
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    p = fused_step_reference(model, *args, probe=False, symmetry=symmetry)
    end.record()
    end.synchronize()
    plain_ms = start.elapsed_time(end)
    err = 0
    for name in ("flat", "chi", "clo", "cvalid", "pbits", "ebits",
                 "terminal") + (("ohi", "olo") if symmetry else ()):
        x = getattr(k, name).to(torch.int64)
        y = getattr(p, name).to(torch.int64)
        if x.shape != y.shape:
            raise AssertionError(f"f={f} {name}: shape {x.shape} != {y.shape}")
        err = max(err, int((x - y).abs().max()) if x.numel() else 0)
    sk, sp = k.stats.cpu().numpy(), p.stats.cpu().numpy()
    hit = ring_hits(k, carry.ring)
    keys = pack64(k.chi, k.clo)
    live = k.cvalid & ~hit
    kd = keys[k.dvalid].cpu().numpy()
    pd = keys[p.dvalid].cpu().numpy()
    live_keys = set(keys[live].cpu().numpy().tolist())
    # K5's tile stage passes one lane per key and tile to the ring: S_CCH
    # counts those the ring holds
    n_win = tile_key_pairs(k, k.cvalid, f, a)
    n_held = tile_key_pairs(k, hit, f, a)
    checks = {
        "lane_exact": err == 0,
        "scalars": bool(all(sk[i] == sp[i] for i in (S_XOVF, S_OVF,
                                                      S_VALID))
                        and sk[S_FAULT] == 0),
        "ring_hits": int(sk[S_CCH]) == n_held,
        "discoveries": bool((sk[S_DISC:] == sp[S_DISC:]).all()),
        "dvalid_subset": bool((k.dvalid <= live).all()),
        "dvalid_key_set": set(kd.tolist()) == live_keys
        == set(pd.tolist()),
        "one_lane_per_key": len(kd) == len(set(kd.tolist())),
        "lowest_lane_wins": lowest_lane_wins(k._replace(
            dvalid=live, inserted=k.dvalid)),
        # one claimed cell per kept lane
        "claims": n_claims == int(sk[S_DEDUP]) == int(sk[S_INSERTED])
        == len(kd),
        # each claim's commit cleared its cell: no memset before a step
        "arena_clean": arena_clean,
    }
    if not all(checks.values()):
        raise AssertionError(f"probe-free step f={f} disagrees with its "
                             f"plain version: {checks}")
    ms = cuda_ms(launch, reps)
    dev = device_times(launch)
    if ws.arena.any():
        raise AssertionError(f"probe-free step f={f}: the key arena is not "
                             "clean after the timed steps")
    lanes = f * a
    n_valid = int(k.cvalid.sum())
    nbytes = (f * (4 * w + 4 + 8 + 1)            # frontier, ebits, fps, fvalid
              + f * (max(n_props, 1) + 4 + 1)    # pbits, ebits, terminal
              + lanes * (4 * w + 8 + 2)          # flat, chi/clo, 2 masks
              + lanes * (8 if symmetry else 0)   # ohi/olo
              + n_win * 8)                       # ring probes
    ops = lanes * step_ops(model, symmetry) + n_valid * 16
    return {"f": f, "lanes": lanes, "valid": n_valid,
            "tile_winners": n_win, "ring_hits": int(sk[S_CCH]),
            "ring_hits_plain": int(sp[S_CCH]), "dvalid": len(kd),
            "dvalid_plain": len(pd), "claims": n_claims,
            "max_abs_err": err, "ms": ms,
            "device_ms": dev["ours_ms"],
            "device_by_kernel_ms": dev["by_kernel_ms"],
            "memset_ms": dev["copy_ms"], "plain_ms": plain_ms,
            **bound(nbytes, ops),
            "parts": kernel_parts(model, f, symmetry, carry.ring.shape[0],
                                  dev["by_kernel_ms"],
                                  noprobe=(n_valid, n_win, n_held,
                                           n_claims)),
            "checks": checks}, k


def probe_lanes(model, carry, step):
    """The received lanes of the default one-rank sharded run: the lanes
    the probe-free step ``step`` kept, compacted to ``kmax`` rows (the
    fresh ones first). Returns ``(hi, lo, valid)``."""
    import torch

    from stateright_tpu_torch.checker.device_loop import shrink_indices
    from stateright_tpu_torch.checker.gpu import candidate_sizes

    _kraw, kmax = candidate_sizes(model, 12288, {})
    count = int(step.dvalid.sum())
    if count > kmax:  # the engine's abort handler widens it so
        kmax = min(max(kmax * 2, -(-(count + count // 4) // 256) * 256),
                   12288 * model.max_actions)
    src = shrink_indices(step.dvalid, kmax)
    return (step.chi[src], step.clo[src],
            torch.arange(kmax, device=step.chi.device) < count)


def check_probe(model, carry, step, reps: int) -> dict:
    """K6 (``probe_block``) against ``probe_block_reference`` on the card:
    the lanes the probe-free step ``step`` kept, at the received width of
    the default one-rank sharded run (``probe_lanes``), probed into a
    copy of ``carry``'s table; then the same lanes twice over, where the
    lowest lane of each fresh key must win. Each is repeated on an equal
    table with the same workspace (the same mask), and timed."""
    import numpy as np
    import torch

    from stateright_tpu_torch.ops.fused import (S_FAULT, StepWorkspace,
                                                probe_block,
                                                probe_block_reference)
    from stateright_tpu_torch.ops.words import pack64

    hi, lo, valid = probe_lanes(model, carry, step)
    out = {"n": hi.shape[0], "valid": int(valid.sum())}
    for label, (h, l_, v) in (("main", (hi, lo, valid)),
                              ("twice", (torch.cat([hi, hi]),
                                         torch.cat([lo, lo]),
                                         torch.cat([valid, valid])))):
        t_k, t_p = carry.table.clone(), carry.table.clone()
        ws = StepWorkspace(t_k.numel(), 0, 0, t_k.device)
        ins_k, ovf_k, _r = probe_block(t_k, h, l_, v, ws)
        fault = int(ws.insert_stats[S_FAULT])
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        ins_p, ovf_p, _rp = probe_block_reference(t_p, h, l_, v)
        end.record()
        end.synchronize()
        keys = pack64(h, l_)
        kk, pk = keys[ins_k].cpu().numpy(), keys[ins_p].cpu().numpy()
        table_k = np.sort(t_k[t_k != 0].cpu().numpy())
        table_p = np.sort(t_p[t_p != 0].cpu().numpy())
        t_again = carry.table.clone()
        ins_again, _o, _r = probe_block(t_again, h, l_, v, ws)
        checks = {
            "inserted_set": set(kk.tolist()) == set(pk.tolist()),
            "one_lane_per_key": len(kk) == len(set(kk.tolist())),
            "table_set": np.array_equal(table_k, table_p),
            "flags": bool(ovf_k) == bool(ovf_p) and fault == 0,
            "lowest_lane_wins": lowest_valid_lane_wins(keys, v, ins_k),
            "repeat": torch.equal(ins_again, ins_k),
        }
        if table_k.shape != table_p.shape or not all(checks.values()):
            raise AssertionError(f"owner-side probe ({label}) disagrees "
                                 f"with its plain version: {checks}")
        words_k = table_k.view(np.uint32).astype(np.int64)
        words_p = table_p.view(np.uint32).astype(np.int64)
        err = int(np.abs(words_k - words_p).max()) if words_k.size else 0

        def restore(t=t_k, t0=carry.table):
            t.copy_(t0)

        def launch(t=t_k, h=h, l_=l_, v=v, ws=ws):
            return probe_block(t, h, l_, v, ws)

        dev = device_times(launch, before=restore)
        n_ins = len(kk)
        out[label] = {"n": h.shape[0], "inserted": n_ins,
                      "max_abs_err": err,
                      "ms": cuda_ms(launch, reps, restore),
                      "device_ms": dev["ours_ms"],
                      "device_by_kernel_ms": dev["by_kernel_ms"],
                      "torch_ms": dev["torch_ms"],
                      "plain_ms": start.elapsed_time(end),
                      **insert_bound(keys, v, n_ins, True),
                      "parts": insert_parts(keys, v, n_ins,
                                            dev["by_kernel_ms"], True),
                      "checks": checks}
    main = out["main"]
    out.update({k: main[k] for k in ("ms", "device_ms", "plain_ms",
                                     "bound_ms", "bound_by", "bytes",
                                     "ops")},
               max_abs_err=max(out["main"]["max_abs_err"],
                               out["twice"]["max_abs_err"]))
    return out


#: kernels per wrapper launch inside the chunk's graph: ``fused_step``
#: is K1-K3, ``append`` K7
KERNELS_PER_LAUNCH = {"fused_step": 3, "append": 1}


def replay_nodes(run: dict) -> float:
    """Kernel launches per replay of a single-chip run's iteration graph
    (an ``end_to_end`` result): the graph's launches over its replays and
    the capture's warm-up launch of each kernel; ``append`` must equal
    those (one K7 each)."""
    n = run["graph_launches"] + run["captures"]
    launches = run["launches"]
    if launches["append"] != n:
        return float("nan")
    return sum(KERNELS_PER_LAUNCH[k] * launches[k]
               for k in KERNELS_PER_LAUNCH) / n


def check_control(model, carry, f: int = 12288) -> dict:
    """The chunk's start (``chunk_begin_kernel``, ``csrc/chunk.cu``, with
    the chunk's first gate, ``eval_gate``) against its plain version on
    the card, from the counters of a mid-search ``carry``, under chunk
    parameters that open the gate and that shut it (no steps left, the
    generation target reached, the growth limit reached), and with the
    staged chunk's terms (``kovf`` set; ``e_n`` past and at the edge
    log's limit, through ``chunk_begin_args``): the counter block (gate
    included) bit for bit and the step's stats vector zeroed. Also the
    kernel nodes of one captured iteration."""
    import torch

    from stateright_tpu_torch.checker.device_loop import (
        B_E_N, B_KOVF, E_GATE, G_SIZE, I32_MAX, ChunkRunner,
        chunk_begin_reference, step_sizes)
    from stateright_tpu_torch.ops import _cuda

    lay = carry.layout
    card = ChunkRunner(model, carry, f).card()
    f_small, f_large, qmargin = step_sizes(model, f)
    qlimit = carry.q.shape[0] - qmargin
    ctr0 = carry.ctr.clone()
    stats = card.bufs["stats"]
    # the staged chunk's start (launched with an edge log of 0 rows)
    staged = _cuda.chunk_begin_args(
        ctr=carry.ctr, stats=stats, qlimit=qlimit, n_props=lay.P,
        f_small=f_small, f_large=f_large, ext=lay.ext, cch=lay.cch)
    run = (3, I32_MAX, I32_MAX, 7)
    # name: (parameters, counter words set first, the edge log's limit)
    cases = {"open": (run, {}, None),
             "no_steps": ((0, I32_MAX, I32_MAX, 7), {}, None),
             "target": ((3, 0, I32_MAX, 7), {}, None),
             "grow_limit": ((3, I32_MAX, 0, 7), {}, None),
             "kovf": (run, {B_KOVF: 1}, None),
             "edge_log_full": (run, {B_E_N: 1}, 0),
             "edge_log_room": (run, {}, 0)}
    opens = ("open", "edge_log_room")
    err, checks = 0, {}
    for name, (params, words, elimit) in cases.items():
        carry.ctr.copy_(ctr0)
        for i, v in words.items():
            carry.ctr[i] = v
        start = carry.ctr.clone()
        stats.fill_(-1)
        if elimit is None:
            card.begin(*params)
        else:
            _cuda.chunk_begin(staged, carry.ctr.device, *params, elimit)
        k_ctr, k_stats = carry.ctr.clone(), stats.clone()
        p_ctr, p_stats = start, torch.full_like(k_stats, -1)
        chunk_begin_reference(p_ctr, lay, *params, f_small, f_large, qlimit,
                              p_stats,
                              elimit=I32_MAX if elimit is None else elimit)
        e = int((k_ctr.long() - p_ctr.long()).abs().max())
        err = max(err, e)
        opened = int(k_ctr[lay.ext + E_GATE + G_SIZE]) != 0
        checks[name] = (e == 0 and not bool(k_stats.any())
                        and not bool(p_stats.any())
                        and opened == (name in opens))
    carry.ctr.copy_(ctr0)
    # the captured iteration: K1-K3 of both sizes and K7, no gate kernel
    nodes = sum(KERNELS_PER_LAUNCH[k] * n
                for k, n in card.graph.counts.items())
    checks["graph_nodes"] = nodes == 7
    if not all(checks.values()):
        raise AssertionError(f"chunk_begin disagrees with its plain "
                             f"version: {checks} (graph {card.graph.counts})")

    def restore():
        carry.ctr.copy_(ctr0)

    def begin():
        card.begin(*run)

    ms_begin = cuda_ms(begin, 200)
    dev = device_times(begin, before=restore)
    p_ctr = ctr0.clone()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    chunk_begin_reference(p_ctr, lay, *run, f_small, f_large, qlimit,
                          stats)
    end.record()
    end.synchronize()
    plain_ms = start.elapsed_time(end)
    restore()
    # the bound: the counter block read and written once, the stats
    # vector written; a few dozen integer operations
    nbytes = 4 * (2 * lay.length + stats.shape[0])
    by = dev["by_kernel_ms"] or {}
    return {"f": f, "counters": lay.length, "max_abs_err": err,
            "ms": ms_begin, "device_ms": by.get("chunk_begin_kernel"),
            "plain_ms": plain_ms, "graph_counts": card.graph.counts,
            "graph_kernel_nodes": nodes, **bound(nbytes, 64),
            "checks": checks}


def check_append(model, carry, f: int, reps: int) -> dict:
    """K7 (``append_kernel``, ``csrc/chunk.cu``) against its plain
    version on the card over a real step of ``carry`` at ``f`` rows per
    large step: the chunk's start and the gated step (K1-K3) on the
    card, then K7, or ``append_reference`` from the same counters, stats
    vector, queue and log; the counter block (the next gate included),
    the stats vector, the queue and log rows it may write bit for bit.
    Timed with CUDA events and ``torch.profiler`` beside the plain
    version, whose torch kernels are the glue K7 replaced. The carry's
    table, ring and counters are restored afterwards."""
    import torch

    from stateright_tpu_torch.checker.device_loop import (
        B_DISC, B_LOG_N, B_Q_TAIL, E_FAULT, E_GATE, G_SIZE, I32_MAX,
        ChunkRunner, append_reference, step_sizes)
    from stateright_tpu_torch.ops.fused import S_DISC, S_FAULT, S_INSERTED

    lay = carry.layout
    w, a = model.packed_width, model.max_actions
    f_small, f_large, qmargin = step_sizes(model, f)
    qlimit = carry.q.shape[0] - qmargin
    table0, ring0, ctr0 = (carry.table.clone(), carry.ring.clone(),
                           carry.ctr.clone())
    card = ChunkRunner(model, carry, f).card()
    checks, err = {}, 0
    # a chunk of two steps (K7's tail opens the next step's gate), then
    # of one (its tail shuts it), each from the same carry; the second is
    # timed
    for steps in (2, 1):
        carry.table.copy_(table0)
        carry.ring.copy_(ring0)
        carry.ctr.copy_(ctr0)
        carry.ws.step += 1
        card.begin(steps, I32_MAX, I32_MAX, carry.ws.step)
        card.launch_steps()
        c = carry.counters()
        size = int(c[lay.ext + E_GATE + G_SIZE])
        if not size:
            raise AssertionError(f"the gate picked no step at f={f}")
        out = card.outputs(size)
        if steps == 2:
            # a step that discovers every property ends the search, and
            # the tail shuts the gate (Increment's fin): here its hits are
            # cleared, as a search past its discoveries would
            # (mid_search_carry), so the open branch is compared too; the
            # one-step pass compares the real hits
            out.stats[S_DISC:S_DISC + 3 * lay.P] = 0
            carry.ctr[B_DISC:B_DISC + 3 * lay.P] = 0
        lanes = out.inserted.shape[0]
        qbase, lbase = int(c[B_Q_TAIL]), int(c[B_LOG_N])
        rows_q = slice(qbase, qbase + lanes)
        rows_l = slice(lbase, lbase + lanes)
        # K7's tail zeroes the stats vector after reading it
        ctr1, stats1 = carry.ctr.clone(), out.stats.clone()
        q1, log1 = carry.q[rows_q].clone(), carry.log[rows_l].clone()
        cnt = int(out.inserted.sum())
        card.launch_append()
        k = (carry.ctr.clone(), carry.q[rows_q].clone(),
             carry.log[rows_l].clone(), out.stats.clone())

        def restore():
            carry.ctr.copy_(ctr1)
            out.stats.copy_(stats1)

        def plain():
            append_reference(carry.ctr, lay, carry.q, carry.log, out, a,
                             f_small, f_large, qlimit)

        restore()
        carry.q[rows_q] = q1
        carry.log[rows_l] = log1
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        plain()
        end.record()
        end.synchronize()
        plain_ms = start.elapsed_time(end)
        p = (carry.ctr.clone(), carry.q[rows_q].clone(),
             carry.log[rows_l].clone(), out.stats.clone())
        e = max(int((x.long() - y.long()).abs().max()) for x, y in zip(k, p))
        err = max(err, e)
        st = stats1.cpu().numpy()
        gate = int(k[0][lay.ext + E_GATE + G_SIZE])
        one = {
            "bit_exact": e == 0,
            "count": cnt == int(st[S_INSERTED])
            == int(k[0][B_Q_TAIL]) - qbase,
            "no_fault": int(k[0][lay.ext + E_FAULT]) == 0
            and int(st[S_FAULT]) == 0,
            # rows past the appended ones are left as they were
            "rows_past_untouched": torch.equal(k[1][cnt:], q1[cnt:])
            and torch.equal(k[2][cnt:], log1[cnt:]),
            # the tail's gate: open for the chunk's second step (the
            # search is mid-way, past its discoveries), shut once its one
            # step is spent
            "gate": gate != 0 if steps == 2 else gate == 0,
            "stats_zeroed": not bool(k[3].any()),
        }
        if not all(one.values()):
            raise AssertionError(
                f"K7 f={f} steps={steps} disagrees with its plain version: "
                f"{one} (max_abs_err {e})")
        checks.update({f"{k}_steps{steps}": v for k, v in one.items()})
    ms = cuda_ms(card.launch_append, reps, restore)
    dev = device_times(card.launch_append, before=restore)
    glue = device_times(plain, before=restore)
    by = dev["by_kernel_ms"] or {}
    carry.table.copy_(table0)
    carry.ring.copy_(ring0)
    carry.ctr.copy_(ctr0)
    sym = carry.symmetry
    lc = carry.log.shape[1]
    # the bound: the inserted mask read once; per appended row its
    # successor, keys, the row's eventually-bits and the parent's keys
    # read, the queue row and the log row written
    nbytes = (lanes + cnt * (4 * w + 8 + 4 + 8 + (8 if sym else 0))
              + cnt * 4 * (w + 3 + lc))
    return {"f": f, "lanes": lanes, "appended": cnt, "max_abs_err": err,
            "ms": ms, "device_ms": by.get("append_kernel"),
            "plain_ms": plain_ms, "glue_device_ms": glue["torch_ms"],
            "glue_copy_ms": glue["copy_ms"], **bound(nbytes, 4 * lanes),
            "checks": checks}


def frontier_fps(model):
    """``rows -> (hi, lo)``: the int32 fingerprints of the rows' canonical
    members under ``model``'s representative (the plain version)."""
    import torch

    from stateright_tpu_torch.ops.hash_kernel import fp64_device

    def fps(rows):
        hi, lo = fp64_device(model.packed_representative(rows))
        return hi.to(torch.int32), lo.to(torch.int32)
    return fps


def canonical_keys(model, rows, chunk: int = 1 << 20) -> set:
    """``{fp64(model.packed_representative(row))}`` over ``rows`` (int32
    ``[N, W]`` on the card), by the plain version in chunks, as Python
    ints (what ``generated_fingerprints()`` holds)."""
    import numpy as np
    import torch

    from stateright_tpu_torch.ops.hash_kernel import fp64_device
    from stateright_tpu_torch.ops.words import pack64

    parts = [torch.zeros((0,), dtype=torch.int64, device=rows.device)]
    for i in range(0, rows.shape[0], chunk):
        hi, lo = fp64_device(model.packed_representative(rows[i:i + chunk]))
        parts.append(torch.unique(pack64(hi, lo)))
    keys = torch.unique(torch.cat(parts)).cpu().numpy()
    return set(keys.view(np.uint64).tolist())


def orbits_2pc7(device) -> dict:
    """Every reachable state of 2pc n=7 (the port's loop run to the end
    on the card), and the keys both representatives give them: 920
    orbits (the complete representative's keys, whose digest is the JAX
    package's) and 9,840 distinct reference keys, the ends of the
    reference representative's sound range."""
    import numpy as np
    import torch

    from stateright_tpu_torch import TwoPhaseSys
    from stateright_tpu_torch.checker.device_loop import (E_ITERS,
                                                          run_chunk,
                                                          seed_carry)
    from stateright_tpu_torch.ops.hashtable import table_insert
    from stateright_tpu_torch.ops.words import from_numpy_u32

    model = TwoPhaseSys(7)
    init = model.init_states()[0]
    fp = model.fingerprint(init)
    carry = seed_carry(model, 1 << 21, 1 << 20, [model.encode(init)], 0,
                       [fp], 1 << 15, device)
    table_insert(carry.table,
                 from_numpy_u32(np.array([fp >> 32], np.uint32), device),
                 from_numpy_u32(np.array([fp & 0xFFFFFFFF], np.uint32),
                                device),
                 torch.ones((1,), dtype=torch.bool, device=device),
                 mask=False)
    while run_chunk(model, carry, fmax=12288, steps=64,
                    grow_limit=1 << 20)[carry.layout.ext + E_ITERS]:
        pass
    rows = carry.q[:carry.q_tail, :model.packed_width]
    orbit_keys = canonical_keys(TwoPhaseSys(7, complete_symmetry=True),
                                rows)
    ref_keys = canonical_keys(model, rows)
    checks = {
        "states": carry.q_head == carry.q_tail == UNIQUE_2PC7,
        "orbits": len(orbit_keys) == UNIQUE_2PC7_SYM,
        "orbit_digest": fp_digest(orbit_keys) == DIGEST_2PC7_SYM,
        "reference_keys": len(ref_keys) == REF_KEYS_2PC7,
    }
    if not all(checks.values()):
        raise AssertionError(f"2pc7 orbits: {checks} ({carry.q_tail} "
                             f"states, {len(orbit_keys)} orbits, "
                             f"{len(ref_keys)} reference keys)")
    return {"states": carry.q_tail, "orbits": len(orbit_keys),
            "reference_keys": len(ref_keys), "checks": checks}, orbit_keys


def end_to_end_sym(model, path_kernels, off_kernels, want=None, **opts):
    """One check of ``model`` under symmetry reduction
    (``symmetry_fn(model.representative)``) through the user entry
    point: every launch count is set to 0 before it, each of
    ``path_kernels`` must have launched and none of ``off_kernels``;
    ``want`` = (unique, state_count, canonical-key digest) pins the
    answer; the verdicts hold and both witnesses replay through the host
    model. Returns its measurements, the checker and its search record
    (the device log, or every rank's)."""
    import torch

    from stateright_tpu_torch.ops import _cuda

    # a raced run's loser may still be capturing its chunk's graph on
    # its own thread: wait for it before synchronizing the card
    zero_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    # race=False: the card alone (symmetry is never raced anyway)
    ck = model.checker().symmetry_fn(model.representative).gpu_options(
        race=False, **opts).spawn_gpu().join()
    wall = time.perf_counter() - t0
    launches = dict(_cuda.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    # the search record before the mirror pulls it: the log rows
    # (canonical child, canonical parent, original child)
    record = (ck._logs if opts.get("mesh") is not None
              else [ck._mirror[0][:ck._mirror[1]]])
    unique = ck.unique_state_count()
    t1 = time.perf_counter()
    keys = ck.generated_fingerprints()
    mirror_s = time.perf_counter() - t1
    digest = fp_digest(keys)
    prof = ck.profile()
    checks = {
        "launches": all(launches[k] > 0 for k in path_kernels)
        and not any(launches[k] for k in off_kernels),
        "keys": len(keys) == unique,
        "originals": len(ck._orig_of) == unique,
    }
    if want is not None:
        checks.update(unique=unique == want[0],
                      generated=ck.state_count() == want[1],
                      digest=digest == want[2])
    ck.assert_no_discovery("consistent")
    for name in ("abort agreement", "commit agreement"):
        path = ck.assert_any_discovery(name)  # replays or raises
        checks[f"replay {name}"] = model.property(name).condition(
            model, path.last_state())
    shown = {k: (f"DeviceMesh {tuple(v.shape)} {v.device_type}"
                 if k == "mesh" else v) for k, v in opts.items()}
    mode = "complete" if model.complete_symmetry else "reference"
    if not all(checks.values()):
        raise AssertionError(
            f"2pc{model.n} {mode} symmetry {shown or 'default'}: {checks} "
            f"(unique {unique}, generated {ck.state_count()}, digest "
            f"{digest}, launches {launches})")
    keys_prof = ("engine", "syncs", "iterations", "small_iterations",
                 "grows", "capacity", "loop_s", "sync_s", "shards",
                 "chunks", "sync_stall", "capture_s", "graph_launches",
                 "exchange", "collectives", "collectives_per_iteration",
                 "kovfs", "aborts", "kmax", "gather_s", "vmax", "dmax")
    return {"model": f"TwoPhaseSys({model.n}, complete_symmetry="
                     f"{model.complete_symmetry})",
            "representative": mode, "options": shown, "wall_s": wall,
            "unique": unique, "unique_per_s": unique / wall,
            "generated": ck.state_count(), "digest": digest,
            "mirror_pull_s": mirror_s,
            **{k: prof[k] for k in keys_prof if k in prof},
            "max_memory_allocated": peak, "launches": launches,
            "checks": checks}, ck, record


def one_rank_mesh():
    """A one-rank NCCL group on card 0 and its DeviceMesh (the sharded
    engine at D = 1), over the loopback interface."""
    import socket

    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    torch.cuda.set_device(0)
    t0 = time.perf_counter()
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}",
                            rank=0, world_size=1)
    mesh = init_device_mesh("cuda", (1,), mesh_dim_names=("shards",))
    # NCCL builds its communicator at the first collective: do it here,
    # so the timed runs see a warm group
    dist.all_reduce(torch.zeros((1,), device="cuda"),
                    group=mesh.get_group("shards"))
    torch.cuda.synchronize()
    return mesh, time.perf_counter() - t0


def end_to_end(model_cls, path_kernels, **opts):
    """One full 2pc n=7 check through the user entry point, held to the
    oracle; every launch count is set to 0 before it and each of
    ``path_kernels`` must have launched. Returns its measurements and
    launch counts, and the checker."""
    import torch

    from stateright_tpu_torch.ops import _cuda

    # a raced run's loser may still be capturing its chunk's graph on
    # its own thread: wait for it before synchronizing the card
    zero_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    # race=False: the card alone, where a kernel fault raises (a raced
    # run could adopt the host BFS's answer instead)
    ck = model_cls(7).checker().gpu_options(race=False, **opts) \
        .spawn_gpu().join()
    wall = time.perf_counter() - t0
    launches = dict(_cuda.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    unique = ck.unique_state_count()
    digest = fp_digest(ck.generated_fingerprints())
    prof = ck.profile()
    checks = {
        "unique": unique == UNIQUE_2PC7,
        "generated": ck.state_count() == GENERATED_2PC7,
        "digest": digest == DIGEST_2PC7,
        "launches": all(launches[k] > 0 for k in path_kernels),
    }
    ck.assert_no_discovery("consistent")
    for name in ("abort agreement", "commit agreement"):
        # replays through the host model or raises
        path = ck.assert_any_discovery(name)
        checks[f"replay {name}"] = ck.model().property(name).condition(
            ck.model(), path.last_state())
    shown = {k: (f"DeviceMesh {tuple(v.shape)} {v.device_type}"
                 if k == "mesh" else v) for k, v in opts.items()}
    if not all(checks.values()):
        raise AssertionError(f"2pc7 end to end {shown or 'default'}: "
                             f"{checks} (unique {unique}, generated "
                             f"{ck.state_count()}, digest {digest}, "
                             f"launches {launches})")
    keys = ("engine", "syncs", "iterations", "small_iterations", "grows",
            "loop_s", "sync_s", "mirror_s", "shards", "exchange",
            "collectives", "collectives_per_iteration", "kovfs", "aborts",
            "kmax", "gather_s", "dmax", "chunks", "sync_stall", "capture_s",
            "captures", "graph_launches", "pipeline", "chunk_steps")
    return {"options": shown, "wall_s": wall, "unique": unique,
            "unique_per_s": unique / wall, "generated": ck.state_count(),
            "digest": digest, **{k: prof[k] for k in keys if k in prof},
            "max_memory_allocated": peak, "launches": launches,
            "checks": checks}, ck


def mirror_vs_plain(card) -> dict:
    """How far the card's search record (child fp -> parent fp, in
    insertion order) is from the plain versions' on the CPU, which
    reproduce the JAX package lane for lane. The set gate already holds;
    this counts the rows where the winner rules differ (ROADMAP C1)."""
    t0 = time.perf_counter()
    cpu = card.model().checker().gpu_options(device="cpu", race=False) \
        .spawn_gpu().join()
    cpu_wall = time.perf_counter() - t0
    cpu.generated_fingerprints()  # pulls the mirror
    # the mirrors are engine-internal: this diagnostic reads them
    a, b = list(card._generated.items()), list(cpu._generated.items())
    first = next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)
    return {"rows": len(a), "parents_differ": sum(
        1 for k, v in a if cpu._generated.get(k) != v),
        "first_row_differing": first, "cpu_wall_s": cpu_wall}


def race_phase() -> dict:
    """The host race on the main path (``spawn_gpu()`` with default
    options races a budgeted host BFS against the card): IncrementLock(3)
    raced (61 states, won by the host), then the host BFS alone and the
    card alone (K1-K3 and K7 launched), the margin the host's win rests
    on; the same model raced with a chunk that fails to launch and the
    host held back, whose ``join()`` must raise (a device error is never
    hidden by the host's answer); TwoPhaseSys(7) raced (won by the card,
    the pinned count and digest), with its walls and ``loop_s`` against
    ``race=False`` in turns; and TwoPhaseSys(3) raced against
    ``spawn_bfs()``'s set (the ``check-gpu 3`` subcommand in fresh
    processes runs last, ``cold_start_phase``). One ``race`` line each;
    returns them."""
    from stateright_tpu_torch import IncrementLock, TwoPhaseSys
    from stateright_tpu_torch.checker import bfs, device_loop, race
    from stateright_tpu_torch.checker.race import RacingChecker

    out = {}

    def raced(model, **opts):
        if not race.join_losers():
            raise AssertionError("a raced run's loser is still running")
        t0 = time.perf_counter()
        ck = model.checker().gpu_options(**opts).spawn_gpu()
        if not isinstance(ck, RacingChecker):
            raise AssertionError(f"spawn_gpu() did not race: {type(ck)}")
        ck.join()
        return ck, time.perf_counter() - t0

    # a small model: the host answers inside its budget
    ck, wall = raced(IncrementLock(3), capacity=1 << 14)
    ck.assert_properties()
    t0 = time.perf_counter()
    bfs3 = IncrementLock(3).checker().spawn_bfs().join()
    host_wall = time.perf_counter() - t0
    res = {"model": "IncrementLock(3)", "raced": True, "wall_s": wall,
           "host_alone_wall_s": host_wall,
           "engine": ck.profile()["engine"],
           "unique": ck.unique_state_count(),
           "checks": {"unique": ck.unique_state_count() == 61,
                      "engine": ck.profile()["engine"] == "host",
                      "set": ck.generated_fingerprints()
                      == bfs3.generated_fingerprints()}}
    emit(phase="race", **res)
    out["lock3_raced"] = res
    # the same model on the card alone: its kernels run
    lock_kernels = ("fused_step", "table_insert", "chunk_begin", "append")
    res, _ck = end_to_end_model(
        IncrementLock(3), lock_kernels,
        want=(61, 61, fp_digest(bfs3.generated_fingerprints())),
        holds=("fin", "mutex"), capacity=1 << 14)
    emit(phase="race", raced=False, **res)
    out["lock3_card"] = res

    # a device error ends the race: the host racer, held back until the
    # race is decided, would otherwise answer inside its budget
    if not race.join_losers():
        raise AssertionError("a raced run's loser is still running")
    ck = IncrementLock(3).checker().gpu_options(
        capacity=1 << 14, race_budget=60.0).spawn_gpu()
    host_run, dispatch = bfs.BfsChecker._run, device_loop.ChunkRunner.dispatch

    def fail(*args, **kwargs):
        raise RuntimeError("injected chunk failure")

    def held(self):
        ck._decided.wait(30)
        host_run(self)

    bfs.BfsChecker._run, device_loop.ChunkRunner.dispatch = held, fail
    t0 = time.perf_counter()
    try:
        ck.join()
        raised = None
    except RuntimeError as exc:
        raised = str(exc)
    finally:
        bfs.BfsChecker._run, device_loop.ChunkRunner.dispatch = (host_run,
                                                                 dispatch)
    wall = time.perf_counter() - t0
    res = {"model": "IncrementLock(3)", "raced": True,
           "injected": "ChunkRunner.dispatch raises", "wall_s": wall,
           "raised": raised,
           "checks": {"raised": raised == "injected chunk failure",
                      "prompt": wall < 20,
                      "losers": race.join_losers()}}
    emit(phase="race", **res)
    out["device_error"] = res
    del ck

    # the default 2pc7 run: won by the card; raced and unraced in turns
    turns = []
    for turn in range(2):
        for mode in ("raced", "race=False"):
            if mode == "race=False":
                if not race.join_losers():
                    raise AssertionError("a raced loser is still running")
                t0 = time.perf_counter()
                ck = TwoPhaseSys(7).checker().gpu_options(race=False) \
                    .spawn_gpu().join()
                wall = time.perf_counter() - t0
            else:
                ck, wall = raced(TwoPhaseSys(7))
            prof = ck.profile()
            digest = fp_digest(ck.generated_fingerprints())
            res = {"model": "TwoPhaseSys(7)", "mode": mode, "turn": turn,
                   "wall_s": wall, "engine": prof["engine"],
                   **{k: prof.get(k) for k in (
                       "seed_s", "capture_s", "loop_s", "sync_s",
                       "chunks", "graph_launches")},
                   "unique": ck.unique_state_count(),
                   "checks": {
                       "unique": ck.unique_state_count() == UNIQUE_2PC7,
                       "generated": ck.state_count() == GENERATED_2PC7,
                       "digest": digest == DIGEST_2PC7,
                       "engine": prof["engine"] == (
                           "gpu" if mode == "race=False" else "device")}}
            emit(phase="race", **res)
            turns.append(res)
            del ck
    out["2pc7"] = turns

    # whoever wins a full enumeration, its set is the host BFS's
    ck, wall = raced(TwoPhaseSys(3), capacity=1 << 12)
    res = {"model": "TwoPhaseSys(3)", "raced": True, "wall_s": wall,
           "engine": ck.profile()["engine"],
           "checks": {"set": ck.generated_fingerprints()
                      == TwoPhaseSys(3).checker().spawn_bfs().join()
                      .generated_fingerprints()}}
    emit(phase="race", **res)
    out["2pc3"] = res

    failed = {k: r["checks"] for k, r in out.items()
              if k != "2pc7" and not all(r["checks"].values())}
    failed.update({f"2pc7 {r['mode']} {r['turn']}": r["checks"]
                   for r in turns if not all(r["checks"].values())})
    if failed:
        raise AssertionError(f"race phase: {failed}")
    return out


def cold_start_phase() -> dict:
    """The examples' ``check-gpu`` (``spawn_gpu().report(sys.stdout)``)
    in fresh processes, raced and on the card alone in turns: the wall a
    user of a small model pays from a cold start (the interpreter, torch,
    the CUDA context, the kernels' load and the capture). One ``race``
    line each; returns them. It runs last: after another process has used
    the card, ``torch.profiler`` traces of this process mostly lose their
    device time (``tools/torch_trace_probe.py``)."""
    out = {}
    for i, flags in enumerate(([], ["--no-race"], ["--no-race"], [],
                               [], ["--no-race"])):
        cmd = [sys.executable, "-m", "stateright_tpu_torch.examples."
               "increment_lock", "check-gpu", "3", *flags]
        t0 = time.perf_counter()
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True, env={**os.environ, "PYTHONUNBUFFERED": "1"},
            cwd=os.path.dirname(os.path.abspath(__file__)))
        killer = threading.Timer(300, proc.kill)  # a hung run ends
        killer.start()
        lines, done_at = [], None
        for line in proc.stdout:
            lines.append(line.rstrip("\n"))
            if done_at is None and line.startswith("Done."):
                done_at = time.perf_counter() - t0
        proc.wait()
        killer.cancel()
        wall = time.perf_counter() - t0
        done = [ln for ln in lines if ln.startswith("Done.")]
        engine = [ln.split()[1].split("=", 1)[1] for ln in lines
                  if ln.startswith("# engine=")]
        want = ("gpu",) if flags else ("host", "device")
        res = {"command": " ".join(["increment_lock check-gpu 3",
                                    *flags]),
               "turn": i, "rc": proc.returncode, "done_line_s": done_at,
               "process_wall_s": wall,
               "engine": engine[0] if engine else None,
               "output": "\n".join(lines)[-2000:],
               "checks": {"rc": proc.returncode == 0,
                          "done": len(done) == 1 and done[0].startswith(
                              "Done. states=61, unique=61"),
                          "engine": len(engine) == 1
                          and engine[0] in want}}
        emit(phase="race", **res)
        out[f"cli {i}"] = res
    failed = {k: r["checks"] for k, r in out.items()
              if not all(r["checks"].values())}
    if failed:
        raise AssertionError(f"cold-start runs: {failed}")
    return out


def check_preload(keys, capacity: int, reps: int) -> dict:
    """K4 at a resume's preload: every key of the checkpoint's mirror
    (``keys``, uint64) into an empty table of the resumed run's
    ``capacity``, as the resume seeds it (no mask), held to
    ``table_insert_reference`` on the card (the table's key set and the
    overflow flag) and timed."""
    import numpy as np
    import torch

    from stateright_tpu_torch.ops.hashtable import (make_table,
                                                    table_insert,
                                                    table_insert_reference)
    from stateright_tpu_torch.ops.words import from_numpy_u32, pack64

    dev = torch.device("cuda", 0)
    hi = from_numpy_u32((keys >> np.uint64(32)).astype(np.uint32), dev)
    lo = from_numpy_u32(keys.astype(np.uint32), dev)
    valid = torch.ones((len(keys),), dtype=torch.bool, device=dev)
    t_p = make_table(capacity, dev)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    _ins, ovf_p = table_insert_reference(t_p, hi, lo, valid)
    end.record()
    end.synchronize()
    plain_ms = start.elapsed_time(end)
    t_k = make_table(capacity, dev)
    none, ovf_k = table_insert(t_k, hi, lo, valid, mask=False)
    table_p = np.sort(t_p[t_p != 0].cpu().numpy())
    table_k = np.sort(t_k[t_k != 0].cpu().numpy())
    checks = {"table_set": np.array_equal(table_k, table_p),
              "flags": ovf_k == ovf_p and none is None and not ovf_k,
              "every_key": table_k.size == len(keys)}
    if not all(checks.values()):
        raise AssertionError(f"K4 at the resume preload: {checks}")
    words = table_p.view(np.uint32).astype(np.int64)
    err = int(np.abs(table_k.view(np.uint32).astype(np.int64)
                     - words).max()) if words.size else 0

    def launch():
        return table_insert(t_k, hi, lo, valid, mask=False)

    dev_t = device_times(launch, before=t_k.zero_)
    return {"keys": len(keys), "capacity": capacity, "max_abs_err": err,
            "ms": cuda_ms(launch, reps, t_k.zero_),
            "device_ms": dev_t["ours_ms"], "plain_ms": plain_ms,
            **insert_bound(pack64(hi, lo), valid, len(keys), False),
            "checks": checks}


def checkpoint_phase() -> dict:
    """Checkpoints on the card: the default-width TwoPhaseSys(7) bounded
    by ``target_state_count(100_000)`` with ``resumable=True`` (the card
    alone), saved, then resumed in a fresh checker (never raced): the
    pinned count and digest, a witness through the stitched mirror, K4
    launched on the preload (the checkpoint's whole mirror) and timed
    there (``check_preload``); then under complete symmetry at 2pc16,
    whose reduced count is exact: the resumed run reaches the
    uninterrupted run's 21,335 keys and digest through K1-sym. One
    ``checkpoint`` line each; returns them."""
    import tempfile

    import numpy as np

    from stateright_tpu_torch import TwoPhaseSys
    from stateright_tpu_torch.ops import _cuda

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "2pc7.npz")
        zero_launches()
        t0 = time.perf_counter()
        partial = (TwoPhaseSys(7).checker()
                   .gpu_options(resumable=True, race=False)
                   .target_state_count(100_000).spawn_gpu().join())
        partial_wall = time.perf_counter() - t0
        t1 = time.perf_counter()
        partial.save(path)
        save_s = time.perf_counter() - t1
        with np.load(path) as data:
            mirror = data["child"].copy()
            frontier = len(data["rows"])
        zero_launches()
        t0 = time.perf_counter()
        ck = TwoPhaseSys(7).checker().resume_from(path).spawn_gpu().join()
        wall = time.perf_counter() - t0
        launches = dict(_cuda.LAUNCHES)
        prof = ck.profile()
        digest = fp_digest(ck.generated_fingerprints())
        # a witness through the stitched mirror: the deepest state the
        # resumed run found replays back through the checkpoint's part
        saved = set(mirror.tolist())
        last = next(reversed(ck._generated))
        path_fps = []
        fp = last
        while fp is not None:
            path_fps.append(fp)
            fp = ck._generated[fp]
        witness = ck._reconstruct_path(last)  # replays or raises
        ck.assert_no_discovery("consistent")
        for name in ("abort agreement", "commit agreement"):
            ck.assert_any_discovery(name)  # replays or raises
        res = {"model": "TwoPhaseSys(7)", "target": 100_000,
               "partial": {"wall_s": partial_wall,
                           "generated": partial.state_count(),
                           "unique": partial.unique_state_count(),
                           "frontier": frontier},
               "save_s": save_s, "npz_bytes": os.path.getsize(path),
               "wall_s": wall, "seed_s": prof.get("seed_s"),
               "loop_s": prof.get("loop_s"), "capacity": prof["capacity"],
               "preload": len(mirror), "unique": ck.unique_state_count(),
               "generated": ck.state_count(), "digest": digest,
               "witness_len": len(witness), "launches": launches,
               "checks": {
                   "partial": partial.unique_state_count() < UNIQUE_2PC7,
                   "unique": ck.unique_state_count() == UNIQUE_2PC7,
                   "digest": digest == DIGEST_2PC7,
                   "generated_continues": ck.state_count()
                   >= partial.state_count(),
                   "stitched": last not in saved
                   and any(f in saved for f in path_fps[1:]),
                   "launches": all(launches[k] > 0 for k in (
                       "table_insert", "fused_step", "chunk_begin",
                       "append"))}}
        res["k4_preload"] = check_preload(mirror, prof["capacity"], 20)
        emit(phase="checkpoint", **res)
        out["plain"] = res
        del partial, ck

        # under complete symmetry at full width: an exact reduced count
        path = os.path.join(tmp, "2pc16_sym.npz")
        m = TwoPhaseSys(16, complete_symmetry=True)
        partial = (m.checker().symmetry_fn(m.representative)
                   .gpu_options(resumable=True)
                   .target_state_count(100_000).spawn_gpu().join())
        partial.save(path)
        zero_launches()
        t0 = time.perf_counter()
        m = TwoPhaseSys(16, complete_symmetry=True)
        ck = (m.checker().symmetry_fn(m.representative).resume_from(path)
              .spawn_gpu().join())
        wall = time.perf_counter() - t0
        launches = dict(_cuda.LAUNCHES)
        digest = fp_digest(ck.generated_fingerprints())
        for name in ("abort agreement", "commit agreement"):
            ck.assert_any_discovery(name)  # replays or raises
        res = {"model": "TwoPhaseSys(16, complete_symmetry=True)",
               "target": 100_000,
               "partial": {"generated": partial.state_count(),
                           "unique": partial.unique_state_count()},
               "npz_bytes": os.path.getsize(path), "wall_s": wall,
               "seed_s": ck.profile().get("seed_s"),
               "unique": ck.unique_state_count(),
               "generated": ck.state_count(), "digest": digest,
               "launches": launches,
               "checks": {
                   "partial": partial.unique_state_count()
                   < UNIQUE_2PC16_SYM,
                   "unique": ck.unique_state_count() == UNIQUE_2PC16_SYM,
                   "digest": digest == DIGEST_2PC16_SYM,
                   "originals": len(ck._orig_of)
                   == ck.unique_state_count(),
                   "launches": launches["fused_step_sym"] > 0
                   and launches["table_insert"] > 0
                   and not launches["fused_step"]}}
        emit(phase="checkpoint", **res)
        out["symmetric"] = res
    failed = {k: r["checks"] for k, r in out.items()
              if not all(r["checks"].values())}
    if failed:
        raise AssertionError(f"checkpoint phase: {failed}")
    return out


#: K1's new instantiations at a real mid-search step: (label, model
#: class, its arguments, symmetry, the step sizes, pending rows for the
#: search to reach, whether it goes on past its discoveries). The kernels phase
#: checks each size through both step entry points (K1-K3 and K1 + K5).
#: PackedLinearEquation's frontier never holds more than 256 rows (a
#: BFS level is one diagonal x + y = d), so the loop only takes its
#: 256-row step.
MODEL_STEPS = (
    ("increment_lock", "IncrementLock", (9,), False, (12288, 256), 12288,
     False),
    ("lineq", "PackedLinearEquation", (2, 4, 7), False, (256,), 200, False),
    ("increment", "Increment", (16,), False, (12288, 256), 12288, True),
    ("increment", "Increment", (16,), True, (12288, 256), 12288, True),
)


def _models() -> dict:
    from stateright_tpu_torch import (Increment, IncrementLock,
                                      PackedLinearEquation)
    return {"Increment": Increment, "IncrementLock": IncrementLock,
            "PackedLinearEquation": PackedLinearEquation}


def check_model_steps(device) -> dict:
    """K1 of each new instantiation (with K2/K3 and with K5) at a real
    mid-search step of its model (``MODEL_STEPS``), held to the plain
    version by ``check_step`` and ``check_noprobe``, and K7 after the
    large step of each model without symmetry (its queue rows of 14 and
    20 words: ``check_append``); one ``kernels`` line each. Returns the
    results by (kernel, label, F)."""
    out = {}
    for label, cls, args, symmetry, sizes, pending, past in MODEL_STEPS:
        model = _models()[cls](*args)
        carry = mid_search_carry(model, device, symmetry=symmetry,
                                 rows=max(sizes), pending=pending,
                                 past_discoveries=past)
        for f in sizes:
            reps = 20 if f > 256 else 50
            res = check_step(model, carry, f, reps, symmetry=symmetry)
            kernel = "fused_step_sym" if symmetry else "fused_step"
            out[kernel, label, f] = res
            emit(phase="kernels", kernel=kernel, model=type(model).__name__,
                 params=list(model.cuda_spec(symmetry)[1]), **res)
            res, _ = check_noprobe(model, carry, f, reps, symmetry=symmetry)
            kernel = ("fused_step_noprobe_sym" if symmetry
                      else "fused_step_noprobe")
            out[kernel, label, f] = res
            emit(phase="kernels", kernel=kernel, model=type(model).__name__,
                 params=list(model.cuda_spec(symmetry)[1]), **res)
        if not symmetry and max(sizes) == 12288:
            res = out["append", label, 12288] = check_append(
                model, carry, 12288, 50)
            emit(phase="kernels", kernel="append",
                 model=type(model).__name__, **res)
        del carry
    return out


def end_to_end_model(model, path_kernels, off_kernels=(), symmetry=False,
                     want=None, holds=(), witness=None, **opts):
    """One check of ``model`` through the user entry point, every launch
    count set to 0 before it: each of ``path_kernels`` must have launched
    and none of ``off_kernels``; ``want`` = (unique, state_count, digest)
    pins the answer; the properties in ``holds`` have no discovery;
    ``witness`` = (property, length): its discovery replays through the
    host model, ends where the property's condition says it should (a
    ``sometimes`` example satisfies it, an ``always`` counterexample
    violates it) and has that many actions. Returns its measurements and
    the checker."""
    import torch

    from stateright_tpu_torch.core import Expectation
    from stateright_tpu_torch.ops import _cuda

    # a raced run's loser may still be capturing its chunk's graph on
    # its own thread: wait for it before synchronizing the card
    zero_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    # race=False: the card alone, where a kernel fault raises
    builder = model.checker().gpu_options(race=False, **opts)
    if symmetry:
        builder = builder.symmetry_fn(model.representative)
    ck = builder.spawn_gpu().join()
    wall = time.perf_counter() - t0
    launches = dict(_cuda.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    unique = ck.unique_state_count()
    checks = {"launches": all(launches[k] > 0 for k in path_kernels)
              and not any(launches[k] for k in off_kernels)}
    digest = mirror_s = None
    if want is not None:
        t1 = time.perf_counter()
        digest = fp_digest(ck.generated_fingerprints())
        mirror_s = time.perf_counter() - t1
        checks.update(unique=unique == want[0],
                      generated=ck.state_count() == want[1],
                      digest=digest == want[2])
    for name in holds:
        ck.assert_no_discovery(name)
        checks[f"holds {name}"] = True
    length = None
    if witness is not None:
        name, want_len = witness
        path = ck.assert_any_discovery(name)  # replays or raises
        prop = model.property(name)
        reached = prop.condition(model, path.last_state())
        checks[f"replay {name}"] = reached == (
            prop.expectation == Expectation.SOMETIMES)
        length = len(path)
        checks["witness_length"] = length == want_len
    prof = ck.profile()
    shown = {k: (f"DeviceMesh {tuple(v.shape)} {v.device_type}"
                 if k == "mesh" else v) for k, v in opts.items()}
    label = (f"{type(model).__name__}"
             f"({', '.join(str(p) for p in model.cache_key()[1:])})"
             + (" under symmetry" if symmetry else ""))
    if not all(checks.values()):
        raise AssertionError(
            f"{label} {shown or 'default'}: {checks} (unique {unique}, "
            f"generated {ck.state_count()}, digest {digest}, witness "
            f"{length}, launches {launches})")
    keys = ("engine", "syncs", "iterations", "small_iterations", "grows",
            "capacity", "loop_s", "sync_s", "seed_s", "shards", "exchange",
            "collectives", "collectives_per_iteration", "kovfs", "aborts",
            "kmax", "gather_s", "vmax", "dmax", "chunks", "sync_stall",
            "capture_s", "captures", "graph_launches", "fmax", "h_n",
            "histories", "pulls", "hgrow", "hgrow_s", "host_eval_s",
            "host_evals", "mirror_s")
    return {"model": label, "options": shown, "wall_s": wall,
            "unique": unique, "unique_per_s": unique / wall,
            "generated": ck.state_count(), "digest": digest,
            "mirror_and_digest_s": mirror_s, "witness_length": length,
            **{k: prof[k] for k in keys if k in prof},
            "max_memory_allocated": peak, "launches": launches,
            "checks": checks}, ck


def models_phase(mesh) -> dict:
    """Phase ``models``: the other models end to end on the card (see
    the module docstring); ``mesh`` is the one-rank NCCL mesh of the
    sharded runs. Returns each run's launch counts by label."""
    m = _models()
    chunk = ("chunk_begin", "append")
    single = ("fused_step", "table_insert") + chunk
    single_off = ("fused_step_sym", "fused_step_noprobe",
                  "fused_step_noprobe_sym", "probe_block")
    single_sym = ("fused_step_sym", "table_insert") + chunk
    sym_off = ("fused_step", "fused_step_noprobe", "fused_step_noprobe_sym",
               "probe_block")
    sharded = ("fused_step_noprobe", "probe_block", "table_insert")
    sharded_off = ("fused_step", "fused_step_sym",
                   "fused_step_noprobe_sym") + chunk
    sharded_sym = ("fused_step_noprobe_sym", "probe_block", "table_insert")
    sharded_sym_off = ("fused_step", "fused_step_sym",
                       "fused_step_noprobe") + chunk
    lock9, _ck = end_to_end_model(m["IncrementLock"](9), single, single_off,
                                  want=PIN_LOCK9, holds=("fin", "mutex"))
    del _ck
    # the table quadruples at each growth: 2**20 -> 2**22 -> 2**24 at
    # grow_at 0.55 (576,716 and 2,306,867 log rows)
    lock9["checks"]["growths"] = lock9["grows"] >= 2
    emit(phase="models", **lock9)
    runs = {"increment_lock": lock9}
    lineq, _ck = end_to_end_model(m["PackedLinearEquation"](2, 4, 7),
                                  single, single_off, holds=("solvable",),
                                  capacity=1 << 14)
    del _ck
    lineq["checks"].update(
        unique=lineq["unique"] == 65536, growths=lineq["grows"] >= 1,
        recaptured=lineq["captures"] == lineq["grows"] + 1)
    emit(phase="models", **lineq)
    runs["lineq"] = lineq
    res, _ck = end_to_end_model(m["PackedLinearEquation"](2, 10, 14),
                                single, single_off,
                                witness=("solvable", SOLVABLE_LEN))
    emit(phase="models", **res)
    for n in (7, 16):
        res, _ck = end_to_end_model(m["Increment"](n), single, single_off,
                                    witness=("fin", FIN_LEN))
        emit(phase="models", **res)
        runs["increment", n] = res
        res, _ck = end_to_end_model(m["Increment"](n), single_sym, sym_off,
                                    symmetry=True, witness=("fin", FIN_LEN))
        emit(phase="models", **res)
        runs["increment_sym", n] = res
    del _ck
    res, _ck = end_to_end_model(m["IncrementLock"](8), sharded, sharded_off,
                                want=PIN_LOCK8, holds=("fin", "mutex"),
                                mesh=mesh)
    emit(phase="models_sharded", **res)
    runs["sharded increment_lock"] = res
    res, _ck = end_to_end_model(m["PackedLinearEquation"](2, 4, 7), sharded,
                                sharded_off, holds=("solvable",),
                                mesh=mesh)
    res["checks"]["unique"] = res["unique"] == 65536
    emit(phase="models_sharded", **res)
    runs["sharded lineq"] = res
    res, _ck = end_to_end_model(m["Increment"](7), sharded, sharded_off,
                                witness=("fin", FIN_LEN), mesh=mesh)
    emit(phase="models_sharded", **res)
    runs["sharded increment"] = res
    res, _ck = end_to_end_model(m["Increment"](7), sharded_sym,
                                sharded_sym_off, symmetry=True,
                                witness=("fin", FIN_LEN), mesh=mesh)
    emit(phase="models_sharded", **res)
    runs["sharded increment_sym"] = res
    del _ck
    failed = [label for label, r in runs.items()
              if not all(r["checks"].values())]
    if failed:
        raise AssertionError(f"models phase: {failed}")
    return runs


def check_history(model, carry, f: int, reps: int) -> dict:
    """K8 (``history_kernel``, ``csrc/history.cu``) against its plain
    version on the card over the rows one more real step of ``carry`` at
    ``f`` rows appends, in three cases: keyed by the model's history
    columns with a table that holds the keys of every earlier row (as
    the search's own would: few or no fresh keys; the timed case), the
    same from an empty table (each distinct history of the step fresh),
    and keyed by the actor words (``[0, _net_off)``) with a table seeded
    from every second earlier row (thousands of fresh keys, repeated
    within the step: the claims, the in-batch dedup and the ordered
    append over many 512-row batches). Each case holds the fresh keys'
    queue indices in order (``hidx``), their count, the overflow flag
    and the table's key set exactly; the last two need fresh keys. Then
    index mode (the re-seed after growth: an index list, no append): the
    search case's rows and the actor-keyed representatives into fresh
    tables, ``h_n`` and ``hidx`` untouched, the key set exact. Each case
    timed with CUDA events and ``torch.profiler``."""
    import ctypes

    import torch

    from stateright_tpu_torch.checker.device_loop import (
        HistoryStage, history_reference, new_history, run_chunk)
    from stateright_tpu_torch.ops import _cuda
    from stateright_tpu_torch.ops.hash_kernel import fp64_device
    from stateright_tpu_torch.ops.hashtable import make_table
    from stateright_tpu_torch.ops.words import pack64

    dev = carry.q.device
    tail0 = carry.q_tail
    run_chunk(model, carry, fmax=f, steps=1)
    tail1 = carry.q_tail
    nrows = tail1 - tail0
    rows = torch.arange(tail0, tail1, dtype=torch.int64, device=dev)
    search = new_history(model, 1 << 16, carry.log.shape[0], tail0, dev)
    wide_cap = 1 << max(4 * tail1 - 1, 1).bit_length()
    cases = {
        "search": (search.hoff, search.hwidth, search.hcap,
                   torch.arange(tail0, dtype=torch.int64, device=dev)),
        "empty": (search.hoff, search.hwidth, search.hcap, None),
        "actors": (0, model._net_off, wide_cap,
                   torch.arange(0, tail0, 2, dtype=torch.int64,
                                device=dev))}
    out, stages = {}, {}
    for label, (hoff, hwidth, hcap, seed) in cases.items():
        base = HistoryStage(
            table=make_table(hcap, dev),
            hidx=torch.zeros_like(search.hidx), hdone=search.hdone.clone(),
            hoff=hoff, hwidth=hwidth)
        if seed is not None:
            history_reference(carry.q, base, seed)
        table0 = base.table.clone()

        def stage(base=base, table0=table0):
            return HistoryStage(
                table=table0.clone(), hidx=torch.zeros_like(base.hidx),
                hdone=base.hdone.clone(), hoff=base.hoff,
                hwidth=base.hwidth)

        k = stage()
        h_k, ovf_k = _cuda.history_insert(carry.q, k, start=tail0,
                                          end=tail1, append=True, h_n=0)
        p = stage()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fresh, ovf_p = history_reference(carry.q, p, rows)
        end.record()
        end.synchronize()
        reps_p = rows[fresh]
        n = reps_p.shape[0]
        got = k.hidx[:h_k].long()
        err = (int((got - reps_p).abs().max()) if n else 0) \
            if h_k == n else 1 << 31
        keys = pack64(*fp64_device(carry.q[rows, hoff:hoff + hwidth]))
        distinct = int(torch.unique(keys).numel())
        # the rows whose key is one of the fresh keys (> n: repeated)
        fresh_rows = int(torch.isin(keys, keys[fresh]).sum())
        checks = {"count": h_k == n, "hidx": err == 0,
                  "overflow": ovf_k == ovf_p == False,  # noqa: E712
                  "table_set": torch.equal(
                      torch.sort(k.table[k.table != 0]).values,
                      torch.sort(p.table[p.table != 0]).values)}
        if label != "search":
            checks["fresh"] = n > 0
        if label == "actors":  # keys repeated within the step
            checks["in_batch_duplicates"] = fresh_rows > n
        out[label] = {"hoff": hoff, "hwidth": hwidth, "hcap": hcap,
                      "seeded_rows": 0 if seed is None else len(seed),
                      "fresh": n, "fresh_rows": fresh_rows,
                      "distinct_keys": distinct,
                      "max_abs_err": err,
                      "plain_ms": start.elapsed_time(end), "checks": checks}
        stages[label] = (k, table0)
    failed = {lb: c["checks"] for lb, c in out.items()
              if not all(c["checks"].values())}
    if failed:
        raise AssertionError(f"K8 over {nrows} rows disagrees with its "
                             f"plain version: {failed}")
    # index mode (the re-seed after growth): the search case's rows and
    # the actor-keyed representatives into fresh tables, no append
    for label in ("search", "actors"):
        hoff, hwidth, hcap, _seed = cases[label]
        idx = rows if label == "search" else stages[label][0].hidx[
            :out[label]["fresh"]].long()

        def fresh_stage(hoff=hoff, hwidth=hwidth, hcap=hcap):
            return HistoryStage(
                table=make_table(hcap, dev),
                hidx=torch.zeros_like(search.hidx),
                hdone=search.hdone.clone(), hoff=hoff, hwidth=hwidth)

        k, p = fresh_stage(), fresh_stage()
        h_k, ovf_k = _cuda.history_insert(carry.q, k, index=idx,
                                          append=False, h_n=7)
        _fresh, ovf_p = history_reference(carry.q, p, idx)
        checks = {"h_n": h_k == 7, "hidx_untouched": not bool(k.hidx.any()),
                  "overflow": ovf_k == ovf_p == False,  # noqa: E712
                  "table_set": torch.equal(
                      torch.sort(k.table[k.table != 0]).values,
                      torch.sort(p.table[p.table != 0]).values)}
        out[f"index {label}"] = {"hoff": hoff, "hwidth": hwidth,
                                 "hcap": hcap, "rows": int(idx.shape[0]),
                                 "max_abs_err": 0 if all(checks.values())
                                 else 1 << 31, "checks": checks}
    failed = {lb: c["checks"] for lb, c in out.items()
              if not all(c["checks"].values())}
    if failed:
        raise AssertionError(f"K8 in index mode disagrees with its plain "
                             f"version: {failed}")
    # the kernel alone: its arguments over a device control block, with
    # a scratch for these rows
    ctl0 = torch.tensor([tail0, tail1, 0, 0], dtype=torch.int32,
                        device=dev)
    ctl = ctl0.clone()
    ptr = ctl.data_ptr()
    scratch = _cuda.history_scratch(nrows, dev)
    for label, (k, table0) in stages.items():
        args = _cuda._hist_args(carry.q, k, scratch)
        args.start, args.end = ptr, ptr + 4
        args.hidx = k.hidx.data_ptr()
        args.h_n, args.ovf = ptr + 8, ptr + 12
        assert ctypes.sizeof(args) == ctypes.sizeof(_cuda.HistArgs)

        def restore(k=k, table0=table0):
            k.table.copy_(table0)
            ctl.copy_(ctl0)

        def launch(args=args):
            _cuda.history(args, dev)

        out[label]["ms"] = cuda_ms(launch, reps, restore)
        times = device_times(launch, before=restore)
        out[label]["device_ms"] = (times["by_kernel_ms"] or {}).get(
            "history_kernel")
    main = out["search"]
    hwidth, n = main["hwidth"], main["fresh"]
    # the bound: each row's key columns and one bucket read, each fresh
    # key's slot and queue index written
    nbytes = nrows * (4 * hwidth + 32) + n * (8 + 4)
    ops = nrows * (25 * hwidth + 30)
    return {"f": f, "rows": nrows, "fresh": n, "hcap": main["hcap"],
            "max_abs_err": max(c["max_abs_err"] for c in out.values()),
            "ms": main["ms"], "device_ms": main.get("device_ms"),
            "plain_ms": main["plain_ms"], **bound(nbytes, ops),
            "grid": _cuda.history_grid(nrows, _cuda.sm_count(dev)),
            "usage": kernel_usage("history", "history_kernel"),
            "parent_device_ms_copied": PARENT_MS["history"],
            "cases": out,
            "checks": {f"{lb} {k}": v for lb, c in out.items()
                       for k, v in c["checks"].items()}}


def check_hpull(model, carry, reps: int) -> dict:
    """K9 (``hpull_kernel``, ``csrc/history.cu``) against its plain
    version on the card: a full window of ``HIST_WINDOW`` (256)
    representatives at seeded queue indices of ``carry`` (rows with a
    log entry), bit for bit, and timed."""
    import numpy as np
    import torch

    from stateright_tpu_torch.checker.device_loop import (HIST_WINDOW,
                                                          hpull_reference)
    from stateright_tpu_torch.ops import _cuda

    dev = carry.q.device
    w = model.packed_width
    n_init = 1  # mid_search_carry seeds one init row
    rng = np.random.default_rng(12)
    hidx = torch.from_numpy(rng.integers(
        n_init, carry.q_tail, HIST_WINDOW).astype(np.int32)).to(dev)
    out = torch.zeros((HIST_WINDOW, w + 2), dtype=torch.int32, device=dev)

    def launch():
        _cuda.hpull(carry.q, hidx, carry.log, 0, n_init, out,
                    count=HIST_WINDOW)

    launch()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    want = hpull_reference(carry.q, hidx, carry.log, 0, HIST_WINDOW,
                           n_init, HIST_WINDOW)
    end.record()
    end.synchronize()
    plain_ms = start.elapsed_time(end)
    err = int((out.long() - want.long()).abs().max())
    if err:
        raise AssertionError(f"K9 disagrees with its plain version: "
                             f"max_abs_err {err}")
    ms = cuda_ms(launch, reps)
    times = device_times(launch)
    # the bound: the indices, the rows and their log keys read once, the
    # window written once
    nbytes = HIST_WINDOW * (4 + 4 * w + 8) + HIST_WINDOW * 4 * (w + 2)
    return {"rows": HIST_WINDOW, "W": w, "max_abs_err": err, "ms": ms,
            "device_ms": (times["by_kernel_ms"] or {}).get("hpull_kernel"),
            "plain_ms": plain_ms, **bound(nbytes, HIST_WINDOW * (w + 2)),
            "checks": {"bit_exact": err == 0}}


def paxos_run(clients: int, path_kernels, target=None, **opts) -> tuple:
    """One PackedPaxos(clients) check through the user entry point on
    the card alone (``race=False``), every launch count set to 0 before
    it: ``linearizable`` holds over the pinned number of distinct
    histories (K8 logged each once, the host evaluated each), ``value
    chosen`` has a witness that replays through the host model and ends
    at a chosen value, and each of ``path_kernels`` launched. Returns
    its measurements and the checker."""
    import torch

    from stateright_tpu_torch.examples.paxos_packed import PackedPaxos
    from stateright_tpu_torch.ops import _cuda

    model = PackedPaxos(clients)
    # a raced run's loser may still be capturing its chunk's graph on
    # its own thread: wait for it before synchronizing the card
    zero_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    builder = model.checker().gpu_options(race=False, **opts)
    if target is not None:
        builder = builder.target_state_count(target)
    t0 = time.perf_counter()
    ck = builder.spawn_gpu().join()
    wall = time.perf_counter() - t0
    launches = dict(_cuda.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    ck.assert_no_discovery("linearizable")
    path = ck.assert_any_discovery("value chosen")  # replays or raises
    prop = model.property("value chosen")
    t1 = time.perf_counter()
    fps = ck.generated_fingerprints()  # pulls the mirror
    mirror_s = time.perf_counter() - t1
    prof = ck.profile()
    want_h = {2: HISTORIES_PAXOS2, 3: HISTORIES_PAXOS3}[clients]
    checks = {"launches": all(launches[k] > 0 for k in path_kernels),
              "histories": prof["h_n"] == prof["histories"] == want_h,
              "replay value chosen": bool(prop.condition(
                  model, path.last_state())),
              "fingerprints": len(fps) == ck.unique_state_count()}
    keys = ("engine", "syncs", "chunks", "iterations", "small_iterations",
            "grows", "capacity", "fmax", "seed_s", "loop_s", "sync_s",
            "capture_s", "captures", "graph_launches", "h_n", "histories",
            "pulls", "hgrow", "hgrow_s", "host_eval_s", "host_evals",
            "vmax", "dmax")
    unique = ck.unique_state_count()
    res = {"model": f"PackedPaxos({clients})", "options": opts,
           "target": target, "wall_s": wall, "unique": unique,
           "generated": ck.state_count(), "unique_per_s": unique / wall,
           "engine_wall_s": prof.get("wall_s"), "mirror_s": mirror_s,
           "witness_length": len(path),
           **{k: prof[k] for k in keys if k in prof},
           "max_memory_allocated": peak, "launches": launches,
           "checks": checks}
    return res, ck, fps


def paxos_kernels(device) -> dict:
    """The Paxos kernels at a mid-search 8,192-row PackedPaxos(3) step
    (phase ``kernels`` with ``model: PackedPaxos``): K1's paxos
    instantiation with K2/K3 lane for lane, its launch
    (``ops/_cuda.py`` ``wide_geometry``/``wide_smem_bytes``), its
    registers and spills; K8 in its cases and index mode; K9. K1's and
    K8's lines carry the parent tree's device ms as copied into
    ``PARENT_MS`` (``parent_device_ms_copied``), not measured here.
    Returns the checks."""
    from stateright_tpu_torch.examples.paxos_packed import PackedPaxos
    from stateright_tpu_torch.ops import _cuda

    model = PackedPaxos(3)
    carry = mid_search_carry(model, device, rows=8192)
    checks = {}
    step = check_step(model, carry, 8192, reps=10)
    geo = _cuda.tile_geometry(8192, model.max_actions,
                              _cuda.sm_count(device))
    wide = _cuda.wide_geometry(geo, 8192, model.max_actions,
                               _cuda.sm_count(device))
    usage = kernel_usage("fused_step", "expand_kernel[PaxosModel]")
    step.update(k1_launch={**wide._asdict(), "smem_bytes":
                           _cuda.wide_smem_bytes(wide, model.packed_width,
                                                 model.max_actions)},
                usage=usage,
                parent_device_ms_copied=PARENT_MS["expand_kernel"])
    step["checks"].update(
        k1_no_spill=bool(usage) and usage["spill_store_bytes"] == 0)
    if not all(step["checks"].values()):
        raise AssertionError(f"K1-paxos: {step['checks']}")
    checks["fused_step"] = step
    emit(phase="kernels", kernel="fused_step", model="PackedPaxos",
         params=list(model.cuda_spec()[1]), **step)
    checks["history"] = check_history(model, carry, 8192, reps=20)
    emit(phase="kernels", kernel="history", model="PackedPaxos",
         **checks["history"])
    checks["hpull"] = check_hpull(model, carry, reps=50)
    emit(phase="kernels", kernel="hpull", model="PackedPaxos",
         **checks["hpull"])
    return checks


def paxos_phase(device) -> dict:
    """Phase ``paxos``: PackedPaxos on the card end to end (see the
    module docstring). Returns the runs."""
    import torch

    from stateright_tpu_torch.examples.paxos_packed import PackedPaxos

    path = ("fused_step", "chunk_begin", "append", "history", "hpull")
    runs = {}
    for hcap in (1 << 16, 4):
        res, _ck, fps = paxos_run(2, path, hcap=hcap)
        res["digest"] = fp_digest(fps)
        res["checks"].update(
            unique=res["unique"] == PIN_PAXOS2[0],
            generated=res["generated"] == PIN_PAXOS2[1],
            digest=res["digest"] == PIN_PAXOS2[2],
            witness_length=res["witness_length"] == CHOSEN_LEN_PAXOS2)
        if hcap == 4:
            res["checks"]["history_grew"] = res.get("hgrow", 0) >= 1
        emit(phase="paxos", **res)
        runs["paxos2", hcap] = res
        del _ck, fps
    # the BASELINE workload at bench.py's size: the budget is the host's
    # generated count at dispatch, which lags one chunk under the
    # pipeline (as in the JAX package), so the run passes it
    res, _ck, _fps = paxos_run(3, path, target=PAXOS3_TARGET,
                               capacity=1 << 21)
    res["checks"].update(target=res["generated"] >= PAXOS3_TARGET,
                         unique_500k=res["unique"] >= 500_000)
    res["states_per_s"] = res["generated"] / res["wall_s"]
    del _ck, _fps
    # where its device time goes: the same run profiled
    prof = device_times(lambda: PackedPaxos(3).checker().gpu_options(
        race=False, capacity=1 << 21).target_state_count(
            PAXOS3_TARGET).spawn_gpu().join(), host_top=12)
    res["profile"] = prof
    emit(phase="paxos", workload="BASELINE paxos check 3", **res)
    runs["paxos3"] = res
    # the default entry point: raced against the host BFS, default options
    from stateright_tpu_torch.checker import race
    race.join_losers()
    t0 = time.perf_counter()
    ck = PackedPaxos(3).checker().target_state_count(
        PAXOS3_TARGET).spawn_gpu().join()
    wall = time.perf_counter() - t0
    ck.assert_no_discovery("linearizable")
    ck.assert_any_discovery("value chosen")
    raced = {"model": "PackedPaxos(3)", "raced": True,
             "target": PAXOS3_TARGET, "wall_s": wall,
             "engine": ck.profile().get("engine"),
             "unique": ck.unique_state_count(),
             "generated": ck.state_count(),
             "checks": {"decided": ck.profile().get("engine") is not None}}
    emit(phase="paxos", **raced)
    runs["paxos3_raced"] = raced
    del ck
    failed = [label for label, r in runs.items()
              if not all(r["checks"].values())]
    if failed:
        raise AssertionError(f"paxos phase: {failed}: "
                             f"{[runs[k]['checks'] for k in failed]}")
    torch.cuda.synchronize()
    return runs


def paxos_kernel_entries(checks: dict, runs: dict) -> list:
    """The ``kernels`` line's records of the Paxos path: K1's paxos
    instantiation (with K2/K3), K8 and K9, with their launches on the
    BASELINE run."""
    launches = runs["paxos3"]["launches"]
    step = checks["fused_step"]
    out = [{
        "name": "fused_step[paxos]", "route": "cuda",
        "source": "stateright_tpu_torch/csrc/fused_step.cu",
        "device_functions": "stateright_tpu_torch/csrc/paxos.cuh",
        "replaces": "stateright_tpu/ops/fused.py:259",
        "configuration": "probe=True", "model": "PackedPaxos(3)",
        "launches": launches["fused_step"],
        "max_abs_err": step["max_abs_err"], "ms": step["ms"],
        "device_ms": step["device_ms"], "plain_ms": step["plain_ms"],
        "bound_ms": step["bound_ms"], "bound_by": step["bound_by"],
        "library_ms": None, "parts": step["parts"],
        "k1": {"redesigned": "active lanes stepped into shared staging, "
                             "children copied coalesced, quiet lanes "
                             "copied from the row",
               "launch": step["k1_launch"],
               "usage": step["usage"]},
        "status": "ok"}]
    src = "stateright_tpu_torch/csrc/history.cu"
    for name, replaces in (
            ("history", "stateright_tpu/checker/device_loop.py:574"),
            ("hpull", "stateright_tpu/checker/tpu.py:2410")):
        r = checks[name]
        entry = {
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "model": "PackedPaxos(3)",
            "launches": launches[name], "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "device_ms": r["device_ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": None,
            "status": "ok"}
        if name == "history":
            entry.update(redesigned="a grid of lookups, the last block "
                         "inserting the absent rows in row order",
                         grid=r["grid"],
                         usage=r["usage"],
                         cases={lb: {k: c.get(k) for k in (
                             "fresh", "ms", "device_ms", "plain_ms")}
                             for lb, c in r["cases"].items()})
        out.append(entry)
    return out


def _abd(*args, **kwargs):
    from stateright_tpu_torch.examples.abd_packed import PackedAbd
    return PackedAbd(*args, **kwargs)


def _single_copy(*args):
    from stateright_tpu_torch.examples.single_copy_packed import \
        PackedSingleCopy
    return PackedSingleCopy(*args)


#: the register family's K1 checks (phase ``kernels`` with a ``model``
#: key), each at a step its configuration's run launches, gated as the
#: search launches it: the label, the model, its ``cuda_spec`` name, the
#: rows of the step and the rows pending at it. The full spaces of 544
#: and 564 states take the small step (256 rows, a few dozen pending);
#: the others ``auto_fmax``'s large step (1,728 rows at abd3's 260
#: words, 1,055 at tpu_abd2's 331, 9,954 at single-copy 3's 79, 9,475 at
#: single-copy 4's 83), every row pending but at single-copy 3, whose
#: large step launches with ~588 of its rows pending (the first such
#: step with at least 512); and single-copy 3 at 512 rows, all pending.
REGISTER_STEPS = (
    ("PackedAbd(2, ordered=True)", lambda: _abd(2, ordered=True),
     "abd_ordered", 256, 48),
    ("PackedAbd(3, server_count=2, ordered=True, channel_depth=8)",
     lambda: _abd(3, server_count=2, ordered=True, channel_depth=8),
     "abd_ordered", 1728, 1728),
    ("PackedAbd(2)", lambda: _abd(2), "abd", 256, 48),
    ("PackedAbd(2, server_count=3, ordered=True, channel_depth=8)",
     lambda: _abd(2, server_count=3, ordered=True, channel_depth=8),
     "abd_ordered", 1055, 1055),
    ("PackedSingleCopy(3)", lambda: _single_copy(3), "single_copy", 9954,
     512),
    ("PackedSingleCopy(3) at 512 rows", lambda: _single_copy(3),
     "single_copy", 512, 512),
    ("PackedSingleCopy(4)", lambda: _single_copy(4), "single_copy", 9475,
     9475),
)
#: the label of the widest register row (331 words), where K7, K8 and
#: K9 are checked too
WIDE_REGISTER = REGISTER_STEPS[3][0]
#: abd3's label (260-word rows), where K7 is checked too
ABD3_REGISTER = REGISTER_STEPS[1][0]
#: the redesigns of the register paths' kernels (the ``kernels`` line's
#: ``redesigned``)
REDESIGNED = {
    "abd": "each child built by a half-warp group with slot j of the "
           "network in lane j (consume by a shuffle, each send's match "
           "and rank by ballots, its insert by a shuffle), written "
           "straight to flat 16 consecutive words a store, each lane "
           "folding its own; only the pending rows stepped, spread over "
           "the grid in a gated launch; quiet lanes' rows unwritten",
    "single_copy": "as abd: the group-built child and the pending rows "
                   "spread over the grid",
    "abd_ordered": "the block's warps share the children (child c by "
                   "warp c % nwarps), each written from the edit's "
                   "columns in registers, 32 words a store; the "
                   "fingerprint from the row's folds with only the "
                   "changed words refolded; rows loaded block-wide",
    "append": "rows wider than 256 words on 128-lane tiles of 128 "
              "threads (the tiles outnumber the SMs), a warp per row, 32 "
              "words a store, 24 words in flight a lane",
    "write_once": "each active lane in two phases: A, a thread each, a "
                  "delivery's scalar part (the dispatch, the validity, "
                  "the history) into a record in shared memory, or a "
                  "crash or restart lane's edit and fingerprint (the "
                  "row's folds with its changed words refolded); B, "
                  "after a barrier, a half-warp each, the delivery's "
                  "child from its record with the network in its lanes, "
                  "or the crash child's words from the shared row; each "
                  "row's property bits and active lanes by a warp, a "
                  "lane a network slot",
    "paxos_crash": "the block's active list split, deliveries first, "
                   "each staged by a thread as K1-paxos's; each crash or "
                   "restart child's edit and fingerprint (the row's "
                   "folds with its changed words refolded) by a thread, "
                   "its words written from the shared row by a warp, 32 "
                   "a store; rows loaded block-wide, 8 words in flight a "
                   "thread; each row's property bits and active lanes by "
                   "a warp, a lane a network slot",
    "paxos_lossy": "each row's suffix folds by a warp (two lanes a "
                   "slot fold its words' change under a shift, then a "
                   "suffix XOR), so a drop child's fingerprint is one "
                   "lookup and its words a group of 8 lanes' copy from "
                   "the shared row as 16-byte vectors; the groups take "
                   "the drop children from a shared counter, starting "
                   "while other warps step the deliveries; no staged "
                   "edit, no barrier",
    "ping_pong": "off the thread-a-lane K1 onto the shared-row K1: rows "
                 "in shared memory, each row's bits and zero tail by a "
                 "warp; only the deliveries and drops before the zero "
                 "tail stepped, each delivery by a thread into its "
                 "staging row and copied by its warp 32 consecutive "
                 "words a store, each drop child as paxos_lossy's; the "
                 "other lanes' rows of flat unwritten",
    "timer_count": "off the thread-a-lane K1 onto its own path: only the "
                   "pending rows, each loaded into shared memory by a "
                   "group of 4 lanes, a lane a column, taking its "
                   "fingerprint folds, property bits and Timeout lanes "
                   "on the way; each active lane (timer bit set) by a "
                   "thread, its fingerprint the row's folds with the "
                   "count and timer words refolded, its edit posted to a "
                   "shared slot; the block's children then written as "
                   "one range of 16-byte vectors from the shared rows; "
                   "the delivery lane and clear Timeout lanes' rows of "
                   "flat unwritten"}
#: K1's model struct of each register instantiation (ptxas's name)
REGISTER_STRUCTS = {"abd_ordered": "AbdOrderedModel", "abd": "AbdModel",
                    "single_copy": "SingleCopyModel"}


def unordered_active(model):
    """A group model's rule (``csrc/abd.cuh`` ``AbdModel``,
    ``csrc/single_copy.cuh``): the lanes K1 writes are those below the
    row's quiet lane, the network's zero tail (``actor_net.cuh``
    ``zero_tail``)."""
    def active(frontier):
        import torch
        e = model.net_capacity
        slots = frontier[:, model._net_off:model._timer_off].reshape(
            -1, e, 4)
        live = (slots != 0).any(-1)
        quiet = (live * torch.arange(1, e + 1, device=frontier.device)
                 ).max(-1).values
        lanes = torch.arange(e, device=frontier.device)
        return (lanes[None, :] < quiet[:, None]).reshape(-1)
    return active


def active_rule(model, name):
    """The lanes K1's instantiation ``name`` writes a child for, by its
    model's rule (None: every lane, as ping-pong's lossless one)."""
    if name == "ping_pong" and not model.lossy_network_:
        return None
    return {"abd_ordered": ordered_active, "abd": unordered_active,
            "single_copy": unordered_active, "write_once": crash_active,
            "paxos_crash": crash_active, "paxos_lossy": lossy_active,
            "ping_pong": lossy_active, "timer_count": timer_active}.get(
                name, lambda _m: None)(model)


def ordered_active(model):
    """The edit model's rule (``csrc/abd.cuh`` ``AbdOrderedModel``): the
    lanes K1 writes are those whose channel holds a message."""
    def active(frontier):
        lens = frontier[:, model._net_off:model._net_off + model._n_chan]
        return (lens != 0).reshape(-1)
    return active


def register_kernels(device) -> tuple:
    """The register family's K1 instantiations at a mid-search step of
    each ``REGISTER_STEPS`` configuration, timed, with their launch,
    registers and spills; at the widest row (331 words) K7 (after a real
    gated step), K8 and K9 against their plain versions, and at abd3's
    (260 words) K7. Returns
    the checks by label and the K1 checks' plain halves
    (:func:`register_plain`), which run at the end of the script."""
    from stateright_tpu_torch.ops import _cuda

    checks, plain = {}, []
    sms = _cuda.sm_count(device)
    for label, make, name, rows, pending in REGISTER_STEPS:
        model = make()
        carry = mid_search_carry(model, device, rows=rows, pending=pending)
        finish = check_step(model, carry, rows, reps=10,
                            active=active_rule(model, name), defer=True,
                            gated=True)
        geo = _cuda.tile_geometry(rows, model.max_actions, sms)
        wide, smem = _cuda.k1_launch(name, geo, rows, model.packed_width,
                                     model.max_actions, sms)
        usage = kernel_usage("fused_step",
                             f"expand_kernel[{REGISTER_STRUCTS[name]}]")
        meta = {"width": model.packed_width, "actions": model.max_actions,
                "pending": min(int(carry.q_tail - carry.q_head), rows),
                "k1_launch": {**wide._asdict(), "smem_bytes": smem},
                "usage": usage}
        checks[label] = {}
        row_checks = (
            ("append", lambda: check_append(model, carry, rows, reps=10)),
            ("history", lambda: check_history(model, carry, rows,
                                              reps=10)),
            ("hpull", lambda: check_hpull(model, carry, reps=20)))
        if label in (WIDE_REGISTER, ABD3_REGISTER):
            for kernel, fn in row_checks[:3 if label == WIDE_REGISTER
                                         else 1]:
                r = fn()
                checks[label][kernel] = r
                emit(phase="kernels", kernel=kernel, model=label, **r)
        plain.append((label, model, name, meta, finish))
        del carry
    return checks, plain


def register_plain(checks: dict, plain: list) -> None:
    """The plain halves of :func:`register_kernels`' K1 checks: each
    plain version on its step's inputs, held against the kernel's
    outputs, into ``checks``. They run after every trace of the script:
    at 1,055 rows (tpu_abd2) and 9,954 (single-copy 3) they take tens of
    seconds (the plain version walks blocks whose rows divide the step:
    5 x 211 and 2 x 4,977), and the traces taken after such a wait lose
    their device time."""
    for label, model, name, meta, finish in plain:
        step = finish()
        step.update(meta)
        usage = meta["usage"]
        step["checks"].update(
            k1_no_spill=bool(usage) and usage["spill_store_bytes"] == 0)
        if not all(step["checks"].values()):
            raise AssertionError(f"K1-{name} {label}: {step['checks']}")
        checks[label]["fused_step"] = step
        emit(phase="kernels", kernel="fused_step", model=label,
             instantiation=name, params=list(model.cuda_spec()[1]), **step)


def register_run(model, path_kernels, want=None, holds=(), found=(),
                 target=None, race=False, sound=False, **opts) -> tuple:
    """One check of a register model through the user entry point,
    every launch count set to 0 before it: on the card alone
    (``race=False``: each of ``path_kernels`` must have launched) or
    raced as by default (``race=None``: no options); ``want`` = (unique,
    state_count, digest) pins the answer; the properties in ``holds``
    have no discovery; each of ``found`` has one whose witness replays
    through the host model to a state where the property's condition
    says it should end (a ``linearizable`` counterexample's history has
    no serialization); ``sound`` asks for ``sound_eventually()``. Returns
    its measurements and the checker."""
    import torch

    from stateright_tpu_torch.core import Expectation
    from stateright_tpu_torch.ops import _cuda

    # a raced run's loser may still be capturing its chunk's graph on
    # its own thread: wait for it before synchronizing the card
    zero_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    builder = model.checker()
    if sound:
        builder = builder.sound_eventually()
    if race is not None:
        builder = builder.gpu_options(race=race, **opts)
    if target is not None:
        builder = builder.target_state_count(target)
    t0 = time.perf_counter()
    ck = builder.spawn_gpu().join()
    wall = time.perf_counter() - t0
    launches = dict(_cuda.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    prof = ck.profile()
    checks = {}
    if race is False:
        checks["launches"] = all(launches[k] > 0 for k in path_kernels)
    digest = None
    if want is not None:
        digest = fp_digest(ck.generated_fingerprints())
        checks.update(unique=ck.unique_state_count() == want[0],
                      generated=ck.state_count() == want[1],
                      digest=digest == want[2])
    for name in holds:
        ck.assert_no_discovery(name)
        checks[f"holds {name}"] = True
    witness = {}
    for name in found:
        path = ck.assert_any_discovery(name)  # replays or raises
        prop = model.property(name)
        checks[f"replay {name}"] = prop.condition(
            model, path.last_state()) == (
                prop.expectation == Expectation.SOMETIMES)
        if name == "linearizable":
            checks["no serialization"] = \
                path.last_state().history.serialized_history() is None
        witness[name] = len(path)
    keys = ("engine", "syncs", "chunks", "iterations", "small_iterations",
            "grows", "capacity", "fmax", "seed_s", "loop_s", "sync_s",
            "capture_s", "captures", "graph_launches", "h_n", "histories",
            "pulls", "hgrow", "host_eval_s", "host_evals", "vmax", "dmax")
    label = (f"{type(model).__name__}"
             f"({', '.join(str(p) for p in model.cache_key()[1:])})")
    res = {"model": label, "raced": race is None, "options": opts,
           "target": target, "wall_s": wall,
           "unique": ck.unique_state_count(), "generated": ck.state_count(),
           "unique_per_s": ck.unique_state_count() / wall,
           "digest": digest, "witness_length": witness,
           **{k: prof[k] for k in keys if k in prof},
           "max_memory_allocated": peak, "launches": launches,
           "checks": checks}
    return res, ck


def registers_phase() -> dict:
    """Phase ``registers``: the register family on the card end to end
    (see the module docstring). Returns the runs by label."""
    import torch

    from stateright_tpu_torch.examples.abd_packed import PackedAbd
    from stateright_tpu_torch.examples.single_copy_packed import \
        PackedSingleCopy

    path = ("fused_step", "chunk_begin", "append", "history", "hpull")
    lin, chosen = "linearizable", "value chosen"
    runs = {}

    def record(key, res, **extra):
        res.update(extra)
        emit(phase="registers", **res)
        runs[key] = res
        if not all(res["checks"].values()):
            raise AssertionError(f"registers {key}: {res['checks']}")

    res, _ck = register_run(PackedAbd(2, ordered=True), path,
                            want=PIN_ABD2_ORDERED, holds=(lin,),
                            found=(chosen,))
    record("abd2_ordered", res,
           workload="BASELINE linearizable-register check 2 ordered")
    abd3 = dict(server_count=2, ordered=True, channel_depth=8)
    res, _ck = register_run(PackedAbd(3, **abd3), path, want=PIN_ABD3,
                            holds=(lin,), found=(chosen,))
    del _ck
    # where its device time goes: the same run profiled
    res["profile"] = device_times(lambda: PackedAbd(3, **abd3).checker()
                                  .gpu_options(race=False).spawn_gpu()
                                  .join(), host_top=8)
    record("abd3", res, workload="bench.py tpu_abd3")
    res, _ck = register_run(PackedAbd(2), path, want=PIN_ABD2,
                            holds=(lin,), found=(chosen,))
    record("abd2", res)
    res, _ck = register_run(PackedSingleCopy(3), path, want=PIN_SC3,
                            holds=(lin,), found=(chosen,))
    record("single_copy3", res,
           workload="BASELINE single-copy-register check 3")
    # the counterexample: raced as by default, and on the card alone
    for race in (None, False):
        res, _ck = register_run(PackedSingleCopy(4, 2), path,
                                found=(lin,), race=race)
        record(("single_copy42", race), res,
               workload="bench.py race_single_copy")
    # bench.py's widest row, bounded as there
    res, _ck = register_run(
        PackedAbd(2, server_count=3, ordered=True, channel_depth=8), path,
        holds=(lin,), target=ABD2_TARGET, capacity=1 << 21)
    res["checks"]["target"] = res["generated"] >= ABD2_TARGET
    record("abd2_s3", res, workload="bench.py tpu_abd2 (bounded)")
    del _ck
    torch.cuda.synchronize()
    return runs


def register_kernel_entries(checks: dict, runs: dict) -> list:
    """The ``kernels`` line's records of K1's register instantiations,
    each with its launches on its configuration's run (``abd_ordered``:
    the full abd3 run; ``abd``: PackedAbd(2); ``single_copy``:
    PackedSingleCopy(3)) and its checks by configuration; the
    ``abd_ordered`` headline is abd3's."""
    from stateright_tpu_torch.ops import _cuda

    main_of = {"abd_ordered": ("PackedAbd(3, server_count=2, ordered=True, "
                               "channel_depth=8)", "abd3"),
               "abd": ("PackedAbd(2)", "abd2"),
               "single_copy": ("PackedSingleCopy(3)", "single_copy3")}
    instantiation = {lb: n for lb, _, n, *_ in REGISTER_STEPS}
    out = []
    for name, (label, run) in main_of.items():
        by = {lb: c["fused_step"] for lb, c in checks.items()
              if instantiation[lb] == name}
        main = by[label]
        out.append({
            "name": f"fused_step[{name}]", "route": "cuda",
            "source": "stateright_tpu_torch/csrc/fused_step.cu",
            "device_functions": "stateright_tpu_torch/csrc/"
                                + ("single_copy.cuh" if name == "single_copy"
                                   else "abd.cuh"),
            "replaces": "stateright_tpu/ops/fused.py:259",
            "configuration": "probe=True", "model": label,
            "launches": runs[run]["launches"]["fused_step"],
            "max_abs_err": max(r["max_abs_err"] for r in by.values()),
            "ms": main["ms"], "device_ms": main["device_ms"],
            "plain_ms": main["plain_ms"],
            # a group K1 steps the pending rows only: the least work is
            # theirs (with every lane's flags and every row's terminal)
            **({"bound_ms": main["pending_bound"]["bound_ms"],
                "bound_by": main["pending_bound"]["bound_by"],
                "bound_of": "the pending rows"}
               if _cuda.pending_rows(name) else
               {"bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
                "bound_of": "every row"}),
            "library_ms": None,
            "by_model": {lb: {k: r[k] for k in (
                "f", "pending", "width", "lanes", "written", "ms",
                "device_ms", "plain_ms", "bound_ms", "bound_by",
                "max_abs_err", "pending_bound",
                "k1_launch", "usage", "parts")} for lb, r in by.items()},
            "status": "ok"})
        if name in REDESIGNED:
            out[-1]["redesigned"] = REDESIGNED[name]
    return out


def _write_once(*args, crashes=1, **kwargs):
    from stateright_tpu_torch.examples.write_once_packed import \
        PackedWriteOnce
    return PackedWriteOnce(*args, **kwargs).crash_restart(crashes,
                                                           actors=[0])


def _paxos_crash(clients):
    from stateright_tpu_torch.examples.paxos_packed import PackedPaxos
    return PackedPaxos(clients).crash_restart(1, actors=[0, 1, 2])


#: the crash lanes' K1 checks (phase ``kernels`` with a ``model`` key),
#: as REGISTER_STEPS: the label, the model, its ``cuda_spec`` name, the
#: rows of the step and the rows pending at it. PackedWriteOnce(7)'s
#: levels hold at most 1,526 states: its run takes the 256-row small
#: step (at ~200 pending: its fourth level) and the large 7,281-row one
#: (an odd size: the plain version walks it a row at a time, minutes);
#: the fullest step is checked at 1,024 rows, all pending.
CRASH_STEPS = (
    ("PackedWriteOnce(7, net_capacity=16).crash_restart(2, actors=[0])",
     lambda: _write_once(7, net_capacity=16, crashes=2), "write_once", 256,
     200),
    ("PackedWriteOnce(7, net_capacity=16).crash_restart(2, actors=[0]) "
     "at 1,024 rows", lambda: _write_once(7, net_capacity=16, crashes=2),
     "write_once", 1024, 1024),
    ("PackedPaxos(3).crash_restart(1, actors=[0, 1, 2])",
     lambda: _paxos_crash(3), "paxos_crash", 8192, 8192),
)
#: K1's model struct of each crash instantiation, and of the parent's
#: instantiations whose registers are reported beside them (ptxas's name)
CRASH_STRUCTS = {"write_once": "WriteOnceModel",
                 "paxos_crash": "PaxosCrashModel"}
PARENT_STRUCTS = {"paxos": "PaxosModel", "abd": "AbdModel",
                  "single_copy": "SingleCopyModel",
                  "abd_ordered": "AbdOrderedModel"}


def _below_zero_tail(model, frontier):
    """``(slots, below)``: each row's network slots (int64 ``[f, E,
    slot words]``: 4 for the register models, 3 for PingPong) and which
    lie before its zero tail (``actor_net.cuh`` ``zero_tail``), bool
    ``[f, E]``."""
    import torch
    dev = frontier.device
    f, e = frontier.shape[0], model.net_capacity
    slots = frontier[:, model._net_off:model._timer_off].reshape(
        f, e, model._sw).to(torch.int64) & 0xFFFFFFFF
    live = (slots != 0).any(-1)
    quiet = (live * torch.arange(1, e + 1, device=dev)).max(-1).values
    return slots, torch.arange(e, device=dev)[None, :] < quiet[:, None]


def lossy_active(model):
    """The active-lane rule of an actor model with drop or Timeout
    lanes: the deliveries and (lossy) the drops of the slots before the
    network's zero tail (``csrc/actor_net.cuh`` ``drop_active_lanes``),
    then the Timeout lanes of the actors whose timer bit is set. Every
    other lane's child is invalid and does not overflow. K1-paxos_lossy
    and the lossy K1-ping_pong write the active lanes' children only;
    K1-timer_count writes fewer still (:func:`timer_active`)."""
    def active(frontier):
        import torch
        below = _below_zero_tail(model, frontier)[1]
        lanes = [below] * (2 if model.lossy_network_ else 1)
        if model.device_timers:
            n = len(model.actor_widths)
            tw = frontier[:, model._timer_off].to(torch.int64) & 0xFFFFFFFF
            bits = torch.arange(n, device=frontier.device)
            lanes.append(((tw[:, None] >> bits) & 1) != 0)
        return torch.cat(lanes, dim=1).reshape(-1)
    return active


def timer_active(model):
    """The active-lane rule of K1's timer instantiation
    (``csrc/timer_count.cuh``, ``step_common.cuh`` ``TimerRow``): the
    Timeout lanes of the actors whose timer bit is set, the lanes of
    :func:`lossy_active` but the delivery, whose child the timer-count
    fixture never takes (its actors take no message). K1-timer_count
    writes these lanes' children only."""
    def active(frontier):
        rule = lossy_active(model)(frontier).reshape(frontier.shape[0], -1)
        rule[:, :model.net_capacity] = False
        return rule.reshape(-1)
    return active


def crash_active(model):
    """The active-lane rule of an instantiation with crash lanes
    (``csrc/actor_net.cuh`` ``crash_active_lanes``): the deliveries below
    the network's zero tail to a recipient that is up, the crash lanes of
    actors up with fewer than ``max_crashes_`` crashes, the restart lanes
    of actors down. K1 writes those lanes' children only; every other
    lane is invalid and does not overflow."""
    def active(frontier):
        import torch
        dev = frontier.device
        slots, below = _below_zero_tail(model, frontier)
        if not model.max_crashes_:
            return below.reshape(-1)
        cw = frontier[:, model._crash_off].to(torch.int64) & 0xFFFFFFFF
        last = len(model.actor_widths) - 1
        to = torch.clamp(slots[:, :, 0] & 0xFF, max=last)
        up = ((cw[:, None] >> (4 * to + 3)) & 1) == 0
        idx = torch.from_numpy(model._crash_idx.astype("int64")).to(dev)
        down = ((cw[:, None] >> (4 * idx + 3)) & 1) != 0
        count = (cw[:, None] >> (4 * idx)) & 7
        return torch.cat([below & up, ~down & (count < model.max_crashes_),
                          down], dim=1).reshape(-1)
    return active


def crash_kernels(device) -> tuple:
    """K1's crash instantiations at the ``CRASH_STEPS``, gated, timed,
    with their launch, registers and spills, and the registers of the
    parent's K1 instantiations; returns the checks by label and their
    plain halves (:func:`register_plain`, which runs them last)."""
    from stateright_tpu_torch.ops import _cuda

    checks, plain = {}, []
    sms = _cuda.sm_count(device)
    for label, make, name, rows, pending in CRASH_STEPS:
        model = make()
        carry = mid_search_carry(model, device, rows=rows, pending=pending)
        finish = check_step(model, carry, rows, reps=10,
                            active=crash_active(model), defer=True,
                            gated=True)
        geo = _cuda.tile_geometry(rows, model.max_actions, sms)
        wide, smem = _cuda.k1_launch(name, geo, rows, model.packed_width,
                                     model.max_actions, sms)
        usage = kernel_usage("fused_step",
                             f"expand_kernel[{CRASH_STRUCTS[name]}]")
        meta = {"width": model.packed_width, "actions": model.max_actions,
                "pending": min(int(carry.q_tail - carry.q_head), rows),
                "k1_launch": {**wide._asdict(), "smem_bytes": smem},
                "usage": usage,
                "parent_usage": {n: kernel_usage(
                    "fused_step", f"expand_kernel[{s}]")
                    for n, s in PARENT_STRUCTS.items()}}
        checks[label] = {}
        plain.append((label, model, name, meta, finish))
        del carry
    return checks, plain


def crash_phase() -> dict:
    """Phase ``crash``: crash/restart fault injection on the card end to
    end (see the module docstring). Returns the runs by label."""
    import torch

    from stateright_tpu_torch.actor.model import Crash

    path = ("fused_step", "chunk_begin", "append", "history", "hpull")
    lin, chosen = "linearizable", "value chosen"
    runs = {}

    def record(key, res, **extra):
        res.update(extra)
        emit(phase="crash", **res)
        runs[key] = res
        if not all(res["checks"].values()):
            raise AssertionError(f"crash {key}: {res['checks']}")

    res, _ck = register_run(_write_once(2), path, want=PIN_WO2,
                            holds=(lin,), found=(chosen,))
    record("write_once2", res)
    # the lost acknowledged write: raced as by default, and the card alone
    for race in (None, False):
        res, ck = register_run(_write_once(2, durable=False), path,
                               found=(lin,), race=race)
        actions = ck.assert_any_discovery(lin).into_actions()
        res["checks"]["witness_crash"] = any(isinstance(a, Crash)
                                             for a in actions)
        record(("write_once2_volatile", race), res,
               witness_actions=[type(a).__name__ for a in actions])
        del ck
    res, _ck = register_run(_write_once(7, net_capacity=16, crashes=2), path,
                            want=PIN_WO7, holds=(lin,), found=(chosen,))
    record("write_once7", res)
    res, _ck = register_run(_paxos_crash(1), path, want=PIN_PAXOS1_CRASH,
                            holds=(lin,), found=(chosen,))
    record("paxos1", res)
    del _ck
    # the BASELINE workload under crashes, bounded as the BASELINE run
    res, _ck = register_run(_paxos_crash(3), path, holds=(lin,),
                            found=(chosen,), target=PAXOS3_TARGET,
                            capacity=1 << 21)
    res["checks"]["target"] = res["generated"] >= PAXOS3_TARGET
    del _ck
    res["profile"] = device_times(lambda: _paxos_crash(3).checker()
                                  .gpu_options(race=False, capacity=1 << 21)
                                  .target_state_count(PAXOS3_TARGET)
                                  .spawn_gpu().join(), host_top=8)
    record("paxos3", res, workload="BASELINE paxos check 3 under "
           "crash_restart(1, actors=[0, 1, 2]), bounded")
    torch.cuda.synchronize()
    return runs


def _paxos_lossy(clients):
    from stateright_tpu_torch.examples.paxos_packed import PackedPaxos
    return PackedPaxos(clients).lossy_network(True)


def _ping_pong(max_nat, lossy=True, duplicating=True):
    from stateright_tpu_torch.actor.test_util import PackedPingPong
    return PackedPingPong(max_nat, lossy=lossy, duplicating=duplicating)


def _timer_count(n, max_nat):
    from stateright_tpu_torch.actor.test_util import PackedTimerCount
    return PackedTimerCount(n, max_nat)


#: the lossy and timer K1 checks (phase ``kernels`` with a ``model``
#: key), as CRASH_STEPS: the label, the model, its ``cuda_spec`` name,
#: the rows of the step and the rows pending at it. PingPong(7)'s widest
#: level holds 10,220 states and TimerCount(8, 4)'s 38,165: both steps
#: are full. The non-duplicating PingPong(7) (30 states) runs the
#: consume and the count bump of the same instantiation, at its widest
#: level of 2 rows; the lossless PingPong(7) (every level 1 row) runs
#: ping-pong's lossless instantiation, on both networks; TimerCount(8, 4)
#: also at its run's small step (256 rows, 8 pending after the first
#: level).
LOSSY_STEPS = (
    ("PackedPaxos(2).lossy_network(True)", lambda: _paxos_lossy(2),
     "paxos_lossy", 8192, 8192),
    ("PackedPingPong(7, lossy=True, duplicating=True)",
     lambda: _ping_pong(7), "ping_pong", 8192, 8192),
    ("PackedPingPong(7, lossy=True, duplicating=False)",
     lambda: _ping_pong(7, duplicating=False), "ping_pong", 2, 2),
    ("PackedTimerCount(8, 4)", lambda: _timer_count(8, 4), "timer_count",
     8192, 8192),
    ("PackedPingPong(7, lossy=False, duplicating=True)",
     lambda: _ping_pong(7, lossy=False), "ping_pong", 1, 1),
    ("PackedPingPong(7, lossy=False, duplicating=False)",
     lambda: _ping_pong(7, lossy=False, duplicating=False), "ping_pong",
     1, 1),
    ("PackedTimerCount(8, 4) at 256 rows", lambda: _timer_count(8, 4),
     "timer_count", 256, 2),
)


def lossy_struct(name: str, model) -> str:
    """K1's model struct of instantiation ``name`` of phase ``lossy``
    for ``model``: ping-pong's lossy one (the wide K1 with drop lanes) or
    its lossless one (the narrow K1, ``csrc/fused_step.cu``
    ``srt_fused_step_ping_pong``)."""
    if name == "ping_pong":
        return ("PingPongLossyModel" if model.lossy_network_
                else "PingPongModel")
    return {"paxos_lossy": "PaxosLossyModel",
            "timer_count": "TimerCountModel"}[name]


#: the registers a thread of every other K1 instantiation takes (ptxas,
#: the parent tree's build on an H100), which the drop lanes' and the
#: shared-row path's redesigns must leave as they are, and K1-timer_count
#: on its own path (``step_common.cuh`` ``TimerRow``; the narrow K1 it
#: replaced took 134)
REGISTERS = {"PaxosModel": 168, "AbdModel": 96, "SingleCopyModel": 121,
             "AbdOrderedModel": 96, "PaxosCrashModel": 164,
             "WriteOnceModel": 72, "TimerCountModel": 47,
             "PingPongModel": 122}


def lossy_kernels(device) -> tuple:
    """K1's lossy and timer instantiations at the ``LOSSY_STEPS``,
    gated, timed, with their launch, registers and spills, and the
    registers of every earlier K1 instantiation (held to ``REGISTERS``,
    no spill); returns the checks by label and their plain halves
    (:func:`register_plain`, which runs them last)."""
    from stateright_tpu_torch.ops import _cuda

    earlier = {n: kernel_usage("fused_step", f"expand_kernel[{n}]")
               for n in REGISTERS}
    same = {n: bool(u) and u["registers"] == REGISTERS[n]
            and u["spill_store_bytes"] == 0 for n, u in earlier.items()}
    emit(phase="kernels", kernel="fused_step", registers_of=earlier,
         registers_before=REGISTERS, unchanged=same)
    if not all(same.values()):
        raise AssertionError(f"earlier K1 registers changed: {earlier}")
    checks, plain = {}, []
    sms = _cuda.sm_count(device)
    for label, make, name, rows, pending in LOSSY_STEPS:
        model = make()
        carry = mid_search_carry(model, device, rows=rows, pending=pending)
        # the drop lanes' instantiations (K1-paxos_lossy, the lossy
        # K1-ping_pong) and K1-timer_count write their active lanes only;
        # the lossless K1-ping_pong writes and is held on every lane, its
        # bound counting the lanes the step needs
        rule = active_rule(model, name)
        finish = check_step(model, carry, rows, reps=10, active=rule,
                            needed=None if rule else lossy_active(model),
                            defer=True, gated=True)
        geo = _cuda.tile_geometry(rows, model.max_actions, sms)
        wide, smem = _cuda.k1_launch(name, geo, rows, model.packed_width,
                                     model.max_actions, sms,
                                     model.cuda_spec()[1])
        usage = kernel_usage("fused_step",
                             f"expand_kernel[{lossy_struct(name, model)}]")
        meta = {"width": model.packed_width, "actions": model.max_actions,
                "pending": min(int(carry.q_tail - carry.q_head), rows),
                "k1_launch": ({**wide._asdict(), "smem_bytes": smem}
                              if smem else geo._asdict()),
                "usage": usage, "parent_usage": earlier}
        checks[label] = {}
        plain.append((label, model, name, meta, finish))
        del carry
    return checks, plain


def lossy_phase() -> dict:
    """Phase ``lossy``: the lossy drop lanes, the duplicating network and
    the device timers on the card end to end (see the module docstring).
    Returns the runs by label."""
    import torch

    from stateright_tpu_torch.actor import Drop, Envelope, Id
    from stateright_tpu_torch.actor.test_util import Ping

    chunk = ("fused_step", "chunk_begin", "append")
    hist = chunk + ("history", "hpull")
    lin, chosen = "linearizable", "value chosen"
    runs = {}

    def record(key, res, **extra):
        res.update(extra)
        emit(phase="lossy", **res)
        runs[key] = res
        if not all(res["checks"].values()):
            raise AssertionError(f"lossy {key}: {res['checks']}")

    res, _ck = register_run(_paxos_lossy(2), hist, want=PIN_PAXOS2_LOSSY,
                            holds=(lin,), found=(chosen,))
    del _ck
    res["profile"] = device_times(lambda: _paxos_lossy(2).checker()
                                  .gpu_options(race=False).spawn_gpu()
                                  .join(), host_top=8)
    record("paxos2", res)
    res, _ck = register_run(_paxos_lossy(1), hist, want=PIN_PAXOS1_LOSSY,
                            holds=(lin,), found=(chosen,))
    record("paxos1", res)
    must = "must reach max"
    canonical = [Drop(Envelope(src=Id(0), dst=Id(1), msg=Ping(0)))]
    for n, want in ((5, PIN_PING5), (7, PIN_PING7)):
        res, ck = register_run(_ping_pong(n), chunk, want=want,
                               holds=("delta within 1",),
                               found=(must, "can reach max"))
        actions = ck.assert_any_discovery(must).into_actions()
        res["checks"]["witness_drop"] = any(isinstance(a, Drop)
                                            for a in actions)
        ck.assert_discovery(must, canonical)  # raises unless it holds
        res["checks"]["canonical_drop_witness"] = True
        record(f"ping_pong{n}", res,
               witness_actions=[type(a).__name__ for a in actions])
        del ck
    res, ck = register_run(_ping_pong(5, lossy=False, duplicating=False),
                           chunk, want=PIN_PING5_LOSSLESS,
                           holds=("delta within 1", must),
                           found=("can reach max",))
    record("ping_pong5_lossless", res)
    res, ck = register_run(_timer_count(3, 2), chunk, want=PIN_TIMER3,
                           holds=("bounded",), found=("all max",))
    record("timer_count3", res)
    res, ck = register_run(_timer_count(8, 4), chunk, want=PIN_TIMER8,
                           holds=("bounded",), found=("all max",))
    record("timer_count8", res)
    del ck
    torch.cuda.synchronize()
    return runs


def lossy_kernel_entries(checks: dict, runs: dict) -> list:
    """The ``kernels`` line's records of K1's lossy and timer
    instantiations, each with its launches on its configuration's run
    (``paxos_lossy``: lossy PackedPaxos(2); ``ping_pong``: PingPong(7),
    duplicating; ``timer_count``: TimerCount(8, 4)) and its checks by
    model."""
    main_of = {"paxos_lossy": (LOSSY_STEPS[0][0], "paxos2", "paxos.cuh"),
               "ping_pong": (LOSSY_STEPS[1][0], "ping_pong7",
                             "ping_pong.cuh"),
               "timer_count": (LOSSY_STEPS[3][0], "timer_count8",
                               "timer_count.cuh")}
    instantiation = {lb: n for lb, _, n, *_ in LOSSY_STEPS}
    lanes_of = {"paxos_lossy": "stateright_tpu/actor/packed.py:790",
                "ping_pong": "stateright_tpu/actor/packed.py:790",
                "timer_count": "stateright_tpu/actor/packed.py:806"}
    out = []
    for name, (label, run, header) in main_of.items():
        by = {lb: c["fused_step"] for lb, c in checks.items()
              if instantiation[lb] == name}
        main = by[label]
        out.append({
            "name": f"fused_step[{name}]", "route": "cuda",
            "source": "stateright_tpu_torch/csrc/fused_step.cu",
            "device_functions": f"stateright_tpu_torch/csrc/{header}",
            "replaces": "stateright_tpu/ops/fused.py:259",
            "lanes_of": lanes_of[name],
            "configuration": "probe=True", "model": label,
            "launches": runs[run]["launches"]["fused_step"],
            "max_abs_err": max(r["max_abs_err"] for r in by.values()),
            "ms": main["ms"], "device_ms": main["device_ms"],
            "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": None,
            **({"redesigned": REDESIGNED[name]} if name in REDESIGNED
               else {}),
            **{k: main[k] for k in (
                "f", "pending", "width", "lanes", "written", "k1_launch",
                "usage", "parts")},
            "by_model": {lb: {k: r[k] for k in (
                "f", "pending", "width", "lanes", "written", "ms",
                "device_ms", "plain_ms", "bound_ms", "bound_by",
                "max_abs_err", "k1_launch", "usage")}
                for lb, r in by.items()},
            "status": "ok"})
    return out


def crash_kernel_entries(checks: dict, runs: dict) -> list:
    """The ``kernels`` line's records of K1's crash instantiations, each
    with its launches on its configuration's run (``write_once``: the
    PackedWriteOnce(7) run; ``paxos_crash``: the bounded PackedPaxos(3)
    run) and the parent's K1 registers beside its own."""
    from stateright_tpu_torch.ops import _cuda

    main_of = {"write_once": (CRASH_STEPS[1][0], "write_once7"),
               "paxos_crash": (CRASH_STEPS[2][0], "paxos3")}
    instantiation = {lb: n for lb, _, n, *_ in CRASH_STEPS}
    out = []
    for name, (label, run) in main_of.items():
        by = {lb: c["fused_step"] for lb, c in checks.items()
              if instantiation[lb] == name}
        main = by[label]
        pend = _cuda.pending_rows(name)
        out.append({
            "name": f"fused_step[{name}]", "route": "cuda",
            "source": "stateright_tpu_torch/csrc/fused_step.cu",
            "device_functions": "stateright_tpu_torch/csrc/"
                                + ("write_once.cuh" if name == "write_once"
                                   else "paxos.cuh"),
            "replaces": "stateright_tpu/ops/fused.py:259",
            "lanes_of": "stateright_tpu/actor/packed.py:849",
            "configuration": "probe=True", "model": label,
            "launches": runs[run]["launches"]["fused_step"],
            "max_abs_err": max(r["max_abs_err"] for r in by.values()),
            "ms": main["ms"], "device_ms": main["device_ms"],
            "plain_ms": main["plain_ms"],
            **({"bound_ms": main["pending_bound"]["bound_ms"],
                "bound_by": main["pending_bound"]["bound_by"],
                "bound_of": "the pending rows"}
               if pend else
               {"bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
                "bound_of": "every row"}),
            "library_ms": None,
            "redesigned": REDESIGNED[name],
            "parent_usage": main["parent_usage"],
            "by_model": {lb: {k: r[k] for k in (
                "f", "pending", "width", "lanes", "written", "ms",
                "device_ms", "plain_ms", "bound_ms", "bound_by",
                "max_abs_err", "pending_bound", "k1_launch", "usage",
                "parts")} for lb, r in by.items()},
            "status": "ok"})
    return out


def model_kernel_entries(steps: dict, runs: dict) -> list:
    """The ``kernels`` line's records of K1's new instantiations: each
    step kernel by model, with its launches on its model's run (the
    single-chip runs for ``fused_step[_sym]``, the sharded ones for
    ``fused_step_noprobe[_sym]``)."""
    fused_src = "stateright_tpu_torch/csrc/fused_step.cu"
    sharded_src = "stateright_tpu_torch/csrc/sharded_step.cu"
    runs_of = {
        ("fused_step", "increment_lock"): runs["increment_lock"],
        ("fused_step", "lineq"): runs["lineq"],
        ("fused_step", "increment"): runs["increment", 16],
        ("fused_step_sym", "increment"): runs["increment_sym", 16],
        ("fused_step_noprobe", "increment_lock"):
            runs["sharded increment_lock"],
        ("fused_step_noprobe", "lineq"): runs["sharded lineq"],
        ("fused_step_noprobe", "increment"): runs["sharded increment"],
        ("fused_step_noprobe_sym", "increment"):
            runs["sharded increment_sym"],
    }
    out = []
    for (kernel, label), run in runs_of.items():
        by_f = {f: r for (k, lab, f), r in steps.items()
                if k == kernel and lab == label}
        main = by_f[max(by_f)]
        probe = kernel in ("fused_step", "fused_step_sym")
        out.append({
            "name": f"{kernel}[{label}]", "route": "cuda",
            "source": fused_src if probe else sharded_src,
            "replaces": "stateright_tpu/ops/fused.py:259",
            "configuration": ("symmetry=True, " if "sym" in kernel else "")
            + ("probe=True" if probe else "probe=False (sharded step)"),
            "model": run["model"],
            "launches": run["launches"][kernel],
            "max_abs_err": max(r["max_abs_err"] for r in by_f.values()),
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": None,
            "by_rows": {f"f={f}": {k: r[k] for k in (
                "ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
                "max_abs_err", "parts")} for f, r in by_f.items()},
            "status": "ok"})
    return out


#: the runs of ``--ranks``: (exchange, 2pc n or "lock8" for
#: IncrementLock(8), complete symmetry or None)
# --- the staged step (phase ``staged``) ------------------------------------

STAGED_SRC = "stateright_tpu_torch/csrc/staged.cu"
#: the staged step's kernels on the card, with their wrappers' launch
#: counters and the JAX code each replaces
STAGED_KERNELS = {
    "stage": "stateright_tpu/checker/device_loop.py:398",
    "predup": "stateright_tpu/ops/expand.py:122",
    "staged_append": "stateright_tpu/checker/device_loop.py:522",
}
#: the staged chunk's path on the card: K1 alone, KS1-KS3 with K4 and the
#: chunk's start (K8 and K9 with a history stage); never K2/K3 or K7
STAGED_PATH = ("expand", "stage", "predup", "table_insert",
               "staged_append", "chunk_begin")
FUSED_ONLY = ("fused_step", "append")


def _int_err(a, b) -> int:
    """The largest absolute difference of two tensors of uint32 words
    (int32 bit patterns, int64 values or bools; 0 when they agree; any
    shape difference counts as 2**32)."""
    import torch
    a = a.to("cpu", torch.int64) & 0xFFFFFFFF
    b = b.to("cpu", torch.int64) & 0xFFFFFFFF
    if a.shape != b.shape:
        return 1 << 32
    return int((a - b).abs().max()) if a.numel() else 0


def _highest_slots(pd, inserted) -> bool:
    """Each ``inserted`` slot is the highest ``kvalid`` slot carrying its
    key (the winner of the JAX package's insert)."""
    import torch

    from stateright_tpu_torch.ops.words import pack64
    keys = pack64(pd.khi, pd.klo).cpu()
    valid, ins = pd.kvalid.cpu(), inserted.cpu()
    slots = torch.arange(keys.shape[0])
    uniq, inv = torch.unique(keys[valid], return_inverse=True)
    last = torch.full((uniq.shape[0],), -1, dtype=torch.int64)
    last.scatter_reduce_(0, inv, slots[valid], reduce="amax")
    won = last[torch.searchsorted(uniq, keys[ins])]
    return bool((won == slots[ins]).all())


def _sync_ms(fn, reps: int) -> float:
    """Mean wall milliseconds of ``fn()`` with the card synchronized
    around it (the plain versions, whose host reads synchronize)."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def check_staged_step(model, carry, fmax: int, size: int, sound: bool,
                      reps: int) -> dict:
    """One staged step of ``model`` on a mid-search ``carry`` (its queue
    and table cloned) at ``fmax`` rows (``size`` 2: the large step, 1:
    the small one of FMAX_SMALL rows), kernel by kernel: K1 alone
    (``expand``, held to ``expand_frontier`` on its valid lanes, cvalid
    everywhere, the pending rows' bits), KS1, KS2 and KS3, each held bit
    for bit to its plain version on the card kernel's inputs, K4 between
    them; each of KS1-KS3 timed (CUDA events, ``reps``), its plain
    version timed, its bound from this step's counts, and for KS1 the
    one PyTorch call that compacts the same mask (``torch.nonzero``, a
    yardstick only)."""
    import torch

    from stateright_tpu_torch.checker.device_loop import (
        B_E_N, B_KOVF, B_LOG_N, CtrLayout, E_GATE, E_GROW, E_STEPS, E_TAG,
        E_TARGET, G_LEN, I32_MAX)
    from stateright_tpu_torch.checker.gpu import candidate_sizes
    from stateright_tpu_torch.ops import _cuda
    from stateright_tpu_torch.ops.expand import (eventually_indices,
                                                 expand_frontier)
    from stateright_tpu_torch.ops.fused import (S_DISC, StepWorkspace,
                                                stats_len)
    from stateright_tpu_torch.ops.staged import (
        SC_DCOUNT, SC_KOVF, PredupOut, pre_dedup_arena_cells,
        predup_reference, prop_kinds, reversed_slots, stage_reference,
        staged_append_reference, staged_buffers, staged_sizes)

    dev = carry.q.device
    a, w = model.max_actions, model.packed_width
    props = model.properties()
    n_props = len(props)
    kraw, kmax = candidate_sizes(model, fmax, {}, sound)
    plans, qmargin = staged_sizes(model, fmax, kraw, kmax)
    plan = plans[size]
    f = plan.f
    head, tail = carry.q_head, carry.q_tail
    take = min(tail - head, f)
    q = carry.q.clone()
    table = carry.table.clone()
    log = torch.zeros((plan.kfin + 8, 6 if sound else 4), dtype=torch.int32,
                      device=dev)
    ecap = 4 * plan.kfin + qmargin if sound else 0
    elog = (torch.zeros((ecap, 4), dtype=torch.int32, device=dev)
            if sound else None)
    layout = CtrLayout(n_props, w)
    ctr = carry.ctr.clone()
    x = layout.ext
    tag = 1 << 20
    ctr[B_LOG_N] = ctr[B_E_N] = ctr[B_KOVF] = 0
    ctr[x + E_STEPS], ctr[x + E_TAG] = 1, tag
    ctr[x + E_TARGET] = ctr[x + E_GROW] = I32_MAX
    ctr[x + E_GATE:x + E_GATE + G_LEN] = torch.tensor(
        [size, head, take, tag, tail, 0], dtype=torch.int32)
    ws = StepWorkspace(table.numel(), 0, n_props, dev)
    ws.step = tag
    sms = _cuda.sm_count(dev)
    tiles = max(_cuda.tile_geometry(p.f, a, sms).blocks
                for p in plans.values())
    bufs = _cuda.step_buffers(model, plans[2].f, stats_len(model), False,
                              dev, tiles)
    sb = staged_buffers(plans[2], dev)
    qlimit = q.shape[0] - qmargin
    elimit = ecap - qmargin if sound else I32_MAX
    args = _cuda.staged_args(
        ctr=ctr, stats=bufs["stats"], bufs=bufs, sb=sb, q=q, log=log,
        elog=elog, plans=plans, qlimit=qlimit, elimit=elimit, model=model,
        layout=layout, sound=sound)
    gate = ctr[x + E_GATE:].data_ptr()
    bufs["stats"].zero_()
    sb.sctl.zero_()
    lanes = f * a
    cells = pre_dedup_arena_cells(plan.kraw)
    checks, err = {}, 0

    # K1 alone, held to the plain expansion
    _cuda.expand_step(model, q[:f, :w], q[:f, w], None, q[:f, w + 1],
                      q[:f, w + 2], ws, stats_len(model), False, bufs=bufs,
                      gate=gate, gate_size=size)
    torch.cuda.synchronize()
    cvalid = bufs["cvalid"][:lanes].clone()
    pbits = bufs["pbits"][:f].clone()
    terminal = bufs["terminal"][:f].clone()
    ebits_out = bufs["ebits_out"][:f].clone()
    chi, clo = bufs["chi"][:lanes].clone(), bufs["clo"][:lanes].clone()
    flat = bufs["flat"][:lanes].clone()
    block = q[head:head + f]
    fvalid = torch.arange(f, device=dev) < take
    exp = expand_frontier(model, block[:, :w], fvalid, block[:, w],
                          eventually_indices(props),
                          pfp=(block[:, w + 1], block[:, w + 2]))
    v = cvalid
    pend = fvalid
    k1_parts = {
        "cvalid": _int_err(cvalid, exp.cvalid),
        "chi": _int_err(chi[v], exp.chi[v]),
        "clo": _int_err(clo[v], exp.clo[v]),
        "flat": _int_err(flat[v], exp.flat[v]),
        "ebits": _int_err(ebits_out[pend], exp.ebits[pend]),
        "terminal": _int_err(terminal, exp.terminal),
        "pbits": _int_err(pbits[pend][:, :n_props],
                          exp.pbits[pend][:, :n_props])}
    k1_err = max(k1_parts.values())
    checks["expand"] = k1_err == 0
    stats_k1 = bufs["stats"].clone()

    # timed as KS1-KS3 are: its arguments built once, the launch alone
    k1, _out = _cuda.expand_launcher(
        model, q[:f, :w], q[:f, w], None, q[:f, w + 1], q[:f, w + 2], ws,
        stats_len(model), False, bufs=bufs, gate=gate, gate_size=size)
    k1_ms = cuda_ms(k1, reps)
    k1_plain = _sync_ms(lambda: expand_frontier(
        model, block[:, :w], fvalid, block[:, w], eventually_indices(props),
        pfp=(block[:, w + 1], block[:, w + 2])), 3)
    bufs["stats"].copy_(stats_k1)

    # KS1
    def ks1():
        _cuda.stage(args, dev, size)

    ks1()
    torch.cuda.synchronize()
    kinds = prop_kinds(props)
    so = stage_reference(cvalid, pbits, terminal, ebits_out, block[:, w],
                         block[:, w + 1], block[:, w + 2], take, plan,
                         kinds, sound)
    rv = so.rvalid
    e1 = max(_int_err(sb.rvalid[:plan.kraw], rv),
             _int_err(sb.src[:plan.kraw][rv], so.src[rv]),
             _int_err(sb.sctl[:SC_KOVF + 1], so.sctl[:SC_KOVF + 1]),
             _int_err(bufs["stats"][S_DISC:S_DISC + 3 * n_props], so.disc))
    if sound:
        e1 = max(e1, _int_err(sb.pkey[:f], so.pkey))
    checks["stage"] = e1 == 0
    vcount = int(so.sctl[0])
    sctl1 = sb.sctl.clone()
    ks1_ms = cuda_ms(ks1, reps)
    ks1_plain = _sync_ms(lambda: stage_reference(
        cvalid, pbits, terminal, ebits_out, block[:, w], block[:, w + 1],
        block[:, w + 2], take, plan, kinds, sound), 3)
    lib_ms = cuda_ms(lambda: torch.nonzero(cvalid).flatten()[:plan.kraw],
                     reps)

    # KS2
    def ks2():
        _cuda.predup(args, dev, size, cells)

    ks2()
    torch.cuda.synchronize()
    sctl_p = sctl1.clone()
    pd = predup_reference(so.src, so.rvalid, chi, clo, ebits_out, a, plan,
                          sctl_p, sound)
    kfin = plan.kfin
    kv = pd.kvalid
    # the card's slots reversed (KS2 writes slot j at kfin - 1 - j)
    card = reversed_slots(PredupOut(sb.lane, sb.khi, sb.klo, sb.kvalid),
                          kfin)
    e2 = max(_int_err(card.kvalid, kv),
             _int_err(card.lane[kv], pd.lane[kv]),
             _int_err(card.khi[kv], pd.khi[kv]),
             _int_err(card.klo[kv], pd.klo[kv]),
             _int_err(sb.sctl, sctl_p))
    checks["predup"] = e2 == 0
    dcount, kovf = int(sctl_p[SC_DCOUNT]), bool(sctl_p[SC_KOVF])
    sctl2 = sb.sctl.clone()

    def restore_sctl1():
        sb.sctl.copy_(sctl1)

    ks2_ms = cuda_ms(ks2, reps, before=restore_sctl1)
    sb.sctl.copy_(sctl2)
    ks2_plain = _sync_ms(lambda: predup_reference(
        so.src, so.rvalid, chi, clo, ebits_out, a, plan, sctl1.clone(),
        sound), 3)

    # K4, then KS3 on the card and its plain version on copies
    _cuda.staged_insert(table, sb.khi[:kfin], sb.klo[:kfin],
                        sb.kvalid[:kfin], sb.inserted[:kfin], bufs["stats"],
                        ws, gate, size)
    torch.cuda.synchronize()
    inserted = sb.inserted[:kfin].flip(0)
    cnt = int(inserted.sum())
    snap = {"ctr": ctr.clone(), "stats": bufs["stats"].clone(),
            "sctl": sb.sctl.clone()}
    pd_card = reversed_slots(PredupOut(sb.lane, sb.khi, sb.klo, sb.kvalid),
                             kfin)
    # K4 marked the highest slot of each fresh key, as the JAX package's
    # insert (and so the CPU path) does
    checks["insert_winner"] = _highest_slots(pd_card, inserted)
    p_ctr, p_q = snap["ctr"].clone(), q.clone()
    p_log = log.clone()
    p_elog = None if elog is None else elog.clone()
    p_stats, p_sctl = snap["stats"].clone(), snap["sctl"].clone()
    pkey = sb.pkey[:f].clone()

    def ks3():
        _cuda.staged_append(args, dev)

    ks3()
    torch.cuda.synchronize()
    f_small = plans[1].f if 1 in plans else 0

    def ks3_plain(c_, q_, log_, elog_, st_, sc_):
        staged_append_reference(
            c_, layout, q_, log_, elog_, pd_card, inserted, flat, ebits_out,
            chi, clo, chi, clo, pkey, st_, sc_, a, sound, f_small,
            plans[2].f, qlimit, elimit)

    ks3_plain(p_ctr, p_q, p_log, p_elog, p_stats, p_sctl)
    ecnt = int(p_ctr[B_E_N])
    e3 = max(_int_err(ctr, p_ctr), _int_err(q[tail:tail + cnt],
                                            p_q[tail:tail + cnt]),
             _int_err(log[:cnt], p_log[:cnt]),
             _int_err(bufs["stats"], p_stats), _int_err(sb.sctl, p_sctl))
    if sound:
        e3 = max(e3, _int_err(elog[:ecnt], p_elog[:ecnt]))
    checks["staged_append"] = e3 == 0

    def restore3():
        ctr.copy_(snap["ctr"])
        bufs["stats"].copy_(snap["stats"])
        sb.sctl.copy_(snap["sctl"])

    ks3_ms = cuda_ms(ks3, reps, before=restore3)

    def plain3():
        ks3_plain(snap["ctr"].clone(), q.clone(), log.clone(),
                  None if elog is None else elog.clone(),
                  snap["stats"].clone(), snap["sctl"].clone())

    ks3_plain_ms = _sync_ms(plain3, 3)
    # each kernel's bound: the bytes it must move and the operations it
    # must do on this step's data
    key_ops = 60  # one node key: three words folded and finished
    b1 = bound(lanes + 6 * f + 4 * min(vcount, plan.kraw) + plan.kraw
               + (20 * f if sound else 0),
               3 * lanes + (key_ops * f if sound else 0))
    nv = min(vcount, plan.kraw)
    b2 = bound(nv * (4 + 8 + (4 if sound else 12)) + plan.kraw
               + 13 * min(dcount, kfin),
               10 * nv + (key_ops * nv if sound else 0))
    b0 = bound(f * (w + 3) * 4 + lanes * (4 * w + 9) + 6 * f,
               lanes * (2 * w + 8))
    b3 = bound(2 * kfin + cnt * (4 * (w + 3) * 2 + 4 * log.shape[1] + 12)
               + ecnt * 24, 4 * kfin + cnt * (w + 8))
    res = {"model": type(model).__name__, "sound": sound, "f": f,
           "pending": take, "lanes": lanes, "kraw": plan.kraw, "kfin": kfin,
           "vcount": vcount, "dcount": dcount, "kovf": kovf,
           "inserted": cnt, "cross_edges": ecnt,
           "k1_valid": int(stats_k1[4]), "k1_errors": k1_parts,
           "checks": checks}
    res["kernels"] = {
        "expand": {"max_abs_err": k1_err, "ms": k1_ms,
                   "plain_ms": k1_plain, "library_ms": None, **b0},
        "stage": {"max_abs_err": e1, "ms": ks1_ms, "plain_ms": ks1_plain,
                  "library_ms": lib_ms, **b1},
        "predup": {"max_abs_err": e2, "ms": ks2_ms, "plain_ms": ks2_plain,
                   "library_ms": None, **b2},
        "staged_append": {"max_abs_err": e3, "ms": ks3_ms,
                          "plain_ms": ks3_plain_ms, "library_ms": None,
                          **b3}}
    return res


def staged_kernels(device) -> dict:
    """The staged step's kernels (phase ``kernels`` with ``staged``):
    PackedPaxos(3) at a mid-search 8,192-row step and its 256-row small
    step, and under sound PackedPingPong(7, lossy, duplicating) at its
    large and small steps from a frontier with every eventually bit
    pending at the start. Returns the checks."""
    from stateright_tpu_torch.examples.paxos_packed import PackedPaxos
    from stateright_tpu_torch.ops.expand import eventually_indices

    out = {}
    paxos = PackedPaxos(3)
    carry = mid_search_carry(paxos, device, rows=8192)
    for size, reps in ((2, 20), (1, 50)):
        res = check_staged_step(paxos, carry, 8192, size, False, reps)
        emit(phase="kernels", staged=True, **res)
        out["paxos3", size] = res
    del carry
    ping = _ping_pong(7)
    full = sum(1 << i for i in eventually_indices(ping.properties()))
    carry = mid_search_carry(ping, device, rows=7710, pending=4096,
                             ebits=full)
    for size, reps in ((2, 20), (1, 50)):
        res = check_staged_step(ping, carry, 7710, size, True, reps)
        emit(phase="kernels", staged=True, **res)
        out["ping7_sound", size] = res
    del carry
    failed = [k for k, r in out.items() if not all(r["checks"].values())]
    if failed:
        raise AssertionError(f"staged kernels: {failed}: "
                             f"{[out[k]['checks'] for k in failed]}")
    return out


def staged_phase(device) -> dict:
    """Phase ``staged``: the staged step end to end through the user entry
    points, on the card alone, every launch count set to 0 before each
    run: the BASELINE workload with ``fused=False`` (the JAX package's
    staged counts and digest, ``PIN_PAXOS3_STAGED``; K1, KS1-KS3, K4 and
    K8 launched, no K2/K3/K7), profiled; TwoPhaseSys(7) with
    ``fused=False`` and candidate buffers too small (``STAGED_2PC7_KOVF``:
    the chunk rebuilds on kovf; 296,448 and the fused run's digest); and
    PackedPingPong(7, lossy, duplicating) under ``sound_eventually()``
    (``PIN_PING7_SOUND``: 69,629 nodes, the three discoveries replayed,
    cross edges logged and the lasso swept at exhaustion) beside its
    plain fused run, both profiled. Returns the runs."""
    import torch

    from stateright_tpu_torch.examples.paxos_packed import PackedPaxos
    from stateright_tpu_torch.ops import _cuda

    path = STAGED_PATH + ("history", "hpull")
    runs = {}

    def fused_off(res):
        return all(res["launches"][k] == 0 for k in FUSED_ONLY)

    res, _ck, fps = paxos_run(3, path, target=PAXOS3_TARGET,
                              capacity=1 << 21, fused=False)
    res["digest"] = fp_digest(fps)
    res["checks"].update(
        unique=res["unique"] == PIN_PAXOS3_STAGED[0],
        generated=res["generated"] == PIN_PAXOS3_STAGED[1],
        digest=res["digest"] == PIN_PAXOS3_STAGED[2],
        no_fused_step=fused_off(res))
    del _ck, fps
    res["profile"] = device_times(lambda: PackedPaxos(3).checker()
                                  .gpu_options(race=False, fused=False,
                                               capacity=1 << 21)
                                  .target_state_count(PAXOS3_TARGET)
                                  .spawn_gpu().join(), host_top=10)
    emit(phase="staged", workload="BASELINE paxos check 3, fused=False",
         **res)
    runs["paxos3"] = res
    twopc, _ck = register_run(_twopc7(), STAGED_PATH,
                              want=(UNIQUE_2PC7, GENERATED_2PC7,
                                    DIGEST_2PC7), fused=False,
                              **STAGED_2PC7_KOVF)
    prof = _ck.profile()
    twopc.update(kovfs=prof.get("kovfs"), kraw=prof.get("kraw"),
                 kmax=prof.get("kmax"))
    twopc["checks"].update(
        no_fused_step=fused_off(twopc),
        kovf_rebuilt=twopc["kovfs"] >= 1 and twopc["captures"] >= 2)
    emit(phase="staged", **twopc)
    runs["twopc7"] = twopc
    del _ck
    ping, ck = register_run(_ping_pong(7), STAGED_PATH,
                            want=PIN_PING7_SOUND,
                            holds=("delta within 1",),
                            found=PING7_SOUND_FOUND, sound=True)
    prof = ck.profile()
    ping.update(e_n=prof.get("e_n"), lasso_s=prof.get("lasso_s"),
                lasso_nodes=prof.get("lasso_nodes"),
                lasso_edges=prof.get("lasso_edges"),
                witness_lengths={k: len(p)
                                 for k, p in ck.discoveries().items()})
    ping["checks"].update(cross_edges=(prof.get("e_n") or 0) > 0,
                          lasso_swept="lasso_s" in prof,
                          no_fused_step=fused_off(ping))
    del ck
    ping["profile"] = device_times(
        lambda: _ping_pong(7).checker().sound_eventually().gpu_options(
            race=False).spawn_gpu().join(), host_top=8)
    ping["plain_profile"] = device_times(
        lambda: _ping_pong(7).checker().gpu_options(race=False).spawn_gpu()
        .join(), host_top=8)
    emit(phase="staged", sound=True, **ping)
    runs["ping7_sound"] = ping
    failed = [k for k, r in runs.items() if not all(r["checks"].values())]
    if failed:
        raise AssertionError(f"staged phase: {failed}: "
                             f"{[runs[k]['checks'] for k in failed]}")
    torch.cuda.synchronize()
    del _cuda
    return runs


def _twopc7():
    from stateright_tpu_torch import TwoPhaseSys
    return TwoPhaseSys(7)


def staged_kernel_entries(checks: dict, runs: dict) -> list:
    """The ``kernels`` line's records of the staged step: KS1-KS3 and K1
    alone, with their launches on the staged BASELINE run,
    their Paxos(3) 8,192-row numbers and the other shapes beside them."""
    launches = runs["paxos3"]["launches"]
    steps = {k: r for k, r in checks.items() if isinstance(k, tuple)}
    out = []
    for name, replaces in STAGED_KERNELS.items():
        main = checks["paxos3", 2]["kernels"][name]
        by = {f"{lb} f={r['f']}": r["kernels"][name]
              for (lb, _s), r in steps.items()}
        out.append({
            "name": name, "route": "cuda", "source": STAGED_SRC,
            "replaces": replaces, "model": "PackedPaxos(3)",
            "launches": launches[name],
            "max_abs_err": max([main["max_abs_err"]]
                               + [r["max_abs_err"] for r in by.values()]),
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": main["library_ms"],
            "by_shape": {lb: {k: r[k] for k in (
                "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                "max_abs_err")} for lb, r in by.items()},
            "status": "ok"})
    k1 = checks["paxos3", 2]["kernels"]["expand"]
    out.append({
        "name": "expand", "route": "cuda",
        "source": "stateright_tpu_torch/csrc/fused_step.cu",
        "replaces": "stateright_tpu/checker/device_loop.py:407",
        "configuration": "K1 alone (srt_expand_<model>): the staged step's "
                         "expansion",
        "model": "PackedPaxos(3)", "launches": launches["expand"],
        "max_abs_err": max(r["kernels"]["expand"]["max_abs_err"]
                           for r in steps.values()),
        **{k: k1[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                              "library_ms")},
        "by_shape": {f"{lb} f={r['f']}": {
            k: r["kernels"]["expand"][k] for k in (
                "ms", "plain_ms", "bound_ms", "bound_by", "max_abs_err")}
            for (lb, _s), r in steps.items()},
        "status": "ok"})
    return out


RANK_CASES = (("bucket", 7, None), ("ring", 7, None), ("bucket", 16, True),
              ("bucket", "lock8", None))


def rank_run(rank: int, world: int, init: str, out_dir: str,
             device_type: str = "cuda") -> None:
    """One rank of ``--ranks``: each of ``RANK_CASES`` through the sharded
    engine on this rank's card (2pc n=7 with each exchange, then 2pc n=16
    under complete symmetry reduction); writes what its checker answers
    to ``<out_dir>/rank<rank>.json``."""
    import datetime

    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from stateright_tpu_torch import IncrementLock, TwoPhaseSys
    from stateright_tpu_torch.ops import _cuda

    cuda = device_type == "cuda"
    if cuda:
        torch.cuda.set_device(rank)
    dist.init_process_group("nccl" if cuda else "gloo", init_method=init,
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=300))
    runs = []
    try:
        mesh = init_device_mesh(device_type, (world,),
                                mesh_dim_names=("shards",))
        for exchange, n, complete in RANK_CASES:
            # NCCL sets up its peer connections at the first collective
            # of each kind: a small check first, so the timed run is warm
            TwoPhaseSys(3).checker().gpu_options(
                mesh=mesh, exchange=exchange).spawn_gpu().join()
            for key in _cuda.LAUNCHES:
                _cuda.LAUNCHES[key] = 0
            if cuda:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            model = (IncrementLock(8) if n == "lock8" else
                     TwoPhaseSys(n, complete_symmetry=bool(complete)))
            builder = model.checker().gpu_options(mesh=mesh,
                                                  exchange=exchange)
            if complete is not None:
                builder = builder.symmetry_fn(model.representative)
            ck = builder.spawn_gpu().join()
            wall = time.perf_counter() - t0
            prof = ck.profile()
            if n == "lock8":  # both properties hold
                replay = {prop: ck.discovery(prop) is None
                          for prop in ("fin", "mutex")}
            else:
                replay = {}
                for prop in ("abort agreement", "commit agreement"):
                    path = ck.assert_any_discovery(prop)  # or raises
                    replay[prop] = bool(ck.model().property(prop).condition(
                        ck.model(), path.last_state()))
            runs.append({
                "n": n, "symmetry": complete is not None,
                "exchange": prof["exchange"], "wall_s": wall,
                "unique": ck.unique_state_count(),
                "generated": ck.state_count(),
                "digest": fp_digest(ck.generated_fingerprints()),
                "replay": replay, "launches": dict(_cuda.LAUNCHES),
                "peak": (torch.cuda.max_memory_allocated() if cuda
                         else None),
                **{k: prof[k] for k in (
                    "iterations", "small_iterations", "syncs", "sync_s",
                    "collectives", "collectives_per_iteration", "kovfs",
                    "aborts", "kmax", "kb", "loop_s", "gather_s",
                    "rank_rows", "dmax", "bmax")}})
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(runs, f)


def ranks_main(world: int) -> int:
    """``--ranks N``: the sharded engine across N cards (see the module
    docstring)."""
    import socket
    import tempfile

    import torch
    import torch.multiprocessing as mp
    if not torch.cuda.is_available() or torch.cuda.device_count() < world:
        print(f"chip_smoke: --ranks {world} needs {world} CUDA devices",
              file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    try:
        from stateright_tpu_torch.ops import _cuda
    except ImportError as exc:
        print(f"chip_smoke: run from a checkout of the repository ({exc})",
              file=sys.stderr)
        return 2
    names = [torch.cuda.get_device_name(i) for i in range(world)]
    smi = run(["nvidia-smi", "--query-gpu=name,power.limit",
               "--format=csv,noheader"]).splitlines()
    emit(phase="device", names=names, nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda,
         count=torch.cuda.device_count())
    info = _cuda.build()  # once, before the ranks load it
    emit(phase="build", seconds=info["seconds"], library=info["path"])
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    out_dir = os.path.join(root, "build", "ranks")
    os.makedirs(out_dir, exist_ok=True)
    out_dir = tempfile.mkdtemp(dir=out_dir)
    mp.spawn(rank_run, args=(world, f"tcp://127.0.0.1:{port}", out_dir),
             nprocs=world, join=True)
    ranks = []
    for r in range(world):
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    for i, first in enumerate(ranks[0]):
        same = ("exchange", "unique", "generated", "digest", "replay",
                "iterations", "rank_rows")
        want = (PIN_LOCK8 if first["n"] == "lock8" else
                (UNIQUE_2PC16_SYM, GENERATED_2PC16_SYM, DIGEST_2PC16_SYM)
                if first["symmetry"] else
                (UNIQUE_2PC7, GENERATED_2PC7, DIGEST_2PC7))
        step = ("fused_step_noprobe_sym" if first["symmetry"]
                else "fused_step_noprobe")
        checks = {
            "unique": first["unique"] == want[0],
            "generated": first["generated"] == want[1],
            "digest": first["digest"] == want[2],
            "replay": all(first["replay"].values()),
            "ranks_agree": all(r[i][k] == first[k] for r in ranks
                               for k in same),
            "exchange": first["exchange"] == RANK_CASES[i][0],
            "launches": all(r[i]["launches"][step] > 0
                            and r[i]["launches"]["probe_block"] > 0
                            and r[i]["launches"]["fused_step"] == 0
                            and r[i]["launches"]["fused_step_sym"] == 0
                            for r in ranks),
        }
        wall = max(r[i]["wall_s"] for r in ranks)
        emit(phase="e2e_ranks", ranks=world, wall_s=wall,
             unique_per_s=first["unique"] / wall,
             per_rank=[{k: r[i][k] for k in (
                 "wall_s", "loop_s", "syncs", "sync_s", "collectives",
                 "peak", "launches", "gather_s")} for r in ranks],
             **{k: first[k] for k in (
                 "n", "symmetry", "exchange", "unique", "generated",
                 "digest", "iterations",
                 "small_iterations", "collectives_per_iteration", "kovfs",
                 "aborts", "kmax", "kb", "rank_rows", "dmax", "bmax")},
             checks=checks)
        if not all(checks.values()):
            raise AssertionError(f"{world}-rank {first['n']}, "
                                 f"{first['exchange']}: {checks}")
    for line in smi:
        print(line, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": names[0], "count": world}}), flush=True)
    return 0


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    root = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, root)
    try:
        from stateright_tpu_torch import TwoPhaseSys
        from stateright_tpu_torch.ops import _cuda
    except ImportError as exc:
        print(f"chip_smoke: run from a checkout of the repository ({exc})",
              file=sys.stderr)
        return 2

    name = torch.cuda.get_device_name(0)
    smi = run(["nvidia-smi", "--query-gpu=name,power.limit",
               "--format=csv,noheader"]).splitlines()[0]
    try:
        nvcc = run([_cuda._nvcc(), "--version"]).splitlines()[-1]
    except (RuntimeError, subprocess.CalledProcessError) as exc:
        nvcc = f"unavailable: {exc}"
    emit(phase="device", name=name, nvidia_smi=smi,
         torch=torch.__version__, cuda=torch.version.cuda, nvcc=nvcc,
         count=torch.cuda.device_count())

    info = _cuda.build()
    emit(phase="build", seconds=info["seconds"], library=info["path"],
         kernels={lib: ptxas_usage(log)
                  for lib, log in info["logs"].items()})
    # the Paxos kernels first: their device times come from traces of
    # single launches, which later phases can spoil (PERF.md section 7)
    pax_checks = paxos_kernels(torch.device("cuda", 0))
    reg_checks, reg_plain = register_kernels(torch.device("cuda", 0))
    crash_checks, crash_plain = crash_kernels(torch.device("cuda", 0))
    lossy_checks, lossy_plain = lossy_kernels(torch.device("cuda", 0))
    staged_checks = staged_kernels(torch.device("cuda", 0))
    # the host race on the main path, and checkpoints on the card
    race_phase()
    ckpt = checkpoint_phase()

    model = TwoPhaseSys(7)
    carry = mid_search_carry(model, torch.device("cuda", 0))
    large = check_step(model, carry, 12288, reps=20)
    emit(phase="kernels", kernel="fused_step", **large)
    small = check_step(model, carry, 256, reps=50)
    emit(phase="kernels", kernel="fused_step", **small)
    ins = check_insert(carry, reps=10)
    emit(phase="kernels", kernel="table_insert", **ins)
    np_large, step = check_noprobe(model, carry, 12288, reps=20)
    emit(phase="kernels", kernel="fused_step_noprobe", **np_large)
    np_small, _ = check_noprobe(model, carry, 256, reps=50)
    emit(phase="kernels", kernel="fused_step_noprobe", **np_small)
    probe = check_probe(model, carry, step, reps=20)
    emit(phase="kernels", kernel="probe_block", **probe)
    del step
    # the chunk's kernels: its start (with the first gate), then K7 (with
    # the next gate) after a real step of 12,288 and of 256 rows
    control = check_control(model, carry)
    emit(phase="kernels", kernel="chunk_begin", **control)
    appends = {("plain", f): check_append(model, carry, f, reps)
               for f, reps in ((12288, 50), (256, 100))}
    for (_mode, f), res in appends.items():
        emit(phase="kernels", kernel="append", **res)
    del carry

    # the symmetric steps at the full width of 2pc n=16 (82 actions): a
    # mid-search frontier of the reference representative's search; the
    # complete representative's own search never holds more than ~1,200
    # pending rows, so it is checked on the same rows with its own
    # canonical frontier fingerprints
    sym_models = {"reference": TwoPhaseSys(16),
                  "complete": TwoPhaseSys(16, complete_symmetry=True)}
    carry16 = mid_search_carry(sym_models["reference"],
                               torch.device("cuda", 0), symmetry=True)
    sym_kernels = {"fused_step_sym": {}, "fused_step_noprobe_sym": {}}
    for mode, m16 in sym_models.items():
        pfp = None if mode == "reference" else frontier_fps(m16)
        for f, reps in ((12288, 20), (256, 50)):
            res = check_step(m16, carry16, f, reps, symmetry=True, pfp=pfp)
            sym_kernels["fused_step_sym"][mode, f] = res
            emit(phase="kernels", kernel="fused_step_sym",
                 representative=mode, **res)
            res, _ = check_noprobe(m16, carry16, f, reps, symmetry=True,
                                   pfp=pfp)
            sym_kernels["fused_step_noprobe_sym"][mode, f] = res
            emit(phase="kernels", kernel="fused_step_noprobe_sym",
                 representative=mode, **res)
    # K7 with the 6-column log, after a real symmetric step
    for f, reps in ((12288, 50), (256, 100)):
        res = appends["symmetric", f] = check_append(
            sym_models["reference"], carry16, f, reps)
        emit(phase="kernels", kernel="append", symmetry="reference", **res)
    del carry16
    # K1's instantiations for the other models, at their real mid-search
    # steps
    model_steps = check_model_steps(torch.device("cuda", 0))

    chunk_kernels = ("chunk_begin", "append")
    single = ("fused_step", "table_insert") + chunk_kernels
    default, card = end_to_end(TwoPhaseSys, single)
    # each replay (and the capture's warm-up) launches K1-K3 of both
    # sizes and K7: 7 kernel nodes, no gate kernel
    default["kernel_nodes_per_replay"] = replay_nodes(default)
    default["checks"]["kernel_nodes"] = \
        default["kernel_nodes_per_replay"] == 7
    emit(phase="e2e", **default)
    if not default["checks"]["kernel_nodes"]:
        raise AssertionError(f"2pc7 default: {default['launches']} over "
                             f"{default['graph_launches']} replays")
    # the chunk: the default run (pipeline=True) and the synchronous
    # chunk loop, in turns, on this card; one sync per chunk
    chunk_runs = []
    for pipeline in (True, False, True, False):
        res, _ck = end_to_end(TwoPhaseSys, single, pipeline=pipeline)
        del _ck
        chunk_runs.append(res)
        limit = -(-res["iterations"] // 64) + 2
        res["checks"]["syncs_per_chunk"] = (res["syncs"] <= limit
                                            and res["syncs"]
                                            == res["chunks"])
        emit(phase="chunk", pipeline=pipeline, sync_limit=limit,
             **{k: res[k] for k in (
                 "wall_s", "loop_s", "chunks", "syncs", "sync_stall",
                 "sync_s", "capture_s", "graph_launches", "iterations",
                 "small_iterations", "launches", "checks")})
        if not res["checks"]["syncs_per_chunk"]:
            raise AssertionError(f"chunk run pipeline={pipeline}: "
                                 f"{res['syncs']} syncs, {res['chunks']} "
                                 f"chunks over {res['iterations']} "
                                 "iterations")
    emit(phase="mirror_vs_plain", **mirror_vs_plain(card))
    del card
    # where the device time of the run goes (a separate, profiled run),
    # and the kernel nodes of a replay as the trace counts them
    prof = device_times(lambda: TwoPhaseSys(7).checker().gpu_options(
        race=False).spawn_gpu().join(), host_top=12)
    if prof["by_kernel_calls"] is not None:
        calls = prof["by_kernel_calls"]
        prof["kernel_nodes_per_replay_traced"] = sum(
            calls[k] for k in ("expand_kernel", "claim_kernel",
                               "commit_kernel", "append_kernel")) / (
            prof["graph_launches"] + prof["captures"])
    emit(phase="e2e_profile", engine="gpu", **prof)
    if prof.get("kernel_nodes_per_replay_traced", 7) != 7:
        raise AssertionError("the traced replays do not launch 7 kernel "
                             f"nodes each: {prof['by_kernel_calls']}")
    # the capacity pre-bump (capacity grows x4 until grow_at * capacity
    # exceeds one step's appends) would lift 2**16 straight to 2**20 at
    # 12,288-row steps; 512-row steps keep it, so the run grows twice
    grown, _ck = end_to_end(TwoPhaseSys, single, capacity=1 << 16,
                            fmax=512)
    emit(phase="e2e", **grown)
    if grown["grows"] != 2 or grown["digest"] != default["digest"]:
        raise AssertionError(f"growth run: {grown['grows']} growths, "
                             f"digest {grown['digest']}")

    # symmetry reduction on one card: the orbits of 2pc7 and its
    # reference representative's sound range, recounted on the card;
    # then the symmetric single-chip path
    orbits, orbit_keys7 = orbits_2pc7(torch.device("cuda", 0))
    emit(phase="orbits_2pc7", **orbits)
    single_sym = ("fused_step_sym", "table_insert") + chunk_kernels
    off_sym = ("fused_step", "fused_step_noprobe", "fused_step_noprobe_sym",
               "probe_block")
    res, ck7, _rec = end_to_end_sym(
        TwoPhaseSys(7, complete_symmetry=True), single_sym, off_sym,
        want=(UNIQUE_2PC7_SYM, GENERATED_2PC7_SYM, DIGEST_2PC7_SYM))
    emit(phase="e2e_sym", **res)
    res, ck7, _rec = end_to_end_sym(TwoPhaseSys(7), single_sym, off_sym)
    # the reference representative: a count in the sound range, and the
    # original rows it enqueued cover every orbit
    q7, tail7 = ck7._queue
    cover7 = canonical_keys(TwoPhaseSys(7, complete_symmetry=True),
                            q7[:tail7, :4])
    res["checks"].update(
        sound_range=UNIQUE_2PC7_SYM <= res["unique"] <= REF_KEYS_2PC7,
        covers_every_orbit=cover7 == orbit_keys7)
    emit(phase="e2e_sym", **res)
    if not all(res["checks"].values()):
        raise AssertionError(f"2pc7 reference symmetry: {res['checks']}")
    del ck7, q7, _rec
    sym16, ck16, _rec = end_to_end_sym(
        TwoPhaseSys(16, complete_symmetry=True), single_sym, off_sym,
        want=(UNIQUE_2PC16_SYM, GENERATED_2PC16_SYM, DIGEST_2PC16_SYM))
    emit(phase="e2e_sym", **sym16)
    orbit_keys16 = ck16.generated_fingerprints()
    verdicts16 = sorted(ck16.discoveries())
    del ck16, _rec
    # the full-width run where the kernels work: over a million
    # reduced states
    want_ref16 = (UNIQUE_2PC16_REF, GENERATED_2PC16_REF, DIGEST_2PC16_REF)
    ref16, ck16, rec16 = end_to_end_sym(TwoPhaseSys(16), single_sym,
                                        off_sym, want=want_ref16)
    emit(phase="e2e_sym", **ref16)
    again, _ck, rec_again = end_to_end_sym(TwoPhaseSys(16), single_sym,
                                           off_sym, want=want_ref16)
    del _ck
    q16, tail16 = ck16._queue
    cover16 = canonical_keys(TwoPhaseSys(16, complete_symmetry=True),
                             q16[:tail16, :4])
    checks = {
        # K2/K3's winner rule makes the search record repeat row for row
        "record_repeats": (len(rec16[0]) == len(rec_again[0])
                           and torch.equal(rec16[0], rec_again[0])),
        "covers_every_orbit": cover16 == orbit_keys16,
        "verdicts": sorted(ck16.discoveries()) == verdicts16,
    }
    emit(phase="e2e_sym_checks", representative="reference", n=16,
         rows=len(rec16[0]), enqueued=tail16, orbits=len(cover16),
         repeat_wall_s=again["wall_s"], checks=checks)
    if not all(checks.values()):
        raise AssertionError(f"2pc16 reference symmetry: {checks}")
    del ck16, q16, rec16, rec_again
    # where the device time of the full-width symmetric run goes (a
    # separate, profiled run)
    m16 = TwoPhaseSys(16)
    prof16 = device_times(lambda: m16.checker().symmetry_fn(
        m16.representative).gpu_options(race=False).spawn_gpu().join(),
        host_top=12)
    emit(phase="e2e_profile", engine="gpu", symmetry="reference", n=16,
         **prof16)
    # growth under symmetry (the 6-column log re-inserted): 16-row steps
    # keep a 2**12-slot table, which then grows twice
    grown_sym, _ck, _rec = end_to_end_sym(
        TwoPhaseSys(16, complete_symmetry=True), single_sym, off_sym,
        want=(UNIQUE_2PC16_SYM, GENERATED_2PC16_SYM, DIGEST_2PC16_SYM),
        capacity=1 << 12, fmax=16)
    emit(phase="e2e_sym", **grown_sym)
    if grown_sym["grows"] < 1:
        raise AssertionError("the symmetric growth run did not grow")
    del _ck, _rec

    # the sharded engine on a one-rank NCCL group: the probe-free step,
    # the owner-side probe, the insert kernel (seeding, growth) — and no
    # single-chip step
    import torch.distributed as dist
    mesh, nccl_init_s = one_rank_mesh()
    emit(phase="nccl", ranks=1, init_s=nccl_init_s)
    sharded = ("fused_step_noprobe", "probe_block", "table_insert")
    sh, sh_ck = end_to_end(TwoPhaseSys, sharded, mesh=mesh)
    sh["single_chip_steps"] = sh["launches"]["fused_step"]
    emit(phase="e2e_sharded", **sh)
    if sh["digest"] != default["digest"] or sh["launches"]["fused_step"]:
        raise AssertionError(f"sharded run: digest {sh['digest']}, "
                             f"{sh['launches']}")
    runs = []
    sh_prof = device_times(lambda: runs.append(
        TwoPhaseSys(7).checker().gpu_options(mesh=mesh).spawn_gpu().join()),
        host_top=12)
    # the owner-side probe's winner rule makes the record repeat
    runs[0].generated_fingerprints()  # pulls its mirror
    again = list(runs[0]._generated.items())
    first = list(sh_ck._generated.items())
    emit(phase="e2e_profile", engine="gpu-sharded",
         record_repeats=again == first, rows=len(first), **sh_prof)
    if again != first:
        raise AssertionError("the sharded search record differs between "
                             "two runs on the card")
    del sh_ck, runs
    sh_grown, _ck = end_to_end(TwoPhaseSys, sharded, mesh=mesh,
                               capacity=1 << 16, fmax=512)
    emit(phase="e2e_sharded", **sh_grown)
    if sh_grown["grows"] < 1 or sh_grown["digest"] != default["digest"]:
        raise AssertionError(f"sharded growth run: {sh_grown['grows']} "
                             f"growths, digest {sh_grown['digest']}")
    # the sharded engine under symmetry: the symmetric probe-free step,
    # the owner-side probe on canonical keys, the same 21,335 orbits
    sh_sym, _ck, _rec = end_to_end_sym(
        TwoPhaseSys(16, complete_symmetry=True),
        ("fused_step_noprobe_sym", "probe_block", "table_insert"),
        ("fused_step", "fused_step_sym", "fused_step_noprobe")
        + chunk_kernels,
        want=(UNIQUE_2PC16_SYM, GENERATED_2PC16_SYM, DIGEST_2PC16_SYM),
        mesh=mesh)
    emit(phase="e2e_sharded_sym", **sh_sym)
    del _ck, _rec
    # the other models end to end, on one card and on the one-rank mesh
    model_runs = models_phase(mesh)
    dist.destroy_process_group()
    # Paxos on the card end to end (its kernels were checked first)
    pax_runs = paxos_phase(torch.device("cuda", 0))
    # the register family on the card end to end
    reg_runs = registers_phase()
    # crash/restart fault injection on the card end to end
    crash_runs = crash_phase()
    # the lossy network and the device timers on the card end to end
    lossy_runs = lossy_phase()
    # the staged step (fused=False, sound_eventually()) end to end
    staged_runs = staged_phase(torch.device("cuda", 0))
    # the register, crash and lossy K1 checks' plain versions, after every
    # trace
    register_plain(reg_checks, reg_plain)
    register_plain(crash_checks, crash_plain)
    register_plain(lossy_checks, lossy_plain)
    # the cold starts last: another process on the card spoils the traces
    cold_start_phase()

    fused_src = "stateright_tpu_torch/csrc/fused_step.cu"
    sharded_src = "stateright_tpu_torch/csrc/sharded_step.cu"
    kernels = [
        {"name": "fused_step", "route": "cuda", "source": fused_src,
         "replaces": "stateright_tpu/ops/fused.py:259",
         "launches": default["launches"]["fused_step"],
         "max_abs_err": max(large["max_abs_err"], small["max_abs_err"]),
         "ms": large["ms"], "plain_ms": large["plain_ms"],
         "bound_ms": large["bound_ms"], "bound_by": large["bound_by"],
         "library_ms": None,
         "small_step": {k: small[k] for k in ("ms", "plain_ms", "bound_ms",
                                              "bound_by")},
         "parts": {"f=12288": large["parts"], "f=256": small["parts"]},
         "status": "ok"},
        {"name": "table_insert", "route": "cuda", "source": fused_src,
         "replaces": "stateright_tpu/ops/hashtable.py:71",
         "launches": default["launches"]["table_insert"],
         "max_abs_err": ins["max_abs_err"], "ms": ins["ms"],
         "plain_ms": ins["plain_ms"], "bound_ms": ins["bound_ms"],
         "bound_by": ins["bound_by"], "library_ms": None,
         "parts": ins["parts"],
         "mask": {k: ins["mask"][k] for k in ("ms", "device_ms", "bound_ms",
                                              "bound_by", "parts")},
         "resume_preload": {
             "launches": ckpt["plain"]["launches"]["table_insert"],
             **{k: ckpt["plain"]["k4_preload"][k] for k in (
                 "keys", "capacity", "max_abs_err", "ms", "device_ms",
                 "plain_ms", "bound_ms", "bound_by")}},
         "status": "ok"},
        {"name": "fused_step_noprobe", "route": "cuda",
         "source": sharded_src,
         "replaces": "stateright_tpu/ops/fused.py:259",
         "configuration": "probe=False (sharded step)",
         "launches": sh["launches"]["fused_step_noprobe"],
         "max_abs_err": max(np_large["max_abs_err"],
                            np_small["max_abs_err"]),
         "ms": np_large["ms"], "plain_ms": np_large["plain_ms"],
         "bound_ms": np_large["bound_ms"], "bound_by": np_large["bound_by"],
         "library_ms": None,
         "small_step": {k: np_small[k] for k in ("ms", "plain_ms",
                                                 "bound_ms", "bound_by")},
         "parts": {"f=12288": np_large["parts"],
                   "f=256": np_small["parts"]},
         "status": "ok"},
        {"name": "probe_block", "route": "cuda", "source": sharded_src,
         "replaces": "stateright_tpu/ops/fused.py:526",
         "launches": sh["launches"]["probe_block"],
         "max_abs_err": probe["max_abs_err"], "ms": probe["ms"],
         "plain_ms": probe["plain_ms"], "bound_ms": probe["bound_ms"],
         "bound_by": probe["bound_by"], "library_ms": None,
         "parts": {"main": probe["main"]["parts"],
                   "twice": probe["twice"]["parts"]},
         "status": "ok"},
    ]
    for kernel, launches in (("fused_step_sym",
                               ref16["launches"]["fused_step_sym"]),
                              ("fused_step_noprobe_sym",
                               sh_sym["launches"]["fused_step_noprobe_sym"])):
        runs = sym_kernels[kernel]
        large = runs["reference", 12288]
        probe = kernel == "fused_step_sym"
        kernels.append({
            "name": kernel, "route": "cuda",
            "source": fused_src if probe else sharded_src,
            "replaces": "stateright_tpu/ops/fused.py:259",
            "configuration": "symmetry=True, probe="
                             + ("True" if probe else "False (sharded step)"),
            "launches": launches,
            "max_abs_err": max(r["max_abs_err"] for r in runs.values()),
            "ms": large["ms"], "plain_ms": large["plain_ms"],
            "bound_ms": large["bound_ms"], "bound_by": large["bound_by"],
            "library_ms": None,
            "by_mode_and_rows": {
                f"{mode} f={f}": {k: r[k] for k in (
                    "ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
                    "max_abs_err", "parts")}
                for (mode, f), r in runs.items()},
            "status": "ok"})
    chunk_src = "stateright_tpu_torch/csrc/chunk.cu"
    k7 = appends["plain", 12288]
    for label in ("increment_lock", "increment"):
        appends[label, 12288] = model_steps["append", label, 12288]
    gate_src = ("stateright_tpu/checker/device_loop.py:352 (make_cond, "
                "evaluated in eval_gate)")
    kernels += [
        {"name": "append", "route": "cuda", "source": chunk_src,
         "replaces": "stateright_tpu/checker/device_loop.py:696",
         "gate": gate_src,
         "launches": default["launches"]["append"],
         "max_abs_err": max(r["max_abs_err"] for r in appends.values()),
         "ms": k7["ms"], "device_ms": k7["device_ms"],
         "plain_ms": k7["plain_ms"],
         "bound_ms": k7["bound_ms"], "bound_by": k7["bound_by"],
         "library_ms": None,
         "by_shape": {f"{mode} f={f}": {k: r[k] for k in (
             "lanes", "appended", "ms", "device_ms", "plain_ms",
             "glue_device_ms", "bound_ms", "bound_by", "max_abs_err")}
             for (mode, f), r in appends.items()},
         "status": "ok"},
        {"name": "chunk_begin", "route": "cuda", "source": chunk_src,
         "replaces": "stateright_tpu/checker/tpu.py:1377",
         "gate": gate_src,
         "launches": default["launches"]["chunk_begin"],
         "max_abs_err": control["max_abs_err"], "ms": control["ms"],
         "plain_ms": control["plain_ms"],
         "bound_ms": control["bound_ms"],
         "bound_by": control["bound_by"], "library_ms": None,
         "device_ms": control["device_ms"], "status": "ok"},
    ]
    kernels += model_kernel_entries(model_steps, model_runs)
    kernels += paxos_kernel_entries(pax_checks, pax_runs)
    kernels += register_kernel_entries(reg_checks, reg_runs)
    kernels += crash_kernel_entries(crash_checks, crash_runs)
    kernels += lossy_kernel_entries(lossy_checks, lossy_runs)
    kernels += staged_kernel_entries(staged_checks, staged_runs)
    # K7, K8 and K9 at the widest register row (331 words), K7 at abd3's
    # (260)
    for entry in kernels:
        for label, key, run_key in (
                (WIDE_REGISTER, "register_331", "abd2_s3"),
                (ABD3_REGISTER, "register_260", "abd3")):
            r = reg_checks[label].get(entry["name"])
            if r is None or entry["name"] not in ("append", "history",
                                                  "hpull"):
                continue
            entry[key] = {
                "model": label, "launches": reg_runs[run_key][
                    "launches"][entry["name"]],
                **{k: r.get(k) for k in (
                    "max_abs_err", "ms", "device_ms", "plain_ms",
                    "bound_ms", "bound_by")}}
            if entry["name"] in REDESIGNED:
                entry[key]["redesigned"] = REDESIGNED[entry["name"]]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    # the run uses one card, whatever the machine holds
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] == "--ranks":
        sys.exit(ranks_main(int(sys.argv[2])))
    sys.exit(main())
