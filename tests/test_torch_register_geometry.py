"""The register family's K1 launch and device functions, on the CPU
without JAX: K1's launch (``ops/_cuda.py`` ``k1_launch``) and shared
memory at every ordered ABD configuration ``cuda_spec`` admits (up to
352 words and 32 channels: the edit model of ``csrc/abd.cuh``) and at
the unordered ones (the group model, up to 128 words); and the device
functions themselves (``csrc/actor_net.cuh``, ``abd.cuh``,
``single_copy.cuh``, ``paxos.cuh``, ``write_once.cuh``,
``timer_count.cuh``), compiled for the host with ``g++`` under a header
that defines CUDA's qualifiers away:
``reg_chan`` and ``reg_chan_ends`` against ``register_channels()``, the
packed layout's channel order; the row and edit sizes the launch sizes
shared memory with; and each model's step on every lane of reachable and
crowded rows against its plain version, under K1's lane rules (a wide
model's quiet lanes are the row, invalid; an edit model's lanes of empty
channels, and the inactive lanes of a model with crash lanes or of the
timer model, are invalid and their rows unwritten); the timer K1's
launch and the order in which its block writes its children. The
card's tests and ``chip_smoke.py`` hold the kernels."""

import ctypes
import pathlib
import shutil
import subprocess

import numpy as np
import pytest
import torch

from stateright_tpu_torch.actor.test_util import (PackedPingPong,
                                                  PackedTimerCount)
from stateright_tpu_torch.examples.abd_packed import PackedAbd
from stateright_tpu_torch.examples.paxos_packed import PackedPaxos
from stateright_tpu_torch.examples.single_copy_packed import \
    PackedSingleCopy
from stateright_tpu_torch.examples.write_once_packed import PackedWriteOnce
from stateright_tpu_torch.fingerprint import fp64_words
from stateright_tpu_torch.ops import _cuda

CSRC = pathlib.Path(_cuda.__file__).resolve().parent.parent / "csrc"

#: an H100 SXM: its SMs, and the shared memory of one SM and one block
SMS = 132
SM_SMEM = 228 * 1024
BLOCK_SMEM = 227 * 1024
#: the block's own reserve of shared memory
RESERVED = 1024

#: the device functions behind a C interface, for ctypes. Per row a
#: step writes its property bits, then per lane a flags word (1 valid,
#: 2 overflow, 4 stepped: below a wide model's quiet lane, or an edit,
#: crash or timer model's active lane), the child's fingerprint (hi,
#: lo) and its words, as K1 would: a quiet lane's child is the row, an
#: inactive lane's is left zero (its fingerprint the row's); a wide
#: model's fingerprint folds every word of the child (RowOut), an edit
#: model's, and a crash or restart child's, is the row's folds with the
#: words the child changes refolded (fold.cuh fold_change, as
#: step_common.cuh's K1 takes it); a crash or restart child is its edit
#: and fingerprint (crash_child, a thread's) and its words (crash_write,
#: a group's lanes), a group model's delivery with crash lanes its record
#: (deliver_scalar, a thread's) and its child (deliver_group, the
#: group's)
HOST_SOURCE = r"""
#define __device__
#define __host__
#define __forceinline__ inline
#include <ucontext.h>

#include <algorithm>
#include <cstdint>
#include <string>
#include <type_traits>
#include <vector>
using std::min;
using std::max;
inline int __popc(unsigned x) { return __builtin_popcount(x); }
inline int __clz(unsigned x) { return x ? __builtin_clz(x) : 32; }
#include "abd.cuh"
#include "fold.cuh"
#include "paxos.cuh"
#include "ping_pong.cuh"
#include "single_copy.cuh"
#include "timer_count.cuh"
#include "write_once.cuh"

namespace {
// a model with drop lanes (step_common.cuh DropLanes), and one whose
// lanes after the deliveries are edits of the row (crash or drop lanes)
template <class M, class = void>
struct Lossy : std::false_type {};
template <class M>
struct Lossy<M, std::void_t<decltype(M::kLossy)>>
    : std::integral_constant<bool, M::kLossy> {};
template <class M>
constexpr bool kEdits = actor::HasCrash<M>::value || Lossy<M>::value;

struct Out {
  uint32_t* dst;
  void put(int i, uint32_t v) { dst[i] = v; }
};

// the XOR-folds of a row's W words
void fold_row(const uint32_t* w, int W, uint32_t& h1, uint32_t& h2) {
  h1 = h2 = 0u;
  for (int k = 0; k < W; ++k) fold_word(h1, h2, k, w[k]);
}

// a crash or restart lane's child as K1 takes it: its edit and
// fingerprint by a thread, its words by the lanes of a group (one here)
template <class M>
bool crash_lane(const M& m, const uint32_t* w, int e, uint32_t* out,
                uint32_t* fp) {
  uint32_t r1, r2;
  fold_row(w, m.width(), r1, r2);
  const auto ed = m.crash_child(w, e, r1, r2, fp[0], fp[1]);
  m.crash_write(w, ed, 0, 1, out);
  return ed.valid;
}

// a drop lane's child by one thread (actor_net.cuh drop_fingerprint,
// drop_copy): the reference drop_suffix_folds, drop_fold and drop_write
// are held to
template <class M>
bool drop_lane(const M& m, const uint32_t* w, int e, uint32_t* out,
               uint32_t* fp) {
  uint32_t r1, r2;
  fold_row(w, m.width(), r1, r2);
  const auto ed = actor::drop_fingerprint(m, w, e, r1, r2, fp[0], fp[1]);
  actor::drop_copy(m, w, ed, 0, 1, out);
  return ed.valid;
}

// the lanes K1 steps: those below the quiet lane, or a crash or lossy
// model's active lanes (step_common.cuh CrashLanes, DropLanes)
template <class M>
uint32_t stepped_lanes(const M& m, const uint32_t* w, int A) {
  if constexpr (kEdits<M>) {
    return m.active_lanes(w);
  } else {
    const int q = m.quiet_from(w);
    return q >= 32 ? ~0u : (1u << q) - 1u;
  }
}


// K1's edit branch on the host: per active lane the edit, its columns
// (edit_head) and each child word from the row word (child_word); the
// fingerprint from the row's folds, each changed word refolded
void step_edit(const AbdOrderedModel& m, const uint32_t* rows, int f,
               uint32_t* out) {
  const int W = m.width(), A = m.max_actions();
  for (int r = 0; r < f; ++r) {
    const uint32_t* w = rows + (long)r * W;
    *out++ = m.props_row(w);
    const uint32_t mask = m.active_lanes(w);
    uint32_t r1, r2;
    fold_row(w, W, r1, r2);
    for (int e = 0; e < A; ++e) {
      uint32_t* flags = out++;
      uint32_t* fp = out;
      out += 2;
      bool ovf = false, v = false;
      const bool on = (mask >> e) & 1u;
      uint32_t h1 = r1, h2 = r2;
      if (on) {
        AbdOrderedModel::Edit ed;
        v = m.edit_lane(w, e, ed, ovf);
        const AbdOrderedModel::Head h = m.edit_head(ed);
        for (int k = 0; k < W; ++k) {
          out[k] = m.child_word(w, ed, h, k, w[k]);
          if (out[k] != w[k]) fold_change(h1, h2, k, w[k], out[k]);
        }
      } else {
        for (int k = 0; k < W; ++k) out[k] = 0u;
      }
      fp64_finish(h1, h2, W, fp[0], fp[1]);
      *flags = (v ? 1u : 0u) | (ovf ? 2u : 0u) | (on ? 4u : 0u);
      out += W;
    }
  }
}

// A group of G lanes on the host (step_common.cuh WarpGroup's
// collectives): each lane runs the device step on its own stack
// (ucontext), and each collective switches back to the scheduler, which
// runs every lane of the group to the same collective, computes its
// results as the warp's shuffles and ballots would, and resumes them.
struct Sched {
  int G = 0;
  ucontext_t main;
  ucontext_t lane[32];
  std::vector<char> stack[32];
  int kind[32];
  uint32_t in[32], out[32];
  uint32_t words[64];  // the group's shared words
  bool done[32];
  void (*body)(int) = nullptr;
};
Sched sched;

struct HostGroup {
  int r, n;
  uint32_t call(int k, uint32_t v) const {
    sched.kind[r] = k;
    sched.in[r] = v;
    swapcontext(&sched.lane[r], &sched.main);
    return sched.out[r];
  }
  int rank() const { return r; }
  int size() const { return n; }
  uint32_t* words() const { return sched.words; }
  void sync() const { call(5, 0u); }
  uint32_t down(uint32_t v) const { return call(1, v); }
  uint32_t up(uint32_t v) const { return call(2, v); }
  uint32_t ballot(bool p) const { return call(3, p ? 1u : 0u); }
  uint32_t xor_all(uint32_t v) const { return call(4, v); }
  uint32_t suffix_xor(uint32_t v) const { return call(6, v); }
};

void lane_entry(int r) {
  sched.body(r);
  sched.done[r] = true;
}

// Run body(r) for the G lanes of a group in lockstep; false when the
// lanes reach different collectives or some end before the others.
bool run_group(int G, void (*body)(int)) {
  sched.G = G;
  sched.body = body;
  for (int r = 0; r < G; ++r) {
    sched.stack[r].resize(1 << 16);
    getcontext(&sched.lane[r]);
    sched.lane[r].uc_stack.ss_sp = sched.stack[r].data();
    sched.lane[r].uc_stack.ss_size = sched.stack[r].size();
    sched.lane[r].uc_link = &sched.main;
    makecontext(&sched.lane[r], (void (*)())lane_entry, 1, r);
    sched.done[r] = false;
  }
  while (true) {
    for (int r = 0; r < G; ++r) swapcontext(&sched.main, &sched.lane[r]);
    int ended = 0;
    for (int r = 0; r < G; ++r) ended += sched.done[r];
    if (ended == G) return true;
    if (ended) return false;
    for (int r = 1; r < G; ++r)
      if (sched.kind[r] != sched.kind[0]) return false;
    uint32_t bits = 0u, x = 0u;
    for (int r = 0; r < G; ++r) {
      bits |= (sched.in[r] ? 1u : 0u) << r;
      x ^= sched.in[r];
    }
    uint32_t suffix = 0u;  // lanes r to G - 1, from the last down
    for (int r = G - 1; r >= 0; --r) {
      suffix ^= sched.in[r];
      switch (sched.kind[0]) {
        case 1: sched.out[r] = sched.in[r + 1 < G ? r + 1 : r]; break;
        case 2: sched.out[r] = sched.in[r >= 1 ? r - 1 : r]; break;
        case 3: sched.out[r] = bits; break;
        case 6: sched.out[r] = suffix; break;
        default: sched.out[r] = x;
      }
    }
  }
}

// One child by a group: the model, its row and lane, a delivery's record
// (a group model with crash lanes: phase A's), and each lane's results
// (which must agree).
struct GroupTask {
  const void* m;
  const uint32_t* w;
  int e;
  uint32_t* dst;
  const void* rec;
  bool v[32], ovf[32];
  uint32_t hi[32], lo[32];
};
GroupTask task;

// a delivery's record type (a group model with crash lanes), or none
template <class M>
struct RecordOf {
  using type = typename M::Record;
};
struct NoRecord {
  struct type {};
};

bool group_agrees(int G) {
  for (int x = 1; x < G; ++x)
    if (task.v[x] != task.v[0] || task.ovf[x] != task.ovf[0] ||
        task.hi[x] != task.hi[0] || task.lo[x] != task.lo[0])
      return false;
  return true;
}

template <class M>
void group_body(int r) {
  const M& m = *static_cast<const M*>(task.m);
  const HostGroup g{r, sched.G};
  bool ovf = false;
  if constexpr (actor::HasCrash<M>::value) {
    task.v[r] = m.deliver_group(
        task.w, task.e, *static_cast<const typename M::Record*>(task.rec),
        g, task.dst, ovf, task.hi[r], task.lo[r]);
  } else {
    task.v[r] = m.step_group(task.w, task.e, g, task.dst, ovf, task.hi[r],
                             task.lo[r]);
  }
  task.ovf[r] = ovf;
}

// a lossy row's suffix folds as K1 takes them: by a warp of 32 lanes
// (actor_net.cuh drop_suffix_folds), two words a slot (sfx[2 j])
struct SuffixTask {
  const void* m;
  const uint32_t* w;
  uint32_t s1[32], s2[32];
};
SuffixTask suffix_task;

template <class M>
void suffix_body(int r) {
  const M& m = *static_cast<const M*>(suffix_task.m);
  m.drop_suffix(suffix_task.w, HostGroup{r, 32}, suffix_task.s1[r],
                suffix_task.s2[r]);
}

// 0, or 4 when the lanes reach different collectives
template <class M>
int row_suffix(const M& m, const uint32_t* w, uint32_t* sfx) {
  suffix_task = SuffixTask{&m, w};
  if (!run_group(32, suffix_body<M>)) return 4;
  for (int j = 0; j < m.E; ++j) {  // slot j's in lane 2 j
    sfx[2 * j] = suffix_task.s1[2 * j];
    sfx[2 * j + 1] = suffix_task.s2[2 * j];
  }
  return 0;
}

// a drop lane's child as K1 builds it: its words by a group of 8 lanes
// (drop_write, 16-byte vectors or not), its fingerprint from the row's
// folds and suffix folds by the group's first lane (drop_fold)
constexpr int kDropLanes = 8;
template <class M>
bool drop_child(const M& m, const uint32_t* w, int e, const uint32_t* sfx,
                bool vec, uint32_t* out, uint32_t* fp) {
  uint32_t r1, r2;
  fold_row(w, m.width(), r1, r2);
  const actor::DropEdit ed = m.drop_edit(w, e);
  for (int r = 0; r < kDropLanes; ++r)
    m.drop_write(w, ed, r, kDropLanes, out, vec);
  m.drop_fold(w, ed, sfx, r1, r2, fp[0], fp[1]);
  return ed.valid;
}

// per row, per drop lane E + j: whether it is active, then K1's valid
// flag, fingerprint (hi, lo) and words (drop_child), then the thread's
// (drop_lane)
template <class M>
int drops(const M& m, bool vec, const uint32_t* rows, int f, uint32_t* out) {
  const int W = m.width();
  if (vec && (W & 3)) return 3;
  uint32_t sfx[32];
  for (int r = 0; r < f; ++r) {
    const uint32_t* w = rows + (long)r * W;
    const uint32_t on = m.active_lanes(w);
    if (row_suffix(m, w, sfx)) return 4;
    for (int j = 0; j < m.E; ++j) {
      const int e = m.E + j;
      uint32_t* o = out + ((long)r * m.E + j) * (7 + 2 * W);
      o[0] = (on >> e) & 1u;
      if (!o[0]) continue;
      o[1] = drop_child(m, w, e, sfx, vec, o + 7, o + 2);
      o[4] = drop_lane(m, w, e, o + 7 + W, o + 5);
    }
  }
  return 0;
}

// K1's wide branch on the host: every lane below the quiet lane through
// step_row (the child folded in full, RowOut), the quiet lanes the row;
// with crash lanes the active deliveries through step_row, each crash or
// restart child as crash_lane, each drop child as drop_child (16-byte
// vectors where the width is a multiple of four, as K1), the inactive
// lanes unwritten (their fingerprint the row's)
template <class M>
int step_wide(const M& m, const uint32_t* rows, int f, uint32_t* out) {
  const int W = m.width(), A = m.max_actions();
  constexpr bool kCrash = kEdits<M>;
  for (int r = 0; r < f; ++r) {
    const uint32_t* w = rows + (long)r * W;
    *out++ = m.props_row(w);
    const uint32_t on = stepped_lanes(m, w, A);
    uint32_t r1, r2;
    fold_row(w, W, r1, r2);
    uint32_t sfx[32];
    if constexpr (Lossy<M>::value)
      if (row_suffix(m, w, sfx)) return 4;
    for (int e = 0; e < A; ++e) {
      uint32_t* flags = out++;
      uint32_t* fp = out;
      out += 2;
      bool ovf = false, v = false;
      const bool stepped = (on >> e) & 1u;
      uint32_t h1 = r1, h2 = r2;
      bool crash = false;
      if constexpr (kCrash) crash = stepped && e >= m.E;
      if (crash) {
        if constexpr (Lossy<M>::value) {
          v = drop_child(m, w, e, sfx, (W & 3) == 0, out, fp);
        } else if constexpr (kCrash) {
          v = crash_lane(m, w, e, out, fp);
        }
      } else if (stepped) {
        Out o{out};
        v = m.step_row(w, e, o, ovf);
        fold_row(out, W, h1, h2);
      } else if (!kCrash) {
        for (int k = 0; k < W; ++k) out[k] = w[k];
        fold_row(out, W, h1, h2);
      }
      if (!crash) fp64_finish(h1, h2, W, fp[0], fp[1]);
      *flags = (v ? 1u : 0u) | (ovf ? 2u : 0u) | (stepped ? 4u : 0u);
      out += W;
    }
  }
  return 0;
}

// K1's group branch on the host: every lane below the quiet lane (a
// crash model's active lanes) built by a group of G lanes (its words
// straight to its row of the output, its fingerprint the group's); the
// quiet lanes the row, its fingerprint (a crash model's inactive lanes
// unwritten, the row's fingerprint)
template <class M>
int step_group(const M& m, int G, const uint32_t* rows, int f,
               uint32_t* out) {
  const int W = m.width(), A = m.max_actions();
  constexpr bool kCrash = actor::HasCrash<M>::value;
  if (G < m.E || G > 32 || A > 32) return 3;
  for (int r = 0; r < f; ++r) {
    const uint32_t* w = rows + (long)r * W;
    *out++ = m.props_row(w);
    const uint32_t on = stepped_lanes(m, w, A);
    for (int e = 0; e < A; ++e) {
      uint32_t* flags = out++;
      uint32_t* fp = out;
      out += 2;
      bool ovf = false, v = false;
      const bool stepped = (on >> e) & 1u;
      bool crash = false;
      if constexpr (kCrash) crash = stepped && e >= m.E;
      if (crash) {
        if constexpr (kCrash) v = crash_lane(m, w, e, out, fp);
      } else if (stepped) {
        // with crash lanes phase A by one thread, then the group
        task = GroupTask{&m, w, e, out, nullptr};
        typename std::conditional_t<kCrash, RecordOf<M>, NoRecord>::type rec;
        if constexpr (kCrash) {
          m.deliver_scalar(w, e, rec);
          task.rec = &rec;
        }
        if (!run_group(G, group_body<M>)) return 4;
        if (!group_agrees(G)) return 5;
        v = task.v[0];
        ovf = task.ovf[0];
        fp[0] = task.hi[0];
        fp[1] = task.lo[0];
      } else {
        if (!kCrash)
          for (int k = 0; k < W; ++k) out[k] = w[k];
        uint32_t h1, h2;
        fold_row(w, W, h1, h2);
        fp64_finish(h1, h2, W, fp[0], fp[1]);
      }
      *flags = (v ? 1u : 0u) | (ovf ? 2u : 0u) | (stepped ? 4u : 0u);
      out += W;
    }
  }
  return 0;
}

// a crash model's row lanes by a group of 32 lanes (crash_row_lanes), as
// K1 takes them: every lane's results
struct RowLanesTask {
  const void* m;
  const uint32_t* w;
  uint32_t pb[32], mask[32];
};
RowLanesTask lanes_task;

template <class M>
void row_lanes_body(int r) {
  const M& m = *static_cast<const M*>(lanes_task.m);
  m.row_lanes(lanes_task.w, HostGroup{r, 32}, lanes_task.pb[r],
              lanes_task.mask[r]);
}

// per row: the warp's property bits and lanes, then props_row's and
// active_lanes' (a thread's); 4 when the lanes disagree
template <class M>
int row_lanes(const M& m, const uint32_t* rows, int f, uint32_t* out) {
  const int W = m.width();
  for (int r = 0; r < f; ++r) {
    const uint32_t* w = rows + (long)r * W;
    lanes_task = RowLanesTask{&m, w};
    if (!run_group(32, row_lanes_body<M>)) return 4;
    for (int x = 1; x < 32; ++x)
      if (lanes_task.pb[x] != lanes_task.pb[0] ||
          lanes_task.mask[x] != lanes_task.mask[0])
        return 4;
    *out++ = lanes_task.pb[0];
    *out++ = lanes_task.mask[0];
    *out++ = m.props_row(w);
    *out++ = m.active_lanes(w);
  }
  return 0;
}

// a narrow model's K1 (a thread a lane): per row the property bits, per
// lane the flags, the fingerprint (every word of the child folded, as
// step_common.cuh fp64) and the child's words
template <class M>
int step_narrow(const M& m, const uint32_t* rows, int f, uint32_t* out) {
  if (!m.ok()) return 1;
  const int W = m.width(), A = m.max_actions();
  for (int r = 0; r < f; ++r) {
    uint32_t w[M::W] = {};
    for (int k = 0; k < W; ++k) w[k] = rows[(long)r * W + k];
    *out++ = m.props(w);
    for (int e = 0; e < A; ++e) {
      uint32_t s[M::W];
      bool ovf = false;
      const bool v = m.step(w, e, s, ovf);
      uint32_t h1 = 0u, h2 = 0u;
      for (int k = 0; k < W; ++k) fold_word(h1, h2, k, s[k]);
      *out++ = (v ? 1u : 0u) | (ovf ? 2u : 0u) | 4u;
      fp64_finish(h1, h2, W, out[0], out[1]);
      out += 2;
      for (int k = 0; k < W; ++k) *out++ = s[k];
    }
  }
  return 0;
}

// a timer model's row by a group of G lanes (row_fold), as K1 takes it:
// every lane's results
struct FoldTask {
  const void* m;
  const uint32_t* w;
  uint32_t h1[32], h2[32], pb[32], lanes[32];
};
FoldTask fold_task;

template <class M>
void fold_body(int r) {
  const M& m = *static_cast<const M*>(fold_task.m);
  m.row_fold(fold_task.w, HostGroup{r, sched.G}, fold_task.h1[r],
             fold_task.h2[r], fold_task.pb[r], fold_task.lanes[r]);
}

// K1's timer branch on the host (step_common.cuh TimerRow): per row its
// folds, property bits and Timeout lanes by a group of G lanes (row_fold:
// 4 when the lanes disagree);
// per lane the flags (4: active), the fingerprint (an active lane's from
// the row's folds, timer_fold; every other lane's the row's) and the
// child's words (an active lane's the row with its edit, timer_word;
// every other lane's left zero)
template <class M>
int step_timer(const M& m, int G, const uint32_t* rows, int f,
               uint32_t* out) {
  if (!m.ok() || G < 1 || G > 32) return 1;
  const int W = m.width(), A = m.max_actions();
  for (int r = 0; r < f; ++r) {
    const uint32_t* row = rows + (long)r * W;
    fold_task = FoldTask{&m, row};
    if (!run_group(G, fold_body<M>)) return 4;
    for (int x = 1; x < G; ++x)
      if (fold_task.h1[x] != fold_task.h1[0] ||
          fold_task.h2[x] != fold_task.h2[0] ||
          fold_task.pb[x] != fold_task.pb[0] ||
          fold_task.lanes[x] != fold_task.lanes[0])
        return 4;
    const uint32_t lanes = fold_task.lanes[0];
    *out++ = fold_task.pb[0];
    for (int e = 0; e < A; ++e) {
      uint32_t* flags = out++;
      uint32_t* fp = out;
      out += 2;
      const bool on = e > 0 && ((lanes >> (e - 1)) & 1u);
      if (on) {
        const typename M::Edit ed = m.timer_edit(row, e - 1);
        m.timer_fold(row, ed, fold_task.h1[0], fold_task.h2[0], fp[0],
                     fp[1]);
        for (int k = 0; k < W; ++k) out[k] = m.timer_word(ed, k, row[k]);
      } else {
        fp64_finish(fold_task.h1[0], fold_task.h2[0], W, fp[0], fp[1]);
        for (int k = 0; k < W; ++k) out[k] = 0u;
      }
      *flags = on ? 5u : 0u;
      out += W;
    }
  }
  return 0;
}

// the model's K1: a wide model's RowOut (lanes 0), a group model's group
// branch with groups of that many lanes
template <class M>
int run(const M& m, int lanes, const uint32_t* rows, int f, uint32_t* out) {
  if (!m.ok()) return 1;
  if constexpr (std::is_base_of_v<PaxosModel, M> ||
                std::is_base_of_v<PingPongLossyModel, M>) {
    return lanes ? 6 : step_wide(m, rows, f, out);
  } else {
    return lanes ? step_group(m, lanes, rows, f, out) : 6;
  }
}
}  // namespace

extern "C" {
int h_reg_chan(uint32_t src, uint32_t dst, int c, int s) {
  return actor::reg_chan(src, dst, c, s);
}
void h_reg_chan_ends(int ch, int c, int s, uint32_t* src, uint32_t* dst) {
  actor::reg_chan_ends(ch, c, s, *src, *dst);
}
// 0: the shared row's words, 1: the edit's (OrderedEdit) or a delivery
// record's (DeliveryRecord, made odd: step_common.cuh slot_words), by
// model
int h_words(const char* name, int what) {
  const std::string n(name);
  if (n == "abd_ordered")
    return what ? (int)(sizeof(AbdOrderedModel::Edit) / 4)
                : AbdOrderedModel::W;
  if (n == "write_once" && what)
    return (int)(sizeof(WriteOnceModel::Record) / 4) | 1;
  if (n == "abd") return AbdModel::W;
  if (n == "single_copy") return SingleCopyModel::W;
  if (n == "paxos") return PaxosModel::W;
  if (n == "paxos_crash") return PaxosCrashModel::W;
  if (n == "paxos_lossy") return PaxosLossyModel::W;
  if (n == "ping_pong") return PingPongLossyModel::W;
  if (n == "timer_count") return TimerCountModel::W;
  if (n == "write_once") return WriteOnceModel::W;
  return -1;
}
// the model's step over its cuda_spec parameters p (np of them)
int h_step(const char* name, const int* p, int np, int lanes,
           const uint32_t* rows, int f, uint32_t* out) {
  const std::string n(name);
  if (n == "abd_ordered") {
    const AbdOrderedModel m(p[0], p[1], p[2]);
    if (!m.ok() || lanes) return 1;
    step_edit(m, rows, f, out);
    return 0;
  }
  if (n == "abd") return run(AbdModel(p[0], p[1], p[2]), lanes, rows, f, out);
  if (n == "single_copy")
    return run(SingleCopyModel(p[0], p[1], p[2]), lanes, rows, f, out);
  if (n == "paxos")
    return run(PaxosModel(p[0], p[1], p[2]), lanes, rows, f, out);
  if (n == "paxos_lossy")
    return run(PaxosLossyModel(p[0], p[1], p[2]), lanes, rows, f, out);
  // ping_pong: lanes 0 its one-lane step (PingPongModel::step, a thread a
  // lane: the lossless K1), -1 the lossy K1's wide branch
  if (n == "ping_pong" && np == 4) {
    if (lanes == 0)
      return step_narrow(PingPongModel(p[0], p[1], p[2], p[3]), rows, f,
                         out);
    if (lanes != -1 || !p[3]) return 6;
    return run(PingPongLossyModel(p[0], p[1], p[2]), 0, rows, f, out);
  }
  // timer_count: K1's timer branch, a row by a group of that many lanes
  if (n == "timer_count" && np == 2)
    return step_timer(TimerCountModel(p[0], p[1]), lanes, rows, f, out);
  if (np != 8) return 2;
  const actor::CrashSpec cr{p[3], p[4], (uint32_t)p[5], (uint32_t)p[6],
                            (uint32_t)p[7]};
  if (n == "paxos_crash")
    return run(PaxosCrashModel(p[0], p[1], p[2], cr), lanes, rows, f, out);
  if (n == "write_once")
    return run(WriteOnceModel(p[0], p[1], p[2], cr), lanes, rows, f, out);
  return 2;
}
// a lossy model's drop children by a warp and by a thread (drops above)
int h_drops(const char* name, const int* p, int np, int vec,
            const uint32_t* rows, int f, uint32_t* out) {
  const std::string n(name);
  if (n == "paxos_lossy" && np == 3)
    return drops(PaxosLossyModel(p[0], p[1], p[2]), vec, rows, f, out);
  if (n == "ping_pong" && np == 4 && p[3])
    return drops(PingPongLossyModel(p[0], p[1], p[2]), vec, rows, f, out);
  return 2;
}
// a crash model's row lanes (row_lanes above)
int h_row_lanes(const char* name, const int* p, int np, const uint32_t* rows,
                int f, uint32_t* out) {
  const std::string n(name);
  if (n == "paxos_lossy" && np == 3)
    return row_lanes(PaxosLossyModel(p[0], p[1], p[2]), rows, f, out);
  if (n == "ping_pong" && np == 4 && p[3])
    return row_lanes(PingPongLossyModel(p[0], p[1], p[2]), rows, f, out);
  if (np != 8) return 2;
  const actor::CrashSpec cr{p[3], p[4], (uint32_t)p[5], (uint32_t)p[6],
                            (uint32_t)p[7]};
  if (n == "paxos_crash")
    return row_lanes(PaxosCrashModel(p[0], p[1], p[2], cr), rows, f, out);
  if (n == "write_once")
    return row_lanes(WriteOnceModel(p[0], p[1], p[2], cr), rows, f, out);
  return 2;
}
}
"""


@pytest.fixture(scope="module")
def host(tmp_path_factory):
    """The device functions built for the host (``g++``), by ctypes."""
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("no g++ to build the device functions for the host")
    d = tmp_path_factory.mktemp("host_cuda")
    src = d / "host.cpp"
    src.write_text(HOST_SOURCE)
    lib = d / "libhost.so"
    subprocess.run([cxx, "-std=c++17", "-O1", "-shared", "-fPIC",
                    f"-I{CSRC}", str(src), "-o", str(lib)], check=True,
                   capture_output=True, text=True)
    h = ctypes.CDLL(str(lib))
    h.h_reg_chan.argtypes = [ctypes.c_uint32, ctypes.c_uint32, ctypes.c_int,
                             ctypes.c_int]
    h.h_reg_chan_ends.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                  ctypes.POINTER(ctypes.c_uint32),
                                  ctypes.POINTER(ctypes.c_uint32)]
    h.h_words.argtypes = [ctypes.c_char_p, ctypes.c_int]
    h.h_step.argtypes = [ctypes.c_char_p, ctypes.c_void_p, ctypes.c_int,
                         ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                         ctypes.c_void_p]
    h.h_row_lanes.argtypes = [ctypes.c_char_p, ctypes.c_void_p, ctypes.c_int,
                              ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    h.h_drops.argtypes = [ctypes.c_char_p, ctypes.c_void_p, ctypes.c_int,
                          ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                          ctypes.c_void_p]
    return h


def _reg_chan_ends(host, ch, c, s):
    src, dst = ctypes.c_uint32(), ctypes.c_uint32()
    host.h_reg_chan_ends(ch, c, s, ctypes.byref(src), ctypes.byref(dst))
    return src.value, dst.value


def _admitted_ordered():
    for c in range(1, 8):
        for s in range(1, 5):
            for d in range(1, 17):
                model = PackedAbd(c, server_count=s, ordered=True,
                                  channel_depth=d)
                if (model.packed_width <= _cuda.row_words("abd_ordered")
                        and model.max_actions <= 32):
                    yield model


@pytest.mark.parametrize("clients", range(1, 8))
@pytest.mark.parametrize("servers", range(1, 5))
def test_channel_arithmetic_is_the_layouts(host, clients, servers):
    """``reg_chan`` maps each declared (sender, recipient) to its index
    in ``register_channels()`` and every other pair to -1;
    ``reg_chan_ends`` inverts it."""
    model = PackedAbd(clients, server_count=servers, ordered=True)
    chans = model.register_channels()
    assert [tuple(x) for x in model.ordered_channels] == chans
    n = clients + servers
    for ch, (src, dst) in enumerate(chans):
        assert host.h_reg_chan(src, dst, clients, servers) == ch
        assert _reg_chan_ends(host, ch, clients, servers) == (src, dst)
    declared = set(chans)
    for src in range(n + 2):
        for dst in range(n + 2):
            if (src, dst) not in declared:
                assert host.h_reg_chan(src, dst, clients, servers) == -1


def test_edit_size_is_the_launchs(host):
    """The launch sizes shared memory with the device structs' own
    sizes: ``AbdOrderedModel::W`` and ``sizeof(Edit)`` (``OrderedEdit<6,
    3>``: the destination's 6 words, the 22 history words of 7 clients,
    3 appended messages of two words, 5 scalars and the 3 appends'
    length columns and entry words), and each wide and group model's
    ``W``."""
    edit = 6 + (1 + 3 * 7) + 2 * 3 + 5 + 2 * 3
    assert _cuda.EDIT_MODELS["abd_ordered"] == (
        host.h_words(b"abd_ordered", 0), host.h_words(b"abd_ordered", 1))
    assert _cuda.EDIT_MODELS["abd_ordered"][1] == edit
    for name, words in {**_cuda.WIDE_MODELS, **_cuda.GROUP_MODELS}.items():
        assert host.h_words(name.encode(), 0) == words == \
            _cuda.row_words(name)


def test_k1_launch_fits_at_every_admitted_ordered_configuration():
    """At every admitted configuration and frontier the edit K1's tile
    holds at most 32 rows, its threads are whole warps, the blocks cover
    the frontier, and ``EDIT_BLOCKS_PER_SM`` blocks fit an SM's shared
    memory."""
    n = 0
    for model in _admitted_ordered():
        n += 1
        a, w = model.max_actions, model.packed_width
        for f in (1, 37, 256, 4096, 8192):
            geo = _cuda.tile_geometry(f, a, SMS)
            wide, smem = _cuda.k1_launch("abd_ordered", geo, f, w, a, SMS)
            assert 1 <= wide.rows <= _cuda.WIDE_ROWS
            assert wide.threads % 32 == 0 and wide.threads <= 128
            assert wide.blocks * wide.rows >= f
            assert smem <= BLOCK_SMEM
            assert _cuda.EDIT_BLOCKS_PER_SM * (smem + RESERVED) <= SM_SMEM
    assert n > 100
    assert PackedAbd(2, server_count=3, ordered=True,
                     channel_depth=8).packed_width == 331


@pytest.mark.parametrize("make", [
    lambda c, s: PackedAbd(c, server_count=s),
    lambda c, s: PackedSingleCopy(c, s)], ids=["abd", "single-copy"])
def test_unordered_register_rows_fit_the_wide_k1(make):
    """Every unordered ABD and single-copy configuration of at most 7
    clients, 4 servers and 16 slots fits the group K1's 128-word shared
    row (the wide K1's, which it replaced), and its launch's shared
    memory fits a block."""
    for c in range(1, 8):
        for s in range(1, 5):
            model = make(c, s)
            name = model.cuda_spec()[0]
            assert model.packed_width <= _cuda.GROUP_MODELS[name] == 128
            geo = _cuda.tile_geometry(8192, model.max_actions, SMS)
            _wide, smem = _cuda.k1_launch(name, geo, 8192,
                                          model.packed_width,
                                          model.max_actions, SMS)
            assert smem <= BLOCK_SMEM


def _admitted_unordered():
    """Every unordered ABD and single-copy configuration ``cuda_spec``
    admits: up to 7 clients, 4 servers and 16 slots."""
    for c in range(1, 8):
        for s in range(1, 5):
            for e in (1, 4, 8, 16):
                yield PackedAbd(c, server_count=s, net_capacity=e)
                yield PackedSingleCopy(c, s, net_capacity=e)


def _group_smem(rows, a, threads):
    """The group K1's dynamic shared memory: per row its ``RowState``
    (128 words and 16 bytes of flags), four info words, four words of
    the count, the tile's active lanes, two words a thread (a group's
    child's history of at most 22 words, 2 G words a group)."""
    return (rows * (4 * 128 + 16)
            + 4 * (4 * (rows + 1) + rows * a + 2 * threads))


def test_group_k1_launch_fits_at_every_admitted_unordered_configuration():
    """At every admitted unordered register configuration and frontier
    the group K1's launch (``k1_launch``) holds at most 32 rows a block
    (``kWideRows``: one warp scans them), whole warps of half-warp groups
    (``kGroupLanes``, at least the network's slots: slot j in lane j),
    blocks that cover the frontier, shared memory with no staging rows
    (the layout of ``step_common.cuh`` ``WideSmem``, two words a thread),
    and ``GROUP_BLOCKS_PER_SM`` blocks fit an SM's shared memory."""
    n = 0
    lanes = _step_constant("kGroupLanes")
    assert lanes == 16 and _step_constant("kGroupSlotWords") == \
        _cuda.GROUP_SLOT_WORDS == 2
    assert _cuda.GROUP_THREADS % 32 == 0 and _cuda.GROUP_THREADS <= 1024
    for model in _admitted_unordered():
        name = model.cuda_spec()[0]
        a, w = model.max_actions, model.packed_width
        assert name in _cuda.GROUP_MODELS and _cuda.pending_rows(name)
        assert w <= _cuda.row_words(name) and a <= lanes
        n += 1
        for f in (1, 37, 256, 512, 4096, 9954, 12288):
            geo = _cuda.tile_geometry(f, a, SMS)
            wide, smem = _cuda.k1_launch(name, geo, f, w, a, SMS)
            assert 1 <= wide.rows <= _cuda.WIDE_ROWS == 32
            assert wide.threads == _cuda.GROUP_THREADS
            assert wide.blocks * wide.rows >= f
            assert (wide.blocks - 1) * wide.rows < f
            assert smem == _group_smem(wide.rows, a, wide.threads) \
                <= BLOCK_SMEM
            assert _cuda.GROUP_BLOCKS_PER_SM * (smem + RESERVED) <= SM_SMEM
    assert n == 7 * 4 * 4 * 2


def _write_once_smem(rows, a, threads):
    """The write-once register's K1 shared memory: as ``_group_smem`` but
    a thread's slot the delivery record of its phase A
    (``GROUP_RECORD_WORDS``: 27 words)."""
    return (rows * (4 * 128 + 16)
            + 4 * (4 * (rows + 1) + rows * a + 27 * threads))


def _admitted_write_once():
    """Write-once configurations ``cuda_spec`` admits, with and without
    crash/restart: up to 7 clients, 4 servers, 16 slots, 8 actors."""
    for c in range(1, 8):
        for s in range(1, 5):
            if c + s > 8:
                continue
            for e in (1, 8, 16):
                yield PackedWriteOnce(c, server_count=s, net_capacity=e)
                yield PackedWriteOnce(c, server_count=s, net_capacity=e,
                                      durable=False).crash_restart(2)
                yield PackedWriteOnce(c, server_count=s,
                                      net_capacity=e).crash_restart(
                                          7, actors=[0])


def test_group_record_is_the_devices(host):
    """The host's words of a delivery record (``GROUP_RECORD_WORDS``, a
    thread's slot in the write-once register's K1) are the device
    struct's (``actor_net.cuh`` ``DeliveryRecord<WriteOnceModel>``: the
    history's 22 words, one new destination word, a send's three, the
    flags) made odd, so that the 32 threads of a warp write word ``q`` of
    their records to 32 distinct banks and a group reads one record's
    consecutive words from distinct banks; the crash edit a crash lane's
    thread leaves in the same slot fits it."""
    words = _cuda.GROUP_RECORD_WORDS["write_once"]
    assert words == host.h_words(b"write_once", 1) == (22 + 1 + 3 + 1) | 1
    assert set(_cuda.GROUP_RECORD_WORDS) <= set(_cuda.GROUP_MODELS)
    lane = np.arange(32)
    for q in range(words):
        assert len(set(((lane * words + q) % 32).tolist())) == 32
    assert len(set(((5 * words + np.arange(words)) % 32).tolist())) == \
        min(words, 32)


@pytest.mark.parametrize("sms", [1, 132])
def test_write_once_k1_launch_fits(sms):
    """At every admitted write-once configuration and frontier the group
    K1's launch (``k1_launch``) holds at most 32 rows a block, the
    records of its 128 threads in shared memory, blocks that cover the
    frontier, and ``GROUP_BLOCKS_PER_SM`` blocks fit an SM's shared
    memory; a delivery lane is a network slot (at most ``kGroupLanes``)
    and the crash lanes fit the 32-lane mask."""
    n = 0
    for model in _admitted_write_once():
        name = model.cuda_spec()[0]
        a, w = model.max_actions, model.packed_width
        assert name == "write_once" and _cuda.pending_rows(name)
        assert w <= _cuda.row_words(name) and a <= 32
        assert a - 2 * len(getattr(model, "_crash_idx", ())) \
            <= _step_constant("kGroupLanes")
        n += 1
        for f in (1, 37, 256, 1024, 7281, 12288):
            geo = _cuda.tile_geometry(f, a, sms)
            wide, smem = _cuda.k1_launch(name, geo, f, w, a, sms)
            assert 1 <= wide.rows <= _cuda.WIDE_ROWS
            assert wide.threads == _cuda.GROUP_THREADS
            assert wide.blocks * wide.rows >= f > (wide.blocks - 1) * wide.rows
            assert smem == _write_once_smem(wide.rows, a, wide.threads) \
                <= BLOCK_SMEM
            assert _cuda.GROUP_BLOCKS_PER_SM * (smem + RESERVED) <= SM_SMEM
    assert n == 22 * 3 * 3


def test_group_k1_launch_at_the_register_steps():
    """The group K1's launch at the steps its runs launch on an H100:
    PackedAbd(2)'s 256-row small step, PackedSingleCopy(3)'s 9,954-row and
    PackedSingleCopy(4)'s 9,475-row large steps (``auto_fmax``) take a
    few rows a block, their blocks
    resident at once, and under the gate spread their pending rows (54,
    ~588, 512 of 512; PackedSingleCopy(4)'s 9,475 of 9,475: a few) at
    most two a block, or as many as the geometry's rows."""
    from stateright_tpu_torch.checker.gpu import auto_fmax
    for model, f, take in ((PackedAbd(2), 256, 54),
                           (PackedSingleCopy(3), 9954, 588),
                           (PackedSingleCopy(3), 512, 512),
                           (PackedSingleCopy(4), 9475, 9475)):
        name = model.cuda_spec()[0]
        a, w = model.max_actions, model.packed_width
        if f > 512:  # the large step (chip_smoke.py REGISTER_STEPS)
            assert auto_fmax(model) == f
        wide, _smem = _cuda.k1_launch(name, _cuda.tile_geometry(f, a, SMS),
                                      f, w, a, SMS)
        assert wide.blocks <= _cuda.GROUP_BLOCKS_PER_SM * SMS + SMS
        span = _cuda.pending_span(take, wide.blocks, wide.rows)
        assert span <= (2 if take < f else wide.rows)


@pytest.mark.parametrize("sms", [1, 66, 114, 132])
@pytest.mark.parametrize("name", ["abd", "single_copy"])
def test_pending_span_covers_every_pending_row_once(name, sms):
    """The gated group K1's spread (``pending_span``, mirroring
    ``step_common.cuh``'s): over a grid of frontiers ``F`` and pending
    counts ``take <= F``, with each instantiation's launch, the blocks'
    spans ``[b * span, min(take, (b + 1) * span))`` cover every pending
    row exactly once and no row past ``take``, and no block takes more
    rows than its shared memory holds (the geometry's ``rows``). The
    wide and edit K1s step every row of their tiles."""
    assert _cuda.pending_rows(name)
    assert not any(_cuda.pending_rows(n) for n in (
        *_cuda.WIDE_MODELS, *_cuda.EDIT_MODELS))
    a, w = {"abd": (16, 82), "single_copy": (16, 79)}[name]
    for f in (1, 2, 31, 32, 33, 256, 512, 1055, 1728, 8192, 9954, 12288):
        wide, _smem = _cuda.k1_launch(name, _cuda.tile_geometry(f, a, sms),
                                      f, w, a, sms)
        for take in sorted({0, 1, 2, f // 3, f - 1, f, 54, 588} - {-1}):
            if take > f:
                continue
            span = _cuda.pending_span(take, wide.blocks, wide.rows)
            assert span <= wide.rows
            hits = np.zeros(f, dtype=np.int64)
            for b in range(wide.blocks):
                lo, hi = b * span, min(take, (b + 1) * span)
                if hi > lo:
                    hits[lo:hi] += 1
            assert (hits[:take] == 1).all() and (hits[take:] == 0).all()


def _reachable(model, limit):
    """The first ``limit`` states of a host BFS, encoded."""
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


def _crowded(model, rows, rng, k):
    """``k`` of ``rows`` with about a third of their FIFO channels filled
    to the depth with messages of an unknown type: appends there
    overflow."""
    out = []
    depth = model.channel_depth
    for row in rows[rng.choice(len(rows), k)]:
        row = row.copy()
        for ch in range(model._n_chan):
            if rng.random() < 0.3:
                for j in range(int(row[model._net_off + ch]), depth):
                    off = model._msgs_off + (ch * depth + j) * 2
                    row[off], row[off + 1] = (14 << 24) | j, j
                row[model._net_off + ch] = depth
        out.append(row)
    return np.stack(out)


def _at_budget(model, rows, rng, k):
    """``k`` of ``rows`` with each crashable actor's crash count set to
    the model's budget (its down bit kept): rows whose crash lanes are
    all spent, which a short search at a budget of two does not reach."""
    out = rows[rng.choice(len(rows), k)].copy()
    for a in model._crash_idx.tolist():
        cw = out[:, model._crash_off]
        cw = (cw & ~np.uint32(7 << (4 * a))) \
            | np.uint32(model.max_crashes_ << (4 * a))
        out[:, model._crash_off] = cw
    return out


#: the configurations whose device step is held lane for lane: ABD on
#: the ordered network (the BASELINE's, abd3, tpu_abd2, the smallest and
#: one with a single server and deep channels), ABD unordered,
#: single-copy (seven clients: a history of 22 words, more than a
#: half-warp's lanes) and Paxos
HOST_STEPS = {
    "abd-ordered-2": lambda: PackedAbd(2, ordered=True),
    "abd-ordered-3x2-d8": lambda: PackedAbd(3, server_count=2, ordered=True,
                                            channel_depth=8),
    "abd-ordered-2x3-d8": lambda: PackedAbd(2, server_count=3, ordered=True,
                                            channel_depth=8),
    "abd-ordered-1x1": lambda: PackedAbd(1, server_count=1, ordered=True),
    "abd-ordered-1x4-d6": lambda: PackedAbd(1, server_count=4, ordered=True,
                                            channel_depth=6),
    "abd-2": lambda: PackedAbd(2),
    "abd-3x2": lambda: PackedAbd(3, server_count=2),
    "abd-2x3": lambda: PackedAbd(2, server_count=3),
    "single-copy-3": lambda: PackedSingleCopy(3),
    "single-copy-2x2": lambda: PackedSingleCopy(2, 2),
    "single-copy-4x2": lambda: PackedSingleCopy(4, 2),
    "single-copy-7": lambda: PackedSingleCopy(7),
    "abd-7x2": lambda: PackedAbd(7, server_count=2),
    "paxos-1": lambda: PackedPaxos(1),
    "paxos-2": lambda: PackedPaxos(2),
    "write-once-2": lambda: PackedWriteOnce(2).crash_restart(1, actors=[0]),
    "write-once-2-volatile": lambda: PackedWriteOnce(
        2, durable=False).crash_restart(1, actors=[0]),
    "write-once-7x16-k2": lambda: PackedWriteOnce(
        7, net_capacity=16).crash_restart(2, actors=[0]),
    "write-once-2x2-all": lambda: PackedWriteOnce(
        2, server_count=2, durable=False).crash_restart(1),
    "write-once-3-no-crash": lambda: PackedWriteOnce(3),
    "paxos-1-crash": lambda: PackedPaxos(1).crash_restart(
        1, actors=[0, 1, 2]),
    "paxos-2-crash-all-k2": lambda: PackedPaxos(2).crash_restart(2),
    "paxos-1-lossy": lambda: PackedPaxos(1).lossy_network(True),
    "paxos-2-lossy": lambda: PackedPaxos(2).lossy_network(True),
}

#: the instantiations with crash/restart lanes (``csrc/step_common.cuh``
#: ``CrashLanes``): K1 steps their active lanes only, a lane mask (the
#: write-once register's without crashes too)
CRASH_MODELS = ("write_once", "paxos_crash")
#: the instantiations with drop lanes (``DropLanes``): K1 steps their
#: active lanes only, a lane mask (``chip_smoke.py`` ``lossy_active``)
LOSSY_MODELS = ("paxos_lossy",)


def _counts_up(model, rows, rng, k):
    """``k`` of ``rows`` with the count of about half their occupied
    network slots raised to 2 or 3: a drop there keeps the slot (its
    count less one), which a short search seldom reaches."""
    out = rows[rng.choice(len(rows), k)].copy()
    e = model.net_capacity
    for row in out:
        net = row[model._net_off:model._net_off + 4 * e].reshape(e, 4)
        for j in range(e):
            if net[j, 0] and rng.random() < 0.5:
                net[j, 1] = rng.integers(2, 4)
    return out


def _chip_smoke():
    """``chip_smoke.py`` (its lane rules)."""
    import sys
    sys.path.insert(0, str(CSRC.parents[1]))
    import chip_smoke
    return chip_smoke


def _step_constant(name):
    """A ``constexpr int`` of ``csrc/step_common.cuh``."""
    import re
    m = re.search(rf"constexpr int {name} = (\d+);",
                  (CSRC / "step_common.cuh").read_text())
    return int(m.group(1))


def _k1_lanes(name):
    """The lanes K1's instantiation ``name`` builds a child with: a group
    model's half-warp (``kGroupLanes``), a timer model's row group
    (``kTimerLanes``), else 0 (a wide model's thread, an edit model's
    edit)."""
    if name in _cuda.TIMER_MODELS:
        return _step_constant("kTimerLanes")
    return _step_constant("kGroupLanes") if name in _cuda.GROUP_MODELS \
        else 0


def _host_step(host, config):
    """``HOST_STEPS[config]``'s rows (reachable, and on the ordered
    network crowded too) through the host-built device step as K1 takes
    it: the model, its rows, the property bits, and per lane the flags,
    the fingerprint as K1 takes it (uint64) and the child's words."""
    model = HOST_STEPS[config]()
    name, params = model.cuda_spec()
    lanes = _k1_lanes(name)
    rows = _reachable(model, 300)
    if name == "abd_ordered":
        rng = np.random.default_rng(5)
        rows = np.concatenate([rows, _crowded(model, rows, rng, 100)])
    if model.max_crashes_:
        rng = np.random.default_rng(7)
        rows = np.concatenate([rows, _at_budget(model, rows, rng, 100)])
    if name in LOSSY_MODELS:
        rng = np.random.default_rng(9)
        rows = np.concatenate([rows, _counts_up(model, rows, rng, 100)])
    rows = np.ascontiguousarray(rows, dtype=np.uint32)
    f, w, a = rows.shape[0], model.packed_width, model.max_actions
    out = np.zeros(f * (1 + a * (3 + w)), dtype=np.uint32)
    p = np.asarray(params, dtype=np.int32)
    assert host.h_step(name.encode(), p.ctypes.data, len(p), lanes,
                       rows.ctypes.data, f, out.ctypes.data) == 0
    out = out.reshape(f, 1 + a * (3 + w))
    lanes = out[:, 1:].reshape(f, a, 3 + w)
    fp = (lanes[:, :, 1].astype(np.uint64) << np.uint64(32)) | lanes[:, :, 2]
    return model, rows, out[:, 0], lanes[:, :, 0], fp, lanes[:, :, 3:]


@pytest.mark.parametrize("config", list(HOST_STEPS))
def test_device_step_is_the_plain_step(host, config):
    """The model's device functions, as K1 calls them, on every lane of
    reachable rows (and, on the ordered network, rows with full
    channels) against ``packed_step`` and ``packed_properties``: the
    property bits of every row; the child's words, ``valid`` and
    ``overflow`` of every stepped lane; a wide model's quiet lanes are
    the row, invalid, and the plain step agrees; an edit model's lanes
    are those of non-empty channels, and the plain step's other lanes
    are invalid and do not overflow. An edit model's child is the row
    with its edit's spans (``edit_head``, ``child_word``). A model with
    crash lanes steps its active lanes (the deliveries before the
    network's zero tail to a recipient that is up, the crash lanes of
    actors up and below their budget, the restart lanes of actors down):
    bit for bit on every one, and the plain step's other lanes are
    invalid and do not overflow (their junk rows are not written)."""
    model, rows, bits_k, flags, _fp, child = _host_step(host, config)
    name = model.cuda_spec()[0]
    f, w, a = rows.shape[0], model.packed_width, model.max_actions
    stepped = (flags & 4) != 0
    x = torch.from_numpy(rows.astype(np.int64))
    s, valid, ovf = model.packed_step(x)
    s = s.numpy().reshape(f, a, w).astype(np.uint32)
    valid = valid.numpy().reshape(f, a)
    ovf = ovf.numpy().reshape(f, a)
    props = model.packed_properties(x).numpy().astype(np.uint32)
    bits = (props << np.arange(props.shape[1], dtype=np.uint32)).sum(1)
    assert np.array_equal(bits_k, bits)
    if name in CRASH_MODELS + LOSSY_MODELS:
        held = stepped
        assert not (valid & ~held).any() and not (ovf & ~held).any()
        # chip_smoke.py's mirror of the rule, which the card's checks use
        smoke = _chip_smoke()
        rule = (smoke.lossy_active if name in LOSSY_MODELS
                else smoke.crash_active)(model)
        assert np.array_equal(rule(torch.from_numpy(
            rows.astype(np.int64))).numpy().reshape(f, a), stepped)
        if model.max_crashes_:
            e = model.net_capacity
            n_cr = len(model._crash_idx)
            cw = rows[:, model._crash_off]
            down = np.zeros((f, a), dtype=bool)
            for c, act in enumerate(model._crash_idx.tolist()):
                d = ((cw >> (4 * act + 3)) & 1) != 0
                cnt = (cw >> (4 * act)) & 7
                assert np.array_equal(stepped[:, e + n_cr + c], d)
                assert np.array_equal(stepped[:, e + c],
                                      ~d & (cnt < model.max_crashes_))
                down[:, e + c] = d
            # rows with an actor down, and with one at its crash budget
            assert stepped[:, e + n_cr:].any()
            assert (~stepped[:, e:e + n_cr] & ~down[:, e:e + n_cr]).any()
        if name in LOSSY_MODELS:
            e = model.net_capacity
            # a slot's drop lane is active with its delivery; drops that
            # keep the slot (a count above one) and drops that shift
            assert np.array_equal(stepped[:, :e], stepped[:, e:])
            counts = rows[:, model._net_off + 1:model._timer_off:4]
            assert (stepped[:, e:] & (counts > 1)).any()
            assert (stepped[:, e:] & (counts == 1)).any()
            assert valid[:, e:][stepped[:, e:]].all()
    elif name == "abd_ordered":
        lens = rows[:, model._net_off:model._net_off + model._n_chan]
        assert np.array_equal(stepped, lens != 0)
        held = stepped
        assert not (valid & ~held).any() and not (ovf & ~held).any()
        if config != "abd-ordered-1x1":
            assert ovf.any()
    else:
        held = np.ones_like(stepped)
        quiet = ~stepped
        assert np.array_equal(child[quiet],
                              np.broadcast_to(rows[:, None, :],
                                              child.shape)[quiet])
    assert valid[held].any()
    assert np.array_equal(child[held], s[held])
    assert np.array_equal((flags[held] & 1) != 0, valid[held])
    assert np.array_equal((flags[held] & 2) != 0, ovf[held])


@pytest.mark.parametrize("config", list(HOST_STEPS))
def test_k1_child_fingerprint_is_fp64_of_the_child(host, config):
    """The fingerprint K1 gives each lane, on the host, is
    ``fingerprint.py``'s ``fp64_words`` of the plain step's child: a
    wide model's folds every word of the child; an edit model's is its
    row's folds with only the words its child changes refolded, on
    every active lane (the poison child of an overflow among them, and
    columns past the 128 keys of ``kColumnKey`` at abd3's 260 and
    tpu_abd2's 331 words), and the row's own on every other lane."""
    model, rows, _bits, flags, fp, child = _host_step(host, config)
    name = model.cuda_spec()[0]
    f, w, a = rows.shape[0], model.packed_width, model.max_actions
    x = torch.from_numpy(rows.astype(np.int64))
    s, _valid, ovf = model.packed_step(x)
    s = s.numpy().reshape(f, a, w).astype(np.uint32)
    ovf = ovf.numpy().reshape(f, a)
    stepped = (flags & 4) != 0
    edit = name == "abd_ordered" or name in CRASH_MODELS + LOSSY_MODELS
    poisoned = 0
    for r in range(f):
        row_fp = fp64_words(rows[r].tolist())
        for e in range(a):
            if edit and not stepped[r, e]:
                assert fp[r, e] == row_fp
                continue
            assert fp[r, e] == fp64_words(s[r, e].tolist()), (r, e)
            poisoned += bool(ovf[r, e])
    if name == "abd_ordered" and config != "abd-ordered-1x1":
        assert poisoned > 0
    if config in ("abd-ordered-3x2-d8", "abd-ordered-2x3-d8"):
        assert w > 128


@pytest.mark.parametrize("config", [c for c in HOST_STEPS
                                    if HOST_STEPS[c]().cuda_spec()[0]
                                    in CRASH_MODELS + LOSSY_MODELS])
def test_crash_row_lanes_by_a_warp_are_the_threads(host, config):
    """K1 takes a crash or lossy model's property bits and active lanes
    with a warp per row (``actor_net.cuh`` ``crash_row_lanes``,
    ``drop_row_lanes``: lane r reads slot r, every test a ballot): on
    reachable rows, rows at the crash budget and rows with crowded
    networks, every lane of the warp agrees and they equal the thread's
    walks (``props_row``, ``active_lanes``), which the device step tests
    hold to the plain step."""
    model = HOST_STEPS[config]()
    name, params = model.cuda_spec()
    rows = _reachable(model, 300)
    rng = np.random.default_rng(11)
    if model.max_crashes_:
        rows = np.concatenate([rows, _at_budget(model, rows, rng, 100)])
    # rows whose networks fill up to each slot count (zero tails at
    # every slot), as a search's crowded rows
    full = rows[rng.choice(len(rows), 64)].copy()
    e = model.net_capacity
    for k, row in enumerate(full):
        n = k % (e + 1)
        net = row[model._net_off:model._timer_off].reshape(e, 4)
        net[n:] = 0
        for j in range(n):
            if not net[j].any():
                net[j] = [(1 << 16) | (j % 3), 1, (4 << 24) | (j % 5), 0]
    rows = np.ascontiguousarray(np.concatenate([rows, full]),
                                dtype=np.uint32)
    f = rows.shape[0]
    out = np.zeros((f, 4), dtype=np.uint32)
    p = np.asarray(params, dtype=np.int32)
    assert host.h_row_lanes(name.encode(), p.ctypes.data, len(p),
                            rows.ctypes.data, f, out.ctypes.data) == 0
    assert np.array_equal(out[:, 0], out[:, 2])
    assert np.array_equal(out[:, 1], out[:, 3])
    assert (out[:, 0] & 2).any() or config.startswith("paxos")
    assert len(set(out[:, 1].tolist())) > 4


#: the actor test fixtures' device steps as their K1s take them:
#: PackedPingPong in the four network quadrants (the one-lane step), with
#: a small network that overflows, and PackedTimerCount from 1 to its 32
#: actors (the timer branch: a row by a group of lanes, each active
#: Timeout lane an edit of it)
NARROW_STEPS = {
    "ping-pong-5-lossy-dup": lambda: PackedPingPong(5, True, True),
    "ping-pong-5-lossy": lambda: PackedPingPong(5, True, False),
    "ping-pong-5-dup": lambda: PackedPingPong(5, False, True),
    "ping-pong-5": lambda: PackedPingPong(5, False, False),
    "ping-pong-6-lossy-dup-e3": lambda: PackedPingPong(6, True, True,
                                                       net_capacity=3),
    "timer-count-3x2": lambda: PackedTimerCount(3, 2),
    "timer-count-8x4": lambda: PackedTimerCount(8, 4),
    "timer-count-32x2": lambda: PackedTimerCount(32, 2),
    "timer-count-1x3": lambda: PackedTimerCount(1, 3),
    "timer-count-31x3": lambda: PackedTimerCount(31, 3),
}


def _reachable_within(model, limit):
    """The first ``limit`` states of a host BFS within the model's
    boundary, encoded (a state whose network outgrows the encoding is
    skipped)."""
    seen, rows, queue = set(), [], list(model.init_states())
    while queue and len(rows) < limit:
        state = queue.pop(0)
        if not model.within_boundary(state):
            continue
        try:
            row = np.asarray(model.encode(state), dtype=np.uint32)
        except ValueError:
            continue
        if row.tobytes() in seen:
            continue
        seen.add(row.tobytes())
        rows.append(row)
        queue.extend(model.next_states(state))
    return np.stack(rows)


def _timer_edges(model, rng, k):
    """``k`` rows of a timer-count fixture at its edges: counts from 0
    to ``max_nat`` (one below it: the Timeout clears its bit; further
    below: it keeps it), the timer word's bits at random, every one set
    in a third of the rows, none in a tenth."""
    n = model.n_actors
    rows = np.zeros((k, model.packed_width), dtype=np.uint32)
    rows[:, :n] = rng.integers(0, model.max_nat + 1, size=(k, n))
    tw = rng.integers(0, 1 << n, size=k, dtype=np.uint64)
    tw[::3] = (1 << n) - 1
    tw[1::10] = 0
    rows[:, model._timer_off] = tw.astype(np.uint32)
    return rows


@pytest.mark.parametrize("config", list(NARROW_STEPS))
def test_narrow_device_step_is_the_plain_step(host, config):
    """``csrc/ping_pong.cuh`` and ``csrc/timer_count.cuh`` as their K1s
    take them on reachable rows and rows of random words (a timer-count
    fixture's also at its counts' and timer bits' edges, the timer bit
    both kept and cleared): the property bits of every row, and on every
    lane the ping-pong fixture's one-lane step writes, and every active
    lane of the timer branch (a Timeout lane whose timer bit is set:
    ``chip_smoke.py`` ``timer_active``), the child's words, ``valid``,
    ``overflow`` and the fingerprint (``fp64_words`` of the plain step's
    child) against ``packed_step`` and ``packed_properties``; every
    other lane of the timer branch is invalid without overflow in the
    plain step, its fingerprint the row's and its child unwritten."""
    model = NARROW_STEPS[config]()
    name, params = model.cuda_spec()
    rng = np.random.default_rng(17)
    rows = _reachable_within(model, 300)
    junk = rng.integers(0, 2 ** 32, size=(40, model.packed_width),
                        dtype=np.uint64).astype(np.uint32)
    small = rng.integers(0, 8, size=(40, model.packed_width),
                         dtype=np.uint64).astype(np.uint32)
    parts = [rows, junk, small]
    timer = name == "timer_count"
    if timer:
        parts.append(_timer_edges(model, rng, 60))
    rows = np.ascontiguousarray(np.concatenate(parts))
    f, w, a = rows.shape[0], model.packed_width, model.max_actions
    out = np.zeros(f * (1 + a * (3 + w)), dtype=np.uint32)
    p = np.asarray(params, dtype=np.int32)
    assert host.h_step(name.encode(), p.ctypes.data, len(p),
                       _k1_lanes(name), rows.ctypes.data, f,
                       out.ctypes.data) == 0
    out = out.reshape(f, 1 + a * (3 + w))
    lanes = out[:, 1:].reshape(f, a, 3 + w)
    x = torch.from_numpy(rows.astype(np.int64))
    s, valid, ovf = model.packed_step(x)
    s = s.numpy().astype(np.uint32).reshape(f, a, w)
    valid, ovf = valid.numpy().reshape(f, a), ovf.numpy().reshape(f, a)
    props = model.packed_properties(x).numpy().astype(np.uint32)
    assert np.array_equal(out[:, 0], (props << np.arange(
        props.shape[1], dtype=np.uint32)).sum(1))
    held = np.ones((f, a), dtype=bool)
    fp = (lanes[:, :, 1].astype(np.uint64) << np.uint64(32)) \
        | lanes[:, :, 2]
    if timer:
        held = (lanes[:, :, 0] & 4) != 0
        rule = _chip_smoke().timer_active(model)(x).numpy().reshape(f, a)
        assert np.array_equal(held, rule)
        assert not valid[~held].any() and not ovf[~held].any()
        assert not lanes[:, :, 3:][~held].any()
        row_fp = np.array([fp64_words(r.tolist()) for r in rows],
                          dtype=np.uint64)
        assert np.array_equal(fp[~held], np.broadcast_to(
            row_fp[:, None], fp.shape)[~held])
        # an active lane's timer bit kept and one's cleared
        n = a - 1
        bit = np.arange(n, dtype=np.uint32)
        was = (rows[:, model._timer_off][:, None] >> bit) & 1
        now = (s[:, 1:, model._timer_off] >> bit[None, :]) & 1
        assert np.array_equal(held[:, 1:], was != 0) and not held[:, 0].any()
        assert (held[:, 1:] & (now != 0)).any()
        assert (held[:, 1:] & (now == 0)).any()
    assert np.array_equal(lanes[:, :, 3:][held], s[held])
    assert np.array_equal((lanes[:, :, 0] & 1)[held] != 0, valid[held])
    assert np.array_equal((lanes[:, :, 0] & 2)[held] != 0, ovf[held])
    for r in range(0, f, 1 if timer else 7):
        for e in range(a):
            if held[r, e]:
                assert fp[r, e] == fp64_words(s[r, e].tolist())
    assert valid.any()
    if config == "ping-pong-6-lossy-dup-e3":
        assert ovf.any()


#: the lossy ping-pong fixture on K1's shared-row path
#: (``csrc/ping_pong.cuh`` ``PingPongLossyModel``): (max_nat, lossy,
#: duplicating, net_capacity) on both networks at every network size,
#: and small networks whose sends overflow
PING_PONG_WIDE = [(4, True, dup, e) for dup in (True, False)
                  for e in range(1, 17)] \
    + [(6, True, True, 3), (5, True, False, 2)]
#: the lossless ping-pong fixture, on the narrow K1 (``PingPongModel``, a
#: thread a lane), on both networks at every network size
PING_PONG_LOSSLESS = [(4, False, dup, e) for dup in (True, False)
                      for e in range(1, 17)]


def _pp_id(cfg):
    max_nat, lossy, dup, e = cfg
    return (f"max{max_nat}-{'lossy' if lossy else 'lossless'}-"
            f"{'dup' if dup else 'nondup'}-e{e}")


def _ping_pong(cfg):
    max_nat, lossy, dup, e = cfg
    return PackedPingPong(max_nat, lossy, dup, net_capacity=e)


def _crowded_slots(model, rows, rng, sw):
    """``rows`` with each network refilled to a zero tail at every slot
    position in turn (row k: k % (E + 1) slots): distinct occupied
    envelopes of ``sw`` words (header, count 1 to 3, message words), in
    the network's (header, message) order; the junk of a random word in
    a tenth of the slots (an unoccupied header)."""
    e, off = model.net_capacity, model._net_off
    out = rows.copy()
    for k, row in enumerate(out):
        n = k % (e + 1)
        net = row[off:off + sw * e].reshape(e, sw)
        net[:] = 0
        env = set()
        while len(env) < n:
            hdr = (1 << 16) | (int(rng.integers(0, 3)) << 8) \
                | int(rng.integers(0, 3))
            msg = tuple(int(x) for x in rng.integers(0, 1 << 10, sw - 2))
            env.add((hdr,) + msg)
        for j, t in enumerate(sorted(env)):
            net[j, 0], net[j, 1], net[j, 2:] = t[0], rng.integers(1, 4), t[1:]
            if rng.random() < 0.1:
                net[j, 0] = int(rng.integers(1, 1 << 16))
    return out


def _ping_pong_rows(model, seed):
    """Seeded rows of a ping-pong fixture: reachable states within the
    boundary, rows of random words and of small random words, and
    crowded networks (:func:`_crowded_slots`)."""
    rng = np.random.default_rng(seed)
    rows = _reachable_within(model, 200)
    w = model.packed_width
    junk = rng.integers(0, 2 ** 32, size=(30, w),
                        dtype=np.uint64).astype(np.uint32)
    small = rng.integers(0, 8, size=(30, w), dtype=np.uint64).astype(
        np.uint32)
    crowded = _crowded_slots(model, rows[rng.integers(0, len(rows), 60)],
                             rng, 3)
    return np.ascontiguousarray(np.concatenate([rows, junk, small,
                                                crowded]), dtype=np.uint32)


def _host_lanes(host, model, rows, lanes):
    """``h_step`` of ``model``'s instantiation over ``rows`` (``lanes``: 0
    the one-lane step, -1 K1's wide branch): the property bits, and per
    lane the flags, the fingerprint (uint64) and the child's words."""
    name, params = model.cuda_spec()
    f, w, a = rows.shape[0], model.packed_width, model.max_actions
    out = np.zeros(f * (1 + a * (3 + w)), dtype=np.uint32)
    p = np.asarray(params, dtype=np.int32)
    assert host.h_step(name.encode(), p.ctypes.data, len(p), lanes,
                       rows.ctypes.data, f, out.ctypes.data) == 0
    out = out.reshape(f, 1 + a * (3 + w))
    lane = out[:, 1:].reshape(f, a, 3 + w)
    fp = (lane[:, :, 1].astype(np.uint64) << np.uint64(32)) | lane[:, :, 2]
    return out[:, 0], lane[:, :, 0], fp, lane[:, :, 3:]


@pytest.mark.parametrize("cfg", PING_PONG_WIDE, ids=_pp_id)
def test_ping_pong_step_row_is_the_one_lane_step(host, cfg):
    """``csrc/ping_pong.cuh`` on K1's shared-row path (the host's wide
    branch: ``step_row`` through a RowOut on each delivery before the
    network's zero tail, each drop child from the row's suffix folds,
    ``drop_suffix_folds``, ``drop_fold`` and ``drop_write``)
    against ``PingPongModel::step`` (the thread-a-lane step) and the
    plain step, lane for lane on seeded reachable, random and crowded
    rows: the property bits of every row; on every stepped lane (the
    lanes ``chip_smoke.py`` ``lossy_active`` names) the child's words,
    ``valid``, ``overflow`` and fingerprint; every other lane's
    fingerprint the row's and its child invalid without overflow in the
    plain step."""
    model = _ping_pong(cfg)
    rows = _ping_pong_rows(model, list(cfg[1:]))
    f, w, a = rows.shape[0], model.packed_width, model.max_actions
    bits_w, flags_w, fp_w, child_w = _host_lanes(host, model, rows, -1)
    bits_n, flags_n, fp_n, child_n = _host_lanes(host, model, rows, 0)
    assert np.array_equal(bits_w, bits_n)
    stepped = (flags_w & 4) != 0
    rule = _chip_smoke().lossy_active(model)(
        torch.from_numpy(rows.astype(np.int64))).numpy().reshape(f, a)
    x = torch.from_numpy(rows.astype(np.int64))
    s, valid, ovf = model.packed_step(x)
    s = s.numpy().reshape(f, a, w).astype(np.uint32)
    valid = valid.numpy().reshape(f, a)
    ovf = ovf.numpy().reshape(f, a)
    assert np.array_equal(stepped, rule)
    assert stepped.any() and (~stepped).any()
    for arr_w, arr_n in ((child_w, child_n), (fp_w, fp_n),
                         (flags_w & 3, flags_n & 3)):
        assert np.array_equal(arr_w[stepped], arr_n[stepped])
    assert np.array_equal(child_w[stepped], s[stepped])
    assert np.array_equal((flags_w[stepped] & 1) != 0, valid[stepped])
    assert np.array_equal((flags_w[stepped] & 2) != 0, ovf[stepped])
    assert not valid[~stepped].any() and not ovf[~stepped].any()
    row_fp = np.array([fp64_words(r.tolist()) for r in rows],
                      dtype=np.uint64)
    assert np.array_equal(fp_w[~stepped],
                          np.broadcast_to(row_fp[:, None],
                                          fp_w.shape)[~stepped])
    # (a one-slot network has no room for a reply: every delivery
    # overflows)
    assert (valid | ovf)[stepped].any()
    if cfg == (6, True, True, 3):
        assert ovf.any()


@pytest.mark.parametrize("cfg", PING_PONG_LOSSLESS, ids=_pp_id)
def test_lossless_ping_pong_one_lane_step_is_the_plain_step(host, cfg):
    """The lossless ping-pong fixture as its K1 (the narrow K1,
    ``PingPongModel::step``, a thread a lane, every lane written) runs
    it, at every network size on both networks, against the plain step
    on seeded reachable, random and crowded rows (every slot position
    the zero tail): the property bits of every row, and on every lane the
    child's words, ``valid``, ``overflow`` and the fingerprint; the lanes
    past the network's zero tail (``chip_smoke.py`` ``lossy_active``)
    the row itself, invalid."""
    from stateright_tpu_torch.ops.hash_kernel import fp64_device
    model = _ping_pong(cfg)
    rows = _ping_pong_rows(model, list(cfg[1:]))
    f, w, a = rows.shape[0], model.packed_width, model.max_actions
    bits, flags, fp, child = _host_lanes(host, model, rows, 0)
    x = torch.from_numpy(rows.astype(np.int64))
    s, valid, ovf = model.packed_step(x)
    props = model.packed_properties(x).numpy().astype(np.uint32)
    assert np.array_equal(bits, (props << np.arange(
        props.shape[1], dtype=np.uint32)).sum(1))
    s = s.numpy().astype(np.uint32)
    assert np.array_equal(child, s.reshape(f, a, w))
    assert np.array_equal((flags & 1) != 0, valid.numpy().reshape(f, a))
    assert np.array_equal((flags & 2) != 0, ovf.numpy().reshape(f, a))
    hi, lo = fp64_device(torch.from_numpy(s.reshape(f * a, w).view(
        np.int32)))
    want = (hi.numpy().astype(np.uint64) << np.uint64(32)) \
        | lo.numpy().astype(np.uint64)
    assert np.array_equal(fp.reshape(-1), want)
    quiet = ~_chip_smoke().lossy_active(model)(x).numpy().reshape(f, a)
    assert quiet.any() and (~quiet).any()
    assert np.array_equal(child[quiet],
                          np.broadcast_to(rows[:, None, :],
                                          child.shape)[quiet])
    assert not valid.numpy().reshape(f, a)[quiet].any()
    # (a one-slot network has no room for a reply: every delivery
    # overflows)
    assert (valid | ovf).any()


#: the lossy instantiations whose drop children a warp builds: lossy
#: Paxos(1) and (2) (4-word slots, 16-byte vectors) and the lossy
#: ping-pong fixture (3-word slots) at every network size on both
#: unordered networks
DROP_CONFIGS = {
    "paxos-1-lossy": lambda: PackedPaxos(1).lossy_network(True),
    "paxos-2-lossy": lambda: PackedPaxos(2).lossy_network(True),
    **{f"ping-pong-{'dup' if dup else 'nondup'}-e{e}":
       (lambda dup=dup, e=e: PackedPingPong(4, True, dup, net_capacity=e))
       for dup in (True, False) for e in range(1, 17)},
}


def _drop_rows(model, seed):
    """Seeded rows of a lossy model: reachable states, the same with
    counts raised to 2 or 3 (drops that keep their slot), and crowded
    networks at every zero-tail position; a ping-pong fixture's rows of
    :func:`_ping_pong_rows` besides."""
    if model.cuda_spec()[0] == "ping_pong":
        return _ping_pong_rows(model, seed)
    rng = np.random.default_rng(seed)
    rows = _reachable(model, 200)
    up = _counts_up(model, rows, rng, 60)
    crowded = _crowded_slots(model, rows[rng.integers(0, len(rows), 60)],
                             rng, 4)
    return np.ascontiguousarray(np.concatenate([rows, up, crowded]),
                                dtype=np.uint32)


#: each configuration with 32 words a store, and with 16-byte vectors
#: where its width is a multiple of four
DROP_CASES = [(c, vec) for c in DROP_CONFIGS for vec in (False, True)
              if not vec or DROP_CONFIGS[c]().packed_width % 4 == 0]


@pytest.mark.parametrize("config,vec", DROP_CASES,
                         ids=[f"{c}-{'vectors' if v else 'words'}"
                              for c, v in DROP_CASES])
def test_drop_child_by_a_warp_is_the_threads(host, config, vec):
    """A drop child as K1 builds it (``actor_net.cuh``): the row's
    suffix folds by a warp (``drop_suffix_folds``: lanes 2 j and 2 j + 1
    fold half of slot j's words' changes under a shift each, then a
    suffix XOR over the lanes), the child's fingerprint the row's folds
    with the dropped slot's suffix folds or its count word refolded
    (``drop_fold``), its words from the shared row by a group of 8 lanes
    (``drop_write``: 8 consecutive words a store or, where the width is
    a multiple of four, 16-byte vectors), on every active drop lane of
    seeded rows (kept and shifted slots at every position): the warp's
    lanes agree, and the child's words, validity and fingerprint equal
    the thread's (``drop_fingerprint``, ``drop_copy``: each changed word
    refolded in turn), the plain step's child and validity, and
    ``fp64_words`` of it."""
    model = DROP_CONFIGS[config]()
    name, params = model.cuda_spec()
    w, e = model.packed_width, model.net_capacity
    rows = _drop_rows(model, len(config))
    f = rows.shape[0]
    out = np.zeros(f * e * (7 + 2 * w), dtype=np.uint32)
    p = np.asarray(params, dtype=np.int32)
    assert host.h_drops(name.encode(), p.ctypes.data, len(p), int(vec),
                        rows.ctypes.data, f, out.ctypes.data) == 0
    out = out.reshape(f, e, 7 + 2 * w)
    active = out[:, :, 0] != 0
    assert active.any()
    warp, thread = out[:, :, 7:7 + w], out[:, :, 7 + w:]
    assert np.array_equal(warp[active], thread[active])
    assert np.array_equal(out[:, :, 1:4][active], out[:, :, 4:7][active])
    x = torch.from_numpy(rows.astype(np.int64))
    s, valid, ovf = model.packed_step(x)
    s = s.numpy().reshape(f, 2 * e, w)[:, e:].astype(np.uint32)
    valid = valid.numpy().reshape(f, 2 * e)[:, e:]
    assert not ovf.numpy().reshape(f, 2 * e)[:, e:].any()
    assert np.array_equal(warp[active], s[active])
    assert np.array_equal(out[:, :, 1][active] != 0, valid[active])
    assert not valid[~active].any()
    fp = (out[:, :, 2].astype(np.uint64) << np.uint64(32)) | out[:, :, 3]
    for r, j in zip(*np.nonzero(active)):
        assert fp[r, j] == fp64_words(s[r, j].tolist()), (r, j)
    # drops that keep their slot and drops that shift the network
    counts = rows[:, model._net_off + 1:model._timer_off:model._sw]
    if not model._net_dup:
        assert (active & (counts > 1)).any()
    assert (active & (counts == 1)).any()


@pytest.mark.parametrize("dup", [True, False], ids=["dup", "nondup"])
@pytest.mark.parametrize("e", range(1, 17))
def test_ping_pong_row_lanes_by_a_warp_are_lossy_active(host, e, dup):
    """K1 takes the lossy ping-pong fixture's property bits and active
    lanes with a warp per row (``PingPongLossyModel::row_lanes``: the
    counts' bits from words 0 and 1, the zero tail by a ballot over the
    3-word slots): on seeded reachable, random and crowded rows every
    lane agrees, and they equal the plain properties, the thread's
    ``active_lanes`` and ``chip_smoke.py`` ``lossy_active``."""
    model = PackedPingPong(4, True, dup, net_capacity=e)
    name, params = model.cuda_spec()
    rows = _ping_pong_rows(model, [e, dup])
    f, a = rows.shape[0], model.max_actions
    out = np.zeros((f, 4), dtype=np.uint32)
    p = np.asarray(params, dtype=np.int32)
    assert host.h_row_lanes(name.encode(), p.ctypes.data, len(p),
                            rows.ctypes.data, f, out.ctypes.data) == 0
    x = torch.from_numpy(rows.astype(np.int64))
    props = model.packed_properties(x).numpy().astype(np.uint32)
    bits = (props << np.arange(props.shape[1], dtype=np.uint32)).sum(1)
    assert np.array_equal(out[:, 0], bits)
    assert np.array_equal(out[:, 0], out[:, 2])
    rule = _chip_smoke().lossy_active(model)(x).numpy().reshape(f, a)
    mask = (rule * (1 << np.arange(a, dtype=np.int64))).sum(1)
    assert np.array_equal(out[:, 1].astype(np.int64), mask)
    assert np.array_equal(out[:, 1], out[:, 3])
    assert len(set(out[:, 1].tolist())) == e + 1  # every zero tail


@pytest.mark.parametrize("sms", [66, 114, 132])
def test_ping_pong_wide_launch_fits(sms):
    """At every network size the lossy ping-pong fixture's K1 launch
    (``k1_launch`` with its ``cuda_spec`` parameters: K1-wide's geometry
    over ``WIDE_MODELS``'s 52 words a shared row) holds at most 32 rows a
    block, whole warps of at most ``WIDE_THREADS``, blocks that cover the
    frontier, the shared memory of ``step_common.cuh`` ``WideSmem`` (the
    rows' suffix folds, ``kSuffixWords`` a row, and a staging row of the
    width made odd a thread), and ``WIDE_BLOCKS_PER_SM`` blocks an SM; the
    lossless one's is the narrow K1's (the tile geometry, no shared
    memory), its instantiation without drop lanes."""
    assert _cuda.row_words("ping_pong") == 52
    assert _cuda.SUFFIX_WORDS == _step_constant("kSuffixWords") == 32
    n = 0
    for e in range(1, 17):
        for lossy in (True, False):
            model = PackedPingPong(5, lossy, True, net_capacity=e)
            a, w = model.max_actions, model.packed_width
            name, params = model.cuda_spec()
            assert _cuda.drop_lanes(name, params) == lossy
            assert a <= 32 and w <= 51
            n += 1
            for f in (1, 2, 37, 1000, 8192, 10220, 65536):
                geo = _cuda.tile_geometry(f, a, sms)
                wide, smem = _cuda.k1_launch(name, geo, f, w, a, sms,
                                             params)
                if not lossy:
                    assert (wide, smem) == (geo, 0)
                    continue
                assert 1 <= wide.rows <= _cuda.WIDE_ROWS == 32
                assert wide.threads % 32 == 0
                assert wide.threads <= _cuda.WIDE_THREADS
                assert wide.blocks * wide.rows >= f
                assert (wide.blocks - 1) * wide.rows < f
                assert smem == (wide.rows * (4 * 52 + 16)
                                + 4 * (4 * (wide.rows + 1) + wide.rows * a
                                       + 32 * wide.rows
                                       + wide.threads * (w | 1)))
                assert smem <= BLOCK_SMEM
                assert _cuda.WIDE_BLOCKS_PER_SM * (smem + RESERVED) \
                    <= SM_SMEM
    assert n == 32


@pytest.mark.parametrize("sms", [66, 114, 132])
def test_lossy_paxos_launch_fits(sms):
    """At every admitted lossy Paxos configuration (up to 7 clients, 4
    servers, 16 slots: 32 lanes) and frontier, K1-paxos_lossy's launch
    takes the wide K1's shared memory plus the rows' suffix folds
    (``kSuffixWords`` a row), at most 227 KB, and two blocks fit an SM
    (three at lossy PackedPaxos(2)'s 8,192-row step, its 21 rows)."""
    for c in range(1, 8):
        for s in range(1, 5):
            for e in (1, 5, 16):
                model = PackedPaxos(c, server_count=s,
                                    net_capacity=e).lossy_network(True)
                a, w = model.max_actions, model.packed_width
                assert a == 2 * e <= 32 and w <= 128
                name, params = model.cuda_spec()
                assert _cuda.drop_lanes(name, params)
                for f in (1, 37, 8192, 65536):
                    geo = _cuda.tile_geometry(f, a, sms)
                    wide, smem = _cuda.k1_launch(name, geo, f, w, a, sms,
                                                 params)
                    assert smem == _cuda.wide_smem_bytes(
                        wide, w, a) + 4 * 32 * wide.rows
                    assert smem <= BLOCK_SMEM
                    assert 2 * (smem + RESERVED) <= SM_SMEM
                    if (c, s, e, f, sms) == (2, 3, 16, 8192, 132):
                        assert wide.rows == 21
                        assert _cuda.WIDE_BLOCKS_PER_SM * (
                            smem + RESERVED) <= SM_SMEM


#: the timer-count fixture's sizes the timer K1 is held at: 1 to its
#: 32 actors (widths 5 to 36 words; 12, 32 and 36 multiples of four)
TIMER_SIZES = [(1, 3), (3, 2), (8, 4), (28, 2), (31, 3), (32, 2)]


def _timer_rows(model, seed):
    """Seeded rows of a timer-count fixture: reachable states, random and
    small random words, and rows at its counts' and timer bits' edges
    (:func:`_timer_edges`)."""
    rng = np.random.default_rng(seed)
    w = model.packed_width
    junk = rng.integers(0, 2 ** 32, size=(30, w),
                        dtype=np.uint64).astype(np.uint32)
    small = rng.integers(0, 8, size=(30, w), dtype=np.uint64).astype(
        np.uint32)
    return np.ascontiguousarray(np.concatenate([
        _reachable_within(model, 200), junk, small,
        _timer_edges(model, rng, 60)]), dtype=np.uint32)


@pytest.mark.parametrize("lanes", [1, 2, 8, 16, 32])
@pytest.mark.parametrize("n,max_nat", TIMER_SIZES)
def test_timer_row_fold_by_any_group_is_the_k1s(host, n, max_nat, lanes):
    """``csrc/timer_count.cuh`` ``row_fold`` by a group of 1 to 32 lanes
    (each lane's columns folded, then XOR-reduced and balloted over the
    group, on ucontext lanes: ``HostGroup``) gives every lane the same
    folds, property bits and Timeout lanes as the group of
    ``kTimerLanes`` K1 takes, so the K1 branch's every output (the flags,
    each lane's fingerprint and child) is the same."""
    model = PackedTimerCount(n, max_nat)
    name = model.cuda_spec()[0]
    rows = _timer_rows(model, [n, max_nat])
    want = _host_lanes(host, model, rows, _k1_lanes(name))
    got = _host_lanes(host, model, rows, lanes)
    for x, y in zip(want, got):
        assert np.array_equal(x, y)
    assert ((want[1] & 4) != 0).any()


@pytest.mark.parametrize("sms", [66, 132])
@pytest.mark.parametrize("n,max_nat", TIMER_SIZES)
def test_timer_k1_launch_fits(host, n, max_nat, sms):
    """K1-timer_count's launch (``k1_launch``: K1-wide's geometry at
    ``TIMER_THREADS`` and ``TIMER_BLOCKS_PER_SM``) at 1, 256 and 8,192
    rows holds at most 32 rows a block (one warp scans them), whole warps
    of whole row groups (``kTimerLanes``), blocks that cover the frontier,
    the shared memory of ``step_common.cuh`` ``TimerSmem`` (a row's
    ``RowState`` of ``TimerCountModel::W`` = 36 words, four info words a
    row, four of the count, a 16-byte slot a Timeout lane), at most a
    block's, and ``TIMER_BLOCKS_PER_SM`` blocks an SM; the timer K1 steps
    the pending rows only. At TimerCount(8, 4)'s 8,192-row step on 132
    SMs: 32 rows, 256 blocks, 9,744 bytes."""
    model = PackedTimerCount(n, max_nat)
    name, params = model.cuda_spec()
    a, w = model.max_actions, model.packed_width
    assert a == n + 1 <= 33 and w == n + 4
    assert _cuda.row_words(name) == host.h_words(name.encode(), 0) == 36
    assert _cuda.pending_rows(name) and name in _cuda.TIMER_MODELS
    assert _cuda.TIMER_THREADS % 32 == 0
    assert 32 % _step_constant("kTimerLanes") == 0
    for f in (1, 256, 8192):
        geo = _cuda.tile_geometry(f, a, sms)
        wide, smem = _cuda.k1_launch(name, geo, f, w, a, sms, params)
        assert 1 <= wide.rows <= _cuda.WIDE_ROWS == 32
        assert wide.threads == _cuda.TIMER_THREADS
        assert wide.blocks * wide.rows >= f > (wide.blocks - 1) * wide.rows
        assert smem == (wide.rows * (4 * 36 + 16)
                        + 4 * (4 * (wide.rows + 1) + 4 * wide.rows * (a - 1)))
        assert smem <= BLOCK_SMEM
        assert _cuda.TIMER_BLOCKS_PER_SM * (smem + RESERVED) <= SM_SMEM
        if (n, max_nat, f, sms) == (8, 4, 8192, 132):
            assert (wide.rows, wide.blocks, smem) == (32, 256, 9744)


@pytest.mark.parametrize("threads", [64, 128, 256, 512])
@pytest.mark.parametrize("n,max_nat", TIMER_SIZES)
def test_timer_children_written_as_one_range(n, max_nat, threads):
    """A transcription of K1's timer branch over one tile (``csrc/
    step_common.cuh``): each row's first child at the prefix of the
    active counts before it (one warp's scan), an active lane's slot at
    that plus the active lanes before it in its row; then the block's
    threads walk the children as one range of units (16-byte vectors
    where the width is a multiple of four, else words), thread x's next
    unit ``blockDim`` on (the child and unit stepped without a division).
    Over tiles of 1, 5 and 32 rows of seeded rows, every unit of every
    active lane's child is written once, the children are the plain
    step's, and no other lane's row of flat is written."""
    model = PackedTimerCount(n, max_nat)
    rows_all = _timer_rows(model, [n, threads])
    w, a = model.packed_width, model.max_actions
    x = torch.from_numpy(rows_all.astype(np.int64))
    s_all = model.packed_step(x)[0].numpy().astype(np.uint32).reshape(
        -1, a, w)
    rule = _chip_smoke().timer_active(model)(x).numpy().reshape(-1, a)
    for vec in (False, True):
        if vec and w % 4:
            continue
        q = w // 4 if vec else w
        for nrows in (1, 5, 32):
            for r0 in range(0, len(rows_all) - nrows + 1, 97):
                rows = rows_all[r0:r0 + nrows]
                lanes = rows[:, model._timer_off].astype(np.int64) & (
                    (1 << n) - 1)
                cnt = np.array([bin(v).count("1") for v in lanes])
                first = np.concatenate([[0], np.cumsum(cnt)[:-1]])
                nact = int(cnt.sum())
                slots = np.zeros(nact, dtype=np.int64)  # the tile lane
                for t in range(nrows * a):
                    i, e = divmod(t, a)
                    if e and (lanes[i] >> (e - 1)) & 1:
                        below = lanes[i] & ((1 << (e - 1)) - 1)
                        slots[first[i] + bin(int(below)).count("1")] = t
                flat = np.zeros((nrows * a, w), dtype=np.uint32)
                hits = np.zeros((nact, q), dtype=np.int64)
                dc, dk = divmod(threads, q)
                for tid in range(threads):
                    c, k = divmod(tid, q)
                    for _u in range(tid, nact * q, threads):
                        t = slots[c]
                        i, e = divmod(int(t), a)
                        child = s_all[r0 + i, e]
                        cols = slice(4 * k, 4 * k + 4) if vec else slice(
                            k, k + 1)
                        flat[t, cols] = child[cols]
                        hits[c, k] += 1
                        c, k = c + dc, k + dk
                        if k >= q:
                            c, k = c + 1, k - q
                assert (hits == 1).all()
                act = rule[r0:r0 + nrows].reshape(-1)
                assert act.sum() == nact
                assert np.array_equal(
                    flat[act], s_all[r0:r0 + nrows].reshape(-1, w)[act])
                assert not flat[~act].any()


def _chunk_constant(name):
    """A ``constexpr int`` of ``csrc/chunk.cu``."""
    import re
    m = re.search(rf"constexpr int {name} = (\d+);",
                  (CSRC / "chunk.cu").read_text())
    return int(m.group(1))


@pytest.mark.parametrize("lanes", [1, 127, 128, 4_608, 18_990, 24_192,
                                   110_592, 147_456, 454_656])
def test_k7_wide_rows_take_their_tile_and_narrow_rows_keep_theirs(lanes):
    """K7's tile (``append_tile``) at every row width up to the widest
    the kernel takes (352 words, queue rows of 355): rows wider than the
    256-thread block take the 128-lane tile of 128 threads; narrower ones
    keep the 1,024/4,096-lane rule (three tiles for every four SMs);
    either way the grid's tiles cover every lane once, with the tail one
    block past them."""
    assert _chunk_constant("kMaxRowWords") == 352
    assert _chunk_constant("kWideTileThreads") == _cuda.APPEND_WIDE_TILE
    assert _chunk_constant("kAppendThreads") == _cuda.APPEND_THREADS
    want = (3 * SMS) // 4
    narrow = 4096 if lanes // 4096 >= want else 1024
    for width in range(1, 353):
        tile = _cuda.append_tile(lanes, SMS, width)
        if width + 3 > 256:
            assert tile == _cuda.APPEND_WIDE_TILE == 128
        else:
            assert tile == narrow == _cuda.append_tile(lanes, SMS)
        tiles = _cuda.append_grid(lanes, tile) - 1
        assert tiles * tile >= lanes and (tiles - 1) * tile < lanes


@pytest.mark.parametrize("model", [
    lambda: PackedAbd(2, server_count=3, ordered=True, channel_depth=8),
    lambda: PackedAbd(3, server_count=2, ordered=True, channel_depth=8)],
    ids=["tpu_abd2", "abd3"])
def test_k7_wide_tiles_outnumber_the_sms_at_the_ordered_steps(model):
    """At the large steps of bench.py's ordered register rows (tpu_abd2:
    1,055 rows of 18 lanes and 331 words; abd3: 1,728 of 14 and 260),
    K7's wide tiles give every SM of an H100 a block."""
    from stateright_tpu_torch.checker.gpu import auto_fmax
    model = model()
    rows = auto_fmax(model)
    assert rows == {331: 1055, 260: 1728}[model.packed_width]
    lanes = rows * model.max_actions
    tile = _cuda.append_tile(lanes, SMS, model.packed_width)
    assert tile == 128
    assert _cuda.append_grid(lanes, tile) - 1 >= SMS


@pytest.mark.parametrize("width", [257, 260, 328, 331, 352])
def test_k7_wide_row_copy_writes_each_word_once(width):
    """A transcription of K7's wide-row copy (``csrc/chunk.cu``
    ``write_rows``, ``W + 3 >`` the block's threads): warp ``w`` of the
    128-thread block copies rows ``w, w + 4, ...``, ``kRowsInFlight`` at
    a time, lane ``l`` words ``l + 32 u`` for ``u < kQueueWords`` from
    the lane's ``flat`` row, the row's ``ebits`` and the child's key;
    over a tile's rows (none, one, a ragged count, more than the tile's
    warps can hold at once) it writes the queue rows the JAX append
    writes, every word once."""
    qwords = _chunk_constant("kQueueWords")
    in_flight = _chunk_constant("kRowsInFlight")
    threads = _chunk_constant("kWideTileThreads")
    a, qc = 7, width + 3
    rng = np.random.default_rng(width)
    lanes = 128
    flat = rng.integers(0, 2**32, (lanes, width), dtype=np.uint64)
    ebits = rng.integers(0, 2**32, lanes // a + 1, dtype=np.uint64)
    chi, clo = (rng.integers(0, 2**32, lanes, dtype=np.uint64)
                for _ in range(2))
    for density in (0.0, 1 / lanes, 0.3, 1.0):
        ins = np.flatnonzero(rng.random(lanes) < density)
        n = len(ins)
        q = np.zeros((n, qc), dtype=np.uint64)
        writes = np.zeros((n, qc), dtype=np.int64)
        nw = threads // 32
        for wid in range(nw):
            for i0 in range(wid, n, nw * in_flight):
                for j in range(in_flight):
                    i = i0 + j * nw
                    if i >= n:
                        continue
                    lane = ins[i]
                    for wl in range(32):
                        for u in range(qwords):
                            k = wl + 32 * u
                            if k >= qc:
                                continue
                            q[i, k] = (flat[lane, k] if k < width
                                       else ebits[lane // a] if k == width
                                       else (chi if k == width + 1
                                             else clo)[lane])
                            writes[i, k] += 1
        assert (writes == 1).all()
        want = np.concatenate([flat[ins], ebits[ins // a][:, None],
                               chi[ins][:, None], clo[ins][:, None]], 1)
        assert np.array_equal(q, want)
