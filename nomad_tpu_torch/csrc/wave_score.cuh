// The fused wave's per-node arithmetic, shared by its two kernels.
//
// One feasibility, score and metric rule for csrc/fused_wave.cu (B1, the
// one-device wave) and csrc/sharded_wave.cu (the wave over a mesh of node
// shards): ops/kernel._feasible and _score restricted to the fused
// envelope (ports, step penalties, preferred pins, distinct_hosts, shuffle,
// top-k), in the torch version's operation order. The build passes
// -fmad=false and no fast-math, and the fit is scaled by the f32
// reciprocal of 18 as torch scales it on the card, so both kernels score a
// node bit for bit as the plain version does. Also the order-preserving
// score keys and the warp reductions both kernels select with. A function
// taking `a` reads only its `with_ports` and `with_distinct` flags.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define TOPK 8
#define FULL_MASK 0xffffffffu
#define NO_NODE 0x7fffffff
#define NO_RANK 0xffffffffu

#define NEG_INF_F (-1.0e30f)

// Leaf order: mirrored by nomad_tpu_torch/ops/cuda_kernel._LEAVES.
enum Leaf {
  L_CAP_CPU, L_CAP_MEM, L_CAP_DISK,       // f32 [N]
  L_USED_CPU, L_USED_MEM, L_USED_DISK,    // f32 [N]
  L_AFF,                                  // f32 [N]
  L_FREE_DYN, L_JTC, L_JAC, L_PERM,       // i32 [N]
  L_BASE, L_PC, L_PENALTY,                // bool [N]
  L_STEP_PEN,                             // i32 [K, P]
  L_STEP_PREF,                            // i32 [K]
  L_ASK_CPU, L_ASK_MEM, L_ASK_DISK,       // f32 scalar
  L_ASK_DYN, L_DESIRED, L_NSTEPS,         // i32 scalar
  L_ASK_RES, L_ALG, L_DHJ, L_DHT,         // bool scalar
  N_LEAVES
};

// A member's scalars (ops/kernel._feasible / _score read them per member).
struct Member {
  float ask_cpu, ask_mem, ask_disk;
  int ask_dyn, desired;
  int has_res, alg_spread, dhj, dht;
};

// One node as member m sees it: its planes, its carries, its counts.
struct Node {
  float cap_cpu, cap_mem, cap_disk, used_cpu, used_mem, used_disk, aff;
  float a_cpu, a_mem, a_disk;
  int free_dyn, a_dyn, jtc, jac;
  bool base, pc, pen;
};

// Feasibility with the current carries (ops/kernel._feasible restricted to
// the fused envelope).
template <typename A>
__device__ __forceinline__ bool node_feasible(const A& a,
                                              const Member& v,
                                              const Node& d) {
  float ucpu = d.used_cpu + d.a_cpu;
  float umem = d.used_mem + d.a_mem;
  float udisk = d.used_disk + d.a_disk;
  bool ok = d.base && (d.cap_cpu - ucpu) >= v.ask_cpu &&
            (d.cap_mem - umem) >= v.ask_mem &&
            (d.cap_disk - udisk) >= v.ask_disk;
  if (a.with_ports) {
    bool fit_dyn = v.ask_dyn <= 0 || (d.free_dyn - d.a_dyn) >= v.ask_dyn;
    ok = ok && !(d.pc && v.has_res) && fit_dyn;
  }
  if (a.with_distinct) {
    ok = ok && !((v.dhj && d.jac > 0) || (v.dht && d.jtc > 0));
  }
  return ok;
}

// Normalized score (ops/kernel._score restricted to the fused envelope),
// same operation order as the torch version. `pen`: the static penalty
// plane, or'ed with the step's penalty list where the caller says so.
__device__ __forceinline__ float node_score(const Member& v, const Node& d,
                                            bool pen) {
  float util_cpu = (d.used_cpu + d.a_cpu) + v.ask_cpu;
  float util_mem = (d.used_mem + d.a_mem) + v.ask_mem;
  float fc = d.cap_cpu > 0.0f ? 1.0f - util_cpu / d.cap_cpu : 0.0f;
  float fm = d.cap_mem > 0.0f ? 1.0f - util_mem / d.cap_mem : 0.0f;
  float total = powf(10.0f, fc) + powf(10.0f, fm);
  float binpack = fminf(fmaxf(20.0f - total, 0.0f), 18.0f);
  float spreadfit = fminf(fmaxf(total - 2.0f, 0.0f), 18.0f);
  // torch divides a CUDA tensor by a Python scalar as a product with the
  // scalar's f32 reciprocal (ATen div_true_kernel_cuda); so does this
  float sum = (v.alg_spread ? spreadfit : binpack) * (1.0f / 18.0f);
  float nplanes = 1.0f;
  float collisions = (float)d.jtc;
  if (collisions > 0.0f) {
    float denom = fmaxf((float)v.desired, 1.0f);
    sum = sum + (-(collisions + 1.0f) / denom);
    nplanes = nplanes + 1.0f;
  }
  if (pen) {
    sum = sum + -1.0f;
    nplanes = nplanes + 1.0f;
  }
  if (d.aff != 0.0f) {
    sum = sum + d.aff;
    nplanes = nplanes + 1.0f;
  }
  return sum / nplanes;
}

template <typename A>
__device__ __forceinline__ float masked_score(const A& a,
                                              const Member& v,
                                              const Node& d, bool pen) {
  return node_feasible(a, v, d) ? node_score(v, d, pen) : NEG_INF_F;
}

// Pre-wave metric counts of one node (input planes and counts; carries
// unread):
// evaluated, feasible, and exhausted on cpu, mem, disk and ports.
template <typename A>
__device__ __forceinline__ void count_metrics(const A& a,
                                              const Member& v, const Node& d,
                                              int* c) {
  bool fit_cpu = (d.cap_cpu - d.used_cpu) >= v.ask_cpu;
  bool fit_mem = (d.cap_mem - d.used_mem) >= v.ask_mem;
  bool fit_disk = (d.cap_disk - d.used_disk) >= v.ask_disk;
  bool fit_ports = true;
  if (a.with_ports) {
    bool fit_dyn = v.ask_dyn <= 0 || d.free_dyn >= v.ask_dyn;
    fit_ports = !(d.pc && v.has_res) && fit_dyn;
  }
  bool distinct_ok = true;
  if (a.with_distinct)
    distinct_ok = !((v.dhj && d.jac > 0) || (v.dht && d.jtc > 0));
  c[0] += d.base;
  c[1] += d.base && fit_cpu && fit_mem && fit_disk && fit_ports && distinct_ok;
  c[2] += d.base && !fit_cpu;
  c[3] += d.base && !fit_mem;
  c[4] += d.base && !fit_disk;
  c[5] += d.base && !fit_ports;
}

// Order-preserving key of a score: a larger key is a larger value; -0 and
// +0 share a key, as they compare equal.
__device__ __forceinline__ unsigned score_key(float v) {
  const unsigned b = __float_as_uint(v + 0.0f);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

__device__ __forceinline__ float key_score(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

#define PAD_KEY 0x007fffffu        // score_key(-INFINITY): below any score

// Warp argmax on (key desc, rank asc); every lane gets the winner.
__device__ __forceinline__ void warp_best(unsigned& k, unsigned& r, int& i) {
  const unsigned m = __reduce_max_sync(FULL_MASK, k);
  const unsigned rr = __reduce_min_sync(FULL_MASK, k == m ? r : NO_RANK);
  const unsigned hit = __ballot_sync(FULL_MASK, k == m && r == rr);
  i = __shfl_sync(FULL_MASK, i, __ffs(hit) - 1);
  k = m;
  r = rr;
}

__device__ __forceinline__ void list_clear(unsigned* lk, int* li) {
#pragma unroll
  for (int q = 0; q < TOPK; ++q) {
    lk[q] = PAD_KEY;
    li[q] = NO_NODE;
  }
}

// Insert into this thread's sorted top-8 (best first); its nodes come in
// increasing index order, so an equal key ranks after the ones held.
__device__ __forceinline__ void list_insert(unsigned* lk, int* li,
                                            unsigned k, int i) {
  if (k <= lk[TOPK - 1]) return;
  bool placed = false;
#pragma unroll
  for (int q = TOPK - 1; q > 0; --q) {
    if (!placed) {
      if (k > lk[q - 1]) {
        lk[q] = lk[q - 1];
        li[q] = li[q - 1];
      } else {
        lk[q] = k;
        li[q] = i;
        placed = true;
      }
    }
  }
  if (!placed) {
    lk[0] = k;
    li[0] = i;
  }
}

// Top-8 on (key desc, index asc) of the union of the lanes' sorted lists:
// eight rounds, each taking the best head (two reductions) and popping it
// from its lane. Every lane gets the result in (ok, oi); lk/li are spent.
__device__ __forceinline__ void warp_top(unsigned* lk, int* li,
                                         unsigned* ok, int* oi) {
#pragma unroll
  for (int q = 0; q < TOPK; ++q) {
    const unsigned m = __reduce_max_sync(FULL_MASK, lk[0]);
    const unsigned mi = __reduce_min_sync(
        FULL_MASK, lk[0] == m ? (unsigned)li[0] : NO_RANK);
    ok[q] = m;
    oi[q] = (int)mi;
    if (lk[0] == m && (unsigned)li[0] == mi) {
#pragma unroll
      for (int s = 0; s < TOPK - 1; ++s) {
        lk[s] = lk[s + 1];
        li[s] = li[s + 1];
      }
      lk[TOPK - 1] = PAD_KEY;
      li[TOPK - 1] = NO_NODE;
    }
  }
}

struct Best {
  unsigned k, r;  // score key, and the order among equal keys (rank)
  int i;          // node index
};
