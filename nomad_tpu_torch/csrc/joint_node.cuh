// The joint wave's per-node arithmetic, shared by its two kernels.
//
// csrc/joint_wave.cu (the one-device joint wave) and
// csrc/joint_sharded_wave.cu (the joint wave over a mesh of node shards)
// score, commit and count a node under any feature union (spreads,
// devices, reserved cores, bandwidth and everything of B1's envelope) with
// these functions: ops/kernel._feasible, _score and _deduct in the torch
// version's operation order, built with B1's flags (-fmad=false, no
// fast-math), so both kernels place bit for bit as the plain version does.
// A function taking `a` reads one node range through it: the whole node
// axis in joint_wave.cu, one mesh position's rows in the sharded kernel
// (whose position table holds one JointArgs a position, `n` its rows).
// Every device function is force-inlined, so joint_wave.cu compiles as it
// did with the code written out in place.

#pragma once

#include "cluster_wave.cuh"

#define MAX_P 4                    // MAX_PENALTY_NODES
#define N_SPECIAL (MAX_P + 2)      // pending commit, penalty nodes, pin
#define MAX_S 4                    // MAX_SPREADS
#define SB 128                     // SPREAD_BUCKETS
#define MAX_D 4                    // MAX_DEV_REQS
#define N_MET 8                    // FUSED_METRIC_FIELDS
#define BUMP_LANE 16               // warp 0's lanes that bump the counts

static_assert(SB == 4 * 32, "a warp holds a stanza's buckets, four a lane");
static_assert(BUMP_LANE >= N_SPECIAL && BUMP_LANE + MAX_S <= 32, "lanes");

// Leaf order: ops/kernel.KernelIn's field order, mirrored by
// nomad_tpu_torch/ops/cuda_kernel._JOINT_LEAVES.
enum JLeaf {
  J_CAP_CPU, J_CAP_MEM, J_CAP_DISK, J_FREE_CORES, J_SPC, J_FREE_DYN,
  J_BASE, J_USED_CPU, J_USED_MEM, J_USED_DISK, J_USED_CORES, J_USED_MBITS,
  J_AVAIL_MBITS, J_PC, J_DEV_FREE, J_DEV_AFF, J_HAS_DEV_AFF, J_JTC,
  J_PENALTY, J_AFF, J_PERM, J_STEP_PEN, J_STEP_PREF, J_JAC, J_DHJ, J_DHT,
  J_SP_ACTIVE, J_SP_EVEN, J_SP_WEIGHT, J_SP_BUCKET, J_SP_COUNTS,
  J_SP_DESIRED, J_ASK_CPU, J_ASK_MEM, J_ASK_DISK, J_ASK_CORES, J_ASK_DYN,
  J_ASK_RES, J_ASK_DEV, J_ASK_MBITS, J_DESIRED, J_ALG, J_NSTEPS,
  J_N_LEAVES
};

struct JointArgs {
  const void* leaf[J_N_LEAVES];
  long long stride[J_N_LEAVES];  // member stride in elements; 0 = shared
  const int* step_member;        // i32 [T]
  const int* step_local;         // i32 [T]
  float* packed;                 // f32 [2T + 8B]
  int* topk_idx;                 // i32 [T, TOPK]
  float* topk_scores;            // f32 [T, TOPK]
  float* a_cpu;                  // f32 [N] (outputs: the wave's carry)
  float* a_mem;
  float* a_disk;
  int* a_dyn;                    // i32 [N] scratch (with_ports)
  int* a_cores;                  // i32 [N] scratch (with_cores)
  int* a_mbits;                  // i32 [N] scratch (with_network)
  float* a_dev;                  // f32 [N, MAX_D] scratch (with_devices)
  int* jtc;                      // i32 [B, N] scratch
  int* jac;                      // i32 [B, N] scratch (with_distinct)
  unsigned char* pc;             // bool [B, N] scratch (with_ports)
  float* spc;                    // f32 [CLUSTER, B, MAX_S, SB] (ns > 0)
  int n, b, t, k, p, bp, ns;
  int with_topk, with_ports, with_distinct, with_step_pen, with_pref,
      with_shuffle, with_devices, with_cores, with_network, single;
  unsigned char* rows;           // global-row scratch (joint_wave.cu), or 0
};
static_assert(sizeof(JointArgs) == 896 && sizeof(JointArgs) % 16 == 0,
              "mirrored by cuda_kernel._JointArgs; copied as int4");

template <typename T>
__device__ __forceinline__ const T* leaf_of(const JointArgs& a, int leaf,
                                            int m) {
  return reinterpret_cast<const T*>(a.leaf[leaf]) + m * a.stride[leaf];
}

// A member's scalars, its device ask and its stanzas' flags.
struct JMember {
  float ask_cpu, ask_mem, ask_disk;
  float ask_dev[MAX_D];
  float sp_weight[MAX_S];
  int ask_cores, ask_dyn, ask_mbits, desired;
  int has_res, alg_spread, dhj, dht, dev_aff_on;
  int spread;                      // an active stanza among the first ns
  int sp_active[MAX_S], sp_even[MAX_S];
};

__device__ __forceinline__ JMember load_member(const JointArgs& a, int m) {
  JMember v;
  v.ask_cpu = *leaf_of<float>(a, J_ASK_CPU, m);
  v.ask_mem = *leaf_of<float>(a, J_ASK_MEM, m);
  v.ask_disk = *leaf_of<float>(a, J_ASK_DISK, m);
  v.ask_cores = *leaf_of<int>(a, J_ASK_CORES, m);
  v.ask_dyn = *leaf_of<int>(a, J_ASK_DYN, m);
  v.ask_mbits = *leaf_of<int>(a, J_ASK_MBITS, m);
  v.desired = *leaf_of<int>(a, J_DESIRED, m);
  v.has_res = *leaf_of<unsigned char>(a, J_ASK_RES, m) != 0;
  v.alg_spread = *leaf_of<unsigned char>(a, J_ALG, m) != 0;
  v.dhj = *leaf_of<unsigned char>(a, J_DHJ, m) != 0;
  v.dht = *leaf_of<unsigned char>(a, J_DHT, m) != 0;
  v.dev_aff_on = *leaf_of<unsigned char>(a, J_HAS_DEV_AFF, m) != 0;
  const float* dev = leaf_of<float>(a, J_ASK_DEV, m);
#pragma unroll
  for (int q = 0; q < MAX_D; ++q) v.ask_dev[q] = dev[q];
  v.spread = 0;
#pragma unroll
  for (int s = 0; s < MAX_S; ++s) {
    v.sp_active[s] =
        s < a.ns && leaf_of<unsigned char>(a, J_SP_ACTIVE, m)[s] != 0;
    v.sp_even[s] = leaf_of<unsigned char>(a, J_SP_EVEN, m)[s] != 0;
    v.sp_weight[s] = leaf_of<float>(a, J_SP_WEIGHT, m)[s];
    v.spread |= v.sp_active[s];
  }
  return v;
}

// One node as member m sees it. With `single` the f32 carries hold the
// used planes themselves (used_* and dev are read from them, a_* stay 0).
struct JNode {
  float cap_cpu, cap_mem, cap_disk, used_cpu, used_mem, used_disk, aff;
  float dev_aff, spc;
  float a_cpu, a_mem, a_disk;
  float dev[MAX_D], a_dev[MAX_D];
  int free_dyn, a_dyn, free_cores, used_cores, a_cores;
  int used_mbits, a_mbits, avail_mbits, jtc, jac;
  bool base, pc, pen;
};

__device__ __forceinline__ JNode load_node(const JointArgs& a, int m, int i,
                                           bool input_counts) {
  JNode d;
  const long long mi = (long long)m * a.n + i;
  d.cap_cpu = __ldg(leaf_of<float>(a, J_CAP_CPU, m) + i);
  d.cap_mem = __ldg(leaf_of<float>(a, J_CAP_MEM, m) + i);
  d.cap_disk = __ldg(leaf_of<float>(a, J_CAP_DISK, m) + i);
  d.aff = __ldg(leaf_of<float>(a, J_AFF, m) + i);
  d.base = __ldg(leaf_of<unsigned char>(a, J_BASE, m) + i) != 0;
  d.pen = __ldg(leaf_of<unsigned char>(a, J_PENALTY, m) + i) != 0;
  if (a.single) {
    d.used_cpu = a.a_cpu[i];
    d.used_mem = a.a_mem[i];
    d.used_disk = a.a_disk[i];
    d.a_cpu = d.a_mem = d.a_disk = 0.0f;
  } else {
    d.used_cpu = __ldg(leaf_of<float>(a, J_USED_CPU, m) + i);
    d.used_mem = __ldg(leaf_of<float>(a, J_USED_MEM, m) + i);
    d.used_disk = __ldg(leaf_of<float>(a, J_USED_DISK, m) + i);
    d.a_cpu = a.a_cpu[i];
    d.a_mem = a.a_mem[i];
    d.a_disk = a.a_disk[i];
  }
  d.free_dyn = a.with_ports ? __ldg(leaf_of<int>(a, J_FREE_DYN, m) + i) : 0;
  d.a_dyn = a.with_ports ? a.a_dyn[i] : 0;
  d.spc = a.with_cores ? __ldg(leaf_of<float>(a, J_SPC, m) + i) : 0.0f;
  d.free_cores =
      a.with_cores ? __ldg(leaf_of<int>(a, J_FREE_CORES, m) + i) : 0;
  d.used_cores =
      a.with_cores ? __ldg(leaf_of<int>(a, J_USED_CORES, m) + i) : 0;
  d.a_cores = a.with_cores ? a.a_cores[i] : 0;
  d.used_mbits =
      a.with_network ? __ldg(leaf_of<int>(a, J_USED_MBITS, m) + i) : 0;
  d.avail_mbits =
      a.with_network ? __ldg(leaf_of<int>(a, J_AVAIL_MBITS, m) + i) : 0;
  d.a_mbits = a.with_network ? a.a_mbits[i] : 0;
  d.dev_aff = a.with_devices ? __ldg(leaf_of<float>(a, J_DEV_AFF, m) + i)
                             : 0.0f;
#pragma unroll
  for (int q = 0; q < MAX_D; ++q) {
    d.dev[q] = 0.0f;
    d.a_dev[q] = 0.0f;
    if (a.with_devices) {
      if (a.single) {
        d.dev[q] = a.a_dev[(long long)i * MAX_D + q];
      } else {
        d.dev[q] = __ldg(leaf_of<float>(a, J_DEV_FREE, m) +
                         (long long)i * MAX_D + q);
        d.a_dev[q] = a.a_dev[(long long)i * MAX_D + q];
      }
    }
  }
  if (input_counts) {
    d.jtc = __ldg(leaf_of<int>(a, J_JTC, m) + i);
    d.jac = a.with_distinct ? __ldg(leaf_of<int>(a, J_JAC, m) + i) : 0;
    d.pc = a.with_ports &&
           __ldg(leaf_of<unsigned char>(a, J_PC, m) + i) != 0;
  } else {
    d.jtc = a.jtc[mi];
    d.jac = a.with_distinct ? a.jac[mi] : 0;
    d.pc = a.with_ports && a.pc[mi] != 0;
  }
  return d;
}

// ask_cpu_total (ops/kernel._feasible): per node under a core ask.
__device__ __forceinline__ float ask_cpu_total(const JointArgs& a,
                                               const JMember& v,
                                               const JNode& d) {
  return a.with_cores ? v.ask_cpu + (float)v.ask_cores * d.spc : v.ask_cpu;
}

// The fit planes of ops/kernel._feasible, with the current carries (the
// metrics pass calls it before any carry exists); bit q of the result is
// fit_cpu, fit_mem, fit_disk, fit_cores, fit_ports, fit_dev, fit_bw,
// distinct_ok.
__device__ __forceinline__ unsigned node_fits(const JointArgs& a,
                                              const JMember& v,
                                              const JNode& d) {
  const float act = ask_cpu_total(a, v, d);
  const float ucpu = d.used_cpu + d.a_cpu;
  const float umem = d.used_mem + d.a_mem;
  const float udisk = d.used_disk + d.a_disk;
  unsigned f = 0;
  f |= ((d.cap_cpu - ucpu) >= act) << 0;
  f |= ((d.cap_mem - umem) >= v.ask_mem) << 1;
  f |= ((d.cap_disk - udisk) >= v.ask_disk) << 2;
  f |= (!a.with_cores || v.ask_cores <= 0 ||
        (d.free_cores - (d.used_cores + d.a_cores)) >= v.ask_cores) << 3;
  bool ports = true;
  if (a.with_ports) {
    const bool fit_dyn =
        v.ask_dyn <= 0 || (d.free_dyn - d.a_dyn) >= v.ask_dyn;
    ports = !(d.pc && v.has_res) && fit_dyn;
  }
  f |= ports << 4;
  bool dev = true;
  if (a.with_devices) {
#pragma unroll
    for (int q = 0; q < MAX_D; ++q)
      dev = dev && (v.ask_dev[q] <= 0.0f ||
                    (d.dev[q] - d.a_dev[q]) >= v.ask_dev[q]);
  }
  f |= dev << 5;
  f |= (!a.with_network || v.ask_mbits <= 0 ||
        ((d.used_mbits + d.a_mbits) + v.ask_mbits) <= d.avail_mbits) << 6;
  f |= (!a.with_distinct ||
        !((v.dhj && d.jac > 0) || (v.dht && d.jtc > 0))) << 7;
  return f;
}

#define ALL_FITS 0xffu

// The score's planes before the spread term (ops/kernel._score in its
// operation order): their sum and their count; a count of 0 marks an
// infeasible node.
__device__ __forceinline__ void node_rest(const JointArgs& a,
                                          const JMember& v, const JNode& d,
                                          bool pen, float& sum,
                                          unsigned& cnt) {
  if (!d.base || node_fits(a, v, d) != ALL_FITS) {
    sum = 0.0f;
    cnt = 0;
    return;
  }
  const float util_cpu = (d.used_cpu + d.a_cpu) + ask_cpu_total(a, v, d);
  const float util_mem = (d.used_mem + d.a_mem) + v.ask_mem;
  const float fc = d.cap_cpu > 0.0f ? 1.0f - util_cpu / d.cap_cpu : 0.0f;
  const float fm = d.cap_mem > 0.0f ? 1.0f - util_mem / d.cap_mem : 0.0f;
  const float total = powf(10.0f, fc) + powf(10.0f, fm);
  const float binpack = fminf(fmaxf(20.0f - total, 0.0f), 18.0f);
  const float spreadfit = fminf(fmaxf(total - 2.0f, 0.0f), 18.0f);
  // torch scales by the f32 reciprocal of 18 on the card (wave_score.cuh)
  float s = (v.alg_spread ? spreadfit : binpack) * (1.0f / 18.0f);
  unsigned c = 1;
  if (a.with_devices && v.dev_aff_on) {
    s = s + d.dev_aff;
    c += 1;
  }
  const float collisions = (float)d.jtc;
  if (collisions > 0.0f) {
    const float denom = fmaxf((float)v.desired, 1.0f);
    s = s + (-(collisions + 1.0f) / denom);
    c += 1;
  }
  if (pen) {
    s = s + -1.0f;
    c += 1;
  }
  if (d.aff != 0.0f) {
    s = s + d.aff;
    c += 1;
  }
  sum = s;
  cnt = c;
}

// The row key of a node: the parts before the spread term, and the
// node's spread sum (0.0f without an active stanza).
__device__ __forceinline__ unsigned final_key(float sum, unsigned cnt,
                                              float spread) {
  if (cnt == 0) return score_key(NEG_INF_F);
  float s = sum, c = (float)cnt;
  if (spread != 0.0f) {
    s = s + spread;
    c = c + 1.0f;
  }
  return score_key(s / c);
}

// Member m's bucket of node i in stanza s (-1: no bucket; buckets past SB
// clamp to the last, as the one-hot does), read from L2 at every use.
__device__ __forceinline__ int node_bucket(const JointArgs& a, int m, int i,
                                           int s) {
  const int bk =
      __ldg(leaf_of<int>(a, J_SP_BUCKET, m) + (long long)s * a.n + i);
  return bk < 0 ? -1 : min(bk, SB - 1);
}

// counts[s][bucket of node i] += 1 for member m's active stanzas.
__device__ __forceinline__ void bump_stanza(const JointArgs& a,
                                            const JMember& v, int m, int i,
                                            int s, float (*counts)[SB]) {
  if (i < 0 || !v.sp_active[s]) return;
  const int bk = node_bucket(a, m, i, s);
  if (bk >= 0) counts[s][bk] += 1.0f;
}

// Commit one placement of member m on node i (the plain version's one-hot
// update at that node), in memory and in `d`.
__device__ __forceinline__ void commit_node(const JointArgs& a,
                                            const JMember& v, int m, int i,
                                            JNode& d) {
  const long long mi = (long long)m * a.n + i;
  const float act = ask_cpu_total(a, v, d);
  if (a.single) {
    d.used_cpu = d.used_cpu + act;
    d.used_mem = d.used_mem + v.ask_mem;
    d.used_disk = d.used_disk + v.ask_disk;
    a.a_cpu[i] = d.used_cpu;
    a.a_mem[i] = d.used_mem;
    a.a_disk[i] = d.used_disk;
  } else {
    d.a_cpu = d.a_cpu + act;
    d.a_mem = d.a_mem + v.ask_mem;
    d.a_disk = d.a_disk + v.ask_disk;
    a.a_cpu[i] = d.a_cpu;
    a.a_mem[i] = d.a_mem;
    a.a_disk[i] = d.a_disk;
  }
  d.jtc += 1;
  a.jtc[mi] = d.jtc;
  if (a.with_ports) {
    d.a_dyn += v.ask_dyn;
    a.a_dyn[i] = d.a_dyn;
    if (v.has_res) {
      d.pc = true;
      a.pc[mi] = 1;
    }
  }
  if (a.with_distinct) {
    d.jac += 1;
    a.jac[mi] = d.jac;
  }
  if (a.with_cores) {
    d.a_cores += v.ask_cores;
    a.a_cores[i] = d.a_cores;
  }
  if (a.with_network) {
    d.a_mbits += v.ask_mbits;
    a.a_mbits[i] = d.a_mbits;
  }
  if (a.with_devices) {
#pragma unroll
    for (int q = 0; q < MAX_D; ++q) {
      if (a.single) {
        d.dev[q] = d.dev[q] - v.ask_dev[q];
        a.a_dev[(long long)i * MAX_D + q] = d.dev[q];
      } else {
        d.a_dev[q] = d.a_dev[q] + v.ask_dev[q];
        a.a_dev[(long long)i * MAX_D + q] = d.a_dev[q];
      }
    }
  }
}

// Pre-wave metric counts of one node (input planes and counts; carries
// unread): evaluated, feasible, and exhausted on cpu, mem, disk, ports,
// devices and cores (FUSED_METRIC_FIELDS order).
__device__ __forceinline__ void count_metrics(const JointArgs& a,
                                              const JMember& v, JNode d,
                                              int* c) {
  d.a_cpu = d.a_mem = d.a_disk = 0.0f;
  d.a_dyn = d.a_cores = d.a_mbits = 0;
#pragma unroll
  for (int q = 0; q < MAX_D; ++q) d.a_dev[q] = 0.0f;
  const unsigned f = node_fits(a, v, d);
  c[0] += d.base;
  c[1] += d.base && f == ALL_FITS;
  c[2] += d.base && !(f & 1u);
  c[3] += d.base && !(f & 2u);
  c[4] += d.base && !(f & 4u);
  c[5] += d.base && !(f & 16u);
  c[6] += d.base && !(f & 32u);
  c[7] += d.base && !(f & 8u);
}

__device__ __forceinline__ void load_step_nodes(const JointArgs& a, int m,
                                                int j, int* out) {
  const int* sp = leaf_of<int>(a, J_STEP_PEN, m) + (long long)j * a.p;
#pragma unroll
  for (int q = 0; q < MAX_P; ++q)
    out[q] = (a.with_step_pen && q < a.p) ? __ldg(sp + q) : -1;
  out[MAX_P] = a.with_pref ? __ldg(leaf_of<int>(a, J_STEP_PREF, m) + j) : -1;
}

// One warp's stanza s of the step's boost table (ops/kernel._spread_score
// on the bucket axis): lane l computes buckets l, l+32, l+64, l+96 from
// the member's counts and desired counts.
__device__ __forceinline__ void build_boost(const JMember& v, int s, int lane,
                                            const float (*counts)[SB],
                                            const float (*desired)[SB],
                                            float (*boost)[SB]) {
  float cb[4];
  float mn = INFINITY, mx = -INFINITY;
  bool any = false;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    cb[q] = counts[s][lane + 32 * q];
    if (cb[q] > 0.0f) {
      mn = fminf(mn, cb[q]);
      mx = fmaxf(mx, cb[q]);
      any = true;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    mn = fminf(mn, __shfl_xor_sync(FULL_MASK, mn, off));
    mx = fmaxf(mx, __shfl_xor_sync(FULL_MASK, mx, off));
  }
  any = __any_sync(FULL_MASK, any);
  const bool even = v.sp_even[s];
  const float w = v.sp_weight[s];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int bk = lane + 32 * q;
    const float c = cb[q];
    float val;
    if (even) {
      // evenSpreadScoreBoost (spread.go:193)
      if (!any)
        val = 0.0f;
      else if (c != mn)
        val = mn > 0.0f ? (mn - c) / fmaxf(mn, 1.0f) : -1.0f;
      else if (mn == mx)
        val = -1.0f;
      else if (mn == 0.0f)
        val = 1.0f;
      else
        val = (mx - mn) / fmaxf(mn, 1.0f);
    } else {
      // the desired-count path (spread.go:158-183)
      const float des = desired[s][bk];
      val = des > 0.0f ? ((des - (c + 1.0f)) / des) * w : -1.0f;
    }
    boost[s][bk] = val;
  }
}

// Shared memory of a CTA's node range of `c4` entries (a multiple of
// four): row keys, shuffle ranks, partial sums, then the counts (bytes).
__host__ __device__ inline size_t joint_row_bytes(size_t c4,
                                                  int with_shuffle) {
  return c4 * 4 * (2 + (with_shuffle ? 1 : 0)) + c4;
}

// The buckets of member m's active stanzas at node i, one signed byte a
// stanza (-1: no bucket, or the stanza is not active): what the sharded
// kernel hands on with a step's choice, so that every CTA of every card
// bumps the chosen node's buckets without reading its card's planes.
__device__ __forceinline__ int node_buckets(const JointArgs& a,
                                            const JMember& v, int m, int i) {
  unsigned out = 0xffffffffu;
#pragma unroll
  for (int s = 0; s < MAX_S; ++s)
    if (v.sp_active[s])
      out = (out & ~(0xffu << (8 * s))) |
            ((unsigned)(node_bucket(a, m, i, s) & 0xff) << (8 * s));
  return (int)out;
}

// counts[s][b] += 1 for the bucket b that byte s of `pb` names
// (node_buckets' packing).
__device__ __forceinline__ void bump_packed(int pb, int s,
                                            float (*counts)[SB]) {
  const int bk = (int)(signed char)((unsigned)pb >> (8 * s));
  if (bk >= 0) counts[s][bk] += 1.0f;
}
