// Joint placement wave for NVIDIA Hopper (sm_90a), under any feature union.
//
// Replaces: the XLA programs nomad_tpu/ops/kernel.py
// `place_taskgroups_joint_jit` (:1060-1279, its `lax.scan` at :1235), which
// the reference's wave launcher runs for a wave whose feature union leaves
// B1's envelope (nomad_tpu/parallel/coalesce.py:682), and
// `place_taskgroup_jit` (:565-723), its single eval outside the candidate
// set. It computes what nomad_tpu_torch/ops/kernel.place_taskgroups_joint
// computes under any KernelFeatures (spreads, devices, reserved cores and
// bandwidth with everything of B1's envelope), packed the way
// ops/kernel.pack_fused_wave packs it. With `single` set it runs one eval
// as ops/kernel.place_taskgroup does: the f32 carries hold the used planes
// with each placement added in turn (used + a1 + a2), where a wave's hold
// the placements' sum apart (used + (a1 + a2)), as the two reference
// programs round.
//
// Why a kernel of its own beside csrc/fused_wave.cu (B1) rather than a
// template of it: a spread stanza breaks B1's cached row. A step bumps one
// bucket's count, which can change the even-spread boost of every bucket
// (it reads the min and max count over all SPREAD_BUCKETS) and so every
// node's score; B1's step assumes that only the chosen node's score moves.
// Every phase of B1's step would branch on it, and B1's lean code is left
// as it was, bit for bit. What holds no scoring rule (the slots, the rank
// loader, the top-8 lists, the launch) is B1's, from csrc/cluster_wave.cuh.
//
// What bounds it. As for B1, the wave is a chain of T dependent N-wide
// argmaxes (fused_wave.cu's header). A spread member adds to each link one
// pass over the CTA's nodes (a table lookup, an add and a divide a node)
// and a rebuild of every warp's top-8 list; the bytes (B1's planes plus the
// device [N, 4], core, bandwidth and bucket planes, each read once) stay
// ~3-4 us at 3.35 TB/s.
//
// Design: B1's, on a cluster of CLUSTER CTAs, CTA c owning the node range
// [c*chunk, (c+1)*chunk); see fused_wave.cu for the step's phases, the
// slots, the deferred commit and the top-k merge. What differs:
// - Each node keeps in shared memory, beside its row key, the parts of its
//   score before the spread term: their sum and their count (0: the node
//   is infeasible); its bucket per stanza is read from L2 when used. A
//   commit changes only the chosen node's carries (cpu/mem/disk, dynamic
//   ports, cores a_cores, bandwidth a_mbits, devices a_dev[N, 4]), so the
//   owner CTA recomputes only that node's parts, as B1 rescores one node.
// - Per CTA, the current member's spread counts [S, 128] and desired
//   counts live in shared memory; every CTA applies each winner's bump
//   itself (the bucket read from L2), so the counts need no exchange. A
//   member's counts go to this CTA's own scratch when another member's
//   step comes, and come back at its next step.
// - A step of a member with an active stanza: one warp a stanza computes
//   the [S, 128] boost table from the counts (one barrier), then every
//   thread re-derives its nodes' row keys as (sum + spread) / (count + on)
//   in its argmax loop, and every warp rebuilds its top-8 list. Adding the
//   spread term last to the cached partial sum is the plain version's own
//   order of f32 operations (fit, device affinity, anti-affinity, penalty,
//   node affinity, spread, then the divide), and the projection of the
//   one-hot product has one nonzero term, so the keys are the plain
//   version's bits. A member without an active stanza keeps B1's cached
//   row.
// - The pin's step value is read from the row after the argmax loop, where
//   it holds the step's spread term too.
//
// Shared memory: 13 B a node of the CTA's range with shuffle (row key,
// rank, partial sum, count) and 36 B a member, so N=262144 (16384 nodes a
// CTA) takes 212992 B + 36 B a member of the ~219 KiB a block may take
// beside the ~7.5 KiB static part; N=524288 does not fit, and the wrapper
// raises before launching.
//
// Built by nomad_tpu_torch/ops/build.py with B1's flags (-fmad=false, no
// fast-math), so every score rounds op for op as the torch version does on
// the card. The keys and the warp reductions are B1's (csrc/wave_score.cuh).

#include <cooperative_groups.h>

#include "cluster_wave.cuh"

namespace cg = cooperative_groups;

#define CLUSTER 16
#define THREADS 512
#define NWARPS (THREADS / 32)
#define MAX_P 4                    // MAX_PENALTY_NODES
#define N_SPECIAL (MAX_P + 2)      // pending commit, penalty nodes, pin
#define ALL_WARPS (FULL_MASK >> (32 - NWARPS))
#define MAX_DEVICES 64
#define MAX_S 4                    // MAX_SPREADS
#define SB 128                     // SPREAD_BUCKETS
#define MAX_D 4                    // MAX_DEV_REQS
#define N_MET 8                    // FUSED_METRIC_FIELDS
#define BUMP_LANE 16               // warp 0's lanes that bump the counts

static_assert(NWARPS >= MAX_S, "one warp a stanza builds the boost table");
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
};

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

// Shared memory beyond the static part, in words of the CTA's range
// (rounded to four): row keys, shuffle ranks, partial sums, then the
// counts (bytes), the metric partial sums and a flag per member.
__host__ __device__ inline size_t joint_smem_bytes(int n, int b,
                                                   int with_shuffle) {
  const size_t chunk = (size_t)((n + CLUSTER - 1) / CLUSTER);
  const size_t c4 = (chunk + 3) & ~(size_t)3;
  return c4 * 4 * (2 + (with_shuffle ? 1 : 0)) + c4 +
         (size_t)b * (N_MET + 1) * sizeof(int);
}

__global__ void __launch_bounds__(THREADS, 1)
    joint_wave_kernel(const JointArgs a) {
  extern __shared__ __align__(16) unsigned char dyn_smem[];
  __shared__ Slot slot[2];
  __shared__ TopList top_list[2];
  __shared__ Best sh_best[NWARPS];
  __shared__ unsigned sh_tk[NWARPS][TOPK];
  __shared__ int sh_ti[NWARPS][TOPK];
  __shared__ unsigned sh_dirty;
  __shared__ JMember sh_member;
  __shared__ float counts[MAX_S][SB];   // the current member's counts
  __shared__ float desired[MAX_S][SB];  // and its desired counts
  __shared__ float boost[MAX_S][SB];    // this step's boost per bucket

  cg::cluster_group cluster = cg::this_cluster();
  const int cta = (int)cluster.block_rank();
  const int n = a.n, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int chunk = (n + CLUSTER - 1) / CLUSTER;
  const int c4 = (chunk + 3) & ~3;
  const int lo = min(cta * chunk, n), hi = min(lo + chunk, n);
  const int cnt = hi - lo;
  unsigned* row = reinterpret_cast<unsigned*>(dyn_smem);
  unsigned* rank = row + c4;
  float* rsum = reinterpret_cast<float*>(rank + (a.with_shuffle ? c4 : 0));
  unsigned char* rcnt = reinterpret_cast<unsigned char*>(rsum + c4);
  int* part = reinterpret_cast<int*>(rcnt + c4);
  int* seen = part + a.b * N_MET;
  float* my_spc = a.spc + (long long)cta * a.b * MAX_S * SB;

  // ---- pre-wave: the carries (a wave's from 0, a single eval's from its
  // used planes), the partial sums and the flags ----
  for (int i = lo + tid; i < hi; i += THREADS) {
    if (a.single) {
      a.a_cpu[i] = __ldg(leaf_of<float>(a, J_USED_CPU, 0) + i);
      a.a_mem[i] = __ldg(leaf_of<float>(a, J_USED_MEM, 0) + i);
      a.a_disk[i] = __ldg(leaf_of<float>(a, J_USED_DISK, 0) + i);
    } else {
      a.a_cpu[i] = 0.0f;
      a.a_mem[i] = 0.0f;
      a.a_disk[i] = 0.0f;
    }
    if (a.with_ports) a.a_dyn[i] = 0;
    if (a.with_cores) a.a_cores[i] = 0;
    if (a.with_network) a.a_mbits[i] = 0;
    if (a.with_devices)
      for (int q = 0; q < MAX_D; ++q)
        a.a_dev[(long long)i * MAX_D + q] =
            a.single ? __ldg(leaf_of<float>(a, J_DEV_FREE, 0) +
                             (long long)i * MAX_D + q)
                     : 0.0f;
  }
  for (int x = tid; x < a.b * (N_MET + 1); x += THREADS) part[x] = 0;
  __syncthreads();

  auto emit_topk = [&](int pp, int t) {
    unsigned ok[TOPK];
    int oi[TOPK];
    cluster_top<CLUSTER>(cluster, &top_list[pp], a.with_topk, lane, ok, oi);
    write_topk(ok, oi, lane, t, a.with_topk, a.topk_idx, a.topk_scores);
  };
  auto warp_list = [&]() {
    warp_row_top<THREADS>(row, lo, cnt, warp, lane, sh_tk[warp], sh_ti[warp]);
  };
  auto mark = [&](int x) {
    atomicOr(&sh_dirty, 1u << ((x % THREADS) / 32));
  };

  // ---- the step loop ----
  int row_m = -1;      // member whose row (and counts) are cached
  int rank_m = -1;     // permutation row whose ranks are cached
  int mspread = 0;     // row_m has an active stanza: rows re-derived a step
  int pend = -1;       // warp 0: chosen node of the last active step
  int par = 0;
  int n_act = 0;
  int t_prev = -1;
  int restore_x = -1;  // row entry a special thread puts back next step
  unsigned restore_k = 0, restore_c = 0;
  float restore_s = 0.0f;
  int pf_t = -1;
  int pf_s[MAX_P + 1];
  for (int t0 = 0; t0 < a.t; t0 += 32) {
    const int ts = t0 + lane;
    int mem_raw = -1, j_raw = 0;
    bool act = false;
    if (ts < a.t) {
      mem_raw = a.step_member[ts];
      j_raw = a.step_local[ts];
      const int mc = min(max(mem_raw, 0), a.b - 1);
      act = mem_raw >= 0 && j_raw < *leaf_of<int>(a, J_NSTEPS, mc);
    }
    unsigned mask = __ballot_sync(FULL_MASK, act);
    if (cta == 0 && warp == 1 && ts < a.t && !act) {
      a.packed[ts] = -1.0f;
      a.packed[a.t + ts] = 0.0f;
      for (int q = 0; q < TOPK; ++q) {
        a.topk_idx[ts * TOPK + q] = a.with_topk ? q : 0;
        a.topk_scores[ts * TOPK + q] = NEG_INF_F;
      }
    }

    while (mask) {
      const int l = __ffs(mask) - 1;
      mask &= mask - 1;
      const int t = t0 + l;
      const int m = min(max(__shfl_sync(FULL_MASK, mem_raw, l), 0), a.b - 1);
      const int j = min(max(__shfl_sync(FULL_MASK, j_raw, l), 0), a.k - 1);

      // a new member: commit the last one's pending placement (its carries
      // in the owner CTA, its spread bump in every CTA), swap the members'
      // counts, then rebuild the row and the partial sums over this CTA's
      // range (at its first appearance also copying its scratch and
      // counting its metrics)
      if (m != row_m) {
        const bool first = seen[m] == 0;
        if (tid == 0) {
          if (row_m >= 0 && pend >= 0) {
            const JMember old = sh_member;
            if (pend >= lo && pend < hi) {
              JNode d = load_node(a, row_m, pend, false);
              commit_node(a, old, row_m, pend, d);
            }
            if (old.spread)
              for (int s = 0; s < MAX_S; ++s)
                bump_stanza(a, old, row_m, pend, s, counts);
          }
          sh_member = load_member(a, m);
        }
        pend = -1;
        restore_x = -1;
        __syncthreads();
        if (a.ns > 0) {
          const float* in_c = leaf_of<float>(a, J_SP_COUNTS, m);
          const float* in_d = leaf_of<float>(a, J_SP_DESIRED, m);
          for (int x = tid; x < a.ns * SB; x += THREADS) {  // the ns rows
            float* c = &counts[0][0] + x;
            if (row_m >= 0) my_spc[(long long)row_m * MAX_S * SB + x] = *c;
            *c = first ? in_c[x] : my_spc[(long long)m * MAX_S * SB + x];
            (&desired[0][0])[x] = in_d[x];
          }
        }
        const JMember v = sh_member;
        const long long row0 = (long long)m * n;
        int c[N_MET] = {0, 0, 0, 0, 0, 0, 0, 0};
        for (int x = tid; x < cnt; x += THREADS) {
          const int i = lo + x;
          const JNode d = load_node(a, m, i, first);
          if (first) {
            count_metrics(a, v, d, c);
            a.jtc[row0 + i] = d.jtc;
            if (a.with_distinct) a.jac[row0 + i] = d.jac;
            if (a.with_ports) a.pc[row0 + i] = d.pc;
          }
          float s;
          unsigned k;
          node_rest(a, v, d, d.pen, s, k);
          rsum[x] = s;
          rcnt[x] = (unsigned char)k;
          row[x] = final_key(s, k, 0.0f);
        }
        if (first) {
#pragma unroll
          for (int q = 0; q < N_MET; ++q) {
            const int s = __reduce_add_sync(FULL_MASK, c[q]);
            if (lane == 0 && s != 0) atomicAdd(&part[m * N_MET + q], s);
          }
        }
        const int pm = a.bp > 1 ? m : 0;
        if (a.with_shuffle && pm != rank_m) {
          load_ranks<THREADS>(leaf_of<int>(a, J_PERM, pm), n, lo, hi, rank,
                              tid, [](int g) { return g; });
          rank_m = pm;
        }
        row_m = m;
        mspread = v.spread;
        if (tid == 0) {
          seen[m] = 1;
          sh_dirty = ALL_WARPS;
        }
        __syncthreads();
      }

      // special nodes, one thread each in the owner CTA (as in B1), with
      // the partial sums kept beside the row; lanes BUMP_LANE.. of every
      // CTA's warp 0 add the pending placement's spread bump
      int pcl = -1;  // the step's pin (clamped), or -1
      if (warp == 0) {
        if (restore_x >= 0) {
          row[restore_x] = restore_k;
          rsum[restore_x] = restore_s;
          rcnt[restore_x] = (unsigned char)restore_c;
          mark(restore_x);
        }
        restore_x = -1;
        __syncwarp();
        if (pf_t != t) load_step_nodes(a, m, j, pf_s);
        int s[N_SPECIAL];
        s[0] = pend;
#pragma unroll
        for (int q = 0; q <= MAX_P; ++q) s[1 + q] = pf_s[q];
        const int pref = s[N_SPECIAL - 1];
        pcl = pref >= 0 ? min(pref, n - 1) : -1;
        s[N_SPECIAL - 1] = pcl;
        if (mask) {
          const int nl = __ffs(mask) - 1;
          pf_t = t0 + nl;
          load_step_nodes(
              a, min(max(__shfl_sync(FULL_MASK, mem_raw, nl), 0), a.b - 1),
              min(max(__shfl_sync(FULL_MASK, j_raw, nl), 0), a.k - 1), pf_s);
        }
        if (mspread && lane >= BUMP_LANE && lane < BUMP_LANE + MAX_S) {
          const JMember v = sh_member;
          bump_stanza(a, v, m, pend, lane - BUMP_LANE, counts);
        }
        int q = -1;
#pragma unroll
        for (int k = 0; k < N_SPECIAL; ++k)
          if (k == tid) q = s[k];
        bool mine = q >= lo && q < hi;
#pragma unroll
        for (int k = 0; k < N_SPECIAL; ++k)
          if (k < tid && s[k] == q) mine = false;
        if (mine) {
          bool is_pen = false;
#pragma unroll
          for (int k = 1; k <= MAX_P; ++k) is_pen = is_pen || s[k] == q;
          const int x = q - lo;
          if (q == pend || is_pen) {
            const JMember v = sh_member;
            JNode d = load_node(a, m, q, false);
            float rs;
            unsigned rc;
            if (q == pend) {
              commit_node(a, v, m, q, d);
              node_rest(a, v, d, d.pen, rs, rc);
              rsum[x] = rs;
              rcnt[x] = (unsigned char)rc;
              row[x] = final_key(rs, rc, 0.0f);
            }
            if (is_pen) {
              restore_x = x;
              restore_k = row[x];
              restore_s = rsum[x];
              restore_c = rcnt[x];
              node_rest(a, v, d, true, rs, rc);
              rsum[x] = rs;
              rcnt[x] = (unsigned char)rc;
              row[x] = final_key(rs, rc, 0.0f);
            }
            mark(x);
          }
        }
      } else if (warp == 1 && cta == 0 && n_act >= 1) {
        emit_topk(par ^ 1, t_prev);
      }
      __syncthreads();

      // a spread member: the step's boost per (stanza, bucket), one warp a
      // stanza (ops/kernel._spread_score on the bucket axis)
      if (mspread) {
        if (warp < a.ns && sh_member.sp_active[warp]) {
          const int s = warp;
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
          const bool even = sh_member.sp_even[s];
          const float w = sh_member.sp_weight[s];
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
        __syncthreads();
      }

      // every warp: its argmax over its row entries (re-deriving them for
      // a spread member), and its top-8 list when the step made it stale
      const bool all_dirty = mspread;
      {
        unsigned bk = PAD_KEY, br = NO_RANK;
        int bi = NO_NODE;
        for (int x = tid; x < cnt; x += THREADS) {
          unsigned k;
          if (mspread) {
            float sp = 0.0f;
            for (int s = 0; s < a.ns; ++s) {
              if (!sh_member.sp_active[s]) continue;
              const int bk = node_bucket(a, m, lo + x, s);
              sp = sp + (bk < 0 ? -1.0f : boost[s][bk]);
            }
            k = final_key(rsum[x], rcnt[x], sp);
            row[x] = k;
          } else {
            k = row[x];
          }
          const unsigned r = a.with_shuffle ? rank[x] : (unsigned)(lo + x);
          if (k > bk || (k == bk && r < br)) {
            bk = k;
            br = r;
            bi = lo + x;
          }
        }
        warp_best(bk, br, bi);
        if (lane == 0) sh_best[warp] = Best{bk, br, bi};
        if (a.with_topk && (all_dirty || ((sh_dirty >> warp) & 1u)))
          warp_list();
      }
      __syncthreads();

      // this CTA's argmax (warp 0, with the pin's step value read from the
      // row) and top-8 (warp 1) into its slots
      if (warp == 0) {
        Best b = {PAD_KEY, NO_RANK, NO_NODE};
        if (lane < NWARPS) b = sh_best[lane];
        warp_best(b.k, b.r, b.i);
        if (lane == 0)
          slot[par] = Slot{b.k, b.r, b.i,
                           (pcl >= 0 && pcl / chunk == cta)
                               ? key_score(row[pcl - lo])
                               : NEG_INF_F};
      } else if (warp == 1) {
        if (a.with_topk) {
          if (all_dirty || sh_dirty) {
            unsigned lk[TOPK], ok[TOPK];
            int li[TOPK], oi[TOPK];
            list_clear(lk, li);
            if (lane < NWARPS) {
#pragma unroll
              for (int q = 0; q < TOPK; ++q) {
                lk[q] = sh_tk[lane][q];
                li[q] = sh_ti[lane][q];
              }
            }
            warp_top(lk, li, ok, oi);
#pragma unroll
            for (int q = 0; q < TOPK; ++q)
              if (q == lane) {
                top_list[par].k[q] = ok[q];
                top_list[par].i[q] = oi[q];
              }
          } else if (lane < TOPK) {
            top_list[par].k[lane] = top_list[par ^ 1].k[lane];
            top_list[par].i[lane] = top_list[par ^ 1].i[lane];
          }
        }
        __syncwarp();
        if (lane == 0) sh_dirty = 0;
      }
      cluster.sync();

      // warp 0 of every CTA: the cluster's argmax from the CTAs' slots
      if (warp == 0) {
        Best b = {PAD_KEY, NO_RANK, NO_NODE};
        float pin_v = NEG_INF_F;
        if (lane < CLUSTER) {
          const Slot sl = *cluster.map_shared_rank(&slot[par], lane);
          b = Best{sl.k, sl.r, sl.i};
          pin_v = sl.pin_v;
        }
        warp_best(b.k, b.r, b.i);
        int idx = b.i;
        float val = key_score(b.k);
        if (pcl >= 0) {
          const float pv = __shfl_sync(FULL_MASK, pin_v, pcl / chunk);
          if (pv > NEG_INF_F / 2.0f) {
            idx = pcl;
            val = pv;
          }
        }
        const bool found = val > NEG_INF_F / 2.0f;
        if (cta == 0 && lane == 0) {
          a.packed[t] = found ? (float)idx : -1.0f;
          a.packed[a.t + t] = found ? val : 0.0f;
        }
        pend = found ? idx : -1;
      }
      par ^= 1;
      ++n_act;
      t_prev = t;
    }
  }

  // ---- tail: the last placement, the last top-k, the metrics ----
  if (tid == 0 && pend >= lo && pend < hi) {
    JNode d = load_node(a, row_m, pend, false);
    commit_node(a, sh_member, row_m, pend, d);
  }
  for (int m = 0; m < a.b; ++m) {
    if (seen[m]) continue;  // counted at its first row pass
    const JMember v = load_member(a, m);
    int c[N_MET] = {0, 0, 0, 0, 0, 0, 0, 0};
    for (int i = lo + tid; i < hi; i += THREADS)
      count_metrics(a, v, load_node(a, m, i, true), c);
#pragma unroll
    for (int q = 0; q < N_MET; ++q) {
      const int s = __reduce_add_sync(FULL_MASK, c[q]);
      if (lane == 0 && s != 0) atomicAdd(&part[m * N_MET + q], s);
    }
  }
  cluster.sync();
  if (cta == 0) {
    if (warp == 1 && n_act >= 1) emit_topk(par ^ 1, t_prev);
    float* metrics = a.packed + 2 * a.t;
    for (int x = tid; x < a.b * N_MET; x += THREADS) {
      int s = 0;
      for (int c = 0; c < CLUSTER; ++c)
        s += cluster.map_shared_rank(part, c)[x];
      metrics[(x % N_MET) * a.b + x / N_MET] = (float)s;
    }
  }
  cluster.sync();
}

// The dynamic shared memory a block may take on the current device, after
// setting the kernel's attributes there (once per device).
static int g_limit[MAX_DEVICES];  // 0: attributes not set yet

static cudaError_t smem_limit(int* limit) {
  void (*const kernels[])(const JointArgs) = {joint_wave_kernel};
  return cluster_smem_limit(kernels, g_limit, limit);
}

static cudaLaunchConfig_t launch_config(size_t smem, cudaStream_t stream,
                                        cudaLaunchAttribute* attr) {
  return cluster_launch_config<CLUSTER, THREADS>(smem, stream, attr);
}

extern "C" int joint_wave_cluster(void) { return CLUSTER; }

// out[0] cluster size, out[1] dynamic shared memory the wave needs,
// out[2] the most a block may take, out[3] clusters of that shape the card
// can hold at once (0: the launch would be refused).
extern "C" int joint_wave_plan(int n, int b, int with_shuffle, int* out) {
  int limit = 0;
  cudaError_t e = smem_limit(&limit);
  if (e != cudaSuccess) return (int)e;
  const size_t smem = joint_smem_bytes(n, b, with_shuffle);
  out[0] = CLUSTER;
  out[1] = (int)smem;
  out[2] = limit;
  out[3] = 0;
  if (smem > (size_t)limit) return 0;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = launch_config(smem, 0, attr);
  int clusters = 0;
  e = cudaOccupancyMaxActiveClusters(&clusters, joint_wave_kernel, &cfg);
  out[3] = clusters;
  return (int)e;
}

extern "C" int joint_wave_launch(const JointArgs* args, void* stream) {
  if (args->p > MAX_P || args->ns > MAX_S || args->ns < 0)
    return (int)cudaErrorInvalidValue;
  int limit = 0;
  cudaError_t e = smem_limit(&limit);
  if (e != cudaSuccess) return (int)e;
  const size_t smem = joint_smem_bytes(args->n, args->b, args->with_shuffle);
  if (smem > (size_t)limit) return (int)cudaErrorInvalidValue;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = launch_config(smem, (cudaStream_t)stream, attr);
  e = cudaLaunchKernelEx(&cfg, joint_wave_kernel, *args);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
