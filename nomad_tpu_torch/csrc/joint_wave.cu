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
// beside the ~7.5 KiB static part. A wave whose ranges do not fit (a node
// axis padded to 524288 and more: B1 does not hold it either) takes the
// second instantiation, kGlobal: the same step with its CTAs' rows in a
// per-launch global scratch of the same 13 B a node (6.8 MB at N=524288,
// which stays in the 50 MB L2), chosen by the wrapper before the launch
// (ops/cuda_kernel.joint_rows_global). Every wave that fits keeps the
// shared-memory instantiation.
//
// The node arithmetic (feasibility, the partial sums, the commit, the
// metrics, the boost table) lives in csrc/joint_node.cuh, shared with the
// joint sharded kernel (csrc/joint_sharded_wave.cu).
//
// Built by nomad_tpu_torch/ops/build.py with B1's flags (-fmad=false, no
// fast-math), so every score rounds op for op as the torch version does on
// the card. The keys and the warp reductions are B1's (csrc/wave_score.cuh).

#include <cooperative_groups.h>

#include "joint_node.cuh"

namespace cg = cooperative_groups;

#define CLUSTER 16
#define THREADS 512
#define NWARPS (THREADS / 32)
#define MAX_DEVICES 64
#define ALL_WARPS (FULL_MASK >> (32 - NWARPS))

static_assert(NWARPS >= MAX_S, "one warp a stanza builds the boost table");

// Shared memory beyond the static part, in words of the CTA's range
// (rounded to four): row keys, shuffle ranks, partial sums, then the
// counts (bytes), the metric partial sums and a flag per member.
__host__ __device__ inline size_t joint_chunk4(int n) {
  const size_t chunk = (size_t)((n + CLUSTER - 1) / CLUSTER);
  return (chunk + 3) & ~(size_t)3;
}

__host__ __device__ inline size_t joint_smem_bytes(int n, int b,
                                                   int with_shuffle) {
  return joint_row_bytes(joint_chunk4(n), with_shuffle) +
         (size_t)b * (N_MET + 1) * sizeof(int);
}

// The global-row instantiation: its CTAs keep their ranges' rows in
// `rows`, a scratch of joint_global_bytes, and only the metric partial
// sums and the flags in shared memory.
__host__ __device__ inline size_t joint_global_smem(int b) {
  return (size_t)b * (N_MET + 1) * sizeof(int);
}

__host__ __device__ inline size_t joint_cta_rows(int n, int with_shuffle) {
  return (joint_row_bytes(joint_chunk4(n), with_shuffle) + 15) &
         ~(size_t)15;
}

__host__ inline size_t joint_global_bytes(int n, int with_shuffle) {
  return CLUSTER * joint_cta_rows(n, with_shuffle);
}

// kGlobal: the CTAs' rows live in the global scratch `a.rows` (a wave
// whose ranges do not fit shared memory); else in shared memory.
template <bool kGlobal>
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
  unsigned char* rbase =
      kGlobal ? a.rows + (size_t)cta * joint_cta_rows(n, a.with_shuffle)
              : dyn_smem;
  unsigned* row = reinterpret_cast<unsigned*>(rbase);
  unsigned* rank = row + c4;
  float* rsum = reinterpret_cast<float*>(rank + (a.with_shuffle ? c4 : 0));
  unsigned char* rcnt = reinterpret_cast<unsigned char*>(rsum + c4);
  int* part = kGlobal ? reinterpret_cast<int*>(dyn_smem)
                      : reinterpret_cast<int*>(rcnt + c4);
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
        if (warp < a.ns && sh_member.sp_active[warp])
          build_boost(sh_member, warp, lane, counts, desired, boost);
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
  void (*const kernels[])(const JointArgs) = {joint_wave_kernel<false>,
                                              joint_wave_kernel<true>};
  return cluster_smem_limit(kernels, g_limit, limit);
}

static cudaLaunchConfig_t launch_config(size_t smem, cudaStream_t stream,
                                        cudaLaunchAttribute* attr) {
  return cluster_launch_config<CLUSTER, THREADS>(smem, stream, attr);
}

extern "C" int joint_wave_cluster(void) { return CLUSTER; }

// out[0] cluster size, out[1] dynamic shared memory the wave needs with its
// rows in shared memory, out[2] the most a block may take, out[3] clusters
// of the instantiation the wave takes that the card can hold at once (0:
// the launch would be refused), out[4] the global-row scratch it needs (0:
// its rows fit shared memory).
extern "C" int joint_wave_plan(int n, int b, int with_shuffle, int* out) {
  int limit = 0;
  cudaError_t e = smem_limit(&limit);
  if (e != cudaSuccess) return (int)e;
  const size_t smem = joint_smem_bytes(n, b, with_shuffle);
  const bool global = smem > (size_t)limit;
  const size_t take = global ? joint_global_smem(b) : smem;
  out[0] = CLUSTER;
  out[1] = (int)smem;
  out[2] = limit;
  out[3] = 0;
  out[4] = global ? (int)joint_global_bytes(n, with_shuffle) : 0;
  if (take > (size_t)limit) return 0;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = launch_config(take, 0, attr);
  int clusters = 0;
  void (*kernel)(const JointArgs) =
      global ? joint_wave_kernel<true> : joint_wave_kernel<false>;
  e = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
  out[3] = clusters;
  return (int)e;
}

// With args->rows set, the global-row instantiation (the caller's scratch
// holds joint_global_bytes); else the shared-memory one, which the wave
// must fit.
extern "C" int joint_wave_launch(const JointArgs* args, void* stream) {
  if (args->p > MAX_P || args->ns > MAX_S || args->ns < 0)
    return (int)cudaErrorInvalidValue;
  int limit = 0;
  cudaError_t e = smem_limit(&limit);
  if (e != cudaSuccess) return (int)e;
  const bool global = args->rows != nullptr;
  const size_t smem =
      global ? joint_global_smem(args->b)
             : joint_smem_bytes(args->n, args->b, args->with_shuffle);
  if (smem > (size_t)limit) return (int)cudaErrorInvalidValue;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = launch_config(smem, (cudaStream_t)stream, attr);
  void (*kernel)(const JointArgs) =
      global ? joint_wave_kernel<true> : joint_wave_kernel<false>;
  e = cudaLaunchKernelEx(&cfg, kernel, *args);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
