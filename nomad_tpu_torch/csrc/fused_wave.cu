// Fused placement wave for NVIDIA Hopper (sm_90a): a thread-block cluster.
//
// Replaces: nomad_tpu/ops/pallas_kernel.py `fused_wave_place` (:553-603,
// the pl.pallas_call at :600), reached through `_fused_wave_run` (:606),
// `fused_wave_place_jit` (:615) and `make_fused_wave_apply` (:618). It
// computes what nomad_tpu_torch/ops/kernel.place_taskgroups_joint computes
// inside the fused envelope (ports, step penalties, preferred pins,
// distinct_hosts, shuffle, top-k; no spreads, devices, cores or network),
// and packs the result the way ops/kernel.pack_fused_wave does.
//
// What bounds it. Counting each input byte once, the live shape (B=32
// members, N=16384 nodes, T=512 steps) reads about B*N*~19 B of member
// planes plus N*~44 B of shared planes, ~10 MB: ~3 us at 3.35 TB/s. The
// function needs each (member, node) scored once and, per active step, one
// argmax and one top-8 compare per node: ~3e7 f32 operations, under 1 us.
// Neither is the floor that matters. The wave is T sequential steps, and
// step t+1's feasibility depends on step t's choice, so the real floor is
// a chain of T dependent N-wide argmaxes: each link is a reduction over
// the nodes followed by a broadcast of its winner. No design removes the
// chain; a design can only make each link short and keep everything else
// off it.
//
// Starting point: the first design (one block of 1024 threads looping over
// the steps, every node rescored at every step, the top-8 merged in eight
// block-wide rounds) took 16.7-17.0 ms per live wave and 94-129 ms at
// N=131072 on an NVIDIA H100 80GB HBM3 at 700 W, ~33 us per step on one SM.
//
// Design. One launch per wave: a cluster of CLUSTER CTAs of THREADS
// threads, CTA c owning the contiguous node range [c*chunk, (c+1)*chunk).
// - A node's carries (a_cpu/a_mem/a_disk/a_dyn, and the per-member scratch
//   job_tg_count/job_any_count/port_conflict) are read and written only by
//   the CTA that owns the node. They live in global memory (L2); no CTA
//   reads another's, so carries need no cross-CTA ordering.
// - At a member's first step each CTA scores its own nodes for that member
//   with the current carries and the member's static penalty plane, and
//   keeps the masked scores in a row in shared memory (plus the nodes'
//   shuffle ranks). At the member's first appearance the same pass copies
//   its per-member scratch from the inputs and counts its metrics from the
//   pre-wave state, so nothing walks all B x N before the steps. Between
//   two steps of one member only the chosen node's carries change, so the
//   row stays exact: the owner rescores only that node. A step's penalty
//   nodes are scored fresh with the step penalty and swapped into the row
//   for that step only; the preferred pin reads its step value from the
//   row. At most 1 + P + 1 scores per step instead of N.
// - Scores travel as order-preserving u32 keys, so a warp's argmax on
//   (value desc, rank asc) is two redux.sync reductions, and its top-8 on
//   (value desc, index asc) is eight rounds of two, over sorted per-thread
//   lists. A warp rebuilds its top-8 list only when the step changed one of
//   its row entries.
// - A step: the special nodes (the last step's commit, the penalty nodes,
//   the pin), one barrier; every warp's argmax (and stale top-8 lists), one
//   barrier; warp 0 writes the CTA's argmax and warp 1 the CTA's top-8 into
//   this CTA's slot for the step's parity; one cluster.sync(); then every
//   CTA reads the CLUSTER argmax slots through DSMEM and reduces them
//   itself, so no second cluster barrier is needed, and applies the pin
//   rule as the plain version does. CTA 0 merges the CTAs' top-8 lists
//   during the next step's special-node phase. A slot is rewritten two
//   steps later, after a cluster barrier that every reader has passed.
// - The winner's commit is deferred to the next step's special-node pass
//   (or to the member change, or to the end of the wave).
// - Padding and inactive steps skip the scan: found from one ballot per
//   32 steps, their neutral outputs written by CTA 0.
// - Score arithmetic is shared between the row pass and the rescoring and
//   rounds op for op like the torch version on the card (-fmad=false, the
//   fit scaled by the f32 reciprocal of 18), so a cached score and a fresh
//   one are the same bits. It lives in csrc/wave_score.cuh, which the
//   sharded wave (csrc/sharded_wave.cu) shares. The slots, the rank
//   loader, the top-8 lists and the launch, which hold no scoring rule,
//   live in csrc/cluster_wave.cuh, shared with the sharded and joint waves.
//
// Built by nomad_tpu_torch/ops/build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xptxas -v
//        -fmad=false -shared -Xcompiler -fPIC
// (-fmad=false so the score arithmetic rounds op for op like the plain
// torch version on the card; no fast-math). The cluster size is 16, the
// largest an H100 runs (a non-portable size): on an NVIDIA H100 80GB HBM3
// at 700 W a cluster of 8 took 1.20 against 0.99 ms per live wave and 4.10
// against 2.84 ms at N=131072 in an earlier version of this kernel.
//
// Measured on that card: 1.47 ms per live wave (4.6 us per active step),
// 2.8-3.1 ms at N=131072. An earlier version exchanged the argmaxes with
// st.async pushes into every CTA's inbox, counted on mbarriers, with a
// dedicated top-k warp whose lists reached CTA 0 a step later: 0.99 ms per
// live wave, but no change in the main path's round, so the one cluster
// barrier per step was kept for its smaller hazard surface.

#include <cooperative_groups.h>

#include "cluster_wave.cuh"

namespace cg = cooperative_groups;

#define CLUSTER 16
#define THREADS 512
#define NWARPS (THREADS / 32)
#define MAX_P 4                    // MAX_PENALTY_NODES
#define N_SPECIAL (MAX_P + 2)      // pending commit, penalty nodes, pin
#define ROW_UNROLL 2               // nodes a thread loads at once (row pass)
#define ALL_WARPS (FULL_MASK >> (32 - NWARPS))
#define MAX_DEVICES 64

static_assert(NWARPS >= 2 && NWARPS <= 32, "warps 0 and 1 have roles");
static_assert(CLUSTER <= 32, "a warp reduces the CTAs' slots");

struct FusedArgs {
  const void* leaf[N_LEAVES];
  long long stride[N_LEAVES];  // member stride in elements; 0 = shared
  const int* step_member;      // i32 [T]
  const int* step_local;       // i32 [T]
  float* packed;               // f32 [2T + 8B]
  int* topk_idx;               // i32 [T, TOPK]
  float* topk_scores;          // f32 [T, TOPK]
  float* a_cpu;                // f32 [N] (outputs: the wave's carry)
  float* a_mem;
  float* a_disk;
  int* a_dyn;                  // i32 [N] scratch
  int* jtc;                    // i32 [B, N] scratch
  int* jac;                    // i32 [B, N] scratch (with_distinct)
  unsigned char* pc;           // bool [B, N] scratch (with_ports)
  int n, b, t, k, p, bp;
  int with_topk, with_ports, with_distinct, with_step_pen, with_pref,
      with_shuffle;
};

template <typename T>
__device__ __forceinline__ const T* leaf_of(const FusedArgs& a, int leaf,
                                            int m) {
  return reinterpret_cast<const T*>(a.leaf[leaf]) + m * a.stride[leaf];
}

__device__ __forceinline__ Member load_member(const FusedArgs& a, int m) {
  Member v;
  v.ask_cpu = *leaf_of<float>(a, L_ASK_CPU, m);
  v.ask_mem = *leaf_of<float>(a, L_ASK_MEM, m);
  v.ask_disk = *leaf_of<float>(a, L_ASK_DISK, m);
  v.ask_dyn = *leaf_of<int>(a, L_ASK_DYN, m);
  v.desired = *leaf_of<int>(a, L_DESIRED, m);
  v.has_res = *leaf_of<unsigned char>(a, L_ASK_RES, m) != 0;
  v.alg_spread = *leaf_of<unsigned char>(a, L_ALG, m) != 0;
  v.dhj = *leaf_of<unsigned char>(a, L_DHJ, m) != 0;
  v.dht = *leaf_of<unsigned char>(a, L_DHT, m) != 0;
  return v;
}

// Member m's view of node i: its planes, the wave's carries, and the
// member's counts from the inputs (`input_counts`: its first appearance,
// and the metrics) or from the scratch copies. All loads independent.
__device__ __forceinline__ Node load_node(const FusedArgs& a, int m, int i,
                                          bool input_counts) {
  Node d;
  const long long mi = (long long)m * a.n + i;
  d.cap_cpu = __ldg(leaf_of<float>(a, L_CAP_CPU, m) + i);
  d.cap_mem = __ldg(leaf_of<float>(a, L_CAP_MEM, m) + i);
  d.cap_disk = __ldg(leaf_of<float>(a, L_CAP_DISK, m) + i);
  d.used_cpu = __ldg(leaf_of<float>(a, L_USED_CPU, m) + i);
  d.used_mem = __ldg(leaf_of<float>(a, L_USED_MEM, m) + i);
  d.used_disk = __ldg(leaf_of<float>(a, L_USED_DISK, m) + i);
  d.aff = __ldg(leaf_of<float>(a, L_AFF, m) + i);
  d.base = __ldg(leaf_of<unsigned char>(a, L_BASE, m) + i) != 0;
  d.pen = __ldg(leaf_of<unsigned char>(a, L_PENALTY, m) + i) != 0;
  d.a_cpu = a.a_cpu[i];
  d.a_mem = a.a_mem[i];
  d.a_disk = a.a_disk[i];
  d.free_dyn = a.with_ports ? __ldg(leaf_of<int>(a, L_FREE_DYN, m) + i) : 0;
  d.a_dyn = a.with_ports ? a.a_dyn[i] : 0;
  if (input_counts) {
    d.jtc = __ldg(leaf_of<int>(a, L_JTC, m) + i);
    d.jac = a.with_distinct ? __ldg(leaf_of<int>(a, L_JAC, m) + i) : 0;
    d.pc = a.with_ports &&
           __ldg(leaf_of<unsigned char>(a, L_PC, m) + i) != 0;
  } else {
    d.jtc = a.jtc[mi];
    d.jac = a.with_distinct ? a.jac[mi] : 0;
    d.pc = a.with_ports && a.pc[mi] != 0;
  }
  return d;
}

// Commit one placement of member m on node i (the plain version's one-hot
// update at that node), in memory and in `d`.
__device__ __forceinline__ void commit_node(const FusedArgs& a,
                                            const Member& v, int m, int i,
                                            Node& d) {
  const long long mi = (long long)m * a.n + i;
  d.a_cpu = d.a_cpu + v.ask_cpu;
  d.a_mem = d.a_mem + v.ask_mem;
  d.a_disk = d.a_disk + v.ask_disk;
  a.a_cpu[i] = d.a_cpu;
  a.a_mem[i] = d.a_mem;
  a.a_disk[i] = d.a_disk;
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
}

// A step's penalty nodes (-1 where none) and its preferred node (-1: none).
__device__ __forceinline__ void load_step_nodes(const FusedArgs& a, int m,
                                                int j, int* out) {
  const int* sp = leaf_of<int>(a, L_STEP_PEN, m) + (long long)j * a.p;
#pragma unroll
  for (int q = 0; q < MAX_P; ++q)
    out[q] = (a.with_step_pen && q < a.p) ? __ldg(sp + q) : -1;
  out[MAX_P] = a.with_pref ? __ldg(leaf_of<int>(a, L_STEP_PREF, m) + j) : -1;
}

// Shared memory beyond the static part: the member's score-key row and
// shuffle ranks over the CTA's range, the metric partial sums, and a flag
// per member (first appearance seen).
__host__ __device__ inline size_t fused_smem_bytes(int n, int b,
                                                   int with_shuffle) {
  size_t chunk = (size_t)((n + CLUSTER - 1) / CLUSTER);
  return chunk * sizeof(unsigned) * (with_shuffle ? 2 : 1) +
         (size_t)b * 7 * sizeof(int);
}

__global__ void __launch_bounds__(THREADS, 1)
    fused_wave_kernel(const FusedArgs a) {
  extern __shared__ __align__(16) unsigned char dyn_smem[];
  __shared__ Slot slot[2];             // this CTA's argmax, by step parity
  __shared__ TopList top_list[2];      // this CTA's top-8, by step parity
  __shared__ Best sh_best[NWARPS];
  __shared__ unsigned sh_tk[NWARPS][TOPK];  // each warp's top-8 list
  __shared__ int sh_ti[NWARPS][TOPK];
  __shared__ unsigned sh_dirty;  // warps whose row entries the step changed
  __shared__ Member sh_member;
  __shared__ float sh_pin_v;

  cg::cluster_group cluster = cg::this_cluster();
  const int cta = (int)cluster.block_rank();
  const int n = a.n, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int chunk = (n + CLUSTER - 1) / CLUSTER;
  const int lo = min(cta * chunk, n), hi = min(lo + chunk, n);
  const int cnt = hi - lo;
  unsigned* row = reinterpret_cast<unsigned*>(dyn_smem);
  unsigned* rank = row + chunk;
  int* part = reinterpret_cast<int*>(rank + (a.with_shuffle ? chunk : 0));
  int* seen = part + a.b * 6;

  // ---- pre-wave: zero the carries, the partial sums and the flags ----
  for (int i = lo + tid; i < hi; i += THREADS) {
    a.a_cpu[i] = 0.0f;
    a.a_mem[i] = 0.0f;
    a.a_disk[i] = 0.0f;
    if (a.with_ports) a.a_dyn[i] = 0;
  }
  for (int x = tid; x < a.b * 7; x += THREADS) part[x] = 0;  // and seen
  __syncthreads();

  // CTA 0's warp 1: the cluster's top-8 of active step t, from the CTAs'
  // lists of parity pp (written before a cluster barrier already passed)
  auto emit_topk = [&](int pp, int t) {
    unsigned ok[TOPK];
    int oi[TOPK];
    cluster_top<CLUSTER>(cluster, &top_list[pp], a.with_topk, lane, ok, oi);
    write_topk(ok, oi, lane, t, a.with_topk, a.topk_idx, a.topk_scores);
  };
  // the calling warp's sorted top-8 of its nodes (x = warp*32 + lane +
  // k*THREADS) into sh_tk/sh_ti[warp]
  auto warp_list = [&]() {
    warp_row_top<THREADS>(row, lo, cnt, warp, lane, sh_tk[warp], sh_ti[warp]);
  };
  // a row entry changed: its warp's list is stale
  auto mark = [&](int x) {
    atomicOr(&sh_dirty, 1u << ((x % THREADS) / 32));
  };

  // ---- the step loop ----
  int row_m = -1;   // member whose score row is cached
  int rank_m = -1;  // permutation row whose ranks are cached
  int pend = -1;    // warp 0: chosen node of the last active step, not
                    // committed
  int par = 0;      // parity of the active step (slots)
  int n_act = 0;    // active steps so far
  int t_prev = -1;  // step index of the last active step
  int restore_x = -1;  // row entry a special thread puts back next step
  unsigned restore_k = 0;
  int pf_t = -1;       // warp 0: step whose penalty list and pin are loaded
  int pf_s[MAX_P + 1];  // warp 0: that step's penalty nodes, then its pin
  for (int t0 = 0; t0 < a.t; t0 += 32) {
    // which of the next 32 steps place (every warp finds the same mask)
    const int ts = t0 + lane;
    int mem_raw = -1, j_raw = 0;
    bool act = false;
    if (ts < a.t) {
      mem_raw = a.step_member[ts];
      j_raw = a.step_local[ts];
      const int mc = min(max(mem_raw, 0), a.b - 1);
      act = mem_raw >= 0 && j_raw < *leaf_of<int>(a, L_NSTEPS, mc);
    }
    unsigned mask = __ballot_sync(FULL_MASK, act);
    if (cta == 0 && warp == 1 && ts < a.t && !act) {
      // an inactive step scores an all-NEG_INF plane: nothing found, the
      // top-k of the plain version's stable sort
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

      // a new member: commit the last one's pending placement, then score
      // the member's row over this CTA's range (at its first appearance
      // also copying its scratch and counting its metrics)
      if (m != row_m) {
        const bool first = seen[m] == 0;
        if (tid == 0) {
          if (pend >= lo && pend < hi) {
            Node d = load_node(a, row_m, pend, false);
            commit_node(a, sh_member, row_m, pend, d);
          }
          sh_member = load_member(a, m);
        }
        pend = -1;
        restore_x = -1;  // the row is rebuilt
        __syncthreads();
        const Member v = sh_member;
        const long long row0 = (long long)m * n;
        int c[6] = {0, 0, 0, 0, 0, 0};
        for (int x0 = tid; x0 < cnt; x0 += ROW_UNROLL * THREADS) {
          Node d[ROW_UNROLL];
#pragma unroll
          for (int u = 0; u < ROW_UNROLL; ++u) {
            const int x = x0 + u * THREADS;
            if (x < cnt) d[u] = load_node(a, m, lo + x, first);
          }
#pragma unroll
          for (int u = 0; u < ROW_UNROLL; ++u) {
            const int x = x0 + u * THREADS, i = lo + x;
            if (x >= cnt) continue;
            if (first) {
              count_metrics(a, v, d[u], c);
              a.jtc[row0 + i] = d[u].jtc;
              if (a.with_distinct) a.jac[row0 + i] = d[u].jac;
              if (a.with_ports) a.pc[row0 + i] = d[u].pc;
            }
            row[x] = score_key(masked_score(a, v, d[u], d[u].pen));
          }
        }
        if (first) {
#pragma unroll
          for (int q = 0; q < 6; ++q) {
            const int s = __reduce_add_sync(FULL_MASK, c[q]);
            if (lane == 0 && s != 0) atomicAdd(&part[m * 6 + q], s);
          }
        }
        const int pm = a.bp > 1 ? m : 0;
        if (a.with_shuffle && pm != rank_m) {
          // rank of a node = its position in the permutation
          load_ranks<THREADS>(leaf_of<int>(a, L_PERM, pm), n, lo, hi, rank,
                              tid, [](int g) { return g; });
          rank_m = pm;
        }
        row_m = m;
        if (tid == 0) {
          seen[m] = 1;
          sh_dirty = ALL_WARPS;
        }
        __syncthreads();
      }

      // special nodes, one thread each in the owner CTA: put back the last
      // step's penalty values, commit the pending placement and rescore it
      // in the row, swap this step's penalty values into the row, note the
      // pin's step value. Meanwhile CTA 0's warp 1 writes out the top-k of
      // the last active step.
      int pcl = -1;  // the step's pin (clamped), or -1
      if (warp == 0) {
        if (restore_x >= 0) {
          row[restore_x] = restore_k;
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
        if (mask) {  // the next active step of these 32: load ahead
          const int nl = __ffs(mask) - 1;
          pf_t = t0 + nl;
          load_step_nodes(
              a, min(max(__shfl_sync(FULL_MASK, mem_raw, nl), 0), a.b - 1),
              min(max(__shfl_sync(FULL_MASK, j_raw, nl), 0), a.k - 1), pf_s);
        }
        int q = -1;
#pragma unroll
        for (int k = 0; k < N_SPECIAL; ++k)
          if (k == tid) q = s[k];
        bool mine = q >= lo && q < hi;
#pragma unroll
        for (int k = 0; k < N_SPECIAL; ++k)
          if (k < tid && s[k] == q) mine = false;  // handled by lane k
        if (mine) {
          bool is_pen = false;
#pragma unroll
          for (int k = 1; k <= MAX_P; ++k) is_pen = is_pen || s[k] == q;
          const int x = q - lo;
          unsigned key = row[x];
          if (q == pend || is_pen) {
            const Member v = sh_member;
            Node d = load_node(a, m, q, false);
            if (q == pend) {
              commit_node(a, v, m, q, d);
              key = score_key(masked_score(a, v, d, d.pen));
              row[x] = key;
            }
            if (is_pen) {
              restore_x = x;
              restore_k = key;
              key = score_key(masked_score(a, v, d, true));
              row[x] = key;
            }
            mark(x);
          }
          if (q == pcl) sh_pin_v = key_score(key);
        }
      } else if (warp == 1 && cta == 0 && n_act >= 1) {
        emit_topk(par ^ 1, t_prev);
      }
      __syncthreads();

      // every warp: its argmax over its row entries, and its top-8 list
      // when the step made it stale
      {
        unsigned bk = PAD_KEY, br = NO_RANK;
        int bi = NO_NODE;
        for (int x = tid; x < cnt; x += THREADS) {
          const unsigned k = row[x];
          const unsigned r = a.with_shuffle ? rank[x] : (unsigned)(lo + x);
          if (k > bk || (k == bk && r < br)) {
            bk = k; br = r; bi = lo + x;
          }
        }
        warp_best(bk, br, bi);
        if (lane == 0) sh_best[warp] = Best{bk, br, bi};
        if (a.with_topk && ((sh_dirty >> warp) & 1u)) warp_list();
      }
      __syncthreads();

      // this CTA's argmax (warp 0) and top-8 (warp 1) into its slots
      if (warp == 0) {
        Best b = {PAD_KEY, NO_RANK, NO_NODE};
        if (lane < NWARPS) b = sh_best[lane];
        warp_best(b.k, b.r, b.i);
        if (lane == 0)
          slot[par] = Slot{b.k, b.r, b.i,
                           (pcl >= 0 && pcl / chunk == cta) ? sh_pin_v
                                                            : NEG_INF_F};
      } else if (warp == 1) {
        if (a.with_topk) {
          if (sh_dirty) {
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
          } else if (lane < TOPK) {  // the row is as it was a step ago
            top_list[par].k[lane] = top_list[par ^ 1].k[lane];
            top_list[par].i[lane] = top_list[par ^ 1].i[lane];
          }
        }
        __syncwarp();
        if (lane == 0) sh_dirty = 0;
      }
      cluster.sync();  // every CTA's slots of this parity written

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
          // pin rule (ops/kernel.place_taskgroups_joint): a feasible pin
          // wins; its masked step value is > NEG_INF / 2 exactly then
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
    Node d = load_node(a, row_m, pend, false);
    commit_node(a, sh_member, row_m, pend, d);
  }
  for (int m = 0; m < a.b; ++m) {
    if (seen[m]) continue;  // counted at its first row pass
    const Member v = load_member(a, m);
    int c[6] = {0, 0, 0, 0, 0, 0};
    for (int i = lo + tid; i < hi; i += THREADS)
      count_metrics(a, v, load_node(a, m, i, true), c);
#pragma unroll
    for (int q = 0; q < 6; ++q) {
      const int s = __reduce_add_sync(FULL_MASK, c[q]);
      if (lane == 0 && s != 0) atomicAdd(&part[m * 6 + q], s);
    }
  }
  cluster.sync();  // every CTA's partial sums ready
  if (cta == 0) {
    if (warp == 1 && n_act >= 1) emit_topk(par ^ 1, t_prev);
    float* metrics = a.packed + 2 * a.t;
    for (int x = tid; x < a.b * 6; x += THREADS) {
      int s = 0;
      for (int c = 0; c < CLUSTER; ++c)
        s += cluster.map_shared_rank(part, c)[x];
      metrics[(x % 6) * a.b + x / 6] = (float)s;
    }
    for (int m = tid; m < a.b; m += THREADS) {
      metrics[6 * a.b + m] = 0.0f;  // exhausted_devices: outside envelope
      metrics[7 * a.b + m] = 0.0f;  // exhausted_cores: outside envelope
    }
  }
  cluster.sync();  // no CTA leaves while another may read its shared memory
}

// The dynamic shared memory a block may take on the current device, after
// setting the kernel's attributes there (once per device).
static int g_limit[MAX_DEVICES];  // 0: attributes not set yet

static cudaError_t smem_limit(int* limit) {
  void (*const kernels[])(const FusedArgs) = {fused_wave_kernel};
  return cluster_smem_limit(kernels, g_limit, limit);
}

static cudaLaunchConfig_t launch_config(size_t smem, cudaStream_t stream,
                                        cudaLaunchAttribute* attr) {
  return cluster_launch_config<CLUSTER, THREADS>(smem, stream, attr);
}

extern "C" int fused_wave_cluster(void) { return CLUSTER; }

// out[0] cluster size, out[1] dynamic shared memory the wave needs,
// out[2] the most a block may take, out[3] clusters of that shape the card
// can hold at once (0: the launch would be refused).
extern "C" int fused_wave_plan(int n, int b, int with_shuffle, int* out) {
  int limit = 0;
  cudaError_t e = smem_limit(&limit);
  if (e != cudaSuccess) return (int)e;
  const size_t smem = fused_smem_bytes(n, b, with_shuffle);
  out[0] = CLUSTER;
  out[1] = (int)smem;
  out[2] = limit;
  out[3] = 0;
  if (smem > (size_t)limit) return 0;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = launch_config(smem, 0, attr);
  int clusters = 0;
  e = cudaOccupancyMaxActiveClusters(&clusters, fused_wave_kernel, &cfg);
  out[3] = clusters;
  return (int)e;
}

extern "C" int fused_wave_launch(const FusedArgs* args, void* stream) {
  if (args->p > MAX_P) return (int)cudaErrorInvalidValue;
  int limit = 0;
  cudaError_t e = smem_limit(&limit);
  if (e != cudaSuccess) return (int)e;
  const size_t smem = fused_smem_bytes(args->n, args->b, args->with_shuffle);
  if (smem > (size_t)limit) return (int)cudaErrorInvalidValue;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = launch_config(smem, (cudaStream_t)stream, attr);
  e = cudaLaunchKernelEx(&cfg, fused_wave_kernel, *args);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
