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
// ops/kernel.pack_fused_wave packs it, then one error word. With `single`
// set it runs one eval as ops/kernel.place_taskgroup does: the f32 carries
// hold the used planes with each placement added in turn (used + a1 + a2),
// where a wave's hold the placements' sum apart (used + (a1 + a2)), as the
// two reference programs round.
//
// Why a kernel of its own beside csrc/fused_wave.cu (B1) rather than a
// template of it: a spread stanza breaks B1's cached row. A step bumps one
// bucket's count, which can change the even-spread boost of every bucket
// (it reads the min and max count over all SPREAD_BUCKETS) and so every
// node's score; B1's step assumes that only the chosen node's score moves.
// Every phase of B1's step would branch on it, and B1's lean code is left
// as it was, bit for bit. What holds no scoring rule (the slots' top-8
// lists, the rank loader, the launch) is B1's, from csrc/cluster_wave.cuh.
//
// What bounds it. As for B1, the wave is a chain of T dependent N-wide
// argmaxes (fused_wave.cu's header). A spread member adds to each link one
// pass over the CTA's nodes (a table lookup and an add a stanza, a divide a
// node) and a rebuild of every warp's top-8 list; the bytes (B1's planes
// plus the device [N, 4], core, bandwidth and bucket planes, each read
// once) stay ~3-460 us at 3.35 TB/s. So a step's time is its slowest CTA's
// pass over its rows plus the barriers: the design spreads the rows.
//
// Design: B1's step on `clusters` clusters of CLUSTER CTAs, one launch a
// wave. CTA g of the grid (cluster g / CLUSTER, rank g % CLUSTER) owns the
// node range [g*chunk, (g+1)*chunk) of the flat axis, chunk = ceil(N /
// (clusters * CLUSTER)); see fused_wave.cu for the step's phases, the
// slots, the deferred commit and the top-k merge. What differs:
// - Each node keeps in shared memory, beside its row key and rank, the
//   parts of its score before the spread term (their sum, and their count;
//   0: infeasible) and one signed byte a spread stanza, its bucket (-1:
//   none), loaded with the member's rows. A commit changes only the chosen
//   node's carries (cpu/mem/disk, dynamic ports, cores a_cores, bandwidth
//   a_mbits, devices a_dev[N, 4]), so the owner CTA recomputes only that
//   node's parts, as B1 rescores one node.
// - Per CTA, the current member's spread counts [S, 128] and desired
//   counts live in shared memory, and every CTA applies each winner's bump
//   itself: the winner's buckets come beside its slot (and, between
//   clusters, with its cluster's mailbox entry), so a step reads no L2 for
//   them. A member's counts go to this CTA's own scratch when another
//   member's step comes, and come back at its next step.
// - A step of a member with an active stanza: while warp 0 commits the
//   last choice and rescores the special nodes, one warp a stanza bumps
//   the counts with the buckets warp 0 hands it (a named barrier) and
//   builds the [S, 128] boost table; after the step's first barrier every
//   thread re-derives its nodes' row keys as (sum + spread) / (count + on)
//   from shared memory alone in its argmax loop, and every warp rebuilds
//   its top-8 list. Adding the spread term last to the cached partial sum
//   is the plain version's own order of f32 operations (fit, device
//   affinity, anti-affinity, penalty, node affinity, spread, then the
//   divide), and the projection of the one-hot product has one nonzero
//   term, so the keys are the plain version's bits. A member without an
//   active stanza keeps B1's cached row.
// - Between clusters, one exchange a step: after the cluster's barrier
//   every CTA merges its cluster's slots through DSMEM; the cluster's rank
//   0 CTA then publishes one entry (its argmax, the pin's value where it
//   holds the pin, its top-8, the argmax's and the pin's buckets), tagged
//   with the step and stored with release semantics at gpu scope, in the
//   wave's mailbox, and every CTA acquire-loads the clusters' entries and
//   merges them with the same cascade (largest value, lowest rank, lowest
//   index) and pin rule. Two entries a cluster by step parity, as the
//   sharded kernels' mailboxes (csrc/card_exchange.cuh): a cluster writes
//   step t+2's entry only after every cluster has read step t's. The
//   partial metric sums and each cluster's error flag reach cluster 0
//   through the same mailbox at the tail.
// - Every cluster must be resident at once: the launch is cooperative
//   beside its cluster dimension (CUDA refuses a grid the card cannot
//   hold), `clusters` never exceeds what cudaOccupancyMaxActiveClusters
//   reports, and every wait on another cluster gives up after `spin_ns`,
//   after which the cluster waits no more and the error word (the mask of
//   clusters whose CTAs gave up) makes the wrapper's caller raise.
// - The pin's step value is read from the row after the argmax loop, where
//   it holds the step's spread term too.
//
// Shared memory: 13 B a node of the CTA's range with shuffle (row key,
// rank, partial sum, count), one byte more a spread stanza, and 36 B a
// member. The host's plan (ops/cuda_kernel.joint_clusters) runs one
// cluster while its ranges are cheap to walk, else every cluster the card
// holds, so the ranges stay in shared memory; a wave whose ranges do not
// fit even then takes the second instantiation, kGlobal: the same step
// with its CTAs' rows in a per-launch global scratch of the same layout.
//
// The node arithmetic (feasibility, the partial sums, the commit, the
// metrics, the boost table) lives in csrc/joint_node.cuh, shared with the
// joint sharded kernel (csrc/joint_sharded_wave.cu).
//
// Built by nomad_tpu_torch/ops/build.py with B1's flags (-fmad=false, no
// fast-math), so every score rounds op for op as the torch version does on
// the card. The keys and the warp reductions are B1's (csrc/wave_score.cuh).

#include <cooperative_groups.h>

#include "card_exchange.cuh"
#include "joint_node.cuh"

namespace cg = cooperative_groups;

#define CLUSTER 16
#define THREADS 512
#define NWARPS (THREADS / 32)
#define MAX_DEVICES 64
#define MAX_CLUSTERS 8              // clusters of one wave (a warp polls them)
#define ALL_WARPS (FULL_MASK >> (32 - NWARPS))
#define NO_BUCKETS (-1)             // node_buckets' packing of "none"

#define BOOST_WARP 2                // warps 2.. build the boost table
#define BOOST_BAR 2                 // their named barrier with warp 0

static_assert(NWARPS >= BOOST_WARP + MAX_S,
              "one warp a stanza builds the boost table");
static_assert(CLUSTER <= 32 && MAX_CLUSTERS <= 32,
              "a warp's lanes read the slots and the entries");

// One cluster's result for one step, in the wave's mailbox.
struct __align__(16) CEntry {
  unsigned k, r;
  int i;
  float pin_v;      // the pin's masked value where the cluster holds it
  unsigned tk[TOPK];
  int ti[TOPK];
  int bk;           // its argmax's buckets, or NO_BUCKETS
  int pk;           // the pin's buckets where it holds the pin, else none
  unsigned tag;     // step index + 1, stored last
  int pad;
};
static_assert(sizeof(CEntry) == 96, "mirrored by cuda_kernel._joint_mail");

// The wave's mailbox (clusters > 1): CEntry [2][clusters] (by step parity,
// then cluster), then u32 mtag [clusters], i32 merr [clusters] and i32
// msum [clusters][N_MET B]. Mirrored by cuda_kernel._joint_mail.
__host__ __device__ inline size_t joint_mail_bytes(int clusters, int b) {
  return (size_t)2 * clusters * sizeof(CEntry) +
         (size_t)clusters * (2 + N_MET * b) * sizeof(int);
}

// What one launch is given, by value. Mirrored by
// cuda_kernel._JointLaunch.
struct JLaunch {
  JointArgs a;
  unsigned char* mail;  // the mailbox (clusters > 1), zeroed by the launch
  long long spin_ns;    // the longest wait on another cluster's entry
  int clusters;         // clusters of CLUSTER CTAs over the node axis
  int absent;           // a cluster that publishes nothing, so the others'
                        // bounded waits run out (the card tests'); -1 none
};

// A CTA's node range (rounded to four) and its rows' bytes: row keys,
// shuffle ranks, partial sums, counts, then a bucket byte a stanza.
__host__ __device__ inline int joint_chunk(int n, int clusters) {
  const int ctas = clusters * CLUSTER;
  return (n + ctas - 1) / ctas;
}

__host__ __device__ inline size_t joint_cta_rows(int n, int clusters,
                                                 int with_shuffle, int ns) {
  const size_t c4 = ((size_t)joint_chunk(n, clusters) + 3) & ~(size_t)3;
  return joint_row_bytes(c4, with_shuffle) + c4 * ns;
}

// The metric partial sums and a flag per member.
__host__ __device__ inline size_t joint_member_bytes(int b) {
  return (size_t)b * (N_MET + 1) * sizeof(int);
}

// Shared memory of a CTA with its rows in it.
__host__ __device__ inline size_t joint_smem_bytes(int n, int b,
                                                   int with_shuffle, int ns,
                                                   int clusters) {
  return joint_cta_rows(n, clusters, with_shuffle, ns) +
         joint_member_bytes(b);
}

// The global-row instantiation: its CTAs keep their ranges' rows in
// `rows`, a scratch of joint_global_bytes, 16-byte aligned a CTA.
__host__ __device__ inline size_t joint_cta_stride(int n, int clusters,
                                                   int with_shuffle, int ns) {
  return (joint_cta_rows(n, clusters, with_shuffle, ns) + 15) & ~(size_t)15;
}

__host__ inline size_t joint_global_bytes(int n, int clusters,
                                          int with_shuffle, int ns) {
  return (size_t)clusters * CLUSTER *
         joint_cta_stride(n, clusters, with_shuffle, ns);
}

// kGlobal: the CTAs' rows live in the global scratch `a.rows` (a wave
// whose ranges do not fit shared memory); else in shared memory. kMulti:
// the wave spans several clusters (the mailbox exchange is compiled in);
// one cluster's kernel has none of it.
template <bool kGlobal, bool kMulti>
__global__ void __launch_bounds__(THREADS, 1)
    joint_wave_kernel(const JLaunch w) {
  extern __shared__ __align__(16) unsigned char dyn_smem[];
  __shared__ Slot slot[2];              // this CTA's argmax, by step parity
  __shared__ int2 slot_bk[2];  // a spread member's: the buckets of that
                               // argmax and of the pin where held, or none
  __shared__ TopList top_list[2];       // this CTA's top-8, by step parity
  __shared__ TopList clu_top;           // rank 0: the cluster's top-8
  __shared__ Best sh_best[NWARPS];
  __shared__ unsigned sh_tk[NWARPS][TOPK];  // each warp's top-8 list
  __shared__ int sh_ti[NWARPS][TOPK];
  __shared__ unsigned sh_dirty;  // warps whose row entries the step changed
  __shared__ JMember sh_member;
  __shared__ float counts[MAX_S][SB];   // the current member's counts
  __shared__ float desired[MAX_S][SB];  // and its desired counts
  __shared__ float boost[MAX_S][SB];    // this step's boost per bucket
  __shared__ int sh_pbk;                // the buckets the step bumps
  __shared__ int sh_err;                // this CTA waited past the bound
  __shared__ int sh_mask;               // CTA 0: the clusters at fault

  const JointArgs& a = w.a;
  cg::cluster_group cluster = cg::this_cluster();
  const int cta = (int)cluster.block_rank();
  constexpr bool multi = kMulti;
  const int nclu = multi ? w.clusters : 1;
  const int clu = multi ? (int)blockIdx.x / CLUSTER : 0;
  const int g = clu * CLUSTER + cta;  // this CTA in the grid
  const bool head = g == 0;           // writes the outputs
  const int n = a.n, ns = a.ns, tid = threadIdx.x, lane = tid & 31,
            warp = tid >> 5;
  const int chunk = joint_chunk(n, nclu);
  const int c4 = (chunk + 3) & ~3;
  const int lo = min(g * chunk, n), hi = min(lo + chunk, n);
  const int cnt = hi - lo;
  unsigned char* rbase =
      kGlobal ? a.rows + (size_t)g * joint_cta_stride(n, nclu,
                                                      a.with_shuffle, ns)
              : dyn_smem;
  unsigned* row = reinterpret_cast<unsigned*>(rbase);
  unsigned* rank = row + c4;
  float* rsum = reinterpret_cast<float*>(rank + (a.with_shuffle ? c4 : 0));
  unsigned char* rcnt = reinterpret_cast<unsigned char*>(rsum + c4);
  signed char* rbkt = reinterpret_cast<signed char*>(rcnt + c4);  // [ns][c4]
  int* part = kGlobal ? reinterpret_cast<int*>(dyn_smem)
                      : reinterpret_cast<int*>(rbkt + (size_t)ns * c4);
  int* seen = part + a.b * N_MET;
  float* my_spc = a.spc + (long long)g * a.b * MAX_S * SB;
  CEntry* mail = reinterpret_cast<CEntry*>(w.mail);
  unsigned* mtag = reinterpret_cast<unsigned*>(mail + 2 * nclu);
  int* merr = reinterpret_cast<int*>(mtag + nclu);
  int* msum = merr + nclu;

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
  if (tid == 0) sh_err = 0;
  __syncthreads();

  // the head's warp 1: the wave's top-8 of active step t, from the CTAs'
  // lists (one cluster) or the clusters' entries (several) of parity pp,
  // written before a barrier already passed
  auto emit_topk = [&](int pp, int t) {
    unsigned ok[TOPK];
    int oi[TOPK];
    if (!multi) {
      cluster_top<CLUSTER>(cluster, &top_list[pp], a.with_topk, lane, ok,
                           oi);
    } else {
      unsigned lk[TOPK];
      int li[TOPK];
      list_clear(lk, li);
      list_clear(ok, oi);
      if (a.with_topk && lane < nclu) {
        // this warp acquires the tags itself: warp 0 may still be waiting
        // for them (nothing orders the two warps between the steps)
        const CEntry* e = mail + pp * nclu + lane;
        if (!*reinterpret_cast<volatile int*>(&sh_err) &&
            !wait_tag_gpu(&e->tag, (unsigned)t + 1u, w.spin_ns))
          sh_err = 1;
#pragma unroll
        for (int q = 0; q < TOPK; ++q) {
          lk[q] = __ldcg(&e->tk[q]);
          li[q] = __ldcg(&e->ti[q]);
        }
      }
      if (a.with_topk) warp_top(lk, li, ok, oi);
    }
    write_topk(ok, oi, lane, t, a.with_topk, a.topk_idx, a.topk_scores);
  };
  auto warp_list = [&]() {
    warp_row_top<THREADS>(row, lo, cnt, warp, lane, sh_tk[warp], sh_ti[warp]);
  };
  auto mark = [&](int x) {
    atomicOr(&sh_dirty, 1u << ((x % THREADS) / 32));
  };
  // the current member's buckets at row entry x (node_buckets' packing)
  auto row_buckets = [&](int x) -> int {
    unsigned out = 0xffffffffu;
#pragma unroll
    for (int s = 0; s < MAX_S; ++s)
      if (sh_member.sp_active[s])
        out = (out & ~(0xffu << (8 * s))) |
              ((unsigned)(unsigned char)rbkt[s * c4 + x] << (8 * s));
    return (int)out;
  };

  // ---- the step loop ----
  int row_m = -1;      // member whose row (and counts) are cached
  int rank_m = -1;     // permutation row whose ranks are cached
  int mspread = 0;     // row_m has an active stanza: rows re-derived a step
  int pend = -1;       // warp 0: chosen node of the last active step
  int pbk = NO_BUCKETS;  // warp 0: its buckets, not bumped yet
  int par = 0;
  int n_act = 0;
  int t_prev = -1;
  int restore_x = -1;  // row entry a special thread puts back next step
  unsigned restore_k = 0, restore_c = 0;
  float restore_s = 0.0f;
  int pf_t = -1;
  int pf_s[MAX_P + 1];
  bool dead = false;   // warp 0: a wait ran past the bound; wait no more
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
    if (head && warp == 1 && ts < a.t && !act) {
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
      // in the owner CTA, its spread bump in every CTA from the buckets
      // the step handed on), swap the members' counts, then rebuild the
      // row, the partial sums and the buckets over this CTA's range (at
      // its first appearance also copying its scratch and counting its
      // metrics)
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
                if (old.sp_active[s]) bump_packed(pbk, s, counts);
          }
          sh_member = load_member(a, m);
        }
        pend = -1;
        pbk = NO_BUCKETS;
        restore_x = -1;
        __syncthreads();
        if (ns > 0) {
          const float* in_c = leaf_of<float>(a, J_SP_COUNTS, m);
          const float* in_d = leaf_of<float>(a, J_SP_DESIRED, m);
          for (int x = tid; x < ns * SB; x += THREADS) {  // the ns rows
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
          if (v.spread)
            for (int q = 0; q < ns; ++q)  // the shared copy: no local array
              rbkt[q * c4 + x] = (signed char)(
                  sh_member.sp_active[q] ? node_bucket(a, m, i, q) : -1);
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
                              tid, [](int gi) { return gi; });
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
      // the partial sums kept beside the row. A spread member's step
      // first hands the buckets of the last step's choice to the boost
      // warps, which bump the counts and build the step's boost table
      // beside the special nodes' work: one warp a stanza
      // (ops/kernel._spread_score on the bucket axis)
      int pcl = -1;  // the step's pin (clamped), or -1
      if (mspread && warp == 0) {
        if (lane == 0) sh_pbk = pbk;
        asm volatile("bar.arrive %0, %1;" ::"n"(BOOST_BAR),
                     "r"(32 * (1 + ns)) : "memory");
      } else if (mspread && warp >= BOOST_WARP && warp < BOOST_WARP + ns) {
        asm volatile("bar.sync %0, %1;" ::"n"(BOOST_BAR), "r"(32 * (1 + ns))
                     : "memory");
        const int st = warp - BOOST_WARP;
        if (sh_member.sp_active[st]) {
          if (lane == 0) bump_packed(sh_pbk, st, counts);
          __syncwarp();
          build_boost(sh_member, st, lane, counts, desired, boost);
        }
      }
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
      } else if (warp == 1 && head && n_act >= 1) {
        emit_topk(par ^ 1, t_prev);
      }
      __syncthreads();

      // every warp: its argmax over its row entries (re-deriving them for
      // a spread member from the shared buckets), and its top-8 list when
      // the step made it stale
      const bool all_dirty = mspread;
      {
        unsigned bk = PAD_KEY, br = NO_RANK;
        int bi = NO_NODE;
        for (int x = tid; x < cnt; x += THREADS) {
          unsigned k;
          if (mspread) {
            float sp = 0.0f;
            for (int s = 0; s < ns; ++s) {
              if (!sh_member.sp_active[s]) continue;
              const int b = rbkt[s * c4 + x];
              sp = sp + (b < 0 ? -1.0f : boost[s][b]);
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
      // row and, for a spread member, the buckets of both) and top-8 (warp
      // 1) into its slots
      if (warp == 0) {
        Best b = {PAD_KEY, NO_RANK, NO_NODE};
        if (lane < NWARPS) b = sh_best[lane];
        warp_best(b.k, b.r, b.i);
        if (lane == 0) {
          const bool pin_here = pcl >= lo && pcl < hi;
          slot[par] = Slot{b.k, b.r, b.i,
                           pin_here ? key_score(row[pcl - lo]) : NEG_INF_F};
          if (mspread)
            slot_bk[par] = make_int2(
                b.i != NO_NODE ? row_buckets(b.i - lo) : NO_BUCKETS,
                pin_here ? row_buckets(pcl - lo) : NO_BUCKETS);
        }
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

      // several clusters: rank 0's warp 1 merges its cluster's top-8 for
      // the entry
      if (multi && cta == 0 && warp == 1) {
        unsigned ok[TOPK];
        int oi[TOPK];
        cluster_top<CLUSTER>(cluster, &top_list[par], a.with_topk, lane, ok,
                             oi);
#pragma unroll
        for (int q = 0; q < TOPK; ++q)
          if (q == lane) {
            clu_top.k[q] = ok[q];
            clu_top.i[q] = oi[q];
          }
        asm volatile("bar.sync 1, 64;" ::: "memory");  // with warp 0
      }
      // warp 0 of every CTA: the cluster's argmax from its CTAs' slots,
      // then (several clusters) the wave's from the clusters' entries,
      // and the chosen node's buckets
      if (warp == 0) {
        Best b = {PAD_KEY, NO_RANK, NO_NODE};
        float pin_v = NEG_INF_F;
        int2 sb = make_int2(NO_BUCKETS, NO_BUCKETS);
        if (lane < CLUSTER) {
          const Slot sl = *cluster.map_shared_rank(&slot[par], lane);
          if (mspread) sb = *cluster.map_shared_rank(&slot_bk[par], lane);
          b = Best{sl.k, sl.r, sl.i};
          pin_v = sl.pin_v;
        }
        Best mine = b;
        warp_best(b.k, b.r, b.i);
        // a spread member: the winning CTA's buckets (ranks are distinct)
        // and the pin's from the CTA that holds it (every other hands on
        // NO_BUCKETS, all bits set)
        int bkw = NO_BUCKETS, pkw = NO_BUCKETS;
        if (mspread) {
          const unsigned hit = __ballot_sync(
              FULL_MASK, lane < CLUSTER && mine.k == b.k && mine.r == b.r);
          bkw = __shfl_sync(FULL_MASK, sb.x, hit ? __ffs(hit) - 1 : 0);
          pkw = (int)__reduce_and_sync(FULL_MASK, (unsigned)sb.y);
        }
        // the pin's value, NEG_INF where another cluster holds it
        float pv = NEG_INF_F;
        if (pcl >= 0) {
          const int pg = pcl / chunk;  // the pin's CTA
          pv = __shfl_sync(FULL_MASK, pin_v, pg % CLUSTER);
          if (pg / CLUSTER != clu) pv = NEG_INF_F;
        }
        if (multi) {
          if (cta == 0) {
            asm volatile("bar.sync 1, 64;" ::: "memory");  // clu_top ready
            // a cluster that has given up publishes nothing more
            if (lane == 0 && !dead && clu != w.absent) {
              CEntry* e = mail + par * nclu + clu;
              e->k = b.k;
              e->r = b.r;
              e->i = b.i;
              e->pin_v = pv;
#pragma unroll
              for (int q = 0; q < TOPK; ++q) {
                e->tk[q] = clu_top.k[q];
                e->ti[q] = clu_top.i[q];
              }
              e->bk = bkw;
              e->pk = pkw;
              st_release_gpu(&e->tag, (unsigned)t + 1u);
            }
          }
          bool ok = true;
          float gpv = NEG_INF_F;
          int gbk = NO_BUCKETS, gpk = NO_BUCKETS;
          b = Best{PAD_KEY, NO_RANK, NO_NODE};
          if (lane < nclu) {
            const CEntry* e = mail + par * nclu + lane;
            if (!dead) ok = wait_tag_gpu(&e->tag, (unsigned)t + 1u, w.spin_ns);
            b = Best{__ldcg(&e->k), __ldcg(&e->r), __ldcg(&e->i)};
            gpv = __ldcg(&e->pin_v);
            gbk = __ldcg(&e->bk);
            gpk = __ldcg(&e->pk);
          }
          if (__any_sync(FULL_MASK, !ok)) {
            dead = true;
            if (lane == 0) sh_err = 1;
          }
          // the same cascade over the clusters' entries
          mine = b;
          warp_best(b.k, b.r, b.i);
          const unsigned hit = __ballot_sync(
              FULL_MASK, lane < nclu && mine.k == b.k && mine.r == b.r);
          bkw = __shfl_sync(FULL_MASK, gbk, hit ? __ffs(hit) - 1 : 0);
          pkw = (int)__reduce_and_sync(FULL_MASK, (unsigned)gpk);
#pragma unroll
          for (int off = 16; off > 0; off >>= 1)
            gpv = fmaxf(gpv, __shfl_xor_sync(FULL_MASK, gpv, off));
          pv = gpv;
        }
        int idx = b.i;
        float val = key_score(b.k);
        // the pin rule: a feasible pin wins; its masked step value is
        // > NEG_INF / 2 exactly then
        const bool pinned = pcl >= 0 && pv > NEG_INF_F / 2.0f;
        if (pinned) {
          idx = pcl;
          val = pv;
        }
        const bool found = val > NEG_INF_F / 2.0f;
        if (head && lane == 0) {
          a.packed[t] = found ? (float)idx : -1.0f;
          a.packed[a.t + t] = found ? val : 0.0f;
        }
        pend = found ? idx : -1;
        pbk = found ? (pinned ? pkw : bkw) : NO_BUCKETS;
      }
      par ^= 1;
      ++n_act;
      t_prev = t;
    }
  }

  // ---- tail: the last placement, the metrics, the last top-k, the
  // error word ----
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
  cluster.sync();  // every CTA's partial sums ready
  if (cta == 0) {
    if (head && warp == 1 && n_act >= 1) emit_topk(par ^ 1, t_prev);
    __syncthreads();  // every error flag of this CTA set
    const int nbm = a.b * N_MET;
    // this cluster's error flag: any of its CTAs waited past the bound
    int clu_err = 0;
    if (warp == 0)
      clu_err = __ballot_sync(FULL_MASK,
                              lane < CLUSTER &&
                                  *cluster.map_shared_rank(&sh_err, lane)) !=
                0;
    if (clu != 0) {
      // the cluster's partial sums and flag into cluster 0's slots
      for (int x = tid; x < nbm; x += THREADS) {
        int s = 0;
        for (int c = 0; c < CLUSTER; ++c)
          s += cluster.map_shared_rank(part, c)[x];
        msum[clu * nbm + x] = s;
      }
      if (tid == 0) merr[clu] = clu_err;
      __threadfence();
      __syncthreads();
      if (tid == 0 && clu != w.absent) st_release_gpu(&mtag[clu], 1u);
    } else {
      if (warp == 0) {
        // several clusters: every other cluster's sums, for at most the
        // bound
        bool bad = false;
        if (lane >= 1 && lane < nclu) {
          const bool late = dead || !wait_tag_gpu(&mtag[lane], 1u, w.spin_ns);
          bad = late || __ldcg(&merr[lane]) != 0;
        }
        const unsigned bad_mask = __ballot_sync(FULL_MASK, bad);
        if (lane == 0) sh_mask = (int)(bad_mask | (clu_err ? 1u : 0u));
      }
      __syncthreads();
      float* metrics = a.packed + 2 * a.t;
      for (int x = tid; x < nbm; x += THREADS) {
        int s = 0;
        for (int c = 0; c < CLUSTER; ++c)
          s += cluster.map_shared_rank(part, c)[x];
        for (int c = 1; c < nclu; ++c) s += __ldcg(&msum[c * nbm + x]);
        metrics[(x % N_MET) * a.b + x / N_MET] = (float)s;
      }
      if (tid == 0) a.packed[2 * a.t + nbm] = (float)sh_mask;
    }
  }
  cluster.sync();  // no CTA leaves while another may read its shared memory
}

// ---- the host side ----

// The dynamic shared memory a block may take on the current device, after
// setting the kernels' attributes there, and the clusters of either
// instantiation the card holds at once at that shared memory (once per
// device).
static int g_limit[MAX_DEVICES];     // 0: attributes not set yet
static int g_clusters[MAX_DEVICES];  // -1 + 1: not read yet

static cudaLaunchConfig_t launch_config(size_t smem, int clusters,
                                        cudaStream_t stream,
                                        cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg =
      cluster_launch_config<CLUSTER, THREADS>(smem, stream, attr);
  cfg.gridDim = dim3(clusters * CLUSTER, 1, 1);
  return cfg;
}

static void (*const kernels[])(const JLaunch) = {
    joint_wave_kernel<false, false>, joint_wave_kernel<true, false>,
    joint_wave_kernel<false, true>, joint_wave_kernel<true, true>};

static cudaError_t card_figures(int* limit, int* clusters) {
  CK(cluster_smem_limit(kernels, g_limit, limit));
  int dev = 0;
  CK(cudaGetDevice(&dev));
  if (dev < MAX_DEVICES && g_clusters[dev] > 0) {
    *clusters = g_clusters[dev] - 1;
    return cudaSuccess;
  }
  int most = MAX_CLUSTERS;
  for (auto kernel : kernels) {
    cudaLaunchAttribute attr[1];
    cudaLaunchConfig_t cfg = launch_config(*limit, 1, 0, attr);
    int c = 0;
    CK(cudaOccupancyMaxActiveClusters(&c, kernel, &cfg));
    most = c < most ? c : most;
  }
  *clusters = most;
  if (dev < MAX_DEVICES) g_clusters[dev] = most + 1;
  return cudaSuccess;
}

// The layouts the wrapper mirrors (ops/cuda_kernel.joint_layout): out[0]
// the shared memory a CTA takes with its rows in it, out[1] the global-row
// scratch, out[2] the mailbox, out[3] sizeof(JLaunch).
extern "C" void joint_wave_layout(int n, int b, int with_shuffle, int ns,
                                  int clusters, long long* out) {
  out[0] = (long long)joint_smem_bytes(n, b, with_shuffle, ns, clusters);
  out[1] = (long long)joint_global_bytes(n, clusters, with_shuffle, ns);
  out[2] = (long long)joint_mail_bytes(clusters, b);
  out[3] = (long long)sizeof(JLaunch);
}

// out[0] cluster size, out[1] the dynamic shared memory a block may take,
// out[2] clusters the card holds at once (0: the launch would be refused),
// out[3] the most clusters one wave takes (MAX_CLUSTERS).
extern "C" int joint_wave_plan(int* out) {
  int limit = 0, clusters = 0;
  const cudaError_t e = card_figures(&limit, &clusters);
  out[0] = CLUSTER;
  out[1] = limit;
  out[2] = clusters;
  out[3] = MAX_CLUSTERS;
  return (int)e;
}

// One wave as w->clusters clusters, one cooperative launch. With
// w->a.rows set, the global-row instantiation (the caller's scratch holds
// joint_global_bytes); else the shared-memory one, which the wave must
// fit. Several clusters need the mailbox, zeroed here on the stream.
extern "C" int joint_wave_launch(const JLaunch* w, void* stream) {
  const JointArgs& a = w->a;
  if (a.p > MAX_P || a.ns > MAX_S || a.ns < 0 || w->clusters < 1 ||
      w->clusters > MAX_CLUSTERS || (w->clusters > 1 && !w->mail))
    return (int)cudaErrorInvalidValue;
  int limit = 0, most = 0;
  cudaError_t e = card_figures(&limit, &most);
  if (e != cudaSuccess) return (int)e;
  if (w->clusters > most) return (int)cudaErrorCooperativeLaunchTooLarge;
  const bool global = a.rows != nullptr;
  const size_t smem =
      global ? joint_member_bytes(a.b)
             : joint_smem_bytes(a.n, a.b, a.with_shuffle, a.ns, w->clusters);
  if (smem > (size_t)limit) return (int)cudaErrorInvalidValue;
  if (w->clusters > 1) {
    e = cudaMemsetAsync(w->mail, 0, joint_mail_bytes(w->clusters, a.b),
                        (cudaStream_t)stream);
    if (e != cudaSuccess) return (int)e;
  }
  cudaLaunchAttribute attr[2];
  cudaLaunchConfig_t cfg =
      launch_config(smem, w->clusters, (cudaStream_t)stream, attr);
  attr[1].id = cudaLaunchAttributeCooperative;
  attr[1].val.cooperative = 1;
  cfg.numAttrs = 2;
  e = cudaLaunchKernelEx(&cfg, kernels[(w->clusters > 1) * 2 + global],
                         *w);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
