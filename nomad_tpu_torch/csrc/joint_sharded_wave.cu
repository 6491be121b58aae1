// Joint placement wave over a mesh of node shards, for NVIDIA Hopper
// (sm_90a), under any feature union: one kernel launch a card a wave, its
// rows over one to seven clusters of CTAs on each card.
//
// Replaces: nomad_tpu/parallel/sharded.py `joint_sharded_entry` (:207),
// GSPMD's partition of the joint program `place_taskgroups_joint`
// (nomad_tpu/ops/kernel.py:1060) over the nodes axis: an XLA program, no
// Pallas, which the reference's launch_wave runs for every mesh wave
// outside the fused envelope (nomad_tpu/parallel/coalesce.py:681-700). It
// computes what nomad_tpu_torch/parallel/sharded._sharded_wave computes
// (its plain version): the joint wave under any feature union (spreads up
// to MAX_SPREADS stanzas, device asks and affinities, reserved cores,
// bandwidth, and everything of B1's envelope) with the node axis split
// over a mesh of positions, on one card or over several, with any number
// of positions a card and any number of rows a card below 2^24 nodes; each
// step's choice merged across the positions with the reference's cascade
// (largest value, lowest rank, lowest index), its pin rule and its top-k
// merge on (value desc, global index asc). Outputs: the packed buffer in
// ops/kernel.pack_fused_wave's layout, then one error word, and the top-k
// planes on the mesh's first card; the a_cpu / a_mem / a_disk carries on
// each position's own card.
//
// What bounds it. Counting each input byte once, the shards move the bytes
// of the one-device joint wave (chip_smoke.joint_bound); as for B1 and the
// joint kernel, that is not the floor that matters: a wave is a chain of T
// dependent N-wide argmaxes, so a step's time is its slowest CTA's pass
// over its rows plus the barriers and one exchange between the clusters
// and cards. The design spreads the rows and keeps that pass in shared
// memory.
//
// Design: csrc/joint_wave.cu's step (its header: the partial sums before
// the spread term cached beside the row keys, a spread step that re-derives
// the row keys from the bucket bytes and the boost table in shared memory
// alone, the boost table built by one warp a stanza beside warp 0's commit,
// the counts held by every CTA and bumped with the buckets handed on with
// each choice, several clusters a wave, the global-row instantiation) on a
// card's share of the mesh:
// - A card's rows are its positions' rows in position order. CTA g of the
//   card's grid (cluster g / CLUSTER, rank g % CLUSTER) owns card rows
//   [g*chunk, (g+1)*chunk), chunk = ceil(rows / (clusters * CLUSTER)). At
//   its start a CTA lists the segments of its range (position, first and
//   end card row, the position's first global row) and copies only those
//   positions' JointArgs into shared memory (at most MAX_SEGS); every row
//   loop walks the segments, so no loop divides a row by the shard's
//   width, and the argmax loop reads shared memory alone.
// - One exchange a step among every cluster of every card, flat: after the
//   cluster's barrier the cluster's rank 0 CTA publishes one entry (its
//   argmax, the pin's value where it holds the pin, its top-8, the
//   argmax's and the pin's buckets), tagged with the step, into every
//   card's mailbox at its participant's slot (card * clusters + cluster);
//   every CTA acquire-loads the participants' entries from its own card's
//   mailbox, one lane each, and merges them with the cascade and the pin
//   rule. On one card the tags are released and acquired at gpu scope; over
//   cards at system scope after a system fence (csrc/card_exchange.cuh).
//   One hop: a two-level exchange (each card's clusters merged by one CTA,
//   which trades the card's entry with the other cards and hands the
//   result to the card's CTAs) took 17.7 ms a wave of 32 x 10 at N=1048576
//   over four cards of seven clusters, this one 16.6 (NVIDIA H100 80GB
//   HBM3, 700 W; tools/joint_split.py --sharded 0). A wave's participants
//   stay at most one warp's lanes (MAX_PARTS), so the plan gives a mesh of
//   more than four cards fewer clusters a card.
// - Entries are double-buffered by step parity: a participant writes step
//   t+2's entry only after every participant has read step t's. The
//   partial metric sums and each participant's error flag reach the root
//   card's first cluster through the root's mailbox at the tail. Every
//   wait on another participant gives up after `spin_ns`, after which the
//   cluster waits no more and the error word (the mask of the cards whose
//   clusters gave up) makes the wrapper's caller raise.
// - Every cluster of a card must be resident at once: with several, the
//   launch is cooperative beside its cluster dimension (CUDA refuses a grid
//   the card cannot hold) and the host's plan never asks for more clusters
//   than cudaOccupancyMaxActiveClusters reports. Every card of a mesh runs
//   the same plan.
//
// Shared memory a CTA: 13 B a row of its range with shuffle (row key,
// rank, partial sum, count), one byte more a spread stanza, 36 B a member,
// and the JointArgs of the positions its range touches (static). Past
// what the plan's clusters hold, the second instantiation, kGlobal, keeps
// the same rows in a per-launch global scratch, so no width below 2^24
// nodes is refused.
//
// Why a step of its own beside joint_wave.cu's rather than one template:
// joint_wave.cu's code generation is held as it is (125 / 128 registers,
// no spills); this step maps card rows through its segments, merges over
// cards and hands the buckets on. What holds no placement rule is shared:
// the node arithmetic (csrc/joint_node.cuh), the keys and warp reductions
// (csrc/wave_score.cuh), the slots, top-8 lists and launch helpers
// (csrc/cluster_wave.cuh), the tags and the cards' ordering
// (csrc/card_exchange.cuh).
//
// Built by nomad_tpu_torch/ops/build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xptxas -v
//        -fmad=false -shared -Xcompiler -fPIC

#include <cooperative_groups.h>

#include <mutex>

#include "card_exchange.cuh"
#include "joint_node.cuh"

namespace cg = cooperative_groups;

#define CLUSTER 16
#define THREADS 512
#define NWARPS (THREADS / 32)
#define ALL_WARPS (FULL_MASK >> (32 - NWARPS))
#define MAX_CARDS 8
#define MAX_SHARDS 64              // mesh positions
#define MAX_DEVICES 64
#define MAX_CLUSTERS 8             // clusters a card
#define MAX_PARTS 32               // participants of a wave: cards x clusters
#define MAX_SEGS 5                 // positions a CTA's range touches
#define NO_BUCKETS (-1)            // node_buckets' packing of "none"

#define BOOST_WARP 2               // warps 2.. build the boost table
#define BOOST_BAR 2                // their named barrier with warp 0

// The exchange a wave's kernel has compiled in: none (one cluster on one
// card), between the clusters of one card (gpu scope), or between cards
// (system scope, any clusters a card).
#define X_NONE 0
#define X_GPU 1
#define X_SYS 2

static_assert(NWARPS >= BOOST_WARP + MAX_S,
              "one warp a stanza builds the boost table");
static_assert(CLUSTER <= 32 && MAX_PARTS <= 32 && MAX_CARDS <= 32,
              "a warp's lanes read the slots, the entries and the cards");
// a range of ceil(rows / CLUSTER) rows or fewer starts inside one position
// and covers at most MAX_SHARDS / CLUSTER more
static_assert(MAX_SEGS == MAX_SHARDS / CLUSTER + 1, "segments a CTA");

// One participant's result for one step, in a slot of every card's
// mailbox.
struct __align__(16) JEntry {
  unsigned k, r;
  int i;
  float pin_v;      // the pin's masked value where the cluster holds it
  unsigned tk[TOPK];
  int ti[TOPK];
  int bk;           // its argmax's buckets (node_buckets), or NO_BUCKETS
  int pk;           // the pin's buckets where it holds the pin, else -1
  unsigned tag;     // step index + 1, written last
  int pad;
};
static_assert(sizeof(JEntry) == 96, "mirrored by cuda_kernel._joint_mail");

// A card's mailbox: JEntry [2][parts] (by step parity, then participant),
// then u32 mtag [parts], i32 merr [parts] and i32 msum [parts][N_MET B]
// (read on the root card). Mirrored by cuda_kernel._joint_mail.
__host__ __device__ inline size_t jsw_mail_bytes(int parts, int b) {
  return (size_t)2 * parts * sizeof(JEntry) +
         (size_t)parts * (2 + N_MET * b) * sizeof(int);
}

// A CTA's card rows (rounded to four) and their bytes: row keys, shuffle
// ranks, partial sums, counts, then a bucket byte a stanza; the metric
// partial sums and a flag per member; with the rows, a CTA's shared
// memory; the global-row instantiation's stride a CTA and scratch a card.
// The same layout as joint_wave.cu's over a card's rows, mirrored by
// cuda_kernel.joint_layout.
__host__ __device__ inline int jsw_chunk(int rows, int clusters) {
  const int ctas = clusters * CLUSTER;
  return (rows + ctas - 1) / ctas;
}

__host__ __device__ inline size_t jsw_cta_rows(int rows, int clusters,
                                               int with_shuffle, int ns) {
  const size_t c4 = ((size_t)jsw_chunk(rows, clusters) + 3) & ~(size_t)3;
  return joint_row_bytes(c4, with_shuffle) + c4 * ns;
}

__host__ __device__ inline size_t jsw_member_bytes(int b) {
  return (size_t)b * (N_MET + 1) * sizeof(int);
}

__host__ __device__ inline size_t jsw_smem_bytes(int rows, int b,
                                                 int with_shuffle, int ns,
                                                 int clusters) {
  return jsw_cta_rows(rows, clusters, with_shuffle, ns) + jsw_member_bytes(b);
}

__host__ __device__ inline size_t jsw_cta_stride(int rows, int clusters,
                                                 int with_shuffle, int ns) {
  return (jsw_cta_rows(rows, clusters, with_shuffle, ns) + 15) & ~(size_t)15;
}

__host__ inline size_t jsw_global_bytes(int rows, int clusters,
                                        int with_shuffle, int ns) {
  return (size_t)clusters * CLUSTER *
         jsw_cta_stride(rows, clusters, with_shuffle, ns);
}

// What one card's launch is given, by value. The shape (rows a position,
// members, steps, flags) is every position's JointArgs's.
struct JWave {
  int n_glob;           // global nodes: positions x rows a position
  int n_loc;            // rows a position
  int n_cards, card;    // cards in the mesh, this one (0: the root)
  int n_pos;            // mesh positions this card holds
  int clusters;         // clusters of CLUSTER CTAs on every card
  int absent;           // a participant that publishes nothing, so the
                        // others' bounded waits run out (the card tests');
                        // -1 none
  int pad;
  long long spin_ns;    // the longest wait on another participant's tag
  const JointArgs* pos; // its positions (device), then their first global
                        // rows (g0), i32 [MAX_SHARDS], then the step maps
  const int* sm;        // i32 [T] each step's member (-1: padding)
  const int* sl;        // i32 [T] and its local step
  float* spc;           // f32 [clusters * CLUSTER, B, MAX_S, SB] counts
  unsigned char* rows;  // kGlobal: the card's global-row scratch
  unsigned char* mail[MAX_CARDS];  // every card's mailbox (an exchange)
  float* packed;        // the root: f32 [2T + 8B + 1], the last the error
  int* topk_idx;        // the root: i32 [T, TOPK]
  float* topk_scores;   // the root: f32 [T, TOPK]
};

// A CTA keeps the JointArgs of its range's positions in shared memory,
// and nothing writes them while the kernel runs. The node functions read
// a position through a restrict pointer, so the compiler may keep its
// leaves' pointers and strides in registers across the stores to the
// carries and scratch, as it does with the joint kernel's JointArgs in
// parameter space (without it a store through a generic pointer might
// write shared memory, and every field would be read again after it).

// Member m's card rows [r0, r1) of one position (its first card row
// `base`) rebuilt into the CTA's row entries from `lo`: the partial sums,
// counts, row keys and (a spread member) bucket bytes; at its first
// appearance also its metrics (into c) and its count scratch.
__device__ __forceinline__ void rebuild_rows(
    const JointArgs* __restrict__ pp, const JMember& v,
    const int* sp_active, int m, int r0, int r1, int base, int lo,
    bool first, int ns, int c4, unsigned* row, float* rsum,
    unsigned char* rcnt, signed char* rbkt, int (&c)[N_MET]) {
  const JointArgs& p = *pp;
  const long long row0 = (long long)m * p.n;
  for (int r = r0 + (int)threadIdx.x; r < r1; r += (int)blockDim.x) {
    const int xl = r - base, x = r - lo;
    const JNode d = load_node(p, m, xl, first);
    if (first) {
      count_metrics(p, v, d, c);
      p.jtc[row0 + xl] = d.jtc;
      if (p.with_distinct) p.jac[row0 + xl] = d.jac;
      if (p.with_ports) p.pc[row0 + xl] = d.pc;
    }
    float sum;
    unsigned k;
    node_rest(p, v, d, d.pen, sum, k);
    rsum[x] = sum;
    rcnt[x] = (unsigned char)k;
    row[x] = final_key(sum, k, 0.0f);
    if (v.spread)
      for (int st = 0; st < ns; ++st)  // the shared copy: no local array
        rbkt[st * c4 + x] =
            (signed char)(sp_active[st] ? node_bucket(p, m, xl, st) : -1);
  }
}

// A special node of member m at row xl of a position, row entry x: with
// `commit` the last step's placement committed there and its entry
// rescored; with `pen` its entry saved for the next step and rescored
// under the step's penalty.
__device__ __forceinline__ void special_node(
    const JointArgs* __restrict__ pp, const JMember& v, int m, int xl,
    int x, bool commit, bool pen, unsigned* row, float* rsum,
    unsigned char* rcnt, int& restore_x, unsigned& restore_k,
    float& restore_s, unsigned& restore_c) {
  const JointArgs& p = *pp;
  JNode d = load_node(p, m, xl, false);
  float rs;
  unsigned rc;
  if (commit) {
    commit_node(p, v, m, xl, d);
    node_rest(p, v, d, d.pen, rs, rc);
    rsum[x] = rs;
    rcnt[x] = (unsigned char)rc;
    row[x] = final_key(rs, rc, 0.0f);
  }
  if (pen) {
    restore_x = x;
    restore_k = row[x];
    restore_s = rsum[x];
    restore_c = rcnt[x];
    node_rest(p, v, d, true, rs, rc);
    rsum[x] = rs;
    rcnt[x] = (unsigned char)rc;
    row[x] = final_key(rs, rc, 0.0f);
  }
}

// The last placement of member m committed at row xl of a position.
__device__ __forceinline__ void commit_last(const JointArgs* __restrict__ pp,
                                            const JMember& v, int m,
                                            int xl) {
  JNode d = load_node(*pp, m, xl, false);
  commit_node(*pp, v, m, xl, d);
}

// kGlobal: the CTAs' rows live in the global scratch `w.rows`; else in
// shared memory. kX: the exchange compiled in (X_NONE, X_GPU, X_SYS).
template <bool kGlobal, int kX>
__global__ void __launch_bounds__(THREADS, 1)
    joint_sharded_kernel(const JWave w) {
  extern __shared__ __align__(16) unsigned char dyn_smem[];
  __shared__ JointArgs seg_args[MAX_SEGS];  // the positions of the range
  __shared__ int seg_lo[MAX_SEGS];     // a segment's first card row,
  __shared__ int seg_hi[MAX_SEGS];     // its end,
  __shared__ int seg_base[MAX_SEGS];   // its position's first card row
  __shared__ int seg_g0[MAX_SEGS];     // and first global row
  __shared__ int sh_nseg;
  __shared__ int sh_lp[MAX_SHARDS];    // mesh position -> index here, -1
  __shared__ Slot slot[2];             // this CTA's argmax, by step parity
  __shared__ int2 slot_bk[2];  // a spread member's: the buckets of that
                               // argmax and of the pin where held, or none
  __shared__ TopList top_list[2];      // this CTA's top-8, by step parity
  __shared__ TopList clu_top;          // rank 0: the cluster's top-8
  __shared__ Best sh_best[NWARPS];
  __shared__ unsigned sh_tk[NWARPS][TOPK];  // each warp's top-8 list
  __shared__ int sh_ti[NWARPS][TOPK];
  __shared__ unsigned sh_dirty;  // warps whose row entries the step changed
  __shared__ JMember sh_member;
  __shared__ float counts[MAX_S][SB];   // the current member's counts
  __shared__ float desired[MAX_S][SB];  // and its desired counts
  __shared__ float boost[MAX_S][SB];    // this step's boost per bucket
  __shared__ int sh_pbk;             // the buckets the step bumps
  __shared__ int sh_err;             // this CTA waited past the bound
  __shared__ int sh_mask;            // the root's CTA 0: the cards at fault

  constexpr bool xch = kX != X_NONE;   // an exchange between participants
  constexpr bool cards = kX == X_SYS;  // card rows are not global rows
  cg::cluster_group cluster = cg::this_cluster();
  const int cta = (int)cluster.block_rank();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nclu = xch ? w.clusters : 1;
  const int clu = xch ? (int)blockIdx.x / CLUSTER : 0;
  const int g = clu * CLUSTER + cta;       // this CTA in the card's grid
  const int n_part = xch ? w.n_cards * nclu : 1;
  const int me = w.card * nclu + clu;      // this cluster's participant
  const bool root = w.card == 0;
  const bool head = root && g == 0;        // writes the outputs
  const int n_loc = w.n_loc, n_glob = w.n_glob;
  const int rows = w.n_pos * n_loc;
  const int chunk = jsw_chunk(rows, nclu);
  const int c4 = (chunk + 3) & ~3;
  const int lo = min(g * chunk, rows), hi = min(lo + chunk, rows);
  const int cnt = hi - lo;
  const int* g0s = reinterpret_cast<const int*>(w.pos + w.n_pos);

  // ---- the range's segments, their positions' JointArgs (position 0's
  // where the range is empty: the shape and every leaf that is not a node
  // plane), and the card's positions by mesh index ----
  if (tid == 0) {
    int s = 0;
    for (int r = lo; r < hi; ++s) {
      const int lp = r / n_loc, end = min(hi, (lp + 1) * n_loc);
      seg_lo[s] = r;
      seg_hi[s] = end;
      seg_base[s] = lp * n_loc;
      seg_g0[s] = __ldg(g0s + lp);
      sh_lp[s] = lp;  // scratch until the copy below
      r = end;
    }
    sh_nseg = s;
    sh_err = 0;
  }
  __syncthreads();
  const int nseg = sh_nseg;
  {
    constexpr int n16 = (int)(sizeof(JointArgs) / 16);
    for (int q = tid; q < max(nseg, 1) * n16; q += THREADS) {
      const int s = q / n16;
      const int lp = nseg > 0 ? sh_lp[s] : 0;
      reinterpret_cast<int4*>(&seg_args[s])[q - s * n16] =
          __ldg(reinterpret_cast<const int4*>(w.pos + lp) + (q - s * n16));
    }
  }
  __syncthreads();
  if (cards) {
    for (int q = tid; q < MAX_SHARDS; q += THREADS) sh_lp[q] = -1;
    __syncthreads();
    for (int lp = tid; lp < w.n_pos; lp += THREADS)
      sh_lp[__ldg(g0s + lp) / n_loc] = lp;
  }
  const JointArgs& s = seg_args[0];  // the shape, and the card's copy of
                                     // every leaf that is not a node plane
  // the shape, read once into registers
  const int nb = s.b, ns = s.ns, n_t = s.t, n_k = s.k, n_bp = s.bp;
  const bool shuffle = s.with_shuffle, with_topk = s.with_topk;
  unsigned char* rbase =
      kGlobal ? w.rows + (size_t)g * jsw_cta_stride(rows, nclu,
                                                    shuffle, ns)
              : dyn_smem;
  unsigned* row = reinterpret_cast<unsigned*>(rbase);
  unsigned* rank = row + c4;
  float* rsum = reinterpret_cast<float*>(rank + (shuffle ? c4 : 0));
  unsigned char* rcnt = reinterpret_cast<unsigned char*>(rsum + c4);
  signed char* rbkt = reinterpret_cast<signed char*>(rcnt + c4);  // [ns][c4]
  int* part = kGlobal ? reinterpret_cast<int*>(dyn_smem)
                      : reinterpret_cast<int*>(rbkt + (size_t)ns * c4);
  int* seen = part + nb * N_MET;
  float* my_spc = w.spc + (long long)g * nb * MAX_S * SB;
  unsigned char* my_mail = w.mail[w.card];

  // the segment of a card row of this CTA's range
  auto seg_of = [&](int r) -> int {
    int q = 0;
#pragma unroll
    for (int k = 1; k < MAX_SEGS; ++k) q += (k < nseg && r >= seg_lo[k]);
    return q;
  };
  // card row of global node g (-1: out of range, or on another card)
  auto row_of = [&](int gi) -> int {
    if (gi < 0 || gi >= n_glob) return -1;
    if (!cards) return gi;
    const int q = gi / n_loc, lp = sh_lp[q];
    return lp < 0 ? -1 : lp * n_loc + (gi - q * n_loc);
  };
  // global node of a card row of this CTA's range
  auto global_of = [&](int r) -> int {
    if (!cards) return r;
    const int q = seg_of(r);
    return seg_g0[q] + (r - seg_base[q]);
  };
  // the current member's buckets at row entry x (node_buckets' packing)
  auto row_buckets = [&](int x) -> int {
    unsigned out = 0xffffffffu;
#pragma unroll
    for (int st = 0; st < MAX_S; ++st)
      if (sh_member.sp_active[st])
        out = (out & ~(0xffu << (8 * st))) |
              ((unsigned)(unsigned char)rbkt[st * c4 + x] << (8 * st));
    return (int)out;
  };
  auto entry = [&](unsigned char* mail, int par, int q) -> JEntry* {
    return reinterpret_cast<JEntry*>(mail) + par * n_part + q;
  };
  auto wait_entry = [&](const unsigned* tag, unsigned want) -> bool {
    return kX == X_SYS ? wait_tag(tag, want, w.spin_ns)
                       : wait_tag_gpu(tag, want, w.spin_ns);
  };

  // ---- pre-wave: zero the carries, the partial sums and the flags; the
  // root's idle outputs ----
  for (int q = 0; q < nseg; ++q) {
    const JointArgs& p = seg_args[q];
    for (int r = seg_lo[q] + tid; r < seg_hi[q]; r += THREADS) {
      const int x = r - seg_base[q];
      p.a_cpu[x] = 0.0f;
      p.a_mem[x] = 0.0f;
      p.a_disk[x] = 0.0f;
      if (p.with_ports) p.a_dyn[x] = 0;
      if (p.with_cores) p.a_cores[x] = 0;
      if (p.with_network) p.a_mbits[x] = 0;
      if (p.with_devices)
        for (int d = 0; d < MAX_D; ++d)
          p.a_dev[(long long)x * MAX_D + d] = 0.0f;
    }
  }
  for (int x = tid; x < nb * (N_MET + 1); x += THREADS) part[x] = 0;
  if (head) {
    // an inactive step scores an all-NEG_INF plane: nothing found, the
    // top-k of the plain version's stable sort; active steps overwrite
    for (int t = tid; t < n_t; t += THREADS) {
      w.packed[t] = -1.0f;
      w.packed[n_t + t] = 0.0f;
      for (int q = 0; q < TOPK; ++q) {
        w.topk_idx[t * TOPK + q] = with_topk ? q : 0;
        w.topk_scores[t * TOPK + q] = NEG_INF_F;
      }
    }
  }
  __syncthreads();

  // the head's warp 1: the wave's top-8 of active step t, from the CTAs'
  // lists (no exchange) or the participants' entries of parity pp,
  // written before a barrier already passed
  auto emit_topk = [&](int pp, int t) {
    unsigned ok[TOPK];
    int oi[TOPK];
    if (!xch) {
      cluster_top<CLUSTER>(cluster, &top_list[pp], with_topk, lane, ok,
                           oi);
    } else {
      unsigned lk[TOPK];
      int li[TOPK];
      list_clear(lk, li);
      list_clear(ok, oi);
      if (with_topk && lane < n_part) {
        // this warp acquires the tags itself: warp 0 may still be waiting
        // for them (nothing orders the two warps between the steps)
        const JEntry* e = entry(my_mail, pp, lane);
        if (!*reinterpret_cast<volatile int*>(&sh_err) &&
            !wait_entry(&e->tag, (unsigned)t + 1u))
          sh_err = 1;
#pragma unroll
        for (int q = 0; q < TOPK; ++q) {
          lk[q] = __ldcg(&e->tk[q]);
          li[q] = __ldcg(&e->ti[q]);
        }
      }
      if (with_topk) warp_top(lk, li, ok, oi);
    }
    write_topk(ok, oi, lane, t, with_topk, w.topk_idx, w.topk_scores);
  };
  // the calling warp's sorted top-8 of its rows, on card rows
  auto warp_list = [&]() {
    warp_row_top<THREADS>(row, lo, cnt, warp, lane, sh_tk[warp], sh_ti[warp]);
  };
  // a row entry changed: its warp's list is stale
  auto mark = [&](int x) {
    atomicOr(&sh_dirty, 1u << ((x % THREADS) / 32));
  };

  // ---- the step loop ----
  int row_m = -1;      // member whose row (and counts) are cached
  int rank_m = -1;     // permutation row whose ranks are cached
  int mspread = 0;     // row_m has an active stanza: rows re-derived a step
  int pend = -1;       // warp 0: card row of the last step's choice, not
                       // committed (-1: none, or on another card)
  int pbk = NO_BUCKETS;  // warp 0: its buckets, not bumped yet
  int par = 0;         // parity of the active step (slots, mailbox)
  int t_prev = -1;     // step index of the last active step
  int restore_x = -1;  // row entry a special thread puts back next step
  unsigned restore_k = 0, restore_c = 0;
  float restore_s = 0.0f;
  int pf_t = -1;        // warp 0: step whose nodes are loaded
  int pf_s[MAX_P + 1];  // warp 0: its penalty nodes, then its pin (global)
  bool dead = false;    // warp 0: a wait ran past the bound; wait no more
  for (int t0 = 0; t0 < n_t; t0 += 32) {
    // which of the next 32 steps place: the reference's rule (a member,
    // and a local step under its count); every warp finds the same mask
    const int ts = t0 + lane;
    int mem_raw = -1, j_raw = 0;
    bool act = false;
    if (ts < n_t) {
      mem_raw = __ldg(w.sm + ts);
      j_raw = __ldg(w.sl + ts);
      const int mc = min(max(mem_raw, 0), nb - 1);
      act = mem_raw >= 0 && j_raw < __ldg(leaf_of<int>(s, J_NSTEPS, mc));
    }
    unsigned mask = __ballot_sync(FULL_MASK, act);
    while (mask) {
      const int l = __ffs(mask) - 1;
      mask &= mask - 1;
      const int t = t0 + l;
      const int m = min(max(__shfl_sync(FULL_MASK, mem_raw, l), 0), nb - 1);
      const int j = min(max(__shfl_sync(FULL_MASK, j_raw, l), 0), n_k - 1);

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
              const int q = seg_of(pend);
              commit_last(&seg_args[q], old, row_m, pend - seg_base[q]);
            }
          }
          if (row_m >= 0 && sh_member.spread)
            for (int st = 0; st < MAX_S; ++st)
              if (sh_member.sp_active[st]) bump_packed(pbk, st, counts);
          sh_member = load_member(s, m);
        }
        pend = -1;
        pbk = NO_BUCKETS;
        restore_x = -1;  // the row is rebuilt
        __syncthreads();
        if (ns > 0) {
          const float* in_c = leaf_of<float>(s, J_SP_COUNTS, m);
          const float* in_d = leaf_of<float>(s, J_SP_DESIRED, m);
          for (int x = tid; x < ns * SB; x += THREADS) {  // the ns rows
            float* c = &counts[0][0] + x;
            if (row_m >= 0) my_spc[(long long)row_m * MAX_S * SB + x] = *c;
            *c = first ? in_c[x] : my_spc[(long long)m * MAX_S * SB + x];
            (&desired[0][0])[x] = in_d[x];
          }
        }
        const JMember v = sh_member;
        int c[N_MET] = {0, 0, 0, 0, 0, 0, 0, 0};
        for (int q = 0; q < nseg; ++q)
          rebuild_rows(&seg_args[q], v, sh_member.sp_active, m, seg_lo[q],
                       seg_hi[q], seg_base[q], lo, first, ns, c4, row, rsum,
                       rcnt, rbkt, c);
        if (first) {
#pragma unroll
          for (int q = 0; q < N_MET; ++q) {
            const int sum = __reduce_add_sync(FULL_MASK, c[q]);
            if (lane == 0 && sum != 0) atomicAdd(&part[m * N_MET + q], sum);
          }
        }
        const int pm = n_bp > 1 ? m : 0;
        if (shuffle && pm != rank_m) {
          // rank of a node = its position in the permutation
          load_ranks<THREADS>(leaf_of<int>(s, J_PERM, pm), n_glob, lo, hi,
                              rank, tid, row_of);
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

      // special nodes, one thread each in the owner CTA (as in the joint
      // kernel), with the partial sums kept beside the row. A spread
      // member's step first hands the buckets of the last step's choice to
      // the boost warps, which bump the counts and build the step's boost
      // table beside the special nodes' work: one warp a stanza
      // (ops/kernel._spread_score on the bucket axis). Meanwhile the
      // head's warp 1 writes out the last active step's top-k.
      int pcl = -1;   // warp 0: the step's pin (global, clamped), or -1
      int prow = -1;  // warp 0: its card row, or -1
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
        if (pf_t != t) load_step_nodes(s, m, j, pf_s);
        int sp[N_SPECIAL];
        sp[0] = pend;
#pragma unroll
        for (int q = 0; q < MAX_P; ++q) sp[1 + q] = row_of(pf_s[q]);
        const int pref = pf_s[MAX_P];
        pcl = pref >= 0 ? min(pref, n_glob - 1) : -1;
        prow = row_of(pcl);
        sp[N_SPECIAL - 1] = prow;
        if (mask) {  // the next active step of these 32: load ahead
          const int nl = __ffs(mask) - 1;
          pf_t = t0 + nl;
          load_step_nodes(
              s, min(max(__shfl_sync(FULL_MASK, mem_raw, nl), 0), nb - 1),
              min(max(__shfl_sync(FULL_MASK, j_raw, nl), 0), n_k - 1), pf_s);
        }
        int q = -1;
#pragma unroll
        for (int k = 0; k < N_SPECIAL; ++k)
          if (k == tid) q = sp[k];
        bool mine = q >= lo && q < hi;
#pragma unroll
        for (int k = 0; k < N_SPECIAL; ++k)
          if (k < tid && sp[k] == q) mine = false;  // handled by lane k
        if (mine) {
          bool is_pen = false;
#pragma unroll
          for (int k = 1; k <= MAX_P; ++k) is_pen = is_pen || sp[k] == q;
          const int x = q - lo;
          if (q == pend || is_pen) {
            const int sg = seg_of(q);
            special_node(&seg_args[sg], sh_member, m, q - seg_base[sg], x,
                         q == pend, is_pen, row, rsum, rcnt, restore_x,
                         restore_k, restore_s, restore_c);
            mark(x);
          }
        }
      } else if (warp == 1 && head && t_prev >= 0) {
        emit_topk(par ^ 1, t_prev);
      }
      __syncthreads();

      // every warp: its argmax over its row entries (re-deriving them for
      // a spread member from the shared buckets), and its top-8 list when
      // the step made it stale
      {
        unsigned bk = PAD_KEY, br = NO_RANK;
        int bi = NO_NODE;
        for (int x = tid; x < cnt; x += THREADS) {
          unsigned k;
          if (mspread) {
            float sp = 0.0f;
            for (int st = 0; st < ns; ++st) {
              if (!sh_member.sp_active[st]) continue;
              const int b = rbkt[st * c4 + x];
              sp = sp + (b < 0 ? -1.0f : boost[st][b]);
            }
            k = final_key(rsum[x], rcnt[x], sp);
            row[x] = k;
          } else {
            k = row[x];
          }
          const unsigned r = shuffle ? rank[x] : (unsigned)(lo + x);
          if (k > bk || (k == bk && r < br)) {
            bk = k;
            br = r;
            bi = lo + x;
          }
        }
        warp_best(bk, br, bi);
        if (lane == 0) sh_best[warp] = Best{bk, br, bi};
        if (with_topk && (mspread || ((sh_dirty >> warp) & 1u)))
          warp_list();
      }
      __syncthreads();

      // this CTA's argmax (warp 0, with the pin's step value read from the
      // row, its spread term included, and for a spread member the
      // buckets of both) and top-8 (warp 1) into its slots, on global
      // indices and ranks
      if (warp == 0) {
        Best b = {PAD_KEY, NO_RANK, NO_NODE};
        if (lane < NWARPS) b = sh_best[lane];
        warp_best(b.k, b.r, b.i);
        if (lane == 0) {
          const bool pin_here = prow >= lo && prow < hi;
          if (mspread)
            slot_bk[par] = make_int2(
                b.i != NO_NODE ? row_buckets(b.i - lo) : NO_BUCKETS,
                pin_here ? row_buckets(prow - lo) : NO_BUCKETS);
          if (b.i != NO_NODE) {
            b.i = global_of(b.i);
            if (!shuffle) b.r = (unsigned)b.i;
          }
          slot[par] = Slot{b.k, b.r, b.i,
                           pin_here ? key_score(row[prow - lo]) : NEG_INF_F};
        }
      } else if (warp == 1) {
        if (with_topk) {
          if (mspread || sh_dirty) {
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
                top_list[par].i[q] = oi[q] == NO_NODE ? NO_NODE
                                                      : global_of(oi[q]);
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

      // an exchange: rank 0's warp 1 merges its cluster's top-8 for the
      // entry
      if (xch && cta == 0 && warp == 1) {
        unsigned ok[TOPK];
        int oi[TOPK];
        cluster_top<CLUSTER>(cluster, &top_list[par], with_topk, lane, ok,
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
      // then (an exchange) the wave's from the participants' entries, and
      // the chosen node's buckets
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
        // the pin's value, NEG_INF where another cluster or card holds it
        float pv = NEG_INF_F;
        if (prow >= 0) {
          const int pg = prow / chunk;  // the pin's CTA on this card
          pv = __shfl_sync(FULL_MASK, pin_v, pg % CLUSTER);
          if (pg / CLUSTER != clu) pv = NEG_INF_F;
        }
        if (xch) {
          if (cta == 0) {
            asm volatile("bar.sync 1, 64;" ::: "memory");  // clu_top ready
            // a cluster that has given up publishes nothing more
            if (lane < w.n_cards && !dead && me != w.absent) {
              JEntry* e = entry(w.mail[lane], par, me);
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
              if (kX == X_SYS) {
                __threadfence_system();
                st_release(&e->tag, (unsigned)t + 1u);
              } else {
                st_release_gpu(&e->tag, (unsigned)t + 1u);
              }
            }
          }
          bool ok = true;
          float gpv = NEG_INF_F;
          int gbk = NO_BUCKETS, gpk = NO_BUCKETS;
          b = Best{PAD_KEY, NO_RANK, NO_NODE};
          if (lane < n_part) {
            const JEntry* e = entry(my_mail, par, lane);
            if (!dead) ok = wait_entry(&e->tag, (unsigned)t + 1u);
            b = Best{__ldcg(&e->k), __ldcg(&e->r), __ldcg(&e->i)};
            gpv = __ldcg(&e->pin_v);
            gbk = __ldcg(&e->bk);
            gpk = __ldcg(&e->pk);
          }
          if (__any_sync(FULL_MASK, !ok)) {
            dead = true;
            if (lane == 0) sh_err = 1;
          }
          // the same cascade over the participants' entries; the winner's
          // buckets come with it, the pin's from the one that holds it
          mine = b;
          warp_best(b.k, b.r, b.i);
          const unsigned hit = __ballot_sync(
              FULL_MASK, lane < n_part && mine.k == b.k && mine.r == b.r);
          bkw = __shfl_sync(FULL_MASK, gbk, hit ? __ffs(hit) - 1 : 0);
          pkw = (int)__reduce_and_sync(FULL_MASK, (unsigned)gpk);
#pragma unroll
          for (int off = 16; off > 0; off >>= 1)
            gpv = fmaxf(gpv, __shfl_xor_sync(FULL_MASK, gpv, off));
          pv = gpv;
        }
        int idx = b.i;
        float val = key_score(b.k);
        // pin rule (sharded.py:397-406): a feasible pin wins; its masked
        // step value is > NEG_INF / 2 exactly then
        const bool pinned = pcl >= 0 && pv > NEG_INF_F / 2.0f;
        if (pinned) {
          idx = pcl;
          val = pv;
        }
        const bool found = val > NEG_INF_F / 2.0f;
        if (head && lane == 0) {
          w.packed[t] = found ? (float)idx : -1.0f;
          w.packed[n_t + t] = found ? val : 0.0f;
        }
        pend = found ? row_of(idx) : -1;
        pbk = found ? (pinned ? pkw : bkw) : NO_BUCKETS;
      }
      par ^= 1;
      t_prev = t;
    }
  }

  // ---- tail: the last placement, the metrics, the last top-k, the
  // error word ----
  if (tid == 0 && pend >= lo && pend < hi) {
    const int q = seg_of(pend);
    commit_last(&seg_args[q], sh_member, row_m, pend - seg_base[q]);
  }
  for (int m = 0; m < nb; ++m) {
    if (seen[m]) continue;  // counted at its first row pass
    const JMember v = load_member(s, m);
    int c[N_MET] = {0, 0, 0, 0, 0, 0, 0, 0};
    for (int q = 0; q < nseg; ++q)
      for (int r = seg_lo[q] + tid; r < seg_hi[q]; r += THREADS)
        count_metrics(seg_args[q], v,
                      load_node(seg_args[q], m, r - seg_base[q], true), c);
#pragma unroll
    for (int q = 0; q < N_MET; ++q) {
      const int sum = __reduce_add_sync(FULL_MASK, c[q]);
      if (lane == 0 && sum != 0) atomicAdd(&part[m * N_MET + q], sum);
    }
  }
  cluster.sync();  // every CTA's partial sums ready
  if (cta == 0) {
    if (head && warp == 1 && t_prev >= 0) emit_topk(par ^ 1, t_prev);
    __syncthreads();  // every error flag of this CTA set
    const int nbm = nb * N_MET;
    // this cluster's error flag: any of its CTAs waited past the bound
    int clu_err = 0;
    if (warp == 0)
      clu_err = __ballot_sync(FULL_MASK,
                              lane < CLUSTER &&
                                  *cluster.map_shared_rank(&sh_err, lane)) !=
                0;
    unsigned* mtag = reinterpret_cast<unsigned*>(
        xch ? w.mail[0] + 2 * n_part * sizeof(JEntry) : nullptr);
    int* merr = reinterpret_cast<int*>(mtag + n_part);
    int* msum = merr + n_part;
    if (xch && me != 0) {
      // the cluster's partial sums and flag into the root's mailbox
      for (int x = tid; x < nbm; x += THREADS) {
        int sum = 0;
        for (int c = 0; c < CLUSTER; ++c)
          sum += cluster.map_shared_rank(part, c)[x];
        msum[me * nbm + x] = sum;
      }
      if (tid == 0) merr[me] = clu_err;
      if (kX == X_SYS)
        __threadfence_system();
      else
        __threadfence();
      __syncthreads();
      if (tid == 0 && me != w.absent) {
        if (kX == X_SYS)
          st_release(&mtag[me], 1u);
        else
          st_release_gpu(&mtag[me], 1u);
      }
    } else if (me == 0 && root) {
      if (warp == 0) {
        // every other participant's sums, for at most the bound; a
        // participant at fault marks its card
        bool bad = false;
        if (xch && lane >= 1 && lane < n_part) {
          const bool late = dead || !wait_entry(&mtag[lane], 1u);
          bad = late || __ldcg(&merr[lane]) != 0;
        }
        unsigned at = 0;
        for (int c = 0; c < w.n_cards; ++c)
          if (__any_sync(FULL_MASK, bad && lane / nclu == c)) at |= 1u << c;
        if (lane == 0) sh_mask = (int)(at | (clu_err ? 1u : 0u));
      }
      __syncthreads();
      float* metrics = w.packed + 2 * n_t;
      for (int x = tid; x < nbm; x += THREADS) {
        int sum = 0;
        for (int c = 0; c < CLUSTER; ++c)
          sum += cluster.map_shared_rank(part, c)[x];
        if (xch)
          for (int c = 1; c < n_part; ++c) sum += __ldcg(&msum[c * nbm + x]);
        metrics[(x % N_MET) * nb + x / N_MET] = (float)sum;
      }
      if (tid == 0) w.packed[2 * n_t + nbm] = (float)sh_mask;
    }
  }
  cluster.sync();  // no CTA leaves while another may read its shared memory
}

// ---- the host side ----

static void (*const kernels[])(const JWave) = {
    joint_sharded_kernel<false, X_NONE>, joint_sharded_kernel<true, X_NONE>,
    joint_sharded_kernel<false, X_GPU>,  joint_sharded_kernel<true, X_GPU>,
    joint_sharded_kernel<false, X_SYS>,  joint_sharded_kernel<true, X_SYS>};

// The dynamic shared memory a block of every instantiation may take on the
// current device, after setting their attributes there, and the clusters
// of every instantiation the card holds at once at that shared memory
// (once per device).
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

// One card of the mesh; the first is the root. Mirrored by
// nomad_tpu_torch/ops/cuda_kernel._JCard.
struct JCard {
  int ordinal;            // CUDA device ordinal
  int n_pos;              // mesh positions it holds, in ascending order
  void* stream;           // its current stream
  unsigned char* table;   // on it: JointArgs [n_pos], i32 g0 [MAX_SHARDS],
                          // then the step maps, i32 [T] member and [T]
                          // local step, copied up on `stream`
  unsigned char* mail;    // its mailbox (an exchange), else null
  float* spc;             // its counts scratch (spreads), else null
  unsigned char* rows;    // its global-row scratch (kGlobal), else null
};

// Mirrored by nomad_tpu_torch/ops/cuda_kernel._JShardedArgs. The shape
// repeats the positions' JointArgs (which lie on the cards) for the host.
struct JShardedArgs {
  int n_glob, n_loc, n_cards;
  int b, t, p, ns, with_shuffle;
  int clusters;           // clusters of CLUSTER CTAs on every card
  int absent;             // a participant that publishes nothing; -1 none
  const JCard* card;      // host array, the root first
  float* packed;          // f32 [2T + 8B + 1] on the root
  int* topk_idx;          // i32 [T, TOPK] on the root
  float* topk_scores;     // f32 [T, TOPK] on the root
  long long spin_ns;      // the longest wait on another participant's tag
};

static std::mutex g_enqueue;            // one wave's launches at a time
static unsigned long long g_launches;   // kernel launches, every card's

// The struct sizes the wrapper mirrors: JointArgs, JCard, JShardedArgs,
// JEntry.
extern "C" void joint_sharded_sizes(int* out) {
  out[0] = (int)sizeof(JointArgs);
  out[1] = (int)sizeof(JCard);
  out[2] = (int)sizeof(JShardedArgs);
  out[3] = (int)sizeof(JEntry);
}

// The layouts the wrapper mirrors (ops/cuda_kernel.joint_sharded_layout)
// for a card of `rows` rows: out[0] the shared memory a CTA takes with its
// rows in it, out[1] the global-row scratch, out[2] the mailbox of `parts`
// participants.
extern "C" void joint_sharded_layout(int rows, int b, int with_shuffle,
                                     int ns, int clusters, int parts,
                                     long long* out) {
  out[0] = (long long)jsw_smem_bytes(rows, b, with_shuffle, ns, clusters);
  out[1] = (long long)jsw_global_bytes(rows, clusters, with_shuffle, ns);
  out[2] = (long long)jsw_mail_bytes(parts, b);
}

// Enqueues every card's launch; *launched counts those enqueued.
static cudaError_t run_wave(const JShardedArgs& a, cudaEvent_t* ev,
                            int* launched) {
  const int nc = a.n_cards;
  const int parts = nc * a.clusters;
  const int kx = nc > 1 ? X_SYS : a.clusters > 1 ? X_GPU : X_NONE;
  const bool global = a.card[0].rows != nullptr;
  if (nc > 1) CK(order_cards(a.card, nc, jsw_mail_bytes(parts, a.b), ev));
  for (int d = 0; d < nc; ++d) {
    const JCard& k = a.card[d];
    CK(cudaSetDevice(k.ordinal));
    int limit = 0, most = 0;
    CK(card_figures(&limit, &most));
    if (a.clusters > most) return cudaErrorCooperativeLaunchTooLarge;
    // a card's rows fit its plan: in shared memory, or in its scratch
    if (k.n_pos < 1 || k.n_pos > MAX_SHARDS || (global != (k.rows != 0)))
      return cudaErrorInvalidValue;
    const int rows = k.n_pos * a.n_loc;
    const size_t smem =
        global ? jsw_member_bytes(a.b)
               : jsw_smem_bytes(rows, a.b, a.with_shuffle, a.ns, a.clusters);
    if (smem > (size_t)limit) return cudaErrorInvalidValue;
    if (kx == X_GPU)
      CK(cudaMemsetAsync(k.mail, 0, jsw_mail_bytes(parts, a.b),
                         (cudaStream_t)k.stream));
    JWave w = {};
    w.n_glob = a.n_glob;
    w.n_loc = a.n_loc;
    w.n_cards = nc;
    w.card = d;
    w.n_pos = k.n_pos;
    w.clusters = a.clusters;
    w.absent = a.absent;
    w.spin_ns = a.spin_ns;
    w.pos = reinterpret_cast<const JointArgs*>(k.table);
    w.sm = reinterpret_cast<const int*>(
        k.table + (size_t)k.n_pos * sizeof(JointArgs) +
        MAX_SHARDS * sizeof(int));
    w.sl = w.sm + a.t;
    w.spc = k.spc;
    w.rows = k.rows;
    for (int c = 0; c < nc; ++c) w.mail[c] = a.card[c].mail;
    if (d == 0) {
      w.packed = a.packed;
      w.topk_idx = a.topk_idx;
      w.topk_scores = a.topk_scores;
    }
    cudaLaunchAttribute attr[2];
    cudaLaunchConfig_t cfg =
        launch_config(smem, a.clusters, (cudaStream_t)k.stream, attr);
    if (a.clusters > 1) {
      // every cluster resident at once, or no launch
      attr[1].id = cudaLaunchAttributeCooperative;
      attr[1].val.cooperative = 1;
      cfg.numAttrs = 2;
    }
    CK(cudaLaunchKernelEx(&cfg, kernels[kx * 2 + global], w));
    CK(cudaGetLastError());
    ++g_launches;
    ++*launched;
  }
  return cudaSuccess;
}

extern "C" int joint_sharded_wave_launch(const JShardedArgs* args) {
  const JShardedArgs& a = *args;
  if (a.n_cards < 1 || a.n_cards > MAX_CARDS || a.p > MAX_P || a.ns < 0 ||
      a.ns > MAX_S || a.n_loc < 1 || a.n_glob % a.n_loc != 0 ||
      a.n_glob / a.n_loc > MAX_SHARDS || a.t < 1 || a.b < 1 ||
      a.clusters < 1 || a.clusters > MAX_CLUSTERS ||
      a.n_cards * a.clusters > MAX_PARTS)
    return (int)cudaErrorInvalidValue;
  for (int d = 0; d < a.n_cards; ++d)
    if ((a.n_cards * a.clusters > 1 && !a.card[d].mail) ||
        (a.ns > 0 && !a.card[d].spc))
      return (int)cudaErrorInvalidValue;
  std::lock_guard<std::mutex> hold(g_enqueue);
  int prior = 0;
  cudaError_t e = cudaGetDevice(&prior);
  if (e != cudaSuccess) return (int)e;
  cudaEvent_t ev[MAX_CARDS] = {}, done[MAX_CARDS] = {};
  int launched = 0;
  e = run_wave(a, ev, &launched);
  // also after a launch failed on a later card: the earlier cards' kernels
  // still store into every card's mailbox
  if (a.n_cards > 1 && launched > 0) {
    const cudaError_t ej = join_cards(a.card, a.n_cards, launched, done);
    if (e == cudaSuccess) e = ej;
  }
  // an event destroyed while pending is released once it completes
  for (int d = 0; d < MAX_CARDS; ++d) {
    if (ev[d]) cudaEventDestroy(ev[d]);
    if (done[d]) cudaEventDestroy(done[d]);
  }
  const cudaError_t e2 = cudaSetDevice(prior);
  return (int)(e != cudaSuccess ? e : e2);
}

// out[0] cluster size, out[1] the dynamic shared memory a block may take,
// out[2] clusters the card holds at once (0: the launch would be refused),
// out[3] the most clusters a card takes (MAX_CLUSTERS), out[4] the most
// participants of a wave (MAX_PARTS).
extern "C" int joint_sharded_wave_plan(int* out) {
  int limit = 0, clusters = 0;
  const cudaError_t e = card_figures(&limit, &clusters);
  out[0] = CLUSTER;
  out[1] = limit;
  out[2] = clusters;
  out[3] = MAX_CLUSTERS;
  out[4] = MAX_PARTS;
  return (int)e;
}

// Kernel launches made so far, every card's.
extern "C" unsigned long long joint_sharded_wave_kernel_launches(void) {
  std::lock_guard<std::mutex> hold(g_enqueue);
  return g_launches;
}
