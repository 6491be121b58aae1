// Joint placement wave over a mesh of node shards, for NVIDIA Hopper
// (sm_90a), under any feature union: one thread-block cluster a card, one
// kernel launch a card a wave.
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
// of positions a card; each step's choice merged across the positions with
// the reference's cascade (largest value, lowest rank, lowest index), its
// pin rule and its top-k merge on (value desc, global index asc). Outputs:
// the packed buffer in ops/kernel.pack_fused_wave's layout, then one error
// word, and the top-k planes on the mesh's first card; the a_cpu / a_mem /
// a_disk carries on each position's own card.
//
// What bounds it. Counting each input byte once, the shards move the bytes
// of the one-device joint wave (chip_smoke.joint_bound); as for B1 and the
// joint kernel, that is not the floor that matters: a wave is a chain of T
// dependent N-wide argmaxes, each link one cluster barrier on a card and,
// over several cards, one exchange over NVLink.
//
// Design: csrc/sharded_wave.cu's (a card's rows are its positions' rows in
// position order, CTA c owns card rows [c*chunk, (c+1)*chunk), position
// tables map card rows to positions and global nodes, the mailbox exchange
// over cards with bounded waits) carrying csrc/joint_wave.cu's node parts
// (csrc/joint_node.cuh: partial sums before the spread term cached beside
// the row keys, a spread member's rows re-derived each step from the boost
// table, the spread counts held by every CTA). The position table holds
// one JointArgs a position (its leaves, carries and scratch, `n` its
// rows), so the node functions read a position's rows as joint_wave.cu
// reads the whole axis. What is new over either:
// - The spread bump over cards. A spread step's choice bumps one bucket of
//   each active stanza, and every CTA of every card holds the member's
//   counts; the chosen node's buckets live on the card that holds its row.
//   So each card's mailbox entry also carries its own argmax's buckets,
//   and the pin's when it holds the pin (one signed byte a stanza,
//   node_buckets); after the merge every CTA knows the chosen node's
//   buckets and bumps them at the member's next step, with no second
//   round trip. On one card every CTA reads them from L2.
// - The metrics: all eight, exhausted devices and cores too, reach the
//   root with the other partial sums.
// - Narrow shards: a position of fewer than TOPK rows is rows like any
//   other; the merged top-8 is the plain version's merge of each shard's
//   top min(TOPK, n_loc).
//
// Why a copy of the step rather than one step for the three kernels:
// joint_wave.cu's step reads one flat node range from its kernel
// parameters and its code generation is held unchanged (as B1's is under
// sharded_wave.cu); this step maps card rows through the position table,
// merges over cards and hands the buckets on. What holds no placement rule
// is shared: the node arithmetic (csrc/joint_node.cuh), the keys and warp
// reductions (csrc/wave_score.cuh), the slots, top-8 lists and launch
// helpers (csrc/cluster_wave.cuh), the exchange between cards
// (csrc/card_exchange.cuh).
//
// Shared memory a CTA: the position table (896 B a position), 13 B a card
// row of its range with shuffle (row key, rank, partial sum, count), 36 B
// a member; a card's rows fit up to 262144 (16384 a CTA) with a few
// positions, the one-device joint kernel's ceiling. Rows over it on one
// card raise before the launch.
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
#define NO_BUCKETS (-1)            // node_buckets' packing of "none"

static_assert(NWARPS >= 2 && NWARPS <= 32, "warps 0 and 1 have roles");
static_assert(NWARPS >= MAX_S, "one warp a stanza builds the boost table");
static_assert(CLUSTER <= 32, "a warp reduces the CTAs' slots");
static_assert(MAX_CARDS <= 32, "a warp's lanes poll the cards");

// One card's result for one step, in a slot of every card's mailbox.
struct __align__(16) JEntry {
  unsigned k, r;
  int i;
  float pin_v;      // the pin's masked value where the card holds it
  unsigned tk[TOPK];
  int ti[TOPK];
  int bk;           // its argmax's buckets (node_buckets), or NO_BUCKETS
  int pk;           // the pin's buckets where it holds the pin, else -1
  unsigned tag;     // step index + 1, written last
  int pad;
};
static_assert(sizeof(JEntry) == 96, "mirrored by cuda_kernel._JOINT_ENTRY");

// A card's mailbox: JEntry [2][n_cards] (by step parity, then sending
// card), then u32 mtag [n_cards], i32 merr [n_cards] and i32 msum
// [n_cards][N_MET B]. Mirrored by cuda_kernel._joint_mail_bytes.
__host__ __device__ inline size_t joint_mail_bytes(int n_cards, int b) {
  return (size_t)2 * n_cards * sizeof(JEntry) +
         (size_t)n_cards * (2 + N_MET * b) * sizeof(int);
}

// What one card's launch is given, by value. The shape (rows a position,
// members, steps, flags) is every position's JointArgs's.
struct JWave {
  int n_glob;           // global nodes: positions x rows a position
  int n_cards, card;    // cards in the mesh, this one (0: the root)
  int n_pos;            // mesh positions this card holds
  long long spin_ns;    // the longest wait on another card's tag
  const JointArgs* pos; // its positions (device), then their first global
                        // rows (g0), i32 [MAX_SHARDS], then the step maps
  const int* sm;        // i32 [T] each step's member (-1: padding)
  const int* sl;        // i32 [T] and its local step
  float* spc;           // f32 [CLUSTER, B, MAX_S, SB] counts scratch
  unsigned char* mail[MAX_CARDS];  // every card's mailbox (n_cards > 1)
  float* packed;        // the root: f32 [2T + 8B + 1], the last the error
  int* topk_idx;        // the root: i32 [T, TOPK]
  float* topk_scores;   // the root: f32 [T, TOPK]
};

__device__ __forceinline__ JEntry* jmail_entry(unsigned char* mail,
                                               int n_cards, int par, int c) {
  return reinterpret_cast<JEntry*>(mail) + par * n_cards + c;
}

__device__ __forceinline__ unsigned* jmail_mtag(unsigned char* mail,
                                                int n_cards) {
  return reinterpret_cast<unsigned*>(mail + 2 * n_cards * sizeof(JEntry));
}

// Dynamic shared memory a CTA takes: the card's position table, its
// range's rows (joint_row_bytes), the metric partial sums and a flag per
// member.
__host__ __device__ inline size_t joint_sharded_smem_bytes(int n_pos,
                                                           int n_loc, int b,
                                                           int with_shuffle) {
  const size_t chunk = (size_t)((n_pos * n_loc + CLUSTER - 1) / CLUSTER);
  const size_t c4 = (chunk + 3) & ~(size_t)3;
  return (size_t)n_pos * sizeof(JointArgs) +
         joint_row_bytes(c4, with_shuffle) +
         (size_t)b * (N_MET + 1) * sizeof(int);
}

// kMulti: the mesh spans several cards (the mailbox exchange is compiled
// in); one card's kernel has none of it.
template <bool kMulti>
__global__ void __launch_bounds__(THREADS, 1)
    joint_sharded_kernel(const JWave w) {
  extern __shared__ __align__(16) unsigned char dyn_smem[];
  __shared__ Slot slot[2];             // this CTA's argmax, by step parity
  __shared__ TopList top_list[2];      // this CTA's top-8, by step parity
  __shared__ TopList card_top;         // CTA 0: the card's top-8 (cards)
  __shared__ Best sh_best[NWARPS];
  __shared__ unsigned sh_tk[NWARPS][TOPK];  // each warp's top-8 list
  __shared__ int sh_ti[NWARPS][TOPK];
  __shared__ unsigned sh_dirty;  // warps whose row entries the step changed
  __shared__ JMember sh_member;
  __shared__ float counts[MAX_S][SB];   // the current member's counts
  __shared__ float desired[MAX_S][SB];  // and its desired counts
  __shared__ float boost[MAX_S][SB];    // this step's boost per bucket
  __shared__ int sh_lp[MAX_SHARDS];  // mesh position -> its index here, -1
  __shared__ int sh_g0[MAX_SHARDS];  // index here -> its first global row
  __shared__ int sh_err;             // this CTA waited past the bound
  __shared__ int sh_mask;            // the root's CTA 0: the cards at fault

  cg::cluster_group cluster = cg::this_cluster();
  const int cta = (int)cluster.block_rank();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  JointArgs* pos = reinterpret_cast<JointArgs*>(dyn_smem);
  {
    // the card's position table, read at every node access
    const int4* src4 = reinterpret_cast<const int4*>(w.pos);
    int4* dst4 = reinterpret_cast<int4*>(pos);
    for (int q = tid; q < w.n_pos * (int)(sizeof(JointArgs) / 16);
         q += THREADS)
      dst4[q] = __ldg(src4 + q);
  }
  for (int q = tid; q < MAX_SHARDS; q += THREADS) sh_lp[q] = -1;
  if (tid == 0) sh_err = 0;
  __syncthreads();
  {
    const int* g0s = reinterpret_cast<const int*>(w.pos + w.n_pos);
    const int n_loc0 = pos[0].n;
    for (int lp = tid; lp < w.n_pos; lp += THREADS) {
      const int g0 = __ldg(g0s + lp);
      sh_g0[lp] = g0;
      sh_lp[g0 / n_loc0] = lp;
    }
  }
  const JointArgs& s = pos[0];  // the shape, and the card's copy of every
                                // leaf that is not a node plane
  const int n_loc = s.n, n_glob = w.n_glob, nb = s.b;
  const int rows = w.n_pos * n_loc;
  const int chunk = (rows + CLUSTER - 1) / CLUSTER;
  const int c4 = (chunk + 3) & ~3;
  const int lo = min(cta * chunk, rows), hi = min(lo + chunk, rows);
  const int cnt = hi - lo;
  constexpr bool multi = kMulti;  // else one card holds every position
  const bool root = w.card == 0;
  unsigned* row = reinterpret_cast<unsigned*>(pos + w.n_pos);
  unsigned* rank = row + c4;
  float* rsum = reinterpret_cast<float*>(rank + (s.with_shuffle ? c4 : 0));
  unsigned char* rcnt = reinterpret_cast<unsigned char*>(rsum + c4);
  int* part = reinterpret_cast<int*>(rcnt + c4);
  int* seen = part + nb * N_MET;
  float* my_spc = w.spc + (long long)cta * nb * MAX_S * SB;


  // card row of global node g (-1: out of range, or on another card)
  auto row_of = [&](int g) -> int {
    if (g < 0 || g >= n_glob) return -1;
    if (!multi) return g;
    const int q = g / n_loc, lp = sh_lp[q];
    return lp < 0 ? -1 : lp * n_loc + (g - q * n_loc);
  };
  // global node of card row r
  auto global_of = [&](int r) -> int {
    if (!multi) return r;
    const int lp = r / n_loc;
    return sh_g0[lp] + (r - lp * n_loc);
  };
  // member m's buckets at card row r (node_buckets), or NO_BUCKETS
  auto row_buckets = [&](const JMember& v, int m, int r) -> int {
    if (r < 0 || !v.spread) return NO_BUCKETS;
    const int lp = r / n_loc;
    return node_buckets(pos[lp], v, m, r - lp * n_loc);
  };

  // ---- pre-wave: zero the carries, the partial sums and the flags; the
  // root's idle outputs ----
  for (int seg = lo; seg < hi;) {
    const int lp = seg / n_loc, base = lp * n_loc;
    const int end = min(hi, base + n_loc);
    const JointArgs& p = pos[lp];
    for (int r = seg + tid; r < end; r += THREADS) {
      const int x = r - base;
      p.a_cpu[x] = 0.0f;
      p.a_mem[x] = 0.0f;
      p.a_disk[x] = 0.0f;
      if (p.with_ports) p.a_dyn[x] = 0;
      if (p.with_cores) p.a_cores[x] = 0;
      if (p.with_network) p.a_mbits[x] = 0;
      if (p.with_devices)
        for (int q = 0; q < MAX_D; ++q)
          p.a_dev[(long long)x * MAX_D + q] = 0.0f;
    }
    seg = end;
  }
  for (int x = tid; x < nb * (N_MET + 1); x += THREADS) part[x] = 0;
  if (root && cta == 0) {
    // an inactive step scores an all-NEG_INF plane: nothing found, the
    // top-k of the plain version's stable sort; active steps overwrite
    for (int t = tid; t < s.t; t += THREADS) {
      w.packed[t] = -1.0f;
      w.packed[s.t + t] = 0.0f;
      for (int q = 0; q < TOPK; ++q) {
        w.topk_idx[t * TOPK + q] = s.with_topk ? q : 0;
        w.topk_scores[t * TOPK + q] = NEG_INF_F;
      }
    }
  }
  __syncthreads();

  // the CTAs' top-8 lists of parity pp, merged (a warp of CTA 0)
  auto cta_top = [&](int pp, unsigned* ok, int* oi) {
    cluster_top<CLUSTER>(cluster, &top_list[pp], s.with_topk, lane, ok, oi);
  };
  // the root's CTA 0, warp 1: the wave's top-8 of active step t, from the
  // CTAs' lists (one card) or the cards' entries (several) of parity pp,
  // written before a barrier already passed
  auto emit_topk = [&](int pp, int t) {
    unsigned ok[TOPK];
    int oi[TOPK];
    if (!multi) {
      cta_top(pp, ok, oi);
    } else {
      unsigned lk[TOPK];
      int li[TOPK];
      list_clear(lk, li);
      list_clear(ok, oi);
      if (s.with_topk && lane < w.n_cards) {
        // this warp acquires the tags itself: warp 0 may still be waiting
        // for them (nothing orders the two warps between the steps)
        const JEntry* e = jmail_entry(w.mail[w.card], w.n_cards, pp, lane);
        if (!*reinterpret_cast<volatile int*>(&sh_err) &&
            !wait_tag(&e->tag, (unsigned)t + 1u, w.spin_ns))
          sh_err = 1;
#pragma unroll
        for (int q = 0; q < TOPK; ++q) {
          lk[q] = __ldcg(&e->tk[q]);
          li[q] = __ldcg(&e->ti[q]);
        }
      }
      if (s.with_topk) warp_top(lk, li, ok, oi);
    }
    write_topk(ok, oi, lane, t, s.with_topk, w.topk_idx, w.topk_scores);
  };
  // the calling warp's sorted top-8 of its rows (x = warp*32 + lane +
  // k*THREADS), on card rows, into sh_tk/sh_ti[warp]
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
  int pend_g = -1;     // warp 0: its global node (-1: nothing chosen)
  int pbk = NO_BUCKETS;  // warp 0: its buckets, not bumped yet
  int par = 0;         // parity of the active step (slots, mailbox)
  int t_prev = -1;     // step index of the last active step
  int restore_x = -1;  // row entry a special thread puts back next step
  unsigned restore_k = 0, restore_c = 0;
  float restore_s = 0.0f;
  int pf_t = -1;        // warp 0: step whose nodes are loaded
  int pf_s[MAX_P + 1];  // warp 0: its penalty nodes, then its pin (global)
  bool dead = false;    // warp 0: a wait ran past the bound; wait no more
  for (int t0 = 0; t0 < s.t; t0 += 32) {
    // which of the next 32 steps place: the reference's rule (a member,
    // and a local step under its count); every warp finds the same mask
    const int ts = t0 + lane;
    int mem_raw = -1, j_raw = 0;
    bool act = false;
    if (ts < s.t) {
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
      const int j = min(max(__shfl_sync(FULL_MASK, j_raw, l), 0), s.k - 1);

      // a new member: commit the last one's pending placement (its carries
      // in the owner CTA, its spread bump in every CTA), swap the members'
      // counts, then rebuild the row and the partial sums over this CTA's
      // range (at its first appearance also copying its scratch and
      // counting its metrics)
      if (m != row_m) {
        const bool first = seen[m] == 0;
        if (tid == 0) {
          if (row_m >= 0 && pend_g >= 0) {
            const JMember old = sh_member;
            if (pend >= lo && pend < hi) {
              const int lp = pend / n_loc, x = pend - lp * n_loc;
              JNode d = load_node(pos[lp], row_m, x, false);
              commit_node(pos[lp], old, row_m, x, d);
            }
            if (old.spread)
              for (int st = 0; st < MAX_S; ++st)
                if (old.sp_active[st]) bump_packed(pbk, st, counts);
          }
          sh_member = load_member(s, m);
        }
        pend = -1;
        pend_g = -1;
        pbk = NO_BUCKETS;
        restore_x = -1;  // the row is rebuilt
        __syncthreads();
        if (s.ns > 0) {
          const float* in_c = leaf_of<float>(s, J_SP_COUNTS, m);
          const float* in_d = leaf_of<float>(s, J_SP_DESIRED, m);
          for (int x = tid; x < s.ns * SB; x += THREADS) {  // the ns rows
            float* c = &counts[0][0] + x;
            if (row_m >= 0) my_spc[(long long)row_m * MAX_S * SB + x] = *c;
            *c = first ? in_c[x] : my_spc[(long long)m * MAX_S * SB + x];
            (&desired[0][0])[x] = in_d[x];
          }
        }
        const JMember v = sh_member;
        const long long row0 = (long long)m * n_loc;
        int c[N_MET] = {0, 0, 0, 0, 0, 0, 0, 0};
        for (int seg = lo; seg < hi;) {
          const int lp = seg / n_loc, base = lp * n_loc;
          const int end = min(hi, base + n_loc);
          const JointArgs& p = pos[lp];
          for (int r = seg + tid; r < end; r += THREADS) {
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
          }
          seg = end;
        }
        if (first) {
#pragma unroll
          for (int q = 0; q < N_MET; ++q) {
            const int sum = __reduce_add_sync(FULL_MASK, c[q]);
            if (lane == 0 && sum != 0) atomicAdd(&part[m * N_MET + q], sum);
          }
        }
        const int pm = s.bp > 1 ? m : 0;
        if (s.with_shuffle && pm != rank_m) {
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
      // kernel), with the partial sums kept beside the row; lanes
      // BUMP_LANE.. of every CTA's warp 0 add the pending placement's
      // spread bump from the buckets the last step handed on. Meanwhile
      // the root's CTA 0 warp 1 writes out the last active step's top-k.
      int pcl = -1;   // warp 0: the step's pin (global, clamped), or -1
      int prow = -1;  // warp 0: its card row, or -1
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
              min(max(__shfl_sync(FULL_MASK, j_raw, nl), 0), s.k - 1), pf_s);
        }
        if (mspread && pend_g >= 0 && lane >= BUMP_LANE &&
            lane < BUMP_LANE + MAX_S && sh_member.sp_active[lane - BUMP_LANE])
          bump_packed(pbk, lane - BUMP_LANE, counts);
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
            const JMember v = sh_member;
            const int lp = q / n_loc, xl = q - lp * n_loc;
            const JointArgs& p = pos[lp];
            JNode d = load_node(p, m, xl, false);
            float rs;
            unsigned rc;
            if (q == pend) {
              commit_node(p, v, m, xl, d);
              node_rest(p, v, d, d.pen, rs, rc);
              rsum[x] = rs;
              rcnt[x] = (unsigned char)rc;
              row[x] = final_key(rs, rc, 0.0f);
            }
            if (is_pen) {
              restore_x = x;
              restore_k = row[x];
              restore_s = rsum[x];
              restore_c = rcnt[x];
              node_rest(p, v, d, true, rs, rc);
              rsum[x] = rs;
              rcnt[x] = (unsigned char)rc;
              row[x] = final_key(rs, rc, 0.0f);
            }
            mark(x);
          }
        }
      } else if (warp == 1 && cta == 0 && root && t_prev >= 0) {
        emit_topk(par ^ 1, t_prev);
      }
      __syncthreads();

      // a spread member: the step's boost per (stanza, bucket), one warp a
      // stanza (ops/kernel._spread_score on the bucket axis)
      if (mspread) {
        if (warp < s.ns && sh_member.sp_active[warp])
          build_boost(sh_member, warp, lane, counts, desired, boost);
        __syncthreads();
      }

      // every warp: its argmax over its row entries (re-deriving them for
      // a spread member), and its top-8 list when the step made it stale
      {
        unsigned bk = PAD_KEY, br = NO_RANK;
        int bi = NO_NODE;
        for (int x = tid; x < cnt; x += THREADS) {
          unsigned k;
          if (mspread) {
            const int r = lo + x, lp = r / n_loc, xl = r - lp * n_loc;
            float sp = 0.0f;
            for (int st = 0; st < s.ns; ++st) {
              if (!sh_member.sp_active[st]) continue;
              const int b = node_bucket(pos[lp], m, xl, st);
              sp = sp + (b < 0 ? -1.0f : boost[st][b]);
            }
            k = final_key(rsum[x], rcnt[x], sp);
            row[x] = k;
          } else {
            k = row[x];
          }
          const unsigned r = s.with_shuffle ? rank[x] : (unsigned)(lo + x);
          if (k > bk || (k == bk && r < br)) {
            bk = k;
            br = r;
            bi = lo + x;
          }
        }
        warp_best(bk, br, bi);
        if (lane == 0) sh_best[warp] = Best{bk, br, bi};
        if (s.with_topk && (mspread || ((sh_dirty >> warp) & 1u)))
          warp_list();
      }
      __syncthreads();

      // this CTA's argmax (warp 0, with the pin's step value read from the
      // row, its spread term included) and top-8 (warp 1) into its slots,
      // on global indices and ranks
      if (warp == 0) {
        Best b = {PAD_KEY, NO_RANK, NO_NODE};
        if (lane < NWARPS) b = sh_best[lane];
        warp_best(b.k, b.r, b.i);
        if (lane == 0) {
          if (b.i != NO_NODE) {
            b.i = global_of(b.i);
            if (!s.with_shuffle) b.r = (unsigned)b.i;
          }
          slot[par] = Slot{b.k, b.r, b.i,
                           (prow >= lo && prow < hi) ? key_score(row[prow - lo])
                                                     : NEG_INF_F};
        }
      } else if (warp == 1) {
        if (s.with_topk) {
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

      // several cards: CTA 0's warp 1 merges the card's top-8 for the entry
      if (multi && cta == 0 && warp == 1) {
        unsigned ok[TOPK];
        int oi[TOPK];
        cta_top(par, ok, oi);
#pragma unroll
        for (int q = 0; q < TOPK; ++q)
          if (q == lane) {
            card_top.k[q] = ok[q];
            card_top.i[q] = oi[q];
          }
        asm volatile("bar.sync 1, 64;" ::: "memory");  // with warp 0
      }
      // warp 0 of every CTA: the card's argmax from the CTAs' slots, then
      // (several cards) the wave's from the cards' entries, and the chosen
      // node's buckets
      if (warp == 0) {
        Best b = {PAD_KEY, NO_RANK, NO_NODE};
        float pin_v = NEG_INF_F;
        if (lane < CLUSTER) {
          const Slot sl = *cluster.map_shared_rank(&slot[par], lane);
          b = Best{sl.k, sl.r, sl.i};
          pin_v = sl.pin_v;
        }
        warp_best(b.k, b.r, b.i);
        // the pin's value from the CTA that holds it (NEG_INF: elsewhere)
        float pv = __shfl_sync(FULL_MASK, pin_v, prow >= 0 ? prow / chunk : 0);
        if (prow < 0) pv = NEG_INF_F;
        int bkw = NO_BUCKETS, pkw = NO_BUCKETS;
        if (multi) {
          if (cta == 0) {
            asm volatile("bar.sync 1, 64;" ::: "memory");  // card_top ready
            const JMember v = sh_member;
            const int bkc = row_buckets(
                v, m, b.i == NO_NODE ? -1 : row_of(b.i));
            const int pkc = row_buckets(v, m, prow);
            // a card that has given up pushes nothing more
            if (lane < w.n_cards && !dead) {
              JEntry* e = jmail_entry(w.mail[lane], w.n_cards, par, w.card);
              e->k = b.k;
              e->r = b.r;
              e->i = b.i;
              e->pin_v = pv;
#pragma unroll
              for (int q = 0; q < TOPK; ++q) {
                e->tk[q] = card_top.k[q];
                e->ti[q] = card_top.i[q];
              }
              e->bk = bkc;
              e->pk = pkc;
              __threadfence_system();
              st_release(&e->tag, (unsigned)t + 1u);
            }
          }
          bool ok = true;
          Best g = {PAD_KEY, NO_RANK, NO_NODE};
          float gpv = NEG_INF_F;
          int gbk = NO_BUCKETS, gpk = NO_BUCKETS;
          if (lane < w.n_cards) {
            const JEntry* e =
                jmail_entry(w.mail[w.card], w.n_cards, par, lane);
            if (!dead) ok = wait_tag(&e->tag, (unsigned)t + 1u, w.spin_ns);
            g = Best{__ldcg(&e->k), __ldcg(&e->r), __ldcg(&e->i)};
            gpv = __ldcg(&e->pin_v);
            gbk = __ldcg(&e->bk);
            gpk = __ldcg(&e->pk);
          }
          if (__any_sync(FULL_MASK, !ok)) {
            dead = true;
            if (lane == 0) sh_err = 1;
          }
          // the cascade: largest value, then lowest rank (ranks are
          // distinct); the winning card's buckets come with it
          const Best mine = g;
          warp_best(g.k, g.r, g.i);
          const unsigned hit = __ballot_sync(
              FULL_MASK, lane < w.n_cards && mine.k == g.k && mine.r == g.r);
          bkw = __shfl_sync(FULL_MASK, gbk, hit ? __ffs(hit) - 1 : 0);
          // the pin's buckets from the card that holds it: every other
          // card hands on NO_BUCKETS, all bits set
          pkw = (int)__reduce_and_sync(FULL_MASK, (unsigned)gpk);
#pragma unroll
          for (int off = 16; off > 0; off >>= 1)
            gpv = fmaxf(gpv, __shfl_xor_sync(FULL_MASK, gpv, off));
          b = g;
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
        if (root && cta == 0 && lane == 0) {
          w.packed[t] = found ? (float)idx : -1.0f;
          w.packed[s.t + t] = found ? val : 0.0f;
        }
        pend = found ? row_of(idx) : -1;
        pend_g = found ? idx : -1;
        if (!found)
          pbk = NO_BUCKETS;
        else if (multi)
          pbk = pinned ? pkw : bkw;
        else
          pbk = row_buckets(sh_member, m, pend);
      }
      par ^= 1;
      t_prev = t;
    }
  }

  // ---- tail: the last placement, the metrics, the last top-k ----
  if (tid == 0 && pend >= lo && pend < hi) {
    const int lp = pend / n_loc, x = pend - lp * n_loc;
    JNode d = load_node(pos[lp], row_m, x, false);
    commit_node(pos[lp], sh_member, row_m, x, d);
  }
  for (int m = 0; m < nb; ++m) {
    if (seen[m]) continue;  // counted at its first row pass
    const JMember v = load_member(s, m);
    int c[N_MET] = {0, 0, 0, 0, 0, 0, 0, 0};
    for (int seg = lo; seg < hi;) {
      const int lp = seg / n_loc, base = lp * n_loc;
      const int end = min(hi, base + n_loc);
      for (int r = seg + tid; r < end; r += THREADS)
        count_metrics(pos[lp], v, load_node(pos[lp], m, r - base, true), c);
      seg = end;
    }
#pragma unroll
    for (int q = 0; q < N_MET; ++q) {
      const int sum = __reduce_add_sync(FULL_MASK, c[q]);
      if (lane == 0 && sum != 0) atomicAdd(&part[m * N_MET + q], sum);
    }
  }
  cluster.sync();  // every CTA's partial sums and error flag ready
  if (cta == 0) {
    if (root && warp == 1 && t_prev >= 0) emit_topk(par ^ 1, t_prev);
    const int nbm = nb * N_MET;
    // this card's error flag: any of its CTAs waited past the bound
    int card_err = 0;
    if (warp == 0)
      card_err = __ballot_sync(FULL_MASK,
                               lane < CLUSTER &&
                                   *cluster.map_shared_rank(&sh_err, lane)) !=
                 0;
    if (multi && !root) {
      // the card's partial sums and flag into the root's mailbox
      unsigned* mtag = jmail_mtag(w.mail[0], w.n_cards);
      int* merr = reinterpret_cast<int*>(mtag + w.n_cards);
      int* msum = merr + w.n_cards + w.card * nbm;
      for (int x = tid; x < nbm; x += THREADS) {
        int sum = 0;
        for (int c = 0; c < CLUSTER; ++c)
          sum += cluster.map_shared_rank(part, c)[x];
        msum[x] = sum;
      }
      if (tid == 0) merr[w.card] = card_err;
      __threadfence_system();
      __syncthreads();
      if (tid == 0) st_release(&mtag[w.card], 1u);
    } else if (root) {
      if (warp == 0) {
        // several cards: every other card's sums, for at most the bound
        bool late = false, bad = false;
        if (multi && lane >= 1 && lane < w.n_cards) {
          unsigned* mtag = jmail_mtag(w.mail[0], w.n_cards);
          const int* merr = reinterpret_cast<const int*>(mtag + w.n_cards);
          late = dead || !wait_tag(&mtag[lane], 1u, w.spin_ns);
          bad = late || __ldcg(&merr[lane]) != 0;
        }
        const unsigned cards = __ballot_sync(FULL_MASK, bad);
        if (lane == 0) sh_mask = (int)(cards | (card_err ? 1u : 0u));
      }
      __syncthreads();
      float* metrics = w.packed + 2 * s.t;
      const int* msum = nullptr;
      if (multi) {
        unsigned* mtag = jmail_mtag(w.mail[0], w.n_cards);
        msum = reinterpret_cast<const int*>(mtag + w.n_cards) + w.n_cards;
      }
      for (int x = tid; x < nbm; x += THREADS) {
        int sum = 0;
        for (int c = 0; c < CLUSTER; ++c)
          sum += cluster.map_shared_rank(part, c)[x];
        for (int c = 1; c < w.n_cards; ++c) sum += __ldcg(&msum[c * nbm + x]);
        metrics[(x % N_MET) * nb + x / N_MET] = (float)sum;
      }
      if (tid == 0) w.packed[2 * s.t + N_MET * nb] = (float)sh_mask;
    }
  }
  cluster.sync();  // no CTA leaves while another may read its shared memory
}

// ---- the host side ----

// The dynamic shared memory a block may take on the current device, after
// setting the kernel's attributes there (once per device).
static int g_limit[MAX_DEVICES];  // 0: attributes not set yet

static cudaError_t smem_limit(int* limit) {
  void (*const kernels[])(const JWave) = {joint_sharded_kernel<false>,
                                          joint_sharded_kernel<true>};
  return cluster_smem_limit(kernels, g_limit, limit);
}

static cudaLaunchConfig_t launch_config(size_t smem, cudaStream_t stream,
                                        cudaLaunchAttribute* attr) {
  return cluster_launch_config<CLUSTER, THREADS>(smem, stream, attr);
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
  unsigned char* mail;    // its mailbox (several cards), else null
  float* spc;             // its counts scratch (spreads), else null
};

// Mirrored by nomad_tpu_torch/ops/cuda_kernel._JShardedArgs. The shape
// repeats the positions' JointArgs (which lie on the cards) for the host.
struct JShardedArgs {
  int n_glob, n_loc, n_cards;
  int b, t, p, ns, with_shuffle;
  const JCard* card;      // host array, the root first
  float* packed;          // f32 [2T + 8B + 1] on the root
  int* topk_idx;          // i32 [T, TOPK] on the root
  float* topk_scores;     // f32 [T, TOPK] on the root
  long long spin_ns;      // the longest wait on another card's tag
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

// Enqueues every card's launch; *launched counts those enqueued.
static cudaError_t run_wave(const JShardedArgs& a, cudaEvent_t* ev,
                            int* launched) {
  const int nc = a.n_cards;
  const bool multi = nc > 1;
  if (multi) CK(order_cards(a.card, nc, joint_mail_bytes(nc, a.b), ev));
  for (int d = 0; d < nc; ++d) {
    const JCard& k = a.card[d];
    CK(cudaSetDevice(k.ordinal));
    int limit = 0;
    CK(smem_limit(&limit));
    const size_t smem =
        joint_sharded_smem_bytes(k.n_pos, a.n_loc, a.b, a.with_shuffle);
    if (smem > (size_t)limit) return cudaErrorInvalidValue;
    JWave w = {};
    w.n_glob = a.n_glob;
    w.n_cards = nc;
    w.card = d;
    w.n_pos = k.n_pos;
    w.spin_ns = a.spin_ns;
    w.pos = reinterpret_cast<const JointArgs*>(k.table);
    w.sm = reinterpret_cast<const int*>(
        k.table + (size_t)k.n_pos * sizeof(JointArgs) +
        MAX_SHARDS * sizeof(int));
    w.sl = w.sm + a.t;
    w.spc = k.spc;
    for (int c = 0; c < nc; ++c) w.mail[c] = a.card[c].mail;
    if (d == 0) {
      w.packed = a.packed;
      w.topk_idx = a.topk_idx;
      w.topk_scores = a.topk_scores;
    }
    cudaLaunchAttribute attr[1];
    cudaLaunchConfig_t cfg =
        launch_config(smem, (cudaStream_t)k.stream, attr);
    void (*kernel)(const JWave) =
        multi ? joint_sharded_kernel<true> : joint_sharded_kernel<false>;
    CK(cudaLaunchKernelEx(&cfg, kernel, w));
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
      a.n_glob / a.n_loc > MAX_SHARDS || a.t < 1 || a.b < 1)
    return (int)cudaErrorInvalidValue;
  for (int d = 0; d < a.n_cards; ++d)
    if (a.card[d].n_pos < 1 || (a.n_cards > 1 && !a.card[d].mail) ||
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

// out[0] cluster size, out[1] dynamic shared memory a card of `n_pos`
// positions of `n_loc` rows needs, out[2] the most a block may take, out[3]
// clusters of that shape the current card can hold at once (0: the launch
// would be refused).
extern "C" int joint_sharded_wave_plan(int n_pos, int n_loc, int b,
                                       int with_shuffle, int* out) {
  int limit = 0;
  cudaError_t e = smem_limit(&limit);
  if (e != cudaSuccess) return (int)e;
  const size_t smem = joint_sharded_smem_bytes(n_pos, n_loc, b, with_shuffle);
  out[0] = CLUSTER;
  out[1] = (int)smem;
  out[2] = limit;
  out[3] = 0;
  if (smem > (size_t)limit) return 0;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = launch_config(smem, 0, attr);
  int clusters = 0;
  e = cudaOccupancyMaxActiveClusters(&clusters, joint_sharded_kernel<true>,
                                     &cfg);
  out[3] = clusters;
  return (int)e;
}

// Kernel launches made so far, every card's.
extern "C" unsigned long long joint_sharded_wave_kernel_launches(void) {
  std::lock_guard<std::mutex> hold(g_enqueue);
  return g_launches;
}
