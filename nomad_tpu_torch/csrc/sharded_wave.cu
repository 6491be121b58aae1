// Fused placement wave over a mesh of node shards, for NVIDIA Hopper
// (sm_90a): one thread-block cluster a card, one kernel launch a card a
// wave.
//
// Replaces: nomad_tpu/parallel/sharded.py `_fused_sharded_core` (:291-505),
// the per-shard body that `fused_sharded_entry` (:507) runs under
// shard_map: an XLA program, no Pallas. It computes, for each node shard,
// what that body computes (the fused envelope: ports, step penalties,
// preferred pins, distinct_hosts, shuffle, top-k), merges each step across
// the shards with its pmax / pmin / pmin cascade (:390-396), its pin rule
// (:397-406) and its all_gather top-k merge (:412-423), and returns its
// outputs: the packed buffer in ops/kernel.pack_fused_wave's layout (and
// one trailing error word) and the top-k planes on the mesh's first card,
// the a_cpu/a_mem/a_disk carries on each shard's own card. Its plain
// version is nomad_tpu_torch/parallel/sharded._sharded_wave.
//
// What bounds it. Counting each input byte once, the live wave (B=32
// members, N=16384 nodes, T=512 steps) moves the bytes of the unsharded
// wave, ~10 MB: 3.19 us at 3.35 TB/s (25.4 us at N=131072); its operations
// take less. As for B1 (csrc/fused_wave.cu), neither is the floor that
// matters: step t+1's feasibility depends on step t's choice, so a wave is
// a chain of T dependent N-wide argmaxes. Each link here is one cluster
// barrier on a card and, over several cards, one exchange over NVLink.
//
// Starting point (the first design): a step launch on every card and a
// one-warp merge launch on the root for each active step, stepped from the
// host in C, every row rescored at every step, slots and winners moved by
// cudaMemcpyPeerAsync between events: ~645 launches a live wave, 6.01 /
// 6.24 / 6.42 ms at D = 2 / 4 / 8 virtual shards and 9.58 ms at N=131072,
// D=8 on an NVIDIA H100 80GB HBM3 at 700 W, ~19-21 us an active step where
// B1 takes 4.6.
//
// Design. One launch a card: a cluster of CLUSTER CTAs of THREADS threads.
// - A card's rows are its mesh positions' rows concatenated in position
//   order: card row r is row r % n_loc of its (r / n_loc)-th position, the
//   global node g0 + r % n_loc of that position. CTA c owns the card rows
//   [c*chunk, (c+1)*chunk); a range may cross a position boundary, and the
//   row passes walk it one position segment at a time. Positions ascend
//   within a card, so card-row order is global-index order: a CTA ranks
//   and breaks top-8 ties on card rows and hands global indices on. On one
//   card, a virtual mesh of any D is one cluster over N rows: B1's shape.
// - B1's step inside the cluster. Each CTA keeps its rows' masked score
//   keys (and shuffle ranks, built in-kernel from the permutation) in
//   shared memory, built at the member's first step; at the member's first
//   appearance the same pass copies its per-member scratch and counts its
//   metric partials. After that a step rescores only the committed node,
//   its penalty nodes and the pin. Argmax on (key desc, rank asc), top-8 on
//   (key desc, index asc); one cluster.sync() a step, after which every
//   CTA reduces the CTAs' argmax slots through DSMEM. Only active steps
//   run, found 32 steps at a time from the step maps by one ballot (the
//   reference's rule: a member, and a local step under its count); CTA 0
//   of the root writes every step's idle outputs first.
//   This is a copy of B1's step, not a shared one: B1 addresses one flat
//   node range through its argument struct, this kernel maps card rows
//   through position tables, and sharing the body would template B1's
//   kernel on the addressing, whose code generation is held unchanged.
// - Several cards (n_cards > 1). After the cluster barrier, CTA 0 of each
//   card pushes the card's result for the step (argmax key, rank and
//   index, the pin's masked value, the card's top-8) into a slot of every
//   card's mailbox, its own included: peer stores over NVLink, slots
//   double-buffered by step parity, the tag (step index + 1) written last
//   with a system-scope release after __threadfence_system(). Every CTA's
//   warp 0 then polls its own card's mailbox with system-scope acquire
//   loads until every card's tag reads the step, and reduces the entries
//   with the same cascade and pin rule, so every CTA of every card computes
//   the same winner and no second round trip is needed. A card rewrites a
//   slot two steps later only after it has read every card's next entry,
//   which each card posts only after all its CTAs passed the barrier that
//   follows their reads. The root writes the step's outputs; its warp that
//   writes a step's top-k (during the next step) acquires the tags itself,
//   as nothing orders it after warp 0's wait. At the end the cards' metric
//   partials and error flags reach the root's mailbox. The one-card kernel
//   is compiled apart (kMulti = false) and has none of this.
// - No unbounded spin: a wait on another card's tag gives up after
//   spin_ns (ops/cuda_kernel.SPIN_S, 5 s), sets the CTA's error flag and
//   waits no more; the card's CTA 0 then pushes no more step entries, so
//   the other cards give up at their next wait. The flags reach the root,
//   which writes the mask of the cards at fault into the error word after
//   the packed buffer; the launcher raises on it after its packed readback.
// - Host: one C call enqueues every card's launch. The wrapper copies each
//   card's position table and the step maps up from pinned memory on its
//   current stream (nothing is read back before the launch), and a CTA
//   keeps the table in shared memory. Over several cards each mailbox is
//   zeroed on its own stream, and each card's stream waits on every other
//   card's work enqueued before this wave (mailbox memory may be memory
//   that work still uses), never on an event recorded after a launch of
//   the wave before its own launch. Once every launch is enqueued (or one
//   failed), every card's stream waits on the end of every card's kernel
//   that was launched: a mailbox takes peer stores until the last of them
//   ends (a late card's, after a wait ran past the bound, too), and the
//   wrapper frees it, as every buffer, in its own card's stream order.
//   Where those waits cannot be enqueued, the host waits for the launched
//   kernels instead. A process-wide lock keeps the waves in one order on
//   every card. Peer access is enabled once per pair of cards
//   (sharded_wave_enable_peers); a pair without it raises.
// - Exactness: the feasibility and score come from csrc/wave_score.cuh,
//   shared with B1, under B1's build flags (-fmad=false, no fast-math, the
//   fit scaled by the f32 reciprocal of 18), so a cached score, a fresh
//   one, B1's and the plain version's on the card are the same bits. The
//   slots, the rank loader, the top-8 lists and the launch helpers are
//   B1's too (csrc/cluster_wave.cuh); the acquire and release accesses,
//   the bounded wait and the host's ordering and joining of the cards are
//   shared with the joint sharded kernel (csrc/card_exchange.cuh).
//
// Built by nomad_tpu_torch/ops/build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xptxas -v
//        -fmad=false -shared -Xcompiler -fPIC

#include <cooperative_groups.h>

#include <mutex>

#include "card_exchange.cuh"
#include "cluster_wave.cuh"

namespace cg = cooperative_groups;

#define CLUSTER 16
#define THREADS 512
#define NWARPS (THREADS / 32)
#define MAX_P 4                    // MAX_PENALTY_NODES
#define N_SPECIAL (MAX_P + 2)      // pending commit, penalty nodes, pin
#define ROW_UNROLL 2               // rows a thread loads at once (row pass)
#define ALL_WARPS (FULL_MASK >> (32 - NWARPS))
#define MAX_CARDS 8
#define MAX_SHARDS 64              // mesh positions
#define MAX_DEVICES 64

static_assert(NWARPS >= 2 && NWARPS <= 32, "warps 0 and 1 have roles");
static_assert(CLUSTER <= 32, "a warp reduces the CTAs' slots");
static_assert(MAX_CARDS <= 32, "a warp's lanes poll the cards");

// One mesh position: its leaves (node planes hold its rows, every other
// leaf is its card's copy), its carries and its per-member scratch.
// Mirrored by nomad_tpu_torch/ops/cuda_kernel._Pos.
struct Pos {
  const void* leaf[N_LEAVES];
  float* a_cpu;         // f32 [n_loc] outputs: the wave's carry on its rows
  float* a_mem;
  float* a_disk;
  int* a_dyn;           // i32 [n_loc] scratch (with_ports)
  int* jtc;             // i32 [B, n_loc] scratch
  int* jac;             // i32 [B, n_loc] scratch (with_distinct)
  unsigned char* pc;    // bool [B, n_loc] scratch (with_ports)
  int g0;               // its first global row
  int pad;
};
static_assert(sizeof(Pos) == 272 && sizeof(Pos) % 16 == 0,
              "mirrored by cuda_kernel._Pos; copied as int4");

// What every card's launch of a wave shares. Mirrored by
// nomad_tpu_torch/ops/cuda_kernel._Shape.
struct Shape {
  long long stride[N_LEAVES];  // member stride in elements; 0 = shared
  int n_loc, n_glob, b, k, p, bp, t;
  int with_topk, with_ports, with_distinct, with_step_pen, with_pref,
      with_shuffle;
};

// A CTA's Slot and TopList (csrc/cluster_wave.cuh) hold global node
// indices and ranks.

// One card's result for one step, in a slot of every card's mailbox.
struct __align__(16) Entry {
  unsigned k, r;
  int i;
  float pin_v;      // the pin's masked value where the card holds it
  unsigned tk[TOPK];
  int ti[TOPK];
  unsigned tag;     // step index + 1, written last
  int pad[3];
};
static_assert(sizeof(Entry) == 96, "mirrored by cuda_kernel._ENTRY_BYTES");

// A card's mailbox: Entry [2][n_cards] (by step parity, then sending card),
// then u32 mtag [n_cards], i32 merr [n_cards] and i32 msum [n_cards][6B]:
// the cards' metric partials and error flags at the wave's end (read on the
// root). Mirrored by cuda_kernel._mail_bytes.
__host__ __device__ inline size_t mail_bytes(int n_cards, int b) {
  return (size_t)2 * n_cards * sizeof(Entry) +
         (size_t)n_cards * (2 + 6 * b) * sizeof(int);
}

// What one card's launch is given, by value.
struct Wave {
  Shape s;
  int n_cards, card;    // cards in the mesh, this one (0: the root)
  int n_pos;            // mesh positions this card holds
  long long spin_ns;    // the longest wait on another card's tag
  const Pos* pos;       // its positions (device)
  const int* sm;        // i32 [T] each step's member (-1: padding)
  const int* sl;        // i32 [T] and its local step
  unsigned char* mail[MAX_CARDS];  // every card's mailbox (n_cards > 1)
  float* packed;        // the root: f32 [2T + 8B + 1], the last the error
  int* topk_idx;        // the root: i32 [T, TOPK]
  float* topk_scores;   // the root: f32 [T, TOPK]
};

template <typename T>
__device__ __forceinline__ const T* pleaf(const Shape& s, const Pos& p,
                                          int leaf, int m) {
  return reinterpret_cast<const T*>(p.leaf[leaf]) + m * s.stride[leaf];
}

__device__ __forceinline__ Member load_member(const Shape& s, const Pos& p,
                                              int m) {
  Member v;
  v.ask_cpu = *pleaf<float>(s, p, L_ASK_CPU, m);
  v.ask_mem = *pleaf<float>(s, p, L_ASK_MEM, m);
  v.ask_disk = *pleaf<float>(s, p, L_ASK_DISK, m);
  v.ask_dyn = *pleaf<int>(s, p, L_ASK_DYN, m);
  v.desired = *pleaf<int>(s, p, L_DESIRED, m);
  v.has_res = *pleaf<unsigned char>(s, p, L_ASK_RES, m) != 0;
  v.alg_spread = *pleaf<unsigned char>(s, p, L_ALG, m) != 0;
  v.dhj = *pleaf<unsigned char>(s, p, L_DHJ, m) != 0;
  v.dht = *pleaf<unsigned char>(s, p, L_DHT, m) != 0;
  return v;
}

// Member m's view of the position's row x: its planes, the wave's carries,
// and the member's counts from the inputs (`input_counts`: its first
// appearance, and the metrics) or from the scratch copies.
__device__ __forceinline__ Node load_node(const Shape& s, const Pos& p, int m,
                                          int x, bool input_counts) {
  Node d;
  const long long mx = (long long)m * s.n_loc + x;
  d.cap_cpu = __ldg(pleaf<float>(s, p, L_CAP_CPU, m) + x);
  d.cap_mem = __ldg(pleaf<float>(s, p, L_CAP_MEM, m) + x);
  d.cap_disk = __ldg(pleaf<float>(s, p, L_CAP_DISK, m) + x);
  d.used_cpu = __ldg(pleaf<float>(s, p, L_USED_CPU, m) + x);
  d.used_mem = __ldg(pleaf<float>(s, p, L_USED_MEM, m) + x);
  d.used_disk = __ldg(pleaf<float>(s, p, L_USED_DISK, m) + x);
  d.aff = __ldg(pleaf<float>(s, p, L_AFF, m) + x);
  d.base = __ldg(pleaf<unsigned char>(s, p, L_BASE, m) + x) != 0;
  d.pen = __ldg(pleaf<unsigned char>(s, p, L_PENALTY, m) + x) != 0;
  d.a_cpu = p.a_cpu[x];
  d.a_mem = p.a_mem[x];
  d.a_disk = p.a_disk[x];
  d.free_dyn = s.with_ports ? __ldg(pleaf<int>(s, p, L_FREE_DYN, m) + x) : 0;
  d.a_dyn = s.with_ports ? p.a_dyn[x] : 0;
  if (input_counts) {
    d.jtc = __ldg(pleaf<int>(s, p, L_JTC, m) + x);
    d.jac = s.with_distinct ? __ldg(pleaf<int>(s, p, L_JAC, m) + x) : 0;
    d.pc = s.with_ports &&
           __ldg(pleaf<unsigned char>(s, p, L_PC, m) + x) != 0;
  } else {
    d.jtc = p.jtc[mx];
    d.jac = s.with_distinct ? p.jac[mx] : 0;
    d.pc = s.with_ports && p.pc[mx] != 0;
  }
  return d;
}

// Commit one placement of member m on the position's row x (the plain
// version's one-hot update at that node), in memory and in `d`.
__device__ __forceinline__ void commit_node(const Shape& s, const Pos& p,
                                            const Member& v, int m, int x,
                                            Node& d) {
  const long long mx = (long long)m * s.n_loc + x;
  d.a_cpu = d.a_cpu + v.ask_cpu;
  d.a_mem = d.a_mem + v.ask_mem;
  d.a_disk = d.a_disk + v.ask_disk;
  p.a_cpu[x] = d.a_cpu;
  p.a_mem[x] = d.a_mem;
  p.a_disk[x] = d.a_disk;
  d.jtc += 1;
  p.jtc[mx] = d.jtc;
  if (s.with_ports) {
    d.a_dyn += v.ask_dyn;
    p.a_dyn[x] = d.a_dyn;
    if (v.has_res) {
      d.pc = true;
      p.pc[mx] = 1;
    }
  }
  if (s.with_distinct) {
    d.jac += 1;
    p.jac[mx] = d.jac;
  }
}

// ---- the exchange between cards ----

__device__ __forceinline__ Entry* mail_entry(unsigned char* mail, int n_cards,
                                             int par, int c) {
  return reinterpret_cast<Entry*>(mail) + par * n_cards + c;
}

__device__ __forceinline__ unsigned* mail_mtag(unsigned char* mail,
                                               int n_cards) {
  return reinterpret_cast<unsigned*>(mail + 2 * n_cards * sizeof(Entry));
}

// Dynamic shared memory a CTA takes: the card's position table, the
// member's score-key row and shuffle ranks over the CTA's range, the metric
// partial sums, a flag per member.
__host__ __device__ inline size_t sharded_smem_bytes(int n_pos, int n_loc,
                                                     int b,
                                                     int with_shuffle) {
  size_t chunk = (size_t)((n_pos * n_loc + CLUSTER - 1) / CLUSTER);
  return (size_t)n_pos * sizeof(Pos) +
         chunk * sizeof(unsigned) * (with_shuffle ? 2 : 1) +
         (size_t)b * 7 * sizeof(int);
}

// kMulti: the mesh spans several cards (the mailbox exchange is compiled
// in); one card's kernel has none of it.
template <bool kMulti>
__global__ void __launch_bounds__(THREADS, 1)
    sharded_wave_kernel(const Wave w) {
  extern __shared__ __align__(16) unsigned char dyn_smem[];
  __shared__ Slot slot[2];             // this CTA's argmax, by step parity
  __shared__ TopList top_list[2];      // this CTA's top-8, by step parity
  __shared__ TopList card_top;         // CTA 0: the card's top-8 (cards)
  __shared__ Best sh_best[NWARPS];
  __shared__ unsigned sh_tk[NWARPS][TOPK];  // each warp's top-8 list
  __shared__ int sh_ti[NWARPS][TOPK];
  __shared__ unsigned sh_dirty;  // warps whose row entries the step changed
  __shared__ Member sh_member;
  __shared__ float sh_pin_v;
  __shared__ int sh_lp[MAX_SHARDS];  // mesh position -> its index here, -1
  __shared__ int sh_g0[MAX_SHARDS];  // index here -> its first global row
  __shared__ int sh_err;             // this CTA waited past the bound
  __shared__ int sh_mask;            // the root's CTA 0: the cards at fault

  const Shape& s = w.s;
  cg::cluster_group cluster = cg::this_cluster();
  const int cta = (int)cluster.block_rank();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_loc = s.n_loc;
  const int rows = w.n_pos * n_loc;
  const int chunk = (rows + CLUSTER - 1) / CLUSTER;
  const int lo = min(cta * chunk, rows), hi = min(lo + chunk, rows);
  const int cnt = hi - lo;
  constexpr bool multi = kMulti;  // else one card holds every position
  const bool root = w.card == 0;
  Pos* pos = reinterpret_cast<Pos*>(dyn_smem);
  unsigned* row = reinterpret_cast<unsigned*>(pos + w.n_pos);
  unsigned* rank = row + chunk;
  int* part = reinterpret_cast<int*>(rank + (s.with_shuffle ? chunk : 0));
  int* seen = part + s.b * 6;

  // card row of global node g (-1: out of range, or on another card)
  auto row_of = [&](int g) -> int {
    if (g < 0 || g >= s.n_glob) return -1;
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

  // ---- pre-wave: the position tables; zero the carries, the partial
  // sums and the flags; the root's idle outputs ----
  {
    // the card's position table, read on every special node and row pass
    const int4* src4 = reinterpret_cast<const int4*>(w.pos);
    int4* dst4 = reinterpret_cast<int4*>(pos);
    for (int q = tid; q < w.n_pos * (int)(sizeof(Pos) / 16); q += THREADS)
      dst4[q] = __ldg(src4 + q);
  }
  for (int q = tid; q < MAX_SHARDS; q += THREADS) sh_lp[q] = -1;
  if (tid == 0) sh_err = 0;
  __syncthreads();
  for (int lp = tid; lp < w.n_pos; lp += THREADS) {
    const int g0 = pos[lp].g0;
    sh_g0[lp] = g0;
    sh_lp[g0 / n_loc] = lp;
  }
  for (int seg = lo; seg < hi;) {
    const int lp = seg / n_loc, base = lp * n_loc;
    const int end = min(hi, base + n_loc);
    const Pos& p = pos[lp];
    for (int r = seg + tid; r < end; r += THREADS) {
      p.a_cpu[r - base] = 0.0f;
      p.a_mem[r - base] = 0.0f;
      p.a_disk[r - base] = 0.0f;
      if (s.with_ports) p.a_dyn[r - base] = 0;
    }
    seg = end;
  }
  for (int x = tid; x < s.b * 7; x += THREADS) part[x] = 0;  // and seen
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

  // the calling warp's sorted top-8 of lanes' (key, index) lists
  auto merged = [&](unsigned* lk, int* li, unsigned* ok, int* oi) {
    list_clear(ok, oi);
    if (s.with_topk) warp_top(lk, li, ok, oi);
  };
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
      if (s.with_topk && lane < w.n_cards) {
        // this warp acquires the tags itself: warp 0 may still be waiting
        // for them (nothing orders the two warps between the steps)
        const Entry* e = mail_entry(w.mail[w.card], w.n_cards, pp, lane);
        if (!*reinterpret_cast<volatile int*>(&sh_err) &&
            !wait_tag(&e->tag, (unsigned)t + 1u, w.spin_ns))
          sh_err = 1;
#pragma unroll
        for (int q = 0; q < TOPK; ++q) {
          lk[q] = __ldcg(&e->tk[q]);
          li[q] = __ldcg(&e->ti[q]);
        }
      }
      merged(lk, li, ok, oi);
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
  // a step's penalty nodes, then its preferred node (global, -1: none)
  auto load_step_nodes = [&](int m, int j, int* out) {
    const Pos& p0 = pos[0];
    const int* sp = pleaf<int>(s, p0, L_STEP_PEN, m) + (long long)j * s.p;
#pragma unroll
    for (int q = 0; q < MAX_P; ++q)
      out[q] = (s.with_step_pen && q < s.p) ? __ldg(sp + q) : -1;
    out[MAX_P] = s.with_pref ? __ldg(pleaf<int>(s, p0, L_STEP_PREF, m) + j)
                             : -1;
  };

  // ---- the step loop ----
  int row_m = -1;   // member whose score row is cached
  int rank_m = -1;  // permutation row whose ranks are cached
  int pend = -1;    // warp 0: card row of the last step's choice, not
                    // committed (-1: none, or on another card)
  int par = 0;      // parity of the active step (slots, mailbox)
  int t_prev = -1;  // step index of the last active step
  int restore_x = -1;  // row entry a special thread puts back next step
  unsigned restore_k = 0;
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
      const int mc = min(max(mem_raw, 0), s.b - 1);
      act = mem_raw >= 0 &&
            j_raw < __ldg(pleaf<int>(s, pos[0], L_NSTEPS, mc));
    }
    unsigned mask = __ballot_sync(FULL_MASK, act);
    while (mask) {
      const int l = __ffs(mask) - 1;
      mask &= mask - 1;
      const int t = t0 + l;
      const int m = min(max(__shfl_sync(FULL_MASK, mem_raw, l), 0), s.b - 1);
      const int j = min(max(__shfl_sync(FULL_MASK, j_raw, l), 0), s.k - 1);

      // a new member: commit the last one's pending placement, then score
      // the member's row over this CTA's range (at its first appearance also
      // copying its scratch and counting its metrics)
      if (m != row_m) {
        const bool first = seen[m] == 0;
        if (tid == 0) {
          if (pend >= lo && pend < hi) {
            const int lp = pend / n_loc;
            const Pos& p = pos[lp];
            Node d = load_node(s, p, row_m, pend - lp * n_loc, false);
            commit_node(s, p, sh_member, row_m, pend - lp * n_loc, d);
          }
          sh_member = load_member(s, pos[0], m);
        }
        pend = -1;
        restore_x = -1;  // the row is rebuilt
        __syncthreads();
        const Member v = sh_member;
        const long long row0 = (long long)m * n_loc;
        int c[6] = {0, 0, 0, 0, 0, 0};
        for (int seg = lo; seg < hi;) {
          const int lp = seg / n_loc, base = lp * n_loc;
          const int end = min(hi, base + n_loc);
          const Pos& p = pos[lp];
          for (int r0 = seg + tid; r0 < end; r0 += ROW_UNROLL * THREADS) {
            Node d[ROW_UNROLL];
#pragma unroll
            for (int u = 0; u < ROW_UNROLL; ++u) {
              const int r = r0 + u * THREADS;
              if (r < end) d[u] = load_node(s, p, m, r - base, first);
            }
#pragma unroll
            for (int u = 0; u < ROW_UNROLL; ++u) {
              const int r = r0 + u * THREADS, xl = r - base;
              if (r >= end) continue;
              if (first) {
                count_metrics(s, v, d[u], c);
                p.jtc[row0 + xl] = d[u].jtc;
                if (s.with_distinct) p.jac[row0 + xl] = d[u].jac;
                if (s.with_ports) p.pc[row0 + xl] = d[u].pc;
              }
              row[r - lo] = score_key(masked_score(s, v, d[u], d[u].pen));
            }
          }
          seg = end;
        }
        if (first) {
#pragma unroll
          for (int q = 0; q < 6; ++q) {
            const int sum = __reduce_add_sync(FULL_MASK, c[q]);
            if (lane == 0 && sum != 0) atomicAdd(&part[m * 6 + q], sum);
          }
        }
        const int pm = s.bp > 1 ? m : 0;
        if (s.with_shuffle && pm != rank_m) {
          // rank of a node = its position in the permutation
          load_ranks<THREADS>(pleaf<int>(s, pos[0], L_PERM, pm), s.n_glob,
                              lo, hi, rank, tid, row_of);
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
      // pin's step value. Meanwhile the root's CTA 0 warp 1 writes out the
      // top-k of the last active step.
      int pcl = -1;   // warp 0: the step's pin (global, clamped), or -1
      int prow = -1;  // warp 0: its card row, or -1
      if (warp == 0) {
        if (restore_x >= 0) {
          row[restore_x] = restore_k;
          mark(restore_x);
        }
        restore_x = -1;
        __syncwarp();
        if (pf_t != t) load_step_nodes(m, j, pf_s);
        int sp[N_SPECIAL];
        sp[0] = pend;
#pragma unroll
        for (int q = 0; q < MAX_P; ++q) sp[1 + q] = row_of(pf_s[q]);
        const int pref = pf_s[MAX_P];
        pcl = pref >= 0 ? min(pref, s.n_glob - 1) : -1;
        prow = row_of(pcl);
        sp[N_SPECIAL - 1] = prow;
        if (mask) {  // the next active step of these 32: load ahead
          const int nl = __ffs(mask) - 1;
          pf_t = t0 + nl;
          load_step_nodes(
              min(max(__shfl_sync(FULL_MASK, mem_raw, nl), 0), s.b - 1),
              min(max(__shfl_sync(FULL_MASK, j_raw, nl), 0), s.k - 1), pf_s);
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
          const int xr = q - lo;
          unsigned key = row[xr];
          if (q == pend || is_pen) {
            const Member v = sh_member;
            const int lp = q / n_loc;
            const Pos& p = pos[lp];
            Node d = load_node(s, p, m, q - lp * n_loc, false);
            if (q == pend) {
              commit_node(s, p, v, m, q - lp * n_loc, d);
              key = score_key(masked_score(s, v, d, d.pen));
              row[xr] = key;
            }
            if (is_pen) {
              restore_x = xr;
              restore_k = key;
              key = score_key(masked_score(s, v, d, true));
              row[xr] = key;
            }
            mark(xr);
          }
          if (q == prow) sh_pin_v = key_score(key);
        }
      } else if (warp == 1 && cta == 0 && root && t_prev >= 0) {
        emit_topk(par ^ 1, t_prev);
      }
      __syncthreads();

      // every warp: its argmax over its row entries, and its top-8 list
      // when the step made it stale
      {
        unsigned bk = PAD_KEY, br = NO_RANK;
        int bi = NO_NODE;
        for (int xr = tid; xr < cnt; xr += THREADS) {
          const unsigned k = row[xr];
          const unsigned r = s.with_shuffle ? rank[xr] : (unsigned)(lo + xr);
          if (k > bk || (k == bk && r < br)) {
            bk = k;
            br = r;
            bi = lo + xr;
          }
        }
        warp_best(bk, br, bi);
        if (lane == 0) sh_best[warp] = Best{bk, br, bi};
        if (s.with_topk && ((sh_dirty >> warp) & 1u)) warp_list();
      }
      __syncthreads();

      // this CTA's argmax (warp 0) and top-8 (warp 1) into its slots, on
      // global indices and ranks
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
                           (prow >= 0 && prow / chunk == cta) ? sh_pin_v
                                                              : NEG_INF_F};
        }
      } else if (warp == 1) {
        if (s.with_topk) {
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
      // (several cards) the wave's from the cards' entries
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
        if (multi) {
          if (cta == 0) {
            asm volatile("bar.sync 1, 64;" ::: "memory");  // card_top ready
            // a card that has given up pushes nothing more
            if (lane < w.n_cards && !dead) {
              Entry* e = mail_entry(w.mail[lane], w.n_cards, par, w.card);
              e->k = b.k;
              e->r = b.r;
              e->i = b.i;
              e->pin_v = pv;
#pragma unroll
              for (int q = 0; q < TOPK; ++q) {
                e->tk[q] = card_top.k[q];
                e->ti[q] = card_top.i[q];
              }
              __threadfence_system();
              st_release(&e->tag, (unsigned)t + 1u);
            }
          }
          bool ok = true;
          Best g = {PAD_KEY, NO_RANK, NO_NODE};
          float gpv = NEG_INF_F;
          if (lane < w.n_cards) {
            const Entry* e = mail_entry(w.mail[w.card], w.n_cards, par, lane);
            if (!dead) ok = wait_tag(&e->tag, (unsigned)t + 1u, w.spin_ns);
            g = Best{__ldcg(&e->k), __ldcg(&e->r), __ldcg(&e->i)};
            gpv = __ldcg(&e->pin_v);
          }
          if (__any_sync(FULL_MASK, !ok)) {
            dead = true;
            if (lane == 0) sh_err = 1;
          }
          // the cascade: largest value, then lowest rank (ranks are distinct)
          warp_best(g.k, g.r, g.i);
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
        if (pcl >= 0 && pv > NEG_INF_F / 2.0f) {
          idx = pcl;
          val = pv;
        }
        const bool found = val > NEG_INF_F / 2.0f;
        if (root && cta == 0 && lane == 0) {
          w.packed[t] = found ? (float)idx : -1.0f;
          w.packed[s.t + t] = found ? val : 0.0f;
        }
        pend = found ? row_of(idx) : -1;
      }
      par ^= 1;
      t_prev = t;
    }
  }

  // ---- tail: the last placement, the metrics, the last top-k ----
  if (tid == 0 && pend >= lo && pend < hi) {
    const int lp = pend / n_loc;
    const Pos& p = pos[lp];
    Node d = load_node(s, p, row_m, pend - lp * n_loc, false);
    commit_node(s, p, sh_member, row_m, pend - lp * n_loc, d);
  }
  for (int m = 0; m < s.b; ++m) {
    if (seen[m]) continue;  // counted at its first row pass
    const Member v = load_member(s, pos[0], m);
    int c[6] = {0, 0, 0, 0, 0, 0};
    for (int seg = lo; seg < hi;) {
      const int lp = seg / n_loc, base = lp * n_loc;
      const int end = min(hi, base + n_loc);
      const Pos& p = pos[lp];
      for (int r = seg + tid; r < end; r += THREADS)
        count_metrics(s, v, load_node(s, p, m, r - base, true), c);
      seg = end;
    }
#pragma unroll
    for (int q = 0; q < 6; ++q) {
      const int sum = __reduce_add_sync(FULL_MASK, c[q]);
      if (lane == 0 && sum != 0) atomicAdd(&part[m * 6 + q], sum);
    }
  }
  cluster.sync();  // every CTA's partial sums and error flag ready
  if (cta == 0) {
    if (root && warp == 1 && t_prev >= 0) emit_topk(par ^ 1, t_prev);
    const int nb6 = s.b * 6;
    // this card's error flag: any of its CTAs waited past the bound
    int card_err = 0;
    if (warp == 0)
      card_err = __ballot_sync(FULL_MASK,
                               lane < CLUSTER &&
                                   *cluster.map_shared_rank(&sh_err, lane)) !=
                 0;
    if (multi && !root) {
      // the card's partial sums and flag into the root's mailbox
      unsigned* mtag = mail_mtag(w.mail[0], w.n_cards);
      int* merr = reinterpret_cast<int*>(mtag + w.n_cards);
      int* msum = merr + w.n_cards + w.card * nb6;
      for (int x = tid; x < nb6; x += THREADS) {
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
          unsigned* mtag = mail_mtag(w.mail[0], w.n_cards);
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
        unsigned* mtag = mail_mtag(w.mail[0], w.n_cards);
        msum = reinterpret_cast<const int*>(mtag + w.n_cards) + w.n_cards;
      }
      for (int x = tid; x < nb6; x += THREADS) {
        int sum = 0;
        for (int c = 0; c < CLUSTER; ++c)
          sum += cluster.map_shared_rank(part, c)[x];
        for (int c = 1; c < w.n_cards; ++c) sum += __ldcg(&msum[c * nb6 + x]);
        metrics[(x % 6) * s.b + x / 6] = (float)sum;
      }
      for (int m = tid; m < s.b; m += THREADS) {
        metrics[6 * s.b + m] = 0.0f;  // exhausted_devices: outside envelope
        metrics[7 * s.b + m] = 0.0f;  // exhausted_cores: outside envelope
      }
      if (tid == 0) w.packed[2 * s.t + 8 * s.b] = (float)sh_mask;
    }
  }
  cluster.sync();  // no CTA leaves while another may read its shared memory
}

// ---- the host side ----

// The dynamic shared memory a block may take on the current device, after
// setting the kernel's attributes there (once per device).
static int g_limit[MAX_DEVICES];  // 0: attributes not set yet

static cudaError_t smem_limit(int* limit) {
  void (*const kernels[])(const Wave) = {sharded_wave_kernel<false>,
                                         sharded_wave_kernel<true>};
  return cluster_smem_limit(kernels, g_limit, limit);
}

static cudaLaunchConfig_t launch_config(size_t smem, cudaStream_t stream,
                                        cudaLaunchAttribute* attr) {
  return cluster_launch_config<CLUSTER, THREADS>(smem, stream, attr);
}

// One card of the mesh; the first is the root. Mirrored by
// nomad_tpu_torch/ops/cuda_kernel._Card.
struct Card {
  int ordinal;            // CUDA device ordinal
  int n_pos;              // mesh positions it holds, in ascending order
  void* stream;           // its current stream
  unsigned char* table;   // on it: Pos [n_pos], then the step maps, i32
                          // [T] member and [T] local step, copied up on
                          // `stream`
  unsigned char* mail;    // its mailbox (several cards), else null
};

// Mirrored by nomad_tpu_torch/ops/cuda_kernel._ShardedArgs.
struct ShardedArgs {
  Shape s;
  int n_cards;
  const Card* card;       // host array, the root first
  float* packed;          // f32 [2T + 8B + 1] on the root
  int* topk_idx;          // i32 [T, TOPK] on the root
  float* topk_scores;     // f32 [T, TOPK] on the root
  long long spin_ns;      // the longest wait on another card's tag
};

static_assert(sizeof(Shape) == 264 && sizeof(Card) == 32 &&
                  sizeof(ShardedArgs) == 312,
              "mirrored by cuda_kernel._Shape, _Card, _ShardedArgs");

static std::mutex g_enqueue;            // one wave's launches at a time
static unsigned long long g_launches;   // kernel launches, every card's

// Enqueues every card's launch; *launched counts those enqueued.
static cudaError_t run_wave(const ShardedArgs& a, cudaEvent_t* ev,
                            int* launched) {
  const Shape& s = a.s;
  const int nc = a.n_cards;
  const bool multi = nc > 1;
  auto stream = [&](int d) { return (cudaStream_t)a.card[d].stream; };
  // over several cards: each mailbox zeroed on its card's stream, then
  // every card after every other card's earlier work, since a card's
  // mailbox takes peer stores from the first step on
  if (multi) CK(order_cards(a.card, nc, mail_bytes(nc, s.b), ev));
  for (int d = 0; d < nc; ++d) {
    const Card& k = a.card[d];
    CK(cudaSetDevice(k.ordinal));
    int limit = 0;
    CK(smem_limit(&limit));
    const size_t smem = sharded_smem_bytes(k.n_pos, s.n_loc, s.b,
                                           s.with_shuffle);
    if (smem > (size_t)limit) return cudaErrorInvalidValue;
    Wave w = {};
    w.s = s;
    w.n_cards = nc;
    w.card = d;
    w.n_pos = k.n_pos;
    w.spin_ns = a.spin_ns;
    w.pos = reinterpret_cast<const Pos*>(k.table);
    w.sm = reinterpret_cast<const int*>(k.table +
                                        (size_t)k.n_pos * sizeof(Pos));
    w.sl = w.sm + s.t;
    for (int c = 0; c < nc; ++c) w.mail[c] = a.card[c].mail;
    if (d == 0) {
      w.packed = a.packed;
      w.topk_idx = a.topk_idx;
      w.topk_scores = a.topk_scores;
    }
    cudaLaunchAttribute attr[1];
    cudaLaunchConfig_t cfg = launch_config(smem, stream(d), attr);
    void (*kernel)(const Wave) =
        multi ? sharded_wave_kernel<true> : sharded_wave_kernel<false>;
    CK(cudaLaunchKernelEx(&cfg, kernel, w));
    CK(cudaGetLastError());
    ++g_launches;
    ++*launched;
  }
  return cudaSuccess;
}

extern "C" int sharded_wave_launch(const ShardedArgs* args) {
  const ShardedArgs& a = *args;
  const Shape& s = a.s;
  if (a.n_cards < 1 || a.n_cards > MAX_CARDS || s.p > MAX_P ||
      s.n_loc < 1 || s.n_glob % s.n_loc != 0 ||
      s.n_glob / s.n_loc > MAX_SHARDS || s.t < 1 || s.k < 1)
    return (int)cudaErrorInvalidValue;
  for (int d = 0; d < a.n_cards; ++d)
    if (a.card[d].n_pos < 1 || (a.n_cards > 1 && !a.card[d].mail))
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
extern "C" int sharded_wave_plan(int n_pos, int n_loc, int b,
                                 int with_shuffle, int* out) {
  int limit = 0;
  cudaError_t e = smem_limit(&limit);
  if (e != cudaSuccess) return (int)e;
  const size_t smem = sharded_smem_bytes(n_pos, n_loc, b, with_shuffle);
  out[0] = CLUSTER;
  out[1] = (int)smem;
  out[2] = limit;
  out[3] = 0;
  if (smem > (size_t)limit) return 0;
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg = launch_config(smem, 0, attr);
  int clusters = 0;
  e = cudaOccupancyMaxActiveClusters(&clusters, sharded_wave_kernel<true>,
                                     &cfg);
  out[3] = clusters;
  return (int)e;
}

// Kernel launches made so far, every card's.
extern "C" unsigned long long sharded_wave_kernel_launches(void) {
  std::lock_guard<std::mutex> hold(g_enqueue);
  return g_launches;
}

// Enable peer access between every pair of the `n` cards; -1 (and the pair
// in bad[0], bad[1]) where cudaDeviceCanAccessPeer is 0.
extern "C" int sharded_wave_enable_peers(const int* ordinals, int n,
                                         int* bad) {
  int prior = 0;
  cudaError_t e = cudaGetDevice(&prior);
  if (e != cudaSuccess) return (int)e;
  int rc = 0;
  for (int x = 0; x < n && rc == 0; ++x)
    for (int y = 0; y < n && rc == 0; ++y) {
      if (x == y) continue;
      int ok = 0;
      e = cudaDeviceCanAccessPeer(&ok, ordinals[x], ordinals[y]);
      if (e != cudaSuccess) {
        rc = (int)e;
      } else if (!ok) {
        bad[0] = ordinals[x];
        bad[1] = ordinals[y];
        rc = -1;
      } else if ((e = cudaSetDevice(ordinals[x])) != cudaSuccess) {
        rc = (int)e;
      } else {
        e = cudaDeviceEnablePeerAccess(ordinals[y], 0);
        if (e == cudaErrorPeerAccessAlreadyEnabled)
          cudaGetLastError();  // enabled before: not an error
        else if (e != cudaSuccess)
          rc = (int)e;
      }
    }
  cudaSetDevice(prior);
  return rc;
}
