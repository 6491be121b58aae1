// Fused placement wave over a mesh of node shards, for NVIDIA Hopper
// (sm_90a): one step launch a card and one merge launch a step, stepped
// from the host in one C call.
//
// Replaces: nomad_tpu/parallel/sharded.py `_fused_sharded_core` (:291-505),
// the per-shard body that `fused_sharded_entry` (:507) runs under
// shard_map: an XLA program, no Pallas. It computes, for each node shard,
// what that body computes (the fused envelope: ports, step penalties,
// preferred pins, distinct_hosts, shuffle, top-k), merges each step across
// the shards with its pmax / pmin / pmin cascade (:390-396), its pin rule
// (:397-406) and its all_gather top-k merge (:412-423), and returns its
// outputs: the packed buffer in ops/kernel.pack_fused_wave's layout and the
// top-k planes on the mesh's first card, the a_cpu/a_mem/a_disk carries on
// each shard's own card. Its plain version is
// nomad_tpu_torch/parallel/sharded._sharded_wave.
//
// What bounds it. Counting each input byte once, the live wave (B=32
// members, N=16384 nodes, T=512 steps) moves the bytes of the unsharded
// wave, ~10 MB: 3.19 us at 3.35 TB/s; its operations take less. As for B1
// (csrc/fused_wave.cu), neither is the floor that matters: step t+1's
// feasibility depends on step t's choice, so a wave is a chain of T
// dependent N-wide argmaxes. Here each link is two launches, a shard
// step on every card and a merge on the first, so the floor is a few
// microseconds of launch latency a step.
//
// Design: a simple one, right first.
// - One entry point, `sharded_wave_launch`, takes the whole wave; the
//   host loop over the active steps runs in C, so no Python runs per step.
//   Inactive steps (padding, or past their member's count) launch
//   nothing: one launch writes every step's neutral outputs first, and
//   the merges overwrite the active ones.
// - Wave start, on every card: each position's per-member scratch
//   (job_tg_count, job_any_count, port_conflict) copied from the inputs,
//   its carries zeroed, and its metric partial sums over the pre-wave
//   state counted; with shuffle, the inverse permutations in full.
// - A step, on every card: one launch with `nb` blocks a mesh position,
//   each over a contiguous range of the position's rows. A block first
//   commits the previous step's winner when that node is in its range,
//   then scores its rows for the step's member (penalty and pin ids are
//   global: a row x of the position is node g0 + x, and the indices it
//   offers are global too) and writes one slot: its best under (score
//   desc, rank asc), the pin's masked score when the pin is its own, and
//   its top-8 under (score desc, index asc). Nothing is cached between
//   steps: every step rescores every row, the price of simplicity.
// - A step, on the first card: one warp reduces every slot with the same
//   orders, applies the pin rule, merges the top-8 lists, writes the
//   step's outputs and the winner the next step commits. A last launch a
//   card commits the last winner; one sums the metric partials, exact in
//   i32.
// - Cards: a mesh whose positions all lie on one card runs on its current
//   stream alone, with no events and no copies. Over several cards each
//   card runs on its own current stream; its step launch waits on the
//   first card's merge event, the merge waits on every card's step event,
//   and slots, partials and winners travel by cudaMemcpyPeerAsync.
// - A persistent kernel, one launch a card with an in-kernel mailbox,
//   would take the launches off the chain; that is later work.
// - Exactness: the feasibility and score come from csrc/wave_score.cuh,
//   shared with B1, under B1's build flags (-fmad=false, no fast-math, the
//   fit scaled by the f32 reciprocal of 18), so a shard scores a node bit
//   for bit as B1 and the plain version do on the card.
//
// Built by nomad_tpu_torch/ops/build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xptxas -v
//        -fmad=false -shared -Xcompiler -fPIC

#include "wave_score.cuh"

#define SW_THREADS 256
#define SW_WARPS (SW_THREADS / 32)
#define SW_UNROLL 4                      // rows a thread loads at once
#define SW_ROWS (SW_THREADS * SW_UNROLL)  // rows a step block covers at most
#define MAX_P 4                          // MAX_PENALTY_NODES
#define MAX_CARDS 16

static_assert(SW_WARPS >= 2 && SW_WARPS <= 32, "warps 0 and 1 have roles");

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
static_assert(sizeof(Pos) == 272, "mirrored by cuda_kernel._Pos");

// What every launch of a wave shares, passed by value.
struct Shape {
  long long stride[N_LEAVES];  // member stride in elements; 0 = shared
  int n_loc, n_glob, b, k, p, bp, t, nb;
  int with_topk, with_ports, with_distinct, with_step_pen, with_pref,
      with_shuffle;
};

// One step block's offer.
struct __align__(16) StepSlot {
  unsigned k, r;      // its best score key and that node's rank
  int i;              // that node's global index
  float pin_v;        // the pin's masked score where the block holds it
  unsigned tk[TOPK];  // its top-8 keys, best first
  int ti[TOPK];       // and their global indices
};
static_assert(sizeof(StepSlot) == 80, "mirrored by cuda_kernel");

// The last active step's choice, which the next step commits.
struct __align__(16) Winner {
  int idx, found, m, pad;
};
static_assert(sizeof(Winner) == 16, "mirrored by cuda_kernel");

// One card of the mesh; the first is the root. Mirrored by
// nomad_tpu_torch/ops/cuda_kernel._Card.
struct Card {
  int ordinal;          // CUDA device ordinal
  int n_pos;            // mesh positions it holds
  int pos0;             // its first position in card order (slots, partials)
  int pad;
  void* stream;         // its current stream
  const Pos* pos_host;  // host table of its positions
  Pos* pos;             // its device copy
  StepSlot* slots;      // [n_pos * nb] (the root's: every card's, its own first)
  Winner* win;          // its copy of the last winner
  int* part;            // i32 [n_pos, 6, B] metric partials (the root's: all)
  int* rank;            // i32 [bp, n_glob] inverse permutations (with_shuffle)
};

struct ShardedArgs {
  Shape s;
  int n_cards;
  const Card* card;     // host array, the root first
  int n_act;            // active steps, and for each (host arrays):
  const int* act_t;     //   its step index
  const int* act_m;     //   its member (clamped)
  const int* act_j;     //   its local step (clamped)
  float* packed;        // f32 [2T + 8B] on the root
  int* topk_idx;        // i32 [T, TOPK] on the root
  float* topk_scores;   // f32 [T, TOPK] on the root
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

// Member m's view of the position's row x: its planes, and either the
// wave's carries and the member's scratch counts, or (`inputs`) no
// carries and the counts of the inputs.
__device__ __forceinline__ Node load_node(const Shape& s, const Pos& p, int m,
                                          int x, bool inputs) {
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
  d.free_dyn = s.with_ports ? __ldg(pleaf<int>(s, p, L_FREE_DYN, m) + x) : 0;
  if (inputs) {
    d.a_cpu = d.a_mem = d.a_disk = 0.0f;
    d.a_dyn = 0;
    d.jtc = __ldg(pleaf<int>(s, p, L_JTC, m) + x);
    d.jac = s.with_distinct ? __ldg(pleaf<int>(s, p, L_JAC, m) + x) : 0;
    d.pc = s.with_ports &&
           __ldg(pleaf<unsigned char>(s, p, L_PC, m) + x) != 0;
  } else {
    d.a_cpu = p.a_cpu[x];
    d.a_mem = p.a_mem[x];
    d.a_disk = p.a_disk[x];
    d.a_dyn = s.with_ports ? p.a_dyn[x] : 0;
    d.jtc = p.jtc[mx];
    d.jac = s.with_distinct ? p.jac[mx] : 0;
    d.pc = s.with_ports && p.pc[mx] != 0;
  }
  return d;
}

// Commit one placement of member m on row x (the plain version's one-hot
// update at that node).
__device__ __forceinline__ void commit_row(const Shape& s, const Pos& p,
                                           int m, int x) {
  const Member v = load_member(s, p, m);
  const long long mx = (long long)m * s.n_loc + x;
  p.a_cpu[x] = p.a_cpu[x] + v.ask_cpu;
  p.a_mem[x] = p.a_mem[x] + v.ask_mem;
  p.a_disk[x] = p.a_disk[x] + v.ask_disk;
  p.jtc[mx] += 1;
  if (s.with_ports) {
    p.a_dyn[x] += v.ask_dyn;
    if (v.has_res) p.pc[mx] = 1;
  }
  if (s.with_distinct) p.jac[mx] += 1;
}

// Insert (k, i) into a sorted top-8 on (key desc, index asc), whatever
// order the entries come in.
__device__ __forceinline__ void list_insert_ordered(unsigned* lk, int* li,
                                                    unsigned k, int i) {
#pragma unroll
  for (int q = 0; q < TOPK; ++q) {
    const bool ahead = k > lk[q] || (k == lk[q] && i < li[q]);
    if (ahead) {  // swap: the displaced entry moves down the list
      const unsigned tk = lk[q];
      const int ti = li[q];
      lk[q] = k;
      li[q] = i;
      k = tk;
      i = ti;
    }
  }
}

// ---- wave start, one launch a card ----
// grid (row chunks, positions x members): member m's scratch from the
// inputs, its metric partials; member 0's blocks zero the carries.
__global__ void __launch_bounds__(SW_THREADS)
    sw_init_kernel(const Shape s, const Pos* pos, int* part) {
  const int lp = blockIdx.y / s.b, m = blockIdx.y % s.b;
  const Pos& p = pos[lp];
  const Member v = load_member(s, p, m);
  const long long row0 = (long long)m * s.n_loc;
  const int lo = blockIdx.x * SW_ROWS, hi = min(lo + SW_ROWS, s.n_loc);
  int c[6] = {0, 0, 0, 0, 0, 0};
  for (int x = lo + threadIdx.x; x < hi; x += SW_THREADS) {
    const Node d = load_node(s, p, m, x, true);
    count_metrics(s, v, d, c);
    p.jtc[row0 + x] = d.jtc;
    if (s.with_distinct) p.jac[row0 + x] = d.jac;
    if (s.with_ports) p.pc[row0 + x] = d.pc;
    if (m == 0) {
      p.a_cpu[x] = 0.0f;
      p.a_mem[x] = 0.0f;
      p.a_disk[x] = 0.0f;
      if (s.with_ports) p.a_dyn[x] = 0;
    }
  }
#pragma unroll
  for (int q = 0; q < 6; ++q) {
    const int sum = __reduce_add_sync(FULL_MASK, c[q]);
    if ((threadIdx.x & 31) == 0 && sum != 0)
      atomicAdd(&part[(lp * 6 + q) * s.b + m], sum);
  }
}

// rank[pm][node] = the node's position in permutation row pm
__global__ void sw_rank_kernel(const Shape s, const Pos* pos, int* rank) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= (long long)s.bp * s.n_glob) return;
  const int pm = (int)(e / s.n_glob), g = (int)(e % s.n_glob);
  const int node = __ldg(pleaf<int>(s, pos[0], L_PERM, pm) + g);
  if (node >= 0 && node < s.n_glob) rank[(long long)pm * s.n_glob + node] = g;
}

// every step's outputs as an inactive step gives them (an all-NEG_INF
// plane: nothing found, the top-k of the plain version's stable sort)
__global__ void sw_idle_kernel(const Shape s, float* packed, int* topk_idx,
                               float* topk_scores) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= s.t) return;
  packed[t] = -1.0f;
  packed[s.t + t] = 0.0f;
  for (int q = 0; q < TOPK; ++q) {
    topk_idx[t * TOPK + q] = s.with_topk ? q : 0;
    topk_scores[t * TOPK + q] = NEG_INF_F;
  }
}

// ---- a step, one launch a card: nb blocks a position ----
__global__ void __launch_bounds__(SW_THREADS)
    sw_step_kernel(const Shape s, const Pos* pos, const int* rank,
                   const Winner* win, StepSlot* slots, int m, int j) {
  __shared__ Member sh_v;
  __shared__ int sh_nodes[MAX_P + 1];  // the step's penalty nodes, its pin
  __shared__ float sh_pin_v;
  __shared__ Best sh_best[SW_WARPS];
  __shared__ unsigned sh_tk[SW_WARPS][TOPK];
  __shared__ int sh_ti[SW_WARPS][TOPK];

  const int lp = blockIdx.x / s.nb, q = blockIdx.x % s.nb;
  const Pos& p = pos[lp];
  const int chunk = (s.n_loc + s.nb - 1) / s.nb;
  const int lo = min(q * chunk, s.n_loc), hi = min(lo + chunk, s.n_loc);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  if (tid == 0) {
    // the last active step's winner, committed by the block that holds it
    const Winner w = *win;
    const int x = w.idx - p.g0;
    if (w.found && x >= lo && x < hi) commit_row(s, p, w.m, x);
    sh_v = load_member(s, p, m);
    const int* sp = pleaf<int>(s, p, L_STEP_PEN, m) + (long long)j * s.p;
#pragma unroll
    for (int k = 0; k < MAX_P; ++k)
      sh_nodes[k] = (s.with_step_pen && k < s.p) ? __ldg(sp + k) : -1;
    const int pref =
        s.with_pref ? __ldg(pleaf<int>(s, p, L_STEP_PREF, m) + j) : -1;
    sh_nodes[MAX_P] = pref >= 0 ? min(pref, s.n_glob - 1) : -1;
    sh_pin_v = NEG_INF_F;
  }
  __syncthreads();
  const Member v = sh_v;
  int pen_ids[MAX_P];
#pragma unroll
  for (int k = 0; k < MAX_P; ++k) pen_ids[k] = sh_nodes[k];
  const int pin = sh_nodes[MAX_P];
  const int* rank_m = rank + (long long)(s.bp > 1 ? m : 0) * s.n_glob;

  unsigned bk = PAD_KEY, br = NO_RANK;
  int bi = NO_NODE;
  unsigned lk[TOPK];
  int li[TOPK];
  list_clear(lk, li);
  for (int x0 = lo + tid; x0 < hi; x0 += SW_UNROLL * SW_THREADS) {
    Node d[SW_UNROLL];
    unsigned r[SW_UNROLL];
#pragma unroll
    for (int u = 0; u < SW_UNROLL; ++u) {
      const int x = x0 + u * SW_THREADS;
      if (x < hi) {
        d[u] = load_node(s, p, m, x, false);
        r[u] = s.with_shuffle ? (unsigned)__ldg(rank_m + p.g0 + x)
                              : (unsigned)(p.g0 + x);
      }
    }
#pragma unroll
    for (int u = 0; u < SW_UNROLL; ++u) {
      const int x = x0 + u * SW_THREADS, i = p.g0 + x;
      if (x >= hi) continue;
      bool pen = d[u].pen;
#pragma unroll
      for (int k = 0; k < MAX_P; ++k) pen = pen || i == pen_ids[k];
      const float ms = masked_score(s, v, d[u], pen);
      const unsigned key = score_key(ms);
      if (key > bk || (key == bk && r[u] < br)) {
        bk = key;
        br = r[u];
        bi = i;
      }
      if (s.with_topk) list_insert(lk, li, key, i);
      if (i == pin) sh_pin_v = ms;
    }
  }
  warp_best(bk, br, bi);
  if (lane == 0) sh_best[warp] = Best{bk, br, bi};
  if (s.with_topk) {
    unsigned ok[TOPK];
    int oi[TOPK];
    warp_top(lk, li, ok, oi);
#pragma unroll
    for (int k = 0; k < TOPK; ++k)
      if (k == lane) {
        sh_tk[warp][k] = ok[k];
        sh_ti[warp][k] = oi[k];
      }
  }
  __syncthreads();

  StepSlot* out = slots + blockIdx.x;
  if (warp == 0) {
    Best b = {PAD_KEY, NO_RANK, NO_NODE};
    if (lane < SW_WARPS) b = sh_best[lane];
    warp_best(b.k, b.r, b.i);
    if (lane == 0) {
      out->k = b.k;
      out->r = b.r;
      out->i = b.i;
      out->pin_v = sh_pin_v;
    }
  } else if (warp == 1) {
    unsigned tk[TOPK], ok[TOPK];
    int ti[TOPK], oi[TOPK];
    list_clear(tk, ti);
    if (s.with_topk && lane < SW_WARPS) {
#pragma unroll
      for (int k = 0; k < TOPK; ++k) {
        tk[k] = sh_tk[lane][k];
        ti[k] = sh_ti[lane][k];
      }
    }
    warp_top(tk, ti, ok, oi);
#pragma unroll
    for (int k = 0; k < TOPK; ++k)
      if (k == lane) {
        out->tk[k] = ok[k];
        out->ti[k] = oi[k];
      }
  }
}

// ---- a step, one warp on the root: the merge ----
__global__ void sw_merge_kernel(const Shape s, const Pos* root_pos,
                                const StepSlot* slots, int n_slots,
                                Winner* win, int t, int m, int j,
                                float* packed, int* topk_idx,
                                float* topk_scores) {
  const int lane = threadIdx.x;
  Best b = {PAD_KEY, NO_RANK, NO_NODE};
  float pin_v = NEG_INF_F;
  unsigned lk[TOPK], ok[TOPK];
  int li[TOPK], oi[TOPK];
  list_clear(lk, li);
  for (int x = lane; x < n_slots; x += 32) {
    const StepSlot& sl = slots[x];
    if (sl.k > b.k || (sl.k == b.k && (sl.r < b.r ||
                                       (sl.r == b.r && sl.i < b.i))))
      b = Best{sl.k, sl.r, sl.i};
    pin_v = fmaxf(pin_v, sl.pin_v);
    if (s.with_topk)
#pragma unroll
      for (int k = 0; k < TOPK; ++k)
        list_insert_ordered(lk, li, sl.tk[k], sl.ti[k]);
  }
  // the cascade: largest value, then lowest rank (ranks are distinct)
  warp_best(b.k, b.r, b.i);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    pin_v = fmaxf(pin_v, __shfl_xor_sync(FULL_MASK, pin_v, off));
  warp_top(lk, li, ok, oi);

  int idx = b.i;
  float val = key_score(b.k);
  if (s.with_pref) {
    // pin rule (sharded.py:397-406): a feasible pin wins; its masked step
    // value is > NEG_INF / 2 exactly then
    const int pref = __ldg(pleaf<int>(s, root_pos[0], L_STEP_PREF, m) + j);
    if (pref >= 0 && pin_v > NEG_INF_F / 2.0f) {
      idx = min(pref, s.n_glob - 1);
      val = pin_v;
    }
  }
  const bool found = val > NEG_INF_F / 2.0f;
  if (lane == 0) {
    packed[t] = found ? (float)idx : -1.0f;
    packed[s.t + t] = found ? val : 0.0f;
    *win = Winner{found ? idx : -1, found ? 1 : 0, m, 0};
  }
#pragma unroll
  for (int k = 0; k < TOPK; ++k)
    if (k == lane) {
      topk_idx[t * TOPK + k] = s.with_topk ? oi[k] : 0;
      topk_scores[t * TOPK + k] = s.with_topk ? key_score(ok[k]) : NEG_INF_F;
    }
}

// ---- wave end ----
// one block a position: the last winner, committed where it lies
__global__ void sw_last_kernel(const Shape s, const Pos* pos,
                               const Winner* win) {
  if (threadIdx.x != 0) return;
  const Pos& p = pos[blockIdx.x];
  const Winner w = *win;
  const int x = w.idx - p.g0;
  if (w.found && x >= 0 && x < s.n_loc) commit_row(s, p, w.m, x);
}

// the metric partials of every position summed into the packed buffer
__global__ void sw_metrics_kernel(const Shape s, const int* part, int n_pos,
                                  float* packed) {
  float* metrics = packed + 2 * s.t;
  for (int e = threadIdx.x; e < 8 * s.b; e += blockDim.x) {
    const int q = e / s.b, m = e % s.b;
    int sum = 0;  // exhausted_devices, exhausted_cores: outside the envelope
    if (q < 6)
      for (int p = 0; p < n_pos; ++p) sum += part[(p * 6 + q) * s.b + m];
    metrics[e] = (float)sum;
  }
}

// ---- the host loop ----

#define CK(x)                                   \
  do {                                          \
    const cudaError_t e_ = (x);                 \
    if (e_ != cudaSuccess) return e_;           \
  } while (0)
#define CK_LAUNCH() CK(cudaGetLastError())

struct Events {
  cudaEvent_t root = nullptr;               // on the root: its last merge
  cudaEvent_t card[MAX_CARDS] = {};         // on each other card
};

static cudaError_t run_wave(const ShardedArgs& a, Events& ev) {
  const Shape& s = a.s;
  const Card* c = a.card;
  const Card& root = c[0];
  const bool multi = a.n_cards > 1;
  int n_pos = 0;
  for (int d = 0; d < a.n_cards; ++d) n_pos += c[d].n_pos;
  const int n_slots = n_pos * s.nb;
  auto stream = [&](int d) { return (cudaStream_t)c[d].stream; };

  // every card's stream after the root's earlier work (the root's buffers
  // of this wave may be memory an earlier root launch still reads)
  if (multi) {
    CK(cudaSetDevice(root.ordinal));
    CK(cudaEventCreateWithFlags(&ev.root, cudaEventDisableTiming));
    CK(cudaEventRecord(ev.root, stream(0)));
    for (int d = 1; d < a.n_cards; ++d) {
      CK(cudaSetDevice(c[d].ordinal));
      CK(cudaEventCreateWithFlags(&ev.card[d], cudaEventDisableTiming));
      CK(cudaStreamWaitEvent(stream(d), ev.root, 0));
    }
  }

  // wave start on every card; the partials reach the root
  for (int d = 0; d < a.n_cards; ++d) {
    const Card& k = c[d];
    CK(cudaSetDevice(k.ordinal));
    CK(cudaMemcpyAsync(k.pos, k.pos_host, k.n_pos * sizeof(Pos),
                       cudaMemcpyHostToDevice, stream(d)));
    CK(cudaMemsetAsync(k.win, 0, sizeof(Winner), stream(d)));
    CK(cudaMemsetAsync(k.part, 0, (size_t)k.n_pos * 6 * s.b * sizeof(int),
                       stream(d)));
    const dim3 grid((s.n_loc + SW_ROWS - 1) / SW_ROWS, k.n_pos * s.b);
    sw_init_kernel<<<grid, SW_THREADS, 0, stream(d)>>>(s, k.pos, k.part);
    CK_LAUNCH();
    if (s.with_shuffle) {
      const long long e = (long long)s.bp * s.n_glob;
      sw_rank_kernel<<<(unsigned)((e + 255) / 256), 256, 0, stream(d)>>>(
          s, k.pos, k.rank);
      CK_LAUNCH();
    }
    if (d > 0) {
      CK(cudaMemcpyPeerAsync(root.part + (size_t)k.pos0 * 6 * s.b,
                             root.ordinal, k.part, k.ordinal,
                             (size_t)k.n_pos * 6 * s.b * sizeof(int),
                             stream(d)));
      CK(cudaEventRecord(ev.card[d], stream(d)));
    }
  }
  CK(cudaSetDevice(root.ordinal));
  sw_idle_kernel<<<(s.t + 255) / 256, 256, 0, stream(0)>>>(
      s, a.packed, a.topk_idx, a.topk_scores);
  CK_LAUNCH();
  for (int d = 1; d < a.n_cards; ++d)
    CK(cudaStreamWaitEvent(stream(0), ev.card[d], 0));

  // the active steps
  for (int x = 0; x < a.n_act; ++x) {
    const int t = a.act_t[x], m = a.act_m[x], j = a.act_j[x];
    for (int d = 0; d < a.n_cards; ++d) {
      const Card& k = c[d];
      CK(cudaSetDevice(k.ordinal));
      if (d > 0 && x > 0) CK(cudaStreamWaitEvent(stream(d), ev.root, 0));
      sw_step_kernel<<<k.n_pos * s.nb, SW_THREADS, 0, stream(d)>>>(
          s, k.pos, k.rank, k.win, k.slots, m, j);
      CK_LAUNCH();
      if (d > 0) {
        CK(cudaMemcpyPeerAsync(root.slots + (size_t)k.pos0 * s.nb,
                               root.ordinal, k.slots, k.ordinal,
                               (size_t)k.n_pos * s.nb * sizeof(StepSlot),
                               stream(d)));
        CK(cudaEventRecord(ev.card[d], stream(d)));
      }
    }
    CK(cudaSetDevice(root.ordinal));
    for (int d = 1; d < a.n_cards; ++d)
      CK(cudaStreamWaitEvent(stream(0), ev.card[d], 0));
    sw_merge_kernel<<<1, 32, 0, stream(0)>>>(s, root.pos, root.slots,
                                             n_slots, root.win, t, m, j,
                                             a.packed, a.topk_idx,
                                             a.topk_scores);
    CK_LAUNCH();
    if (multi) {
      for (int d = 1; d < a.n_cards; ++d)
        CK(cudaMemcpyPeerAsync(c[d].win, c[d].ordinal, root.win,
                               root.ordinal, sizeof(Winner), stream(0)));
      CK(cudaEventRecord(ev.root, stream(0)));
    }
  }

  // the last winner on every card; the metrics on the root
  for (int d = 0; d < a.n_cards; ++d) {
    const Card& k = c[d];
    CK(cudaSetDevice(k.ordinal));
    if (d > 0 && a.n_act > 0) CK(cudaStreamWaitEvent(stream(d), ev.root, 0));
    sw_last_kernel<<<k.n_pos, 32, 0, stream(d)>>>(s, k.pos, k.win);
    CK_LAUNCH();
  }
  CK(cudaSetDevice(root.ordinal));
  sw_metrics_kernel<<<1, 256, 0, stream(0)>>>(s, root.part, n_pos,
                                              a.packed);
  CK_LAUNCH();
  return cudaSuccess;
}

extern "C" int sharded_wave_launch(const ShardedArgs* args) {
  const ShardedArgs& a = *args;
  if (a.n_cards < 1 || a.n_cards > MAX_CARDS || a.s.p > MAX_P ||
      a.s.nb < 1 || a.s.n_loc < 1)
    return (int)cudaErrorInvalidValue;
  int prior = 0;
  cudaError_t e = cudaGetDevice(&prior);
  if (e != cudaSuccess) return (int)e;
  Events ev;
  e = run_wave(a, ev);
  // an event destroyed while pending is released once it completes
  if (ev.root) cudaEventDestroy(ev.root);
  for (int d = 1; d < MAX_CARDS; ++d)
    if (ev.card[d]) cudaEventDestroy(ev.card[d]);
  const cudaError_t e2 = cudaSetDevice(prior);
  return (int)(e != cudaSuccess ? e : e2);
}
