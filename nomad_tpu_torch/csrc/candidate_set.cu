// The single eval's candidate set for NVIDIA Hopper (sm_90a): one C call,
// two launches on the caller's stream, the second a programmatic dependent
// launch.
//
// Replaces: the XLA program nomad_tpu/ops/kernel.py `place_taskgroup_topk`
// (:726-973), jitted as `place_taskgroup_topk_jit` (:974), which the
// reference's single-eval launcher runs first for an eval without spread
// stanzas (the port's ops/kernel.default_kernel_launch, `single_topk`). It
// computes what nomad_tpu_torch/ops/kernel.place_taskgroup_topk computes
// for one eval under any feature union without spreads:
//
// 1. one full-width pass of the feasibility and the score with the eval's
//    initial carries: the eight AllocMetric counts and every node's masked
//    score;
// 2. the exact top k_cand of those scores by (score desc, node asc),
//    `topk_ordered`'s order, and the rest max, the best score outside them
//    (NEG_INF when every node is a candidate);
// 3. the preferred pins appended as rows k_cand + i, their base mask
//    cleared where the pin is below 0 (so a row can repeat a candidate);
// 4. K placement steps over those rows as ops/kernel._place_scan runs
//    them: step penalties matched on node ids, the first argmax in the
//    rows' shuffle order (node_perm[node] ascending, then row: the stable
//    argsort of the plain version), the pin where it is feasible and the
//    step active, the top-8 as a stable descending sort over rows mapped to
//    node ids, and each placement deducted from every row of its node;
// 5. `valid`: at every active step that places, the value reaches the rest
//    max unless pinned, and no wanted placement is missing while the rest
//    of the cluster could still take one.
//
// What bounds it. Bytes: the pass reads each of the eval's node planes once
// (770,396 B for a lean eval at N=16384: 0.23 us at 3.35 TB/s). Operations:
// ~25 f32 operations a node in the pass, then K dependent steps. Neither is
// the limit at the live width. The kernel's time is latency: the pass's
// one node a thread and its selection (a few radix passes, two barriers
// each), the scan's selection and rows, and then the step chain, in which
// each step waits on the rescore of the node the last one placed on (two
// powf and three divisions in a dependent chain) and two barriers.
//
// Design (redesigned for the H100; the first kernel rescored every row at
// every step, walked every row to commit and sorted each pass CTA's keys):
// - Launch 1, cand_pass_kernel: one thread a node over a grid of
//   PASS_THREADS-thread CTAs. A node's masked score becomes a u64 key, the
//   order-preserving score bits (wave_score.cuh `score_key`: -0.0 and +0.0
//   share a key, as torch compares them) above ~node, so keys are distinct
//   and key order is (score desc, node asc). A CTA whose range holds more
//   than mm = min(m, PASS_THREADS) nodes, m = k_cand + 1 (or N), hands on
//   its best mm keys in no order (pass_take): radix passes of eight bits on
//   the score key alone, from the highest bit where the CTA's scores
//   differ, each stopping at the first pass whose bin holds exactly the
//   keys still wanted; a score tied across the cut gives its lowest nodes,
//   which are the CTA's threads in order. Then the keys taken are
//   compacted by ballot. Every key of the m best overall is among its
//   CTA's mm best. The metric counts go to one row of partial sums.
// - Launch 2, cand_scan_kernel: one CTA, launched with programmatic stream
//   serialisation: it may start while the pass runs (each pass CTA lets it
//   go at its start) and waits in griddepcontrol.wait, which returns once
//   the pass has finished and its writes are visible. That takes the
//   launch gap off the stream without any state shared between calls: the
//   other way, the last pass CTA running the scan behind a ticket counter,
//   needs a counter that concurrent calls on several streams (worker
//   threads beside the warmup) cannot share, so one zeroed each call, and
//   it runs the scan on a 1024-thread CTA's resources. A plain second
//   launch, timed beside this one on an H100 (N=16384, K=16), took about
//   1.5 us more a call: the gap between the two launches. The scan sums the
//   partial counts, stages the pass's keys in shared memory where they fit,
//   selects the m-th key by the same radix passes on the whole u64 key
//   (scan_select), orders the m keys by counting, and builds the rows.
// - Rows. Row r is a candidate (r < k_cand) or the pin of step r - k_cand.
//   Each row names its head: the first row of its node (its candidate row,
//   found by the node's pass key, else the first pin on the node). That is
//   the node-to-rows link: rows of one node share their carries and their
//   score (a pin below 0 is only ever infeasible), so the head alone keeps
//   the node's JNode (planes and carries) and its cached keys: without and
//   with a step penalty (equal under the static penalty), and whether the
//   node is feasible. A commit touches the head only.
// - Steps. A row's key at a step is its head's key with or without the
//   penalty (the step's penalty nodes, held in shared memory), or the
//   infeasible key for a pin below 0. The rescoring set: a row's key
//   changes between steps only by a placement on its node and by its node
//   entering or leaving the step's penalty set (a choice between the two
//   cached keys). A head also keeps its keys after one more placement
//   (hnext), so a placement switches to keys computed before it. Warps:
//   the commit warp (0), the row warps (1..nw, STEP_ROWS rows a lane up to
//   14 warps) and the top warp. Phase 1: a row warp whose rows hold a node
//   of the rescoring set rebuilds its argmax and its lanes' top-8 lists
//   from the cached keys (one warp holds every row to ~40 steps and always
//   rebuilds; it hands its lanes' lists to the top warp), while the commit
//   warp applies the last placement to its head's carries and computes the
//   head's keys after one more (the one rescore a step, both keys from one
//   node_rest_base) and reads the pin's cached keys. A barrier. Phase 2:
//   the commit warp merges the argmaxes, takes the pin or the argmax,
//   writes the step's outputs and switches the head to its next keys;
//   several row warps merge their lanes' lists into each warp's top-8. A
//   second barrier, without the top warp, which merges the step's lists
//   into its top-8 outputs while the next step runs and meets the others
//   only at the first barrier. The steps past n_steps (the live path pads
//   10 placements to a bucket of 16) write their fixed outputs unscored.
// - The selection buffers and the row arrays live in shared memory while
//   they fit what a block may take (the staged keys where the heads'
//   JNodes go once the selection is done); past that (k_steps in the hundreds)
//   the heads' JNodes, then the rest, go to the global scratch after the
//   keys, read through the same generic pointer. No k_steps is refused.
//   The host asks candidate_set_plan for the scratch's bytes; the layout
//   stays here. The outputs go to the caller's one buffer
//   (ops/cuda_kernel.candidate_layout), which the host reads back in one
//   copy.
// - The per-node arithmetic is csrc/joint_node.cuh's (node_fits,
//   node_rest_base and node_rest_tail, count_metrics): the torch version's
//   operation order, built with -fmad=false and no fast-math, so the
//   kernel places bit for bit as the plain version does on the card. A
//   head takes each placement on its node in turn, as joint_node.cuh's
//   single-eval commit.
//
// Built by nomad_tpu_torch/ops/build.py, loaded with ctypes.

#include "joint_node.cuh"

#define PASS_THREADS 1024         // nodes a CTA of the pass, one a thread
#define PASS_WARPS (PASS_THREADS / 32)
#define SCAN_THREADS 512
#define SCAN_WARPS (SCAN_THREADS / 32)
#define SCAN_BAR 1                 // the named barrier of the steps' warps
#define STEP_BAR 2                 // and the one the top warp stays out of
#define RADIX 256                  // bins of one selection pass
#define STEP_ROWS 4                // rows a lane of a row warp holds
#define MAX_ROW_WARPS (SCAN_WARPS - 2)  // beside the commit and top warps
#define MAX_DEVICES 64

static_assert(N_MET == 8 && SCAN_THREADS % N_MET == 0,
              "a thread sums one metric of the partial counts, lanes l, "
              "l^8, l^16 and l^24 the same");

typedef unsigned long long u64;

// What one call is given, by value. Mirrored by
// nomad_tpu_torch/ops/cuda_kernel._CandLaunch.
struct CandLaunch {
  JointArgs a;             // the eval as a one-member wave: leaves at stride
                           // 0, a.topk_idx / a.topk_scores its [K, 8] out
  unsigned char* scratch;  // candidate_set_plan's bytes
  long long scratch_bytes;
  int* chosen;             // i32 [k_steps]
  float* scores;           // f32 [k_steps]
  unsigned char* found;    // bool [k_steps]
  int* metrics;            // i32 [N_MET], FUSED_METRIC_FIELDS order
  unsigned char* valid;    // bool [1]
  long long* stamps;       // i64 [4] the scan's clock64 stamps, or 0
  int k_steps, k_cand;
};

// One row: its node, its head (the node's first row), its place among
// equal scores (node_perm[node] with shuffle, else the row), and whether it
// is the pin of a step pinned below 0 (its base cleared: never feasible).
struct CRef {
  int node, head;
  unsigned tie;
  int pad;
};

// A head's cached keys: its node's masked score without and with a step
// penalty, and whether the node is feasible (the pin's test).
struct CKey {
  unsigned kn, kp;
  int ok, unused;
};

// Where a call's buffers are (bytes), from its widths.
struct CandPlan {
  long long keys, parts, scratch;
  long long sel, refs, hkeys, steps, small, rows;  // hkeys: cur, then next
  int blocks;        // CTAs of the pass
  int m;             // keys selected: the candidates, then the rest max's
  int mm;            // keys each CTA of the pass hands on
  int k_all;         // rows: candidates, then one pin a step
  int nw;            // the steps' row warps
  int smem;          // the scan's dynamic shared memory
  int small_shared;  // the selection buffers and row arrays in it
  int rows_shared;   // the heads' JNodes in it too
  int stage_shared;  // the pass's keys staged in it for the selection
};

static long long align16(long long x) { return (x + 15) & ~15LL; }

static CandPlan cand_plan(int n, int k_steps, int k_cand, int with_pref,
                          int limit) {
  CandPlan p;
  p.blocks = (n + PASS_THREADS - 1) / PASS_THREADS;
  p.m = k_cand < n ? k_cand + 1 : n;
  p.mm = p.m < PASS_THREADS ? p.m : PASS_THREADS;
  p.k_all = k_cand + (with_pref ? k_steps : 0);
  const int lanes = (p.k_all + STEP_ROWS - 1) / STEP_ROWS;
  const int w = (lanes + 31) / 32;
  p.nw = w < 1 ? 1 : (w < MAX_ROW_WARPS ? w : MAX_ROW_WARPS);
  p.keys = align16(8LL * p.blocks * p.mm);
  p.parts = align16(4LL * N_MET * p.blocks);
  // the unordered keys and the ordered keys; the rows' refs; the heads'
  // keys; the step nodes; then the heads' JNodes
  p.sel = align16(16LL * p.m);
  p.refs = align16((long long)sizeof(CRef) * p.k_all);
  p.hkeys = align16((long long)sizeof(CKey) * 2 * p.k_all);
  p.steps = align16(4LL * (MAX_P + 1) * k_steps);
  p.small = p.sel + p.refs + p.hkeys + p.steps;
  p.rows = align16((long long)sizeof(JNode) * p.k_all);
  p.small_shared = p.small <= limit;
  p.rows_shared = p.small + p.rows <= limit;
  // the pass's keys, staged after the small arrays where the rows go later
  const long long stage = align16(8LL * p.blocks * p.mm);
  p.stage_shared = p.small_shared && p.small + stage <= limit;
  const long long after = p.rows_shared ? p.rows : 0;
  const long long big = p.stage_shared && stage > after ? stage : after;
  p.smem = p.small_shared ? (int)(p.small + big) : 0;
  p.scratch = p.keys + p.parts + (p.small_shared ? 0 : p.small) +
              (p.rows_shared ? 0 : p.rows);
  return p;
}

__device__ __forceinline__ u64 cand_key(float s, int node) {
  return ((u64)score_key(s) << 32) | (unsigned)(~node);
}

__device__ __forceinline__ int key_node(u64 k) {
  return (int)(~(unsigned)k);
}

__device__ __forceinline__ float key_value(u64 k) {
  return key_score((unsigned)(k >> 32));
}

// Node i as the eval's pass sees it: its planes, the used planes and counts
// of the input, no carries yet (ops/kernel._carry_init).
__device__ __forceinline__ JNode cand_node(const JointArgs& a, int i) {
  JNode d;
  d.cap_cpu = __ldg(leaf_of<float>(a, J_CAP_CPU, 0) + i);
  d.cap_mem = __ldg(leaf_of<float>(a, J_CAP_MEM, 0) + i);
  d.cap_disk = __ldg(leaf_of<float>(a, J_CAP_DISK, 0) + i);
  d.aff = __ldg(leaf_of<float>(a, J_AFF, 0) + i);
  d.base = __ldg(leaf_of<unsigned char>(a, J_BASE, 0) + i) != 0;
  d.pen = __ldg(leaf_of<unsigned char>(a, J_PENALTY, 0) + i) != 0;
  d.used_cpu = __ldg(leaf_of<float>(a, J_USED_CPU, 0) + i);
  d.used_mem = __ldg(leaf_of<float>(a, J_USED_MEM, 0) + i);
  d.used_disk = __ldg(leaf_of<float>(a, J_USED_DISK, 0) + i);
  d.a_cpu = d.a_mem = d.a_disk = 0.0f;
  d.free_dyn = a.with_ports ? __ldg(leaf_of<int>(a, J_FREE_DYN, 0) + i) : 0;
  d.a_dyn = 0;
  d.spc = a.with_cores ? __ldg(leaf_of<float>(a, J_SPC, 0) + i) : 0.0f;
  d.free_cores =
      a.with_cores ? __ldg(leaf_of<int>(a, J_FREE_CORES, 0) + i) : 0;
  d.used_cores =
      a.with_cores ? __ldg(leaf_of<int>(a, J_USED_CORES, 0) + i) : 0;
  d.a_cores = 0;
  d.used_mbits =
      a.with_network ? __ldg(leaf_of<int>(a, J_USED_MBITS, 0) + i) : 0;
  d.avail_mbits =
      a.with_network ? __ldg(leaf_of<int>(a, J_AVAIL_MBITS, 0) + i) : 0;
  d.a_mbits = 0;
  d.dev_aff = a.with_devices ? __ldg(leaf_of<float>(a, J_DEV_AFF, 0) + i)
                             : 0.0f;
#pragma unroll
  for (int q = 0; q < MAX_D; ++q) {
    d.dev[q] = a.with_devices ? __ldg(leaf_of<float>(a, J_DEV_FREE, 0) +
                                      (long long)i * MAX_D + q)
                              : 0.0f;
    d.a_dev[q] = 0.0f;
  }
  d.jtc = __ldg(leaf_of<int>(a, J_JTC, 0) + i);
  d.jac = a.with_distinct ? __ldg(leaf_of<int>(a, J_JAC, 0) + i) : 0;
  d.pc = a.with_ports && __ldg(leaf_of<unsigned char>(a, J_PC, 0) + i) != 0;
  return d;
}

// The masked score of a node (ops/kernel._score over _feasible's mask).
__device__ __forceinline__ float masked_value(const JointArgs& a,
                                              const JMember& v,
                                              const JNode& d, bool pen) {
  float sum;
  unsigned cnt;
  node_rest(a, v, d, pen, sum, cnt);
  return cnt != 0 ? sum / (float)cnt : NEG_INF_F;
}

// A head's keys from its node's planes and carries: the very values a
// rescore of any of its rows gives at a step without and with a penalty,
// both finished from one node_rest_base (joint_node.cuh's order).
__device__ __forceinline__ CKey head_keys(const JointArgs& a,
                                          const JMember& v, const JNode& d) {
  CKey k;
  k.unused = 0;
  float s;
  unsigned c;
  k.ok = node_rest_base(a, v, d, s, c);
  if (!k.ok) {
    k.kn = k.kp = score_key(NEG_INF_F);
    return k;
  }
  float sn = s, sp = s;
  unsigned cn = c, cp = c;
  node_rest_tail(d, d.pen, sn, cn);
  node_rest_tail(d, true, sp, cp);
  k.kn = score_key(sn / (float)cn);
  k.kp = score_key(sp / (float)cp);
  return k;
}

// One placement on a head's node (ops/kernel._deduct at that node): the
// used planes take the ask in turn, as joint_node.cuh's single-eval commit.
__device__ __forceinline__ void cand_commit(const JointArgs& a,
                                            const JMember& v, JNode& d) {
  const float act = ask_cpu_total(a, v, d);
  d.used_cpu = d.used_cpu + act;
  d.used_mem = d.used_mem + v.ask_mem;
  d.used_disk = d.used_disk + v.ask_disk;
  d.jtc += 1;
  if (a.with_ports) {
    d.a_dyn += v.ask_dyn;
    if (v.has_res) d.pc = true;
  }
  if (a.with_distinct) d.jac += 1;
  if (a.with_cores) d.a_cores += v.ask_cores;
  if (a.with_network) d.a_mbits += v.ask_mbits;
  if (a.with_devices) {
#pragma unroll
    for (int q = 0; q < MAX_D; ++q) d.dev[q] = d.dev[q] - v.ask_dev[q];
  }
}

__device__ __forceinline__ void scan_bar(int nt) {
  asm volatile("bar.sync %0, %1;" ::"n"(SCAN_BAR), "r"(nt) : "memory");
}

// The second barrier of a step: the commit and row warps, not the top warp.
__device__ __forceinline__ void step_bar(int nt) {
  asm volatile("bar.sync %0, %1;" ::"n"(STEP_BAR), "r"(nt) : "memory");
}

// The split tool's probe: thread 0's clock at edge j of the scan's phases
// (0-3: after the pass, the selection, the rows, the steps), where the
// tool passes a buffer.
__device__ __forceinline__ void stamp(const CandLaunch& c, int j) {
  if (c.stamps && threadIdx.x == 0) c.stamps[j] = clock64();
}

__device__ __forceinline__ bool in_set(const int* s, int node) {
  bool hit = false;
#pragma unroll
  for (int q = 0; q < MAX_P; ++q) hit = hit || s[q] == node;
  return hit;
}

// One key a lane into a pass's histogram where `in`: a warp whose lanes
// all hold one digit adds once, else each lane adds its own.
__device__ __forceinline__ void hist_count(unsigned* h, unsigned dg,
                                           bool in) {
  const unsigned lead = __shfl_sync(FULL_MASK, dg, 0);
  const bool lead_in = __shfl_sync(FULL_MASK, in, 0);
  if (__all_sync(FULL_MASK, dg == lead && in == lead_in)) {
    if (lead_in && (threadIdx.x & 31) == 0) atomicAdd(&h[lead], 32u);
  } else if (in) {
    atomicAdd(&h[dg], 1u);
  }
}

// Warp 0: the bin of a pass's histogram `h` that holds the `remaining`-th
// largest key (sel[0]), the keys in the bins above it (sel[1]) and in it
// (sel[2]); and `next`, the next pass's histogram, zeroed (its last
// readers, the last pass's, are past a barrier).
__device__ __forceinline__ void find_bin(const unsigned* h, int remaining,
                                         int* sel, unsigned* next) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < RADIX / 32; ++j) next[lane + 32 * j] = 0u;
  // lane l holds bins 255 - 8l .. 248 - 8l, the largest first
  const uint4 lo4 = *reinterpret_cast<const uint4*>(h + RADIX - 8 - 8 * lane);
  const uint4 hi4 = *reinterpret_cast<const uint4*>(h + RADIX - 4 - 8 * lane);
  const unsigned cb[8] = {hi4.w, hi4.z, hi4.y, hi4.x,
                          lo4.w, lo4.z, lo4.y, lo4.x};
  unsigned sum = 0u;
#pragma unroll
  for (int j = 0; j < 8; ++j) sum += cb[j];
  unsigned incl = sum;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const unsigned t = __shfl_up_sync(FULL_MASK, incl, off);
    if (lane >= off) incl += t;
  }
  unsigned acc = incl - sum;
  if (acc < (unsigned)remaining && (unsigned)remaining <= incl) {
    bool done = false;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (!done && acc + cb[j] >= (unsigned)remaining) {
        sel[0] = RADIX - 1 - 8 * lane - j;
        sel[1] = (int)acc;
        sel[2] = (int)cb[j];
        done = true;
      }
      acc += cb[j];
    }
  }
}

// The pass CTA's keys to hand on: whether this thread's key is among the
// CTA's best `want` (every thread calls it; `valid` marks a node). Its
// score key `sk` decides, over radix passes of eight bits from the highest
// bit where the CTA's scores differ, each ending at the first pass whose
// bin holds exactly the keys still wanted; a score tied across the cut
// gives its lowest nodes, the threads in order (a key's ~node order).
// `hist` is 2 * RADIX counters, `sel` three ints and `wred` 3 * PASS_WARPS
// words of shared memory.
__device__ __forceinline__ bool pass_take(unsigned sk, bool valid, int want,
                                          unsigned* hist, int* sel,
                                          unsigned* wred) {
  static_assert(PASS_WARPS == 32, "a warp reduces the warps' words");
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int x = tid; x < RADIX; x += PASS_THREADS) hist[x] = 0u;
  const unsigned wmax = __reduce_max_sync(FULL_MASK, valid ? sk : 0u);
  const unsigned wmin = __reduce_min_sync(FULL_MASK, valid ? sk : ~0u);
  if (lane == 0) {
    wred[warp] = wmax;
    wred[PASS_WARPS + warp] = wmin;
  }
  __syncthreads();
  const unsigned smax = __reduce_max_sync(FULL_MASK, wred[lane]);
  const unsigned smin = __reduce_min_sync(FULL_MASK, wred[PASS_WARPS + lane]);
  const unsigned diff = smax ^ smin;
  unsigned prefix = smax;
  int remaining = want;
  bool tie = true;
  if (diff != 0u) {
    int hi = 31 - __clz(diff);
    unsigned mask = hi == 31 ? 0u : ~((2u << hi) - 1u);
    prefix = smax & mask;
    for (int pass = 0;; ++pass) {
      const int w = min(8, hi + 1), lo = hi - w + 1;
      const unsigned dm = (1u << w) - 1u;
      unsigned* h = hist + (pass & 1) * RADIX;
      const bool in = valid && (sk & mask) == prefix;
      hist_count(h, in ? (sk >> lo) & dm : 0u, in);
      __syncthreads();
      if (warp == 0) find_bin(h, remaining, sel, hist + ((pass + 1) & 1) * RADIX);
      __syncthreads();
      const int bin = sel[0], above = sel[1], inbin = sel[2];
      remaining -= above;
      prefix |= (unsigned)bin << lo;
      mask |= dm << lo;
      if (inbin == remaining) {
        tie = false;
        break;
      }
      if (lo == 0) break;  // a whole score, tied across the cut
      hi = lo - 1;
    }
  }
  if (!tie) return valid && sk >= prefix;
  const bool eq = valid && sk == prefix;
  const unsigned bal = __ballot_sync(FULL_MASK, eq);
  if (lane == 0) wred[2 * PASS_WARPS + warp] = __popc(bal);
  __syncthreads();
  const unsigned before = __reduce_add_sync(
      FULL_MASK, lane < warp ? wred[2 * PASS_WARPS + lane] : 0u);
  const int rank = (int)(before + __popc(bal & ((1u << lane) - 1u)));
  return valid && (sk > prefix || (eq && rank < remaining));
}

__device__ __forceinline__ u64 warp_max64(u64 x) {
  const unsigned hi = __reduce_max_sync(FULL_MASK, (unsigned)(x >> 32));
  const unsigned lo = __reduce_max_sync(
      FULL_MASK, (unsigned)(x >> 32) == hi ? (unsigned)x : 0u);
  return ((u64)hi << 32) | lo;
}

__device__ __forceinline__ u64 warp_min64(u64 x) {
  const unsigned hi = __reduce_min_sync(FULL_MASK, (unsigned)(x >> 32));
  const unsigned lo = __reduce_min_sync(
      FULL_MASK, (unsigned)(x >> 32) == hi ? (unsigned)x : ~0u);
  return ((u64)hi << 32) | lo;
}

// The scan's threshold: exactly `want` of ks[0..nk) at or above it (keys
// distinct, 0 the pass's padding), over the block, by the pass's radix
// passes on the whole u64 key from the highest bit where the keys differ.
// `hist` is 2 * RADIX counters, zeroed past a barrier; `sel` three ints;
// `wred` 2 * SCAN_WARPS u64.
__device__ __forceinline__ u64 scan_select(const u64* ks, int nk, int want,
                                           unsigned* hist, int* sel,
                                           u64* wred) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  u64 mx = 0ull, mn = ~0ull;
  for (int i = tid; i < nk; i += SCAN_THREADS) {
    const u64 k = ks[i];
    if (k != 0ull) {
      mx = k > mx ? k : mx;
      mn = k < mn ? k : mn;
    }
  }
  mx = warp_max64(mx);
  mn = warp_min64(mn);
  if (lane == 0) {
    wred[warp] = mx;
    wred[SCAN_WARPS + warp] = mn;
  }
  __syncthreads();
  mx = warp_max64(lane < SCAN_WARPS ? wred[lane] : 0ull);
  mn = warp_min64(lane < SCAN_WARPS ? wred[SCAN_WARPS + lane] : ~0ull);
  const u64 diff = mx ^ mn;
  if (diff == 0ull) return mx;
  int hi = 63 - __clzll(diff);
  u64 mask = hi == 63 ? 0ull : ~((2ull << hi) - 1ull);
  u64 prefix = mx & mask;
  int remaining = want;
  for (int pass = 0;; ++pass) {
    // digits stop at bit 32, the score's end: past it a tie is cut on the
    // bits where the tied keys' nodes differ
    const int lo = max(hi - 7, hi >= 32 ? 32 : 0), w = hi - lo + 1;
    const u64 dm = (1ull << w) - 1ull;
    unsigned* h = hist + (pass & 1) * RADIX;
    for (int i0 = 0; i0 < nk; i0 += SCAN_THREADS) {
      const int i = i0 + tid;
      const u64 k = i < nk ? ks[i] : 0ull;
      const bool in = k != 0ull && (k & mask) == prefix;
      hist_count(h, in ? (unsigned)((k >> lo) & dm) : 0u, in);
    }
    __syncthreads();
    if (warp == 0) find_bin(h, remaining, sel, hist + ((pass + 1) & 1) * RADIX);
    __syncthreads();
    const int bin = sel[0], above = sel[1], inbin = sel[2];
    remaining -= above;
    prefix |= (u64)bin << lo;
    mask |= dm << lo;
    // every key of the bin is wanted (at the last bits the bin is one key)
    if (inbin == remaining || lo == 0) break;
    hi = lo - 1;
    if (lo == 32) {
      // a score tied across the cut: the highest bit where its keys' ~node
      // differ (at least two keys hold it), the bits above it common
      unsigned nx = 0u, nn = ~0u;
      for (int i = tid; i < nk; i += SCAN_THREADS) {
        const u64 k = ks[i];
        if (k != 0ull && (k & mask) == prefix) {
          nx = max(nx, (unsigned)k);
          nn = min(nn, (unsigned)k);
        }
      }
      nx = __reduce_max_sync(FULL_MASK, nx);
      nn = __reduce_min_sync(FULL_MASK, nn);
      if (lane == 0) {
        wred[warp] = nx;
        wred[SCAN_WARPS + warp] = nn;
      }
      __syncthreads();
      nx = __reduce_max_sync(FULL_MASK,
                             lane < SCAN_WARPS ? (unsigned)wred[lane] : 0u);
      nn = __reduce_min_sync(
          FULL_MASK, lane < SCAN_WARPS ? (unsigned)wred[SCAN_WARPS + lane]
                                       : ~0u);
      hi = 31 - __clz(nx ^ nn);
      const u64 common = hi == 31 ? 0ull : 0xffffffffull & ~((2ull << hi) - 1ull);
      prefix |= (u64)nx & common;
      mask |= common;
    }
  }
  return prefix;
}

__global__ void __launch_bounds__(PASS_THREADS)
    cand_pass_kernel(const CandLaunch c, const CandPlan p) {
  __shared__ int part[PASS_WARPS][N_MET];
  __shared__ __align__(16) unsigned hist[2 * RADIX];
  __shared__ unsigned wred[3 * PASS_WARPS];
  __shared__ int sel[3];
  __shared__ int cnt_at;
  // the scan may launch now; it waits for the whole pass before reading
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
  const JointArgs& a = c.a;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int lo = blockIdx.x * PASS_THREADS;
  const int i = lo + tid;
  int cnt[N_MET];
#pragma unroll
  for (int q = 0; q < N_MET; ++q) cnt[q] = 0;
  u64 key = 0ull;  // below every node's key: the padding past N
  if (i < a.n) {
    const JMember v = load_member(a, 0);
    const JNode d = cand_node(a, i);
    count_metrics(a, v, d, cnt);
    key = cand_key(masked_value(a, v, d, d.pen), i);
  }
  u64* pre = reinterpret_cast<u64*>(c.scratch) + (long long)blockIdx.x * p.mm;
  const int range = min(PASS_THREADS, a.n - lo);
  if (range <= p.mm) {
    // every node of the range is handed on (padding keys after them)
    if (tid < p.mm) pre[tid] = key;
  } else {
    // the range's best mm keys, in no order
    if (tid == 0) cnt_at = 0;
    const bool take = pass_take((unsigned)(key >> 32), i < a.n, p.mm, hist,
                                sel, wred);
    const unsigned bal = __ballot_sync(FULL_MASK, take);
    int at = 0;
    if (lane == 0 && bal) at = atomicAdd(&cnt_at, __popc(bal));
    at = __shfl_sync(FULL_MASK, at, 0);
    if (take) pre[at + __popc(bal & ((1u << lane) - 1u))] = key;
  }
#pragma unroll
  for (int q = 0; q < N_MET; ++q) {
    const int s = __reduce_add_sync(FULL_MASK, cnt[q]);
    if (lane == 0) part[warp][q] = s;
  }
  __syncthreads();
  if (tid < N_MET) {
    int s = 0;
#pragma unroll
    for (int w = 0; w < PASS_WARPS; ++w) s += part[w][tid];
    reinterpret_cast<int*>(c.scratch + p.keys)[blockIdx.x * N_MET + tid] = s;
  }
}

// Step i's top-8 outputs (ops/kernel._place_scan's stable descending sort
// over rows, mapped to node ids) from a warp's top-8 (every lane holds it).
__device__ __forceinline__ void write_top(const JointArgs& a,
                                          const CRef* refs, int k_all, int i,
                                          const unsigned* tk, const int* ti,
                                          int lane) {
  if (lane >= TOPK) return;
  unsigned k = PAD_KEY;
  int r = 0;
#pragma unroll
  for (int q = 0; q < TOPK; ++q)
    if (q == lane) {
      k = tk[q];
      r = ti[q];
    }
  a.topk_idx[i * TOPK + lane] = r >= 0 && r < k_all ? refs[r].node : 0;
  a.topk_scores[i * TOPK + lane] = key_score(k);
}

// The top warp: step i's top-8 from the row warps' lists (warps 1..nw of
// lk / li), written out.
__device__ __forceinline__ void merge_top_write(const JointArgs& a,
                                                const CRef* refs, int k_all,
                                                int i, int nw,
                                                unsigned (*lk)[TOPK],
                                                int (*li)[TOPK],
                                                int lane) {
  unsigned k[TOPK], tk[TOPK];
  int r[TOPK], ti[TOPK];
  list_clear(k, r);
  if (lane < nw) {
#pragma unroll
    for (int q = 0; q < TOPK; ++q) {
      k[q] = lk[lane + 1][q];
      r[q] = li[lane + 1][q];
    }
  }
  warp_top(k, r, tk, ti);
  write_top(a, refs, k_all, i, tk, ti, lane);
}

__global__ void __launch_bounds__(SCAN_THREADS, 1)
    cand_scan_kernel(const CandLaunch c, const CandPlan p) {
  extern __shared__ __align__(16) unsigned char dyn_smem[];
  __shared__ __align__(16) unsigned hist[2 * RADIX];
  __shared__ u64 wred[2 * SCAN_WARPS];
  __shared__ int sh_sel[3];
  __shared__ int sh_met[N_MET];
  __shared__ int sh_cnt;
  __shared__ Best sh_best[SCAN_WARPS];         // each row warp's argmax
  __shared__ unsigned sh_tk[2][SCAN_WARPS][TOPK];  // and its top-8, by
  __shared__ int sh_ti[2][SCAN_WARPS][TOPK];       // the step's parity
  __shared__ int sh_win;      // the node the step placed on, or -1
  // one row warp's lanes' top-8 lists, by the step's parity
  __shared__ unsigned sh_lk[2][32][TOPK];
  __shared__ int sh_li[2][32][TOPK];

  const JointArgs& a = c.a;
  const int n = a.n, kc = c.k_cand, m = p.m, k_all = p.k_all;
  const int nk = p.blocks * p.mm;  // the pass's keys: each CTA's best
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const u64* keys = reinterpret_cast<const u64*>(c.scratch);
  const int* parts = reinterpret_cast<const int*>(c.scratch + p.keys);
  unsigned char* gbase = c.scratch + p.keys + p.parts;
  unsigned char* small = p.small_shared ? dyn_smem : gbase;
  unsigned char* rows_at =
      p.rows_shared ? dyn_smem + p.small
                    : (p.small_shared ? gbase : gbase + p.small);
  u64* cand = reinterpret_cast<u64*>(small);
  u64* sorted = cand + m;
  CRef* refs = reinterpret_cast<CRef*>(small + p.sel);
  CKey* hkeys = reinterpret_cast<CKey*>(small + p.sel + p.refs);
  CKey* hnext = hkeys + k_all;  // a head's keys after one more placement
  int* steps = reinterpret_cast<int*>(small + p.sel + p.refs + p.hkeys);
  JNode* rows = reinterpret_cast<JNode*>(rows_at);

  if (tid < N_MET) sh_met[tid] = 0;
  if (tid == 0) sh_cnt = 0;
  for (int x = tid; x < 2 * RADIX; x += SCAN_THREADS) hist[x] = 0u;
  const JMember v = load_member(a, 0);
  // the pass's keys and counts: wait for the whole pass
  asm volatile("griddepcontrol.wait;" ::: "memory");
  __syncthreads();
  stamp(c, 0);

  // the metrics: thread tid sums metric tid % N_MET of every CTA (its
  // first partial in flight beside the keys' loads below)
  const int n_parts = p.blocks * N_MET;
  int met = tid < n_parts ? parts[tid] : 0;

  // ---- the m keys at or above the m-th largest, then in order ----
  // the pass's keys into shared memory where they fit (one read of L2,
  // four loads a thread in flight), so the radix passes read them there
  const u64* ks = keys;
  if (p.stage_shared) {
    u64* stage = reinterpret_cast<u64*>(dyn_smem + p.small);
    for (int i0 = 0; i0 < nk; i0 += 4 * SCAN_THREADS) {
      u64 kk[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = i0 + u * SCAN_THREADS + tid;
        kk[u] = i < nk ? keys[i] : 0ull;
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = i0 + u * SCAN_THREADS + tid;
        if (i < nk) stage[i] = kk[u];
      }
    }
    ks = stage;
  }
  for (int x = tid + SCAN_THREADS; x < n_parts; x += SCAN_THREADS)
    met += parts[x];
  met += __shfl_xor_sync(FULL_MASK, met, 8);
  met += __shfl_xor_sync(FULL_MASK, met, 16);
  if (lane < N_MET) atomicAdd(&sh_met[lane], met);
  __syncthreads();
  const u64 prefix = scan_select(ks, nk, m, hist, sh_sel, wred);
  for (int i0 = 0; i0 < nk; i0 += SCAN_THREADS) {
    const int i = i0 + tid;
    const u64 key = i < nk ? ks[i] : 0ull;
    const bool take = key != 0ull && key >= prefix;
    const unsigned bal = __ballot_sync(FULL_MASK, take);
    int at = 0;
    if (lane == 0 && bal) at = atomicAdd(&sh_cnt, __popc(bal));
    at = __shfl_sync(FULL_MASK, at, 0);
    if (take) cand[at + __popc(bal & ((1u << lane) - 1u))] = key;
  }
  // the steps' penalty nodes and pins, one row of MAX_P + 1 a step
  for (int x = tid; x < c.k_steps; x += SCAN_THREADS)
    load_step_nodes(a, 0, x, steps + x * (MAX_P + 1));
  __syncthreads();
  for (int x = tid; x < m; x += SCAN_THREADS) {
    const u64 key = cand[x];
    int r = 0;
    for (int j = 0; j < m; ++j) r += cand[j] > key;
    sorted[r] = key;
  }
  __syncthreads();
  stamp(c, 1);

  // ---- the rows: the candidates, then each step's pin ----
  const float rest = m > kc ? key_value(sorted[kc]) : NEG_INF_F;
  const int* perm = leaf_of<int>(a, J_PERM, 0);
  for (int r = tid; r < k_all; r += SCAN_THREADS) {
    CRef f;
    f.head = r;
    f.pad = 0;
    if (r < kc) {
      f.node = key_node(sorted[r]);
    } else {
      const int i = r - kc;
      const int pin = steps[i * (MAX_P + 1) + MAX_P];
      f.node = min(max(pin, 0), n - 1);
      f.pad = pin < 0;
    }
    const JNode d = cand_node(a, f.node);
    const CKey h = head_keys(a, v, d);
    if (r >= kc) {
      // the node's row among the candidates (its pass key, whose score is
      // the head's key without a step penalty, among theirs), else the
      // first pin on it
      const int i = r - kc;
      const u64 key = ((u64)h.kn << 32) | (unsigned)(~f.node);
      if (key >= sorted[kc - 1]) {
        int lo = 0, hi = kc - 1;  // sorted[lo..hi] descending holds key
        while (lo < hi) {
          const int mid = (lo + hi) >> 1;
          if (sorted[mid] > key) lo = mid + 1;
          else hi = mid;
        }
        f.head = lo;
      } else {
        int first = i;
        for (int j = 0; j < i; ++j) {
          const int pj = steps[j * (MAX_P + 1) + MAX_P];
          if (first == i && min(max(pj, 0), n - 1) == f.node) first = j;
        }
        f.head = kc + first;
      }
    }
    f.tie = a.with_shuffle ? (unsigned)__ldg(perm + f.node) : (unsigned)r;
    refs[r] = f;
    if (f.head == r) {
      rows[r] = d;
      hkeys[r] = h;
      JNode dn = d;
      cand_commit(a, v, dn);
      hnext[r] = head_keys(a, v, dn);
    }
  }
  if (tid < N_MET) c.metrics[tid] = sh_met[tid];
  __syncthreads();
  stamp(c, 2);

  // ---- the K steps: the commit warp, the row warps, the top warp ----
  const int nw = p.nw;
  const bool lane_lists = nw == 1;  // the top warp merges the lanes' lists
  const int nt_step = 32 * (nw + 1);
  const int nt = nt_step + (a.with_topk ? 32 : 0);
  if (tid >= nt) return;
  const int n_steps = *leaf_of<int>(a, J_NSTEPS, 0);
  const unsigned neg_key = score_key(NEG_INF_F);
  // the steps past n_steps place nothing and score every row NEG_INF: no
  // row need be scored for their outputs (no placement; the top-8 the
  // first eight rows, as a stable sort of equal values leaves them)
  const int active_steps = max(0, min(n_steps, c.k_steps));
  if (warp == 0) {
    for (int i = active_steps; i < c.k_steps; ++i) {
      if (lane == 0) {
        c.chosen[i] = -1;
        c.scores[i] = 0.0f;
        c.found[i] = 0;
      }
      if (lane < TOPK) {
        a.topk_idx[i * TOPK + lane] = a.with_topk ? refs[lane].node : 0;
        a.topk_scores[i * TOPK + lane] = NEG_INF_F;
      }
    }
  }
  const bool row_warp = warp >= 1 && warp <= nw;
  const bool top_warp = warp == nw + 1;
  const int r0 = (warp - 1) * 32 + lane;  // a row warp lane's first row
  const int stride = 32 * nw;             // and the rows apart on it
  bool ok = true, missing = false;
  int last = -1;                  // the node the last step placed on
  int pending = -1;               // the head the last step placed on
  int prev[MAX_P];                // the last step's penalty nodes
#pragma unroll
  for (int q = 0; q < MAX_P; ++q) prev[q] = -1;
  // a row warp's top-8 over its rows (first the lane's own list), kept
  // between steps
  unsigned wk[TOPK];
  int wi[TOPK];
  list_clear(wk, wi);
  for (int i = 0; i < active_steps; ++i) {
    int sp[MAX_P + 1];  // the step's penalty nodes, then its pin
#pragma unroll
    for (int q = 0; q <= MAX_P; ++q) sp[q] = steps[i * (MAX_P + 1) + q];
    bool fresh = false;
    bool pref_ok = false;
    float pin_v = 0.0f;
    if (row_warp) {
      // rebuild where a row's key may have changed: its node was placed on,
      // or entered or left the penalty set (one warp holds every row for
      // ~40 steps, and then the node just placed on is always its own)
      bool dirty = i == 0 || nw == 1;
      for (int r = r0; !dirty && r < k_all; r += stride) {
        const int node = refs[r].node;
        dirty = node == last || in_set(sp, node) || in_set(prev, node);
      }
      fresh = __any_sync(FULL_MASK, dirty);
      if (fresh) {
        unsigned bk = 0u, br = NO_RANK;
        int bi = -1;
        list_clear(wk, wi);
        for (int r = r0; r < k_all; r += stride) {
          const CRef f = refs[r];
          const CKey h = hkeys[f.head];
          const unsigned k =
              f.pad ? neg_key : (in_set(sp, f.node) ? h.kp : h.kn);
          if (k > bk || (k == bk && f.tie < br)) {
            bk = k;
            br = f.tie;
            bi = r;
          }
          if (a.with_topk) list_insert(wk, wi, k, r);
        }
        warp_best(bk, br, bi);
        if (lane == 0) sh_best[warp] = Best{bk, br, bi};
        if (a.with_topk && lane_lists) {
#pragma unroll
          for (int q = 0; q < TOPK; ++q) {
            sh_lk[i & 1][lane][q] = wk[q];
            sh_li[i & 1][lane][q] = wi[q];
          }
        }
      }
    } else if (warp == 0) {
      // the last step's placement on its head: the carries, and the keys
      // after one more placement (the ones this placement switched to
      // were ready); only this warp reads and writes the heads
      if (pending >= 0) {
        JNode d = rows[pending];
        cand_commit(a, v, d);
        JNode dn = d;
        cand_commit(a, v, dn);
        const CKey hn = head_keys(a, v, dn);
        if (lane == 0) {
          rows[pending] = d;
          hnext[pending] = hn;
        }
      }
      // the pin, from its head's cached keys
      if (a.with_pref && sp[MAX_P] >= 0) {
        const CRef f = refs[kc + i];
        const CKey h = hkeys[f.head];
        pref_ok = !f.pad && h.ok;
        pin_v = key_score(in_set(sp, f.node) ? h.kp : h.kn);
      }
    }
    scan_bar(nt);
    if (warp == 0) {
      Best b = lane < nw ? sh_best[lane + 1] : Best{0u, NO_RANK, -1};
      warp_best(b.k, b.r, b.i);
      const int idx = pref_ok ? kc + i : b.i;
      const float val = pref_ok ? pin_v : key_score(b.k);
      const bool fnd = val > NEG_INF_F / 2.0f;
      const CRef f = refs[idx];
      ok = ok && (!fnd || pref_ok || val >= rest);
      missing = missing || !fnd;
      if (lane == 0) {
        c.chosen[i] = fnd ? f.node : -1;
        c.scores[i] = fnd ? val : 0.0f;
        c.found[i] = fnd ? 1 : 0;
        // the placement's keys, computed at the last step that touched
        // the head; its carries follow at the next step
        if (fnd) hkeys[f.head] = hnext[f.head];
        sh_win = fnd ? f.node : -1;
      }
      if (!a.with_topk && lane < TOPK) {
        a.topk_idx[i * TOPK + lane] = 0;
        a.topk_scores[i * TOPK + lane] = NEG_INF_F;
      }
      pending = fnd ? f.head : -1;
    } else if (row_warp) {
      if (a.with_topk && !lane_lists) {
        if (fresh) {
          unsigned lk[TOPK];
          int li[TOPK];
#pragma unroll
          for (int q = 0; q < TOPK; ++q) {
            lk[q] = wk[q];
            li[q] = wi[q];
          }
          warp_top(lk, li, wk, wi);
        }
#pragma unroll
        for (int q = 0; q < TOPK; ++q)
          if (q == lane) {
            sh_tk[i & 1][warp][q] = wk[q];
            sh_ti[i & 1][warp][q] = wi[q];
          }
      }
    } else if (lane_lists) {
      // the top warp: this step's top-8 from the lanes' lists, written
      // while the next step runs (it waits at the next first barrier only)
      unsigned lk[TOPK], tk[TOPK];
      int li[TOPK], ti[TOPK];
#pragma unroll
      for (int q = 0; q < TOPK; ++q) {
        lk[q] = sh_lk[i & 1][lane][q];
        li[q] = sh_li[i & 1][lane][q];
      }
      warp_top(lk, li, tk, ti);
      write_top(a, refs, k_all, i, tk, ti, lane);
    } else if (i > 0) {
      merge_top_write(a, refs, k_all, i - 1, nw, sh_tk[(i - 1) & 1],
                      sh_ti[(i - 1) & 1], lane);
    }
    if (!top_warp) {
      step_bar(nt_step);
      last = sh_win;
#pragma unroll
      for (int q = 0; q < MAX_P; ++q) prev[q] = sp[q];
    }
  }
  if (a.with_topk && !lane_lists && active_steps > 0) {
    // the last step's row-warp lists, then the top warp's merge
    scan_bar(nt);
    if (top_warp)
      merge_top_write(a, refs, k_all, active_steps - 1, nw,
                      sh_tk[(active_steps - 1) & 1],
                      sh_ti[(active_steps - 1) & 1], lane);
  }
  if (tid == 0) {
    c.valid[0] = (ok && (!missing || rest <= NEG_INF_F / 2.0f)) ? 1 : 0;
    stamp(c, 3);
  }
}

// The dynamic shared memory the scan kernel may take on the current device
// (the opt-in limit less its static part), its attribute set once a device.
static int g_limit[MAX_DEVICES];

static cudaError_t scan_smem_limit(int* limit) {
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < MAX_DEVICES && g_limit[dev] > 0) {
    *limit = g_limit[dev];
    return cudaSuccess;
  }
  e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev);
  if (e != cudaSuccess) return e;
  cudaFuncAttributes fa;
  e = cudaFuncGetAttributes(&fa, cand_scan_kernel);
  if (e != cudaSuccess) return e;
  *limit = optin - (int)fa.sharedSizeBytes;
  e = cudaFuncSetAttribute(cand_scan_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           *limit);
  if (e != cudaSuccess) return e;
  if (dev < MAX_DEVICES) g_limit[dev] = *limit;
  return cudaSuccess;
}

// out[0]: the scratch bytes a call of these widths needs on the current
// device; out[1]: the scan's shared memory where the heads' rows live in it
// (0: they are in the scratch).
extern "C" int candidate_set_plan(int n, int k_steps, int k_cand,
                                  int with_pref, long long* out) {
  int limit = 0;
  cudaError_t e = scan_smem_limit(&limit);
  if (e != cudaSuccess) return (int)e;
  const CandPlan p = cand_plan(n, k_steps, k_cand, with_pref, limit);
  out[0] = p.scratch;
  out[1] = p.rows_shared ? p.smem : 0;
  return 0;
}

extern "C" int candidate_set_launch(const CandLaunch* c, void* stream) {
  const JointArgs& a = c->a;
  if (a.n < 1 || a.n >= (1 << 24) || a.ns != 0 || a.b != 1 ||
      c->k_cand < 1 || c->k_cand > a.n || c->k_steps < 1 ||
      c->k_steps > a.k)
    return (int)cudaErrorInvalidValue;
  int limit = 0;
  cudaError_t e = scan_smem_limit(&limit);
  if (e != cudaSuccess) return (int)e;
  const CandPlan p =
      cand_plan(a.n, c->k_steps, c->k_cand, a.with_pref, limit);
  if (c->scratch_bytes < p.scratch || (a.with_topk && p.k_all < TOPK))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  cand_pass_kernel<<<p.blocks, PASS_THREADS, 0, s>>>(*c, p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(1);
  cfg.blockDim = dim3(SCAN_THREADS);
  cfg.dynamicSmemBytes = p.smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, cand_scan_kernel, *c, p);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
