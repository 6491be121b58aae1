// The single eval's candidate set for NVIDIA Hopper (sm_90a): one C call,
// two launches on the caller's stream.
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
// ~25 f32 operations a node in the pass, then K dependent steps over k_cand
// (+ K) rows, a rescore and a compare each. Neither is the limit at the
// live width: the K steps are a chain, each a few hundred cycles of one
// SM's latency (two powf and three divisions a row, the block's argmax and
// top-8, two barriers), so the kernel's time is its step chain, the radix
// passes of its selection and the two launches.
//
// Design, simple first:
// - Launch 1, cand_pass_kernel: one thread a node over a grid of
//   PASS_THREADS-thread CTAs. A node's masked score becomes a u64 key, the
//   order-preserving score bits (wave_score.cuh `score_key`: -0.0 and +0.0
//   share a key, as torch compares them) above ~node, so keys are distinct
//   and key order is (score desc, node asc). Each CTA sorts its range's
//   keys (bitonic, in shared memory) and hands on its best mm = min(m,
//   PASS_THREADS), m = k_cand + 1 (or N): every key of the m best overall
//   is among its CTA's m best. Its metric counts go to one row of partial
//   sums. (Without that cut the one CTA of launch 2 read all N keys in
//   each selection pass: 87-90 us at N=16384, 282-584 us at N=131072 on an
//   NVIDIA H100, nomad_tpu_torch/tools/candidate_split.py.)
// - Launch 2, cand_scan_kernel: one CTA. It sums the partial counts; finds
//   the m-th largest of the handed-on keys by radix selection, eight bits
//   a pass from the top, stopping at the first pass whose bin holds
//   exactly the keys still wanted (two or three passes on real scores);
//   gathers the m keys at or above it and orders them by counting (a key's
//   place is the number of keys above it); builds the rows (each a JNode of
//   csrc/joint_node.cuh with its node id and tie rank); then runs the K
//   steps on the warps that hold rows, one named barrier before the merge
//   of their argmaxes and top-8 lists (none where one warp holds them all)
//   and one after it. The steps past n_steps (the live path pads 10
//   placements to a bucket of 16) write their fixed outputs unscored.
// - The selection buffers and the rows live in shared memory while they fit
//   what a block may take; past that (k_steps in the hundreds) in the
//   global scratch after the keys, read through the same generic pointer.
//   No k_steps is refused. The host asks candidate_set_plan for the
//   scratch's bytes; the layout stays here.
// - The per-node arithmetic is csrc/joint_node.cuh's (node_fits, node_rest,
//   count_metrics): the torch version's operation order, built with
//   -fmad=false and no fast-math, so the kernel places bit for bit as the
//   plain version does on the card. A row keeps its node's carries and
//   takes each placement in turn, as joint_node.cuh's single-eval commit.
//
// Built by nomad_tpu_torch/ops/build.py, loaded with ctypes.

#include "joint_node.cuh"

#define PASS_THREADS 1024         // nodes a CTA of the pass, one a thread
#define SCAN_THREADS 512
#define SCAN_WARPS (SCAN_THREADS / 32)
#define SCAN_BAR 1                 // the named barrier of the scan's warps
#define RADIX 256                  // bins of one selection pass
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
  int k_steps, k_cand;
};

// One candidate row: its node's planes and carries, the node, and its
// place among equal scores (node_perm[node] with shuffle, else the row).
struct CRow {
  JNode d;
  int node;
  unsigned tie;
};

// Where a call's buffers are (bytes), from its widths.
struct CandPlan {
  long long keys, parts, area, scratch;
  int blocks;   // CTAs of the pass
  int m;        // keys selected: the candidates, then the rest max's
  int mm;       // keys each CTA of the pass hands on: its best min(m, range)
  int k_all;    // rows: candidates, then one pin a step
  int smem;     // the area in shared memory (0: in the scratch)
};

static long long align16(long long x) { return (x + 15) & ~15LL; }

static CandPlan cand_plan(int n, int k_steps, int k_cand, int with_pref,
                          int limit) {
  CandPlan p;
  p.blocks = (n + PASS_THREADS - 1) / PASS_THREADS;
  p.m = k_cand < n ? k_cand + 1 : n;
  p.mm = p.m < PASS_THREADS ? p.m : PASS_THREADS;
  p.k_all = k_cand + (with_pref ? k_steps : 0);
  p.keys = align16(8LL * p.blocks * p.mm);
  p.parts = align16(4LL * N_MET * p.blocks);
  // the unordered keys, the ordered keys, the rows
  p.area = 16LL * p.m + (long long)sizeof(CRow) * p.k_all;
  p.smem = p.area <= limit ? (int)p.area : 0;
  p.scratch = p.keys + p.parts + (p.smem ? 0 : align16(p.area));
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

// One placement on a row's node (ops/kernel._deduct at that node): the
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

__global__ void __launch_bounds__(PASS_THREADS)
    cand_pass_kernel(const CandLaunch c, const CandPlan p) {
  __shared__ int part[PASS_THREADS / 32][N_MET];
  __shared__ u64 sk[PASS_THREADS];
  const JointArgs& a = c.a;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int i = blockIdx.x * PASS_THREADS + tid;
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
  // the CTA's best mm keys hold every one of the m best its range has:
  // bitonic sort of the range's keys, largest first, where mm < range
  u64* pre = reinterpret_cast<u64*>(c.scratch) + (long long)blockIdx.x * p.mm;
  if (p.mm < PASS_THREADS) {
    sk[tid] = key;
    __syncthreads();
    for (int size = 2; size <= PASS_THREADS; size <<= 1) {
      for (int j = size >> 1; j > 0; j >>= 1) {
        const int q = tid ^ j;
        if (q > tid) {
          const u64 x = sk[tid], y = sk[q];
          if (((tid & size) == 0) ? x < y : x > y) {
            sk[tid] = y;
            sk[q] = x;
          }
        }
        __syncthreads();
      }
    }
    if (tid < p.mm) pre[tid] = sk[tid];
  } else {
    pre[tid] = key;
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
    for (int w = 0; w < PASS_THREADS / 32; ++w) s += part[w][tid];
    reinterpret_cast<int*>(c.scratch + p.keys)[blockIdx.x * N_MET + tid] = s;
  }
}

__global__ void __launch_bounds__(SCAN_THREADS, 1)
    cand_scan_kernel(const CandLaunch c, const CandPlan p) {
  extern __shared__ __align__(16) unsigned char dyn_smem[];
  __shared__ unsigned hist[RADIX];
  __shared__ int sh_met[N_MET];
  __shared__ int sh_sel[3];   // the bin, the keys above it, the keys in it
  __shared__ int sh_cnt;
  __shared__ Best sh_best[SCAN_WARPS];
  __shared__ unsigned sh_tk[SCAN_WARPS][TOPK];
  __shared__ int sh_ti[SCAN_WARPS][TOPK];
  __shared__ int sh_pin_ok;
  __shared__ float sh_pin_v;
  __shared__ int sh_win;      // the node the step placed on, or -1

  const JointArgs& a = c.a;
  const int n = a.n, kc = c.k_cand, m = p.m, k_all = p.k_all;
  const int nk = p.blocks * p.mm;  // the pass's keys: each CTA's best
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const u64* keys = reinterpret_cast<const u64*>(c.scratch);
  const int* parts = reinterpret_cast<const int*>(c.scratch + p.keys);
  unsigned char* area = p.smem ? dyn_smem : c.scratch + p.keys + p.parts;
  u64* cand = reinterpret_cast<u64*>(area);
  u64* sorted = cand + m;
  CRow* rows = reinterpret_cast<CRow*>(sorted + m);

  // ---- the metrics: thread tid sums metric tid % N_MET of every CTA ----
  if (tid < N_MET) sh_met[tid] = 0;
  if (tid == 0) sh_cnt = 0;
  __syncthreads();
  {
    int s = 0;
    for (int x = tid; x < p.blocks * N_MET; x += SCAN_THREADS) s += parts[x];
    s += __shfl_xor_sync(FULL_MASK, s, 8);
    s += __shfl_xor_sync(FULL_MASK, s, 16);
    if (lane < N_MET) atomicAdd(&sh_met[lane], s);
  }

  // ---- the m-th largest key, eight bits a pass from the top ----
  u64 prefix = 0ull, mask = 0ull;
  int remaining = m;  // keys still wanted among those matching the prefix
  for (int shift = 56; shift >= 0; shift -= 8) {
    for (int x = tid; x < RADIX; x += SCAN_THREADS) hist[x] = 0u;
    __syncthreads();
    for (int i0 = 0; i0 < nk; i0 += SCAN_THREADS) {
      const int i = i0 + tid;
      const u64 key = i < nk ? keys[i] : 0ull;
      const bool in = i < nk && (key & mask) == prefix;
      const unsigned dg = in ? (unsigned)(key >> shift) & 0xffu : RADIX;
      const unsigned peers = __match_any_sync(FULL_MASK, dg);
      if (in && lane == __ffs(peers) - 1)
        atomicAdd(&hist[dg], (unsigned)__popc(peers));
    }
    __syncthreads();
    if (warp == 0) {
      // lane l holds bins 255 - 8l .. 248 - 8l, the largest first
      unsigned cb[8], s = 0u;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        cb[j] = hist[RADIX - 1 - 8 * lane - j];
        s += cb[j];
      }
      unsigned incl = s;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const unsigned t = __shfl_up_sync(FULL_MASK, incl, off);
        if (lane >= off) incl += t;
      }
      unsigned acc = incl - s;
      if (acc < (unsigned)remaining && (unsigned)remaining <= incl) {
        bool done = false;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (!done && acc + cb[j] >= (unsigned)remaining) {
            sh_sel[0] = RADIX - 1 - 8 * lane - j;
            sh_sel[1] = (int)acc;
            sh_sel[2] = (int)cb[j];
            done = true;
          }
          acc += cb[j];
        }
      }
    }
    __syncthreads();
    remaining -= sh_sel[1];
    prefix |= (u64)sh_sel[0] << shift;
    mask |= 0xffull << shift;
    // every key of the bin is wanted: the m keys are those >= prefix
    if (sh_sel[2] == remaining) break;
  }

  // ---- the m keys at or above it, then in order ----
  for (int i0 = 0; i0 < nk; i0 += SCAN_THREADS) {
    const int i = i0 + tid;
    const u64 key = i < nk ? keys[i] : 0ull;
    const bool take = i < nk && key >= prefix;
    const unsigned bal = __ballot_sync(FULL_MASK, take);
    int at = 0;
    if (lane == 0 && bal) at = atomicAdd(&sh_cnt, __popc(bal));
    at = __shfl_sync(FULL_MASK, at, 0);
    if (take) cand[at + __popc(bal & ((1u << lane) - 1u))] = key;
  }
  __syncthreads();
  for (int x = tid; x < m; x += SCAN_THREADS) {
    const u64 key = cand[x];
    int r = 0;
    for (int j = 0; j < m; ++j) r += cand[j] > key;
    sorted[r] = key;
  }
  __syncthreads();

  // ---- the rows: the candidates, then each step's pin ----
  const float rest = m > kc ? key_value(sorted[kc]) : NEG_INF_F;
  const int* prefs = leaf_of<int>(a, J_STEP_PREF, 0);
  const int* perm = leaf_of<int>(a, J_PERM, 0);
  for (int r = tid; r < k_all; r += SCAN_THREADS) {
    int node;
    bool pad = false;
    if (r < kc) {
      node = key_node(sorted[r]);
    } else {
      const int pin = __ldg(prefs + (r - kc));
      node = min(max(pin, 0), n - 1);
      pad = pin < 0;
    }
    CRow row;
    row.d = cand_node(a, node);
    row.d.base = row.d.base && !pad;
    row.node = node;
    row.tie = a.with_shuffle ? (unsigned)__ldg(perm + node) : (unsigned)r;
    rows[r] = row;
  }
  if (tid < N_MET) c.metrics[tid] = sh_met[tid];
  __syncthreads();

  // ---- the K steps, on the warps that hold rows ----
  const int nt = min(SCAN_THREADS, (k_all + 31) & ~31);
  if (tid >= nt) return;
  const int nw = nt >> 5;
  const JMember v = load_member(a, 0);
  const int n_steps = *leaf_of<int>(a, J_NSTEPS, 0);
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
        a.topk_idx[i * TOPK + lane] = a.with_topk ? rows[lane].node : 0;
        a.topk_scores[i * TOPK + lane] = NEG_INF_F;
      }
    }
  }
  bool ok = true, missing = false;
  for (int i = 0; i < active_steps; ++i) {
    int sp[MAX_P + 1];  // the step's penalty nodes, then its pin
    load_step_nodes(a, 0, i, sp);
    const int pin_row = a.with_pref ? kc + i : -1;
    unsigned bk = 0u, br = NO_RANK;
    int bi = -1;
    unsigned lk[TOPK];
    int li[TOPK];
    list_clear(lk, li);
    for (int r = tid; r < k_all; r += nt) {
      const CRow row = rows[r];
      bool pen = row.d.pen;
#pragma unroll
      for (int q = 0; q < MAX_P; ++q) pen = pen || sp[q] == row.node;
      float sum;
      unsigned cnt;
      node_rest(a, v, row.d, pen, sum, cnt);
      const float val = cnt != 0 ? sum / (float)cnt : NEG_INF_F;
      if (r == pin_row) {
        sh_pin_ok = cnt != 0;
        sh_pin_v = val;
      }
      const unsigned k = score_key(val);
      if (k > bk || (k == bk && row.tie < br)) {
        bk = k;
        br = row.tie;
        bi = r;
      }
      if (a.with_topk) list_insert(lk, li, k, r);
    }
    // each warp's argmax and top-8 in every lane; with one warp holding
    // every row they are the step's, and no merge follows
    warp_best(bk, br, bi);
    unsigned tk[TOPK];
    int ti[TOPK];
    list_clear(tk, ti);
    if (a.with_topk) {
      warp_top(lk, li, tk, ti);
#pragma unroll
      for (int q = 0; q < TOPK; ++q)
        if (q == lane) {
          sh_tk[warp][q] = tk[q];
          sh_ti[warp][q] = ti[q];
        }
    }
    if (lane == 0) sh_best[warp] = Best{bk, br, bi};
    scan_bar(nt);
    if (warp == 0) {
      Best b = Best{bk, br, bi};
      if (nw > 1) {
        b = lane < nw ? sh_best[lane] : Best{0u, NO_RANK, -1};
        warp_best(b.k, b.r, b.i);
      }
      const int pref = a.with_pref ? sp[MAX_P] : -1;
      const bool pref_ok = pref >= 0 && sh_pin_ok;
      const int idx = pref_ok ? pin_row : b.i;
      const float val = pref_ok ? sh_pin_v : key_score(b.k);
      const bool fnd = val > NEG_INF_F / 2.0f;
      const int node = rows[idx].node;
      ok = ok && (!fnd || pref_ok || val >= rest);
      missing = missing || !fnd;
      if (lane == 0) {
        c.chosen[i] = fnd ? node : -1;
        c.scores[i] = fnd ? val : 0.0f;
        c.found[i] = fnd ? 1 : 0;
        sh_win = fnd ? node : -1;
      }
      if (a.with_topk && nw > 1) {
        unsigned lk2[TOPK];
        int li2[TOPK];
        list_clear(lk2, li2);
        if (lane < nw) {
#pragma unroll
          for (int q = 0; q < TOPK; ++q) {
            lk2[q] = sh_tk[lane][q];
            li2[q] = sh_ti[lane][q];
          }
        }
        warp_top(lk2, li2, tk, ti);
      }
      if (lane < TOPK) {
        unsigned k = PAD_KEY;
        int r = 0;
#pragma unroll
        for (int q = 0; q < TOPK; ++q)
          if (q == lane) {
            k = tk[q];
            r = ti[q];
          }
        a.topk_idx[i * TOPK + lane] =
            a.with_topk && r < k_all ? rows[r].node : 0;
        a.topk_scores[i * TOPK + lane] =
            a.with_topk ? key_score(k) : NEG_INF_F;
      }
    }
    scan_bar(nt);
    const int win = sh_win;
    if (win >= 0)
      for (int r = tid; r < k_all; r += nt)
        if (rows[r].node == win) cand_commit(a, v, rows[r].d);
  }
  if (tid == 0)
    c.valid[0] = (ok && (!missing || rest <= NEG_INF_F / 2.0f)) ? 1 : 0;
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
// device; out[1]: its rows' bytes in shared memory (0: in the scratch).
extern "C" int candidate_set_plan(int n, int k_steps, int k_cand,
                                  int with_pref, long long* out) {
  int limit = 0;
  cudaError_t e = scan_smem_limit(&limit);
  if (e != cudaSuccess) return (int)e;
  const CandPlan p = cand_plan(n, k_steps, k_cand, with_pref, limit);
  out[0] = p.scratch;
  out[1] = p.smem;
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
  cand_scan_kernel<<<1, SCAN_THREADS, p.smem, s>>>(*c, p);
  return (int)cudaGetLastError();
}
