// Candidate-set batch placement for NVIDIA Hopper (sm_90a), one kernel.
//
// Replaces: nomad_tpu/ops/pallas_kernel.py `pallas_topk_place_batch`
// (:377-496) whole: the full-width score pass (:410-433), the candidate
// top-k and exact rest max (:435-437), and `_cand_scan_kernel` (:261-370,
// the pl.pallas_call at :478). It computes what
// ops/cuda_kernel.topk_place_batch_reference computes (`candidate_pass`,
// then `cand_scan_reference`), per eval:
//
// 1. the masked score of every node, in the pass's operation order
//    (lean_score.cuh `lean_pass_score`);
// 2. the KC + 1 best nodes by (score desc, node asc), KC = min(k_cand, N,
//    128): the first KC are the candidates in `topk_ordered`'s order, the
//    (KC+1)-th score is the rest max (NEG_INF when N == KC);
// 3. K placement steps over the candidates (lean score, scan order), rows
//    of one node sharing deductions (:324-333), and `valid`: the best
//    candidate must reach the rest max at every active step that places
//    (:339-340), and no wanted placement may be missing while the rest of
//    the cluster could take it (:358-364).
//
// No [B, N] tensor is written: the function reads ten shared [N] planes
// and six [B] ask vectors and writes [B, K] outputs and [B] `valid`.
//
// What bounds it. Bytes: ~0.6 MB of planes at N=16384 plus B*K*9 B of
// outputs, ~0.8 MB at B=8192, K=10: ~0.25 us at 3.35 TB/s. Operations:
// each (eval, node) in the base mask scored once, 27 f32 operations and
// one selection compare, a mask test for every other node, then per
// active step one argmax compare per candidate and one rescore (2.35e9 at
// B=8192 over 10000 base nodes of N=16384: ~35 us at 67 TFLOP/s). It is
// bound by operations, and by the two powf and two or three IEEE
// divisions inside each of those 27, which the count does not weigh.
//
// Design. One warp per EPW = 4 evals, WARPS = 8 warps per block. The warp
// walks the node axis 32 nodes at a time: each lane loads its node's ten
// plane values once (coalesced, from L2: every warp reads the same 0.6
// MB) and scores it for each of the warp's evals, all four before any
// selection so that their score chains overlap. Selection is by
// threshold: a score and its node make one u64 key (order-preserving
// score bits high, ~node low, -0.0 mapped to +0.0 as torch compares them),
// so key order is (score desc, node asc) and keys are distinct. Per eval
// the warp keeps a buffer of CAP keys in shared memory (CAP = the power of
// two >= KC + 33) and the running (KC+1)-th key as threshold; lanes whose
// (score, node) passes it (two float compares) append their keys through
// a ballot. When a ballot would overflow the buffer, the warp sorts it
// (bitonic, in registers: CAP / 32 keys a lane, partners through
// shuffles), keeps KC + 1 keys and raises the threshold; on
// random scores that happens about eight times per eval at KC = 64, since
// after the first fill only keys that beat the running (KC+1)-th are
// appended. After the sweep one more sort leaves the candidates in order.
// The scan is the earlier candidate scan, unchanged: candidate c in lane
// c % 32, slot c / 32, statics and carries in registers, one butterfly of
// warp shuffles per step for the (value desc, candidate asc) argmax, the
// candidates' planes gathered from L2.
//
// Built by nomad_tpu_torch/ops/build.py (nvcc -gencode
// arch=compute_90a,code=sm_90a -O3 -fmad=false ...), loaded with ctypes.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "lean_score.cuh"

#define WARPS 8  // warps per block
#define EPW 4    // evals per warp
#define THREADS (WARPS * 32)
#define SLOTS 4  // 128 candidates over 32 lanes
#define MAX_KC (SLOTS * 32)
#define FULL_MASK 0xffffffffu

typedef unsigned long long u64;

// Mirrored by nomad_tpu_torch/ops/cuda_kernel._TopkArgs.
struct TopkArgs {
  const float *cap_cpu, *cap_mem, *cap_disk;     // f32 [N]
  const float *used_cpu, *used_mem, *used_disk;  // f32 [N]
  const unsigned char* base;                     // bool [N]
  const int* jobtg;                              // i32 [N]
  const unsigned char* penalty;                  // bool [N]
  const float* aff;                              // f32 [N]
  const float *ask_cpu, *ask_mem, *ask_disk;     // f32 [B]
  const int *n_steps, *desired;                  // i32 [B]
  const unsigned char* spread;                   // bool [B]
  int* chosen;                                   // i32 [B, K]
  float* scores;                                 // f32 [B, K]
  unsigned char* found;                          // bool [B, K]
  unsigned char* valid;                          // bool [B]
  int n, b, k, kc;
};

__device__ __forceinline__ u64 score_key(float s, int node) {
  unsigned int u = __float_as_uint(s);
  if (u == 0x80000000u) u = 0u;  // -0.0 == +0.0, as torch compares them
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return ((u64)u << 32) | (unsigned int)(~node);
}

__device__ __forceinline__ float key_score(u64 key) {
  unsigned int u = (unsigned int)(key >> 32);
  u = (u & 0x80000000u) ? (u & 0x7fffffffu) : ~u;
  return __uint_as_float(u);
}

__device__ __forceinline__ int key_node(u64 key) {
  return (int)(~(unsigned int)key);
}

// Sort the warp's R * 32 keys descending, key r * 32 + lane in k[r]
// (bitonic: partners in other lanes through shuffles, in other registers
// of the same lane directly).
template <int R>
__device__ __forceinline__ void sort_regs(u64 (&k)[R], int lane) {
#pragma unroll
  for (int size = 2; size <= R * 32; size <<= 1) {
#pragma unroll
    for (int j = size >> 1; j > 0; j >>= 1) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const bool desc = ((r * 32 + lane) & size) == 0;
        if (j >= 32) {
          const int p = r ^ (j >> 5);
          if (p > r) {
            const u64 x = k[r], y = k[p];
            const bool swap = desc ? x < y : x > y;
            k[r] = swap ? y : x;
            k[p] = swap ? x : y;
          }
        } else {
          const u64 y = __shfl_xor_sync(FULL_MASK, k[r], j);
          // the lower of the pair keeps the larger key in a descending run
          const bool keep_max = ((lane & j) == 0) == desc;
          k[r] = keep_max ? (k[r] > y ? k[r] : y) : (k[r] < y ? k[r] : y);
        }
      }
    }
  }
}

template <int R>
__device__ __forceinline__ void sort_buffer(u64* buf, int cnt, int lane) {
  u64 k[R];
  __syncwarp();  // the lanes' appends are visible
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int e = r * 32 + lane;
    k[r] = e < cnt ? buf[e] : 0ull;
  }
  sort_regs<R>(k, lane);
#pragma unroll
  for (int r = 0; r < R; ++r) buf[r * 32 + lane] = k[r];
  __syncwarp();
}

// Sort buf[0, cap) descending, the entries from cnt on taken as 0 (below
// every key: a score word is never 0). cap is 64, 128 or 256 (key_cap);
// the whole warp calls it.
__device__ __noinline__ void warp_sort_desc(u64* buf, int cnt, int cap,
                                            int lane) {
  if (cap == 64)
    sort_buffer<2>(buf, cnt, lane);
  else if (cap == 128)
    sort_buffer<4>(buf, cnt, lane);
  else
    sort_buffer<8>(buf, cnt, lane);
}

// One eval's selection: the threshold key, split into its score and node
// so that a lane tests its node with float compares and builds its key
// only when it passes; nodes at or below the threshold cannot enter the
// best m.
struct Sel {
  float thr_v;
  int thr_j;
  int cnt;  // keys in the buffer
};

__device__ __forceinline__ bool above(float v, int j, const Sel& s) {
  return v > s.thr_v || (v == s.thr_v && j < s.thr_j);
}

// Offer each lane's scored node to one eval's selection (the whole warp
// calls it).
__device__ __forceinline__ void sel_push(u64* buf, Sel& s, float v, int j,
                                         bool ok, int lane, int cap, int m) {
  bool take = ok && above(v, j, s);
  unsigned int mask = __ballot_sync(FULL_MASK, take);
  if (mask == 0u) return;
  if (s.cnt + __popc(mask) > cap) {
    // cnt > cap - 32 >= m: the buffer holds the best m seen so far
    warp_sort_desc(buf, s.cnt, cap, lane);
    s.cnt = m;
    const u64 thr = buf[m - 1];
    s.thr_v = key_score(thr);
    s.thr_j = key_node(thr);
    take = take && above(v, j, s);
    mask = __ballot_sync(FULL_MASK, take);
  }
  if (take) buf[s.cnt + __popc(mask & ((1u << lane) - 1u))] = score_key(v, j);
  s.cnt += __popc(mask);
}

// The candidate scan of eval e over the sorted keys in buf.
__device__ __forceinline__ void cand_scan(const TopkArgs& a, int e,
                                          const u64* buf, float rest,
                                          int lane) {
  const float a_cpu = a.ask_cpu[e], a_mem = a.ask_mem[e],
              a_disk = a.ask_disk[e];
  const int n_steps = a.n_steps[e];
  const bool spread = a.spread[e] != 0;
  const float denom = fmaxf((float)a.desired[e], 1.0f);

  LeanNode s[SLOTS];
  float uc[SLOTS], um[SLOTS], ud[SLOTS], tg[SLOTS];
  int nid[SLOTS];
#pragma unroll
  for (int q = 0; q < SLOTS; ++q) {
    const int c = q * 32 + lane;
    nid[q] = -1;
    if (c < a.kc) {
      const int j = key_node(buf[c]);
      nid[q] = j;
      s[q] = lean_node(a.cap_cpu[j], a.cap_mem[j], a.cap_disk[j],
                       a.base[j] != 0, a.penalty[j] != 0, a.aff[j]);
      uc[q] = a.used_cpu[j];
      um[q] = a.used_mem[j];
      ud[q] = a.used_disk[j];
      tg[q] = (float)a.jobtg[j];
    } else {
      s[q] = lean_node(0.0f, 0.0f, 0.0f, false, false, 0.0f);
      uc[q] = um[q] = ud[q] = tg[q] = 0.0f;
    }
  }

  bool ok = true, missing = false;
  for (int i = 0; i < a.k; ++i) {
    const bool active = i < n_steps;
    float bv = -INFINITY;
    int bc = 0x7fffffff, bid = -1;
#pragma unroll
    for (int q = 0; q < SLOTS; ++q) {
      const int c = q * 32 + lane;
      if (c < a.kc) {
        float v = LEAN_NEG_INF;
        if (active && lean_feasible(s[q], uc[q], um[q], ud[q], a_cpu, a_mem,
                                    a_disk))
          v = lean_score(s[q], uc[q], um[q], tg[q], a_cpu, a_mem, spread,
                         denom);
        if (lean_better(v, c, bv, bc)) {
          bv = v;
          bc = c;
          bid = nid[q];
        }
      }
    }
    for (int off = 16; off > 0; off >>= 1) {
      float v = __shfl_xor_sync(FULL_MASK, bv, off);
      int c = __shfl_xor_sync(FULL_MASK, bc, off);
      int id = __shfl_xor_sync(FULL_MASK, bid, off);
      if (lean_better(v, c, bv, bc)) {
        bv = v;
        bc = c;
        bid = id;
      }
    }
    const bool fnd = bv > LEAN_NEG_INF / 2.0f;
    const bool placed = fnd && active;
    if (placed) {
#pragma unroll
      for (int q = 0; q < SLOTS; ++q) {
        if (nid[q] == bid) {
          uc[q] = uc[q] + a_cpu;
          um[q] = um[q] + a_mem;
          ud[q] = ud[q] + a_disk;
          tg[q] = tg[q] + 1.0f;
        }
      }
    }
    ok = ok && (!active || !fnd || bv >= rest);
    missing = missing || (active && !placed);
    if (lane == 0) {
      const long long o = (long long)e * a.k + i;
      a.chosen[o] = placed ? bid : -1;
      a.scores[o] = placed ? bv : 0.0f;
      a.found[o] = placed ? 1 : 0;
    }
  }
  if (lane == 0) {
    const bool rest_bad = rest <= LEAN_NEG_INF / 2.0f;
    a.valid[e] = (ok && (!missing || rest_bad)) ? 1 : 0;
  }
}

__global__ void __launch_bounds__(THREADS)
    topk_place_batch_kernel(const TopkArgs a, const int cap) {
  extern __shared__ u64 keys[];  // [WARPS][EPW][cap]
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int e0 = (blockIdx.x * WARPS + w) * EPW;
  if (e0 >= a.b) return;  // the whole warp leaves together
  const int ne = min(EPW, a.b - e0);
  const int m = a.kc + 1;  // candidates and the rest max's node
  u64* bufs = keys + (size_t)w * EPW * cap;

  float ac[EPW], am[EPW], ad[EPW], dn[EPW];
  bool sp[EPW];
  Sel sel[EPW];
#pragma unroll
  for (int q = 0; q < EPW; ++q) {
    const int e = e0 + min(q, ne - 1);
    ac[q] = a.ask_cpu[e];
    am[q] = a.ask_mem[e];
    ad[q] = a.ask_disk[e];
    sp[q] = a.spread[e] != 0;
    dn[q] = fmaxf((float)a.desired[e], 1.0f);
    sel[q].thr_v = -INFINITY;  // below every score, NEG_INF included
    sel[q].thr_j = 0;
    sel[q].cnt = 0;
  }

  for (int j0 = 0; j0 < a.n; j0 += 32) {
    const int j = j0 + lane;
    const bool in = j < a.n;
    float cc = 0.0f, cm = 0.0f, cd = 0.0f, uc = 0.0f, um = 0.0f, ud = 0.0f,
          aff = 0.0f, coll = 0.0f;
    bool base = false, pen = false;
    if (in) {
      cc = __ldg(a.cap_cpu + j);
      cm = __ldg(a.cap_mem + j);
      cd = __ldg(a.cap_disk + j);
      uc = __ldg(a.used_cpu + j);
      um = __ldg(a.used_mem + j);
      ud = __ldg(a.used_disk + j);
      aff = __ldg(a.aff + j);
      coll = (float)__ldg(a.jobtg + j);
      base = __ldg(a.base + j) != 0;
      pen = __ldg(a.penalty + j) != 0;
    }
    const float free_c = cc - uc, free_m = cm - um, free_d = cd - ud;
    // every eval's score first, then the selections: no ballot or branch
    // between the evals' score chains, so they overlap. A score is taken
    // whatever its mask (then masked, as torch.where does), except in a
    // warp of padding only.
    float v[EPW];
#pragma unroll
    for (int q = 0; q < EPW; ++q) v[q] = LEAN_NEG_INF;
    if (__any_sync(FULL_MASK, base)) {
#pragma unroll
      for (int q = 0; q < EPW; ++q) {
        const float score = lean_pass_score(cc, cm, uc, um, coll, pen, aff,
                                            ac[q], am[q], sp[q], dn[q]);
        if (base && free_c >= ac[q] && free_m >= am[q] && free_d >= ad[q])
          v[q] = score;
      }
    }
#pragma unroll
    for (int q = 0; q < EPW; ++q)
      if (q < ne) sel_push(bufs + q * cap, sel[q], v[q], j, in, lane, cap, m);
  }

#pragma unroll
  for (int q = 0; q < EPW; ++q) {
    if (q < ne) {
      u64* buf = bufs + q * cap;
      warp_sort_desc(buf, sel[q].cnt, cap, lane);
      const float rest = a.n > a.kc ? key_score(buf[a.kc]) : LEAN_NEG_INF;
      cand_scan(a, e0 + q, buf, rest, lane);
    }
  }
}

// The key buffer of one eval: a power of two with room for the best
// KC + 1 and one more ballot of 32.
static int key_cap(int kc) {
  int cap = 64;
  while (cap < kc + 1 + 32) cap <<= 1;
  return cap;
}

// The dynamic shared memory the kernel is allowed on each device: the
// attribute is raised only when a launch needs more than the last setting,
// so it is set at most once per device (cap 256 is the only size above
// the 48 KB default).
#define MAX_DEVICES 64
static size_t g_smem[MAX_DEVICES];

static cudaError_t allow_smem(size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < MAX_DEVICES && g_smem[dev] >= smem) return cudaSuccess;
  e = cudaFuncSetAttribute(topk_place_batch_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e == cudaSuccess && dev < MAX_DEVICES) g_smem[dev] = smem;
  return e;
}

extern "C" int topk_place_batch_launch(const TopkArgs* args, void* stream) {
  if (args->kc < 1 || args->kc > MAX_KC || args->kc > args->n)
    return (int)cudaErrorInvalidValue;
  const int cap = key_cap(args->kc);
  const size_t smem = (size_t)WARPS * EPW * cap * sizeof(u64);
  cudaError_t err = allow_smem(smem);
  if (err != cudaSuccess) return (int)err;
  const int per_block = WARPS * EPW;
  const int blocks = (args->b + per_block - 1) / per_block;
  topk_place_batch_kernel<<<blocks, THREADS, smem, (cudaStream_t)stream>>>(
      *args, cap);
  return (int)cudaGetLastError();
}
