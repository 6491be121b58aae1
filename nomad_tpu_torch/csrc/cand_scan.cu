// Candidate-set deduction scan for NVIDIA Hopper (sm_90a).
//
// Replaces: nomad_tpu/ops/pallas_kernel.py `_cand_scan_kernel` (:261-370),
// the in-kernel half of `pallas_topk_place_batch` (:377-496, the
// pl.pallas_call at :478). The full-width score pass, the candidate top-k
// and the exact rest max stay torch ops, as they were XLA there
// (ops/cuda_kernel.candidate_pass). This kernel computes what
// ops/cuda_kernel.cand_scan_reference computes: per eval, K placement steps
// over its KC <= 128 candidate nodes (lean score, lean_score.cuh), rows of
// one node sharing deductions (:324-333), and the `valid` bound flag: the
// best candidate must reach the rest of the cluster's best at every active
// step that places (:339-340), and no wanted placement may be missing while
// the rest of the cluster could take it (:358-364).
//
// What bounds it. Per eval it reads KC i32 node ids and, through them,
// rows of ten shared [N] planes (~0.6 MB at N=16384, read once, then from
// L2); it writes [B, K] outputs. At B=8192, KC=64, K=10: ~3.5 MB, ~1 us
// at 3.35 TB/s. A step changes only the chosen node's carries, so the
// function needs B*KC candidate scores (~27 f32 operations each with two
// powf), one argmax compare per (step, candidate) and one rescore per
// step: ~2.2e7, ~0.3 us at 67 TFLOP/s, so it is bound by bytes. This
// design rescores every candidate at every step (B*K*KC scores): that
// redundancy is the design's, not the function's floor. Both bounds are
// small; the scan is a sliver of the batch, whose time is the full-width
// pass.
//
// Design (simple first). One warp per eval, eight evals per block of 256
// threads. Candidate c lives in lane c % 32, slot c / 32 (up to four
// slots), with its static terms and its carries (used cpu/mem/disk and
// count) in registers, so a step touches no memory but the outputs. Each
// step every lane scores its slots and a butterfly of warp shuffles
// leaves every lane holding the best (value desc, candidate asc) with its
// node id, carried as i32 (the Pallas kernel carries it as f32). Lanes
// whose candidate is that node deduct; lane 0 writes the step's outputs
// and, at the end, `valid`. No padding to 128 lanes: slots past KC do
// not exist.
//
// Built by nomad_tpu_torch/ops/build.py (nvcc -gencode
// arch=compute_90a,code=sm_90a -O3 -fmad=false ...), loaded with ctypes.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "lean_score.cuh"

#define THREADS 256
#define EVALS_PER_BLOCK (THREADS / 32)
#define SLOTS 4  // 128 candidates over 32 lanes
#define FULL_MASK 0xffffffffu

// Mirrored by nomad_tpu_torch/ops/cuda_kernel._ScanArgs.
struct ScanArgs {
  const int* cand;                               // i32 [B, KC] node ids
  const float* rest_max;                         // f32 [B]
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

__global__ void __launch_bounds__(THREADS)
    cand_scan_kernel(const ScanArgs a) {
  const int lane = threadIdx.x & 31;
  const int e = blockIdx.x * EVALS_PER_BLOCK + (threadIdx.x >> 5);
  if (e >= a.b) return;  // the whole warp leaves together

  const float a_cpu = a.ask_cpu[e], a_mem = a.ask_mem[e],
              a_disk = a.ask_disk[e];
  const int n_steps = a.n_steps[e];
  const bool spread = a.spread[e] != 0;
  const float denom = fmaxf((float)a.desired[e], 1.0f);
  const float rest = a.rest_max[e];

  LeanNode s[SLOTS];
  float uc[SLOTS], um[SLOTS], ud[SLOTS], tg[SLOTS];
  int nid[SLOTS];
#pragma unroll
  for (int q = 0; q < SLOTS; ++q) {
    const int c = q * 32 + lane;
    nid[q] = -1;
    if (c < a.kc) {
      const int j = a.cand[(long long)e * a.kc + c];
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

extern "C" int cand_scan_launch(const ScanArgs* args, void* stream) {
  const int blocks = (args->b + EVALS_PER_BLOCK - 1) / EVALS_PER_BLOCK;
  cand_scan_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(*args);
  return (int)cudaGetLastError();
}
