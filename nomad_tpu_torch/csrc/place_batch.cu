// Lean full-width batch placement for NVIDIA Hopper (sm_90a).
//
// Replaces: nomad_tpu/ops/pallas_kernel.py `_place_kernel` (:69-158), the
// body of `pallas_place_batch` (:165-238, the pl.pallas_call at :218),
// reached through `make_schedule_apply_step_pallas` (:499-534). It computes
// what nomad_tpu_torch/ops/cuda_kernel.place_batch_reference computes: per
// eval, K placement steps over all N nodes, each a cpu/mem/disk fit mask,
// the lean score (lean_score.cuh), a first-index argmax and a deduction of
// the chosen node's cpu, mem, disk and job/task-group count.
//
// What bounds it. The inputs are ten shared [N] planes (read once: ~0.6 MB
// at N=16384) and six [B] ask vectors; the outputs are [B, K]. Bytes give
// well under a microsecond. A step changes only the chosen node's carries,
// so the function needs B*N node scores (~27 f32 operations each with two
// powf), one argmax compare per (step, node) and one rescore per
// step: ~3.1e8 operations at B=512, K=10, N=16384, ~5 us at 67 TFLOP/s.
// It is bound by operations. This design rescores every node at every
// step (B*K*N scores, ~10x the function's floor): that redundancy is the
// design's, kept because it needs no [B, N] score scratch.
//
// Design (simple first). One block of 512 threads per eval, a loop over the
// K steps inside it; each thread strides over the node axis, scores its
// nodes and keeps its best on (value desc, index asc); a warp-shuffle and
// shared-memory reduction gives the block argmax. The Pallas kernel keeps
// four [N] carries per program in VMEM; here they would not fit in shared
// memory (256 KB at N=16384), so the block keeps only what changes: a
// bitmap of touched nodes (N bits) and a list of at most K touched nodes
// with their carried used cpu/mem/disk and counts, in shared memory.
// Untouched nodes read the shared planes, which every block reads and
// which stay in L2. Thread 0 commits the chosen node into the list; the
// block barrier publishes it. No [B, N] scratch, no input is written, and
// the outputs are [B, K] with no padding.
//
// Built by nomad_tpu_torch/ops/build.py (nvcc -gencode
// arch=compute_90a,code=sm_90a -O3 -fmad=false ...), loaded with ctypes.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "lean_score.cuh"

#define THREADS 512
#define NWARPS (THREADS / 32)
#define MAX_K 128
#define FULL_MASK 0xffffffffu

// Mirrored by nomad_tpu_torch/ops/cuda_kernel._PlaceArgs.
struct PlaceArgs {
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
  int n, b, k;
};

__device__ __forceinline__ bool is_touched(const unsigned int* bits, int j) {
  return (bits[j >> 5] >> (j & 31)) & 1u;
}

__global__ void __launch_bounds__(THREADS)
    place_batch_kernel(const PlaceArgs a) {
  extern __shared__ unsigned int touched[];  // one bit per node
  __shared__ int t_node[MAX_K];
  __shared__ float t_uc[MAX_K], t_um[MAX_K], t_ud[MAX_K];
  __shared__ int t_tg[MAX_K];
  __shared__ float red_v[NWARPS];
  __shared__ int red_i[NWARPS];
  __shared__ int n_touched;

  const int e = blockIdx.x, tid = threadIdx.x, n = a.n;
  for (int w = tid; w < (n + 31) / 32; w += THREADS) touched[w] = 0u;
  if (tid == 0) n_touched = 0;
  __syncthreads();

  const float a_cpu = a.ask_cpu[e], a_mem = a.ask_mem[e],
              a_disk = a.ask_disk[e];
  const int n_steps = a.n_steps[e];
  const bool spread = a.spread[e] != 0;
  const float denom = fmaxf((float)a.desired[e], 1.0f);

  for (int i = 0; i < a.k; ++i) {
    float bv = -INFINITY;
    int bi = 0x7fffffff;
    // an inactive step masks every node: nothing is found
    if (i < n_steps) {
      for (int j = tid; j < n; j += THREADS) {
        float uc = a.used_cpu[j], um = a.used_mem[j], ud = a.used_disk[j];
        int tg = a.jobtg[j];
        if (is_touched(touched, j)) {
          for (int q = 0; q < n_touched; ++q) {
            if (t_node[q] == j) {
              uc = t_uc[q];
              um = t_um[q];
              ud = t_ud[q];
              tg = t_tg[q];
              break;
            }
          }
        }
        LeanNode s = lean_node(a.cap_cpu[j], a.cap_mem[j], a.cap_disk[j],
                               a.base[j] != 0, a.penalty[j] != 0, a.aff[j]);
        float v = LEAN_NEG_INF;
        if (lean_feasible(s, uc, um, ud, a_cpu, a_mem, a_disk))
          v = lean_score(s, uc, um, (float)tg, a_cpu, a_mem, spread, denom);
        if (lean_better(v, j, bv, bi)) {
          bv = v;
          bi = j;
        }
      }
    }
    for (int off = 16; off > 0; off >>= 1) {
      float v = __shfl_down_sync(FULL_MASK, bv, off);
      int j = __shfl_down_sync(FULL_MASK, bi, off);
      if (lean_better(v, j, bv, bi)) {
        bv = v;
        bi = j;
      }
    }
    if ((tid & 31) == 0) {
      red_v[tid >> 5] = bv;
      red_i[tid >> 5] = bi;
    }
    __syncthreads();
    if (tid == 0) {
      for (int w = 1; w < NWARPS; ++w) {
        if (lean_better(red_v[w], red_i[w], bv, bi)) {
          bv = red_v[w];
          bi = red_i[w];
        }
      }
      const bool fnd = bv > LEAN_NEG_INF / 2.0f;
      const long long o = (long long)e * a.k + i;
      a.chosen[o] = fnd ? bi : -1;
      a.scores[o] = fnd ? bv : 0.0f;
      a.found[o] = fnd ? 1 : 0;
      if (fnd) {
        int q = 0;
        if (is_touched(touched, bi)) {
          while (t_node[q] != bi) ++q;
        } else {
          q = n_touched++;
          t_node[q] = bi;
          t_uc[q] = a.used_cpu[bi];
          t_um[q] = a.used_mem[bi];
          t_ud[q] = a.used_disk[bi];
          t_tg[q] = a.jobtg[bi];
          touched[bi >> 5] |= 1u << (bi & 31);
        }
        t_uc[q] = t_uc[q] + a_cpu;
        t_um[q] = t_um[q] + a_mem;
        t_ud[q] = t_ud[q] + a_disk;
        t_tg[q] = t_tg[q] + 1;
      }
    }
    __syncthreads();
  }
}

extern "C" int place_batch_launch(const PlaceArgs* args, void* stream) {
  size_t smem = (size_t)((args->n + 31) / 32) * sizeof(unsigned int);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        place_batch_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  place_batch_kernel<<<args->b, THREADS, smem, (cudaStream_t)stream>>>(
      *args);
  return (int)cudaGetLastError();
}
