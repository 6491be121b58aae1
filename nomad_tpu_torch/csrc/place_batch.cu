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
// so the function needs one score per (eval, node in the base mask) (~27
// f32 operations each with two powf), a mask test for every other node,
// one argmax compare per (step, base node) and one rescore per step:
// ~1.9e8 operations at B=512, K=10 over 10000 base nodes of N=16384, ~3 us
// at 67 TFLOP/s. It is bound by operations.
//
// Design. One block of 512 threads per eval. Thread t owns the nodes
// t, t + 512, t + 1024, ...: it scores each of them once at the start and
// keeps their best in registers on (value desc, index asc). A step is one
// block argmax over the 512 owners' bests (warp shuffles, then the 16 warp
// values, read by every thread after one barrier). Only the chosen node's
// carries change, so only its owner's best can: at the next step the block
// rescores that owner's nodes, one per thread (32 nodes at N=16384, 256 at
// N=131072), and the same reduction also gives the owner's new best. Each
// node is scored once per eval plus once per step for one owner's nodes;
// no score row is kept, so one layout serves every N. The carries of the
// at most K touched nodes live in shared memory: an N-bit bitmap says
// whether a node is touched (a 16 KB bitmap at N=131072), and a hash table
// of 2 * 128 entries gives its slot, so a lookup does not grow with K. The
// thread that rescores the node chosen at the step before commits its
// deduction; no other thread reads that node's slot in that step, and the
// step's barrier publishes it. No [B, N] scratch, no input is written, and
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
#define HASH (2 * MAX_K)  // open addressing, load at most 1/2
#define FULL_MASK 0xffffffffu
#define NO_INDEX 0x7fffffff

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

struct Touched {
  unsigned int* bits;  // one bit per node
  int* h_node;         // [HASH] node id, -1 empty
  int* h_slot;         // [HASH] its slot
  float *uc, *um, *ud;
  int* tg;
  int* count;
};

__device__ __forceinline__ int hash_of(int j) {
  return (int)(((unsigned int)j * 2654435761u) >> 24) & (HASH - 1);
}

// Slot of touched node j (its bit is set).
__device__ __forceinline__ int find_slot(const Touched& t, int j) {
  int h = hash_of(j);
  while (t.h_node[h] != j) h = (h + 1) & (HASH - 1);
  return t.h_slot[h];
}

struct Eval {
  float a_cpu, a_mem, a_disk, denom;
  bool spread;
};

__device__ __forceinline__ float masked_score(const PlaceArgs& a,
                                              const Eval& ev, int j, float uc,
                                              float um, float ud, int tg) {
  LeanNode s = lean_node(a.cap_cpu[j], a.cap_mem[j], a.cap_disk[j],
                         a.base[j] != 0, a.penalty[j] != 0, a.aff[j]);
  if (!lean_feasible(s, uc, um, ud, ev.a_cpu, ev.a_mem, ev.a_disk))
    return LEAN_NEG_INF;
  return lean_score(s, uc, um, (float)tg, ev.a_cpu, ev.a_mem, ev.spread,
                    ev.denom);
}

// Score node j on its current carries; if j is ``commit`` (the node chosen
// at the step before), deduct the eval's ask from its carries first.
__device__ __forceinline__ float rescore(const PlaceArgs& a,
                                         const Eval& ev, Touched& t, int j,
                                         int commit) {
  float uc, um, ud;
  int tg, q = -1;
  const bool hit = (t.bits[j >> 5] >> (j & 31)) & 1u;
  if (hit) {
    q = find_slot(t, j);
    uc = t.uc[q];
    um = t.um[q];
    ud = t.ud[q];
    tg = t.tg[q];
  } else {
    uc = a.used_cpu[j];
    um = a.used_mem[j];
    ud = a.used_disk[j];
    tg = a.jobtg[j];
  }
  if (j == commit) {
    uc = uc + ev.a_cpu;
    um = um + ev.a_mem;
    ud = ud + ev.a_disk;
    tg = tg + 1;
    if (!hit) {
      q = (*t.count)++;
      int h = hash_of(j);
      while (t.h_node[h] != -1) h = (h + 1) & (HASH - 1);
      t.h_slot[h] = q;
      t.h_node[h] = j;
      atomicOr(&t.bits[j >> 5], 1u << (j & 31));
    }
    t.uc[q] = uc;
    t.um[q] = um;
    t.ud[q] = ud;
    t.tg[q] = tg;
  }
  return masked_score(a, ev, j, uc, um, ud, tg);
}

__device__ __forceinline__ void better_of(float& v, int& i, float v2,
                                          int i2) {
  if (lean_better(v2, i2, v, i)) {
    v = v2;
    i = i2;
  }
}

__global__ void __launch_bounds__(THREADS)
    place_batch_kernel(const PlaceArgs a) {
  extern __shared__ unsigned int touched_bits[];  // one bit per node
  __shared__ int h_node[HASH], h_slot[HASH];
  __shared__ float t_uc[MAX_K], t_um[MAX_K], t_ud[MAX_K];
  __shared__ int t_tg[MAX_K];
  __shared__ int n_touched;
  // [step parity][slice, all][warp]
  __shared__ float red_v[2][2][NWARPS];
  __shared__ int red_i[2][2][NWARPS];

  const int e = blockIdx.x, tid = threadIdx.x, lane = tid & 31,
            warp = tid >> 5, n = a.n;
  for (int w = tid; w < (n + 31) / 32; w += THREADS) touched_bits[w] = 0u;
  for (int h = tid; h < HASH; h += THREADS) h_node[h] = -1;
  if (tid == 0) n_touched = 0;
  __syncthreads();
  Touched t{touched_bits, h_node, h_slot, t_uc, t_um, t_ud, t_tg, &n_touched};

  Eval ev;
  ev.a_cpu = a.ask_cpu[e];
  ev.a_mem = a.ask_mem[e];
  ev.a_disk = a.ask_disk[e];
  ev.spread = a.spread[e] != 0;
  ev.denom = fmaxf((float)a.desired[e], 1.0f);
  const int n_steps = min(a.n_steps[e], a.k);

  // this thread's best over the nodes it owns
  float my_v = -INFINITY;
  int my_i = NO_INDEX;
  if (n_steps > 0) {
    for (int j = tid; j < n; j += THREADS)
      better_of(my_v, my_i,
                masked_score(a, ev, j, a.used_cpu[j], a.used_mem[j],
                             a.used_disk[j], a.jobtg[j]),
                j);
  }

  int i = 0, prev = -1;  // prev: the node chosen at step i - 1
  for (; i < n_steps; ++i) {
    // (sv, si): the best of prev's owner's nodes, rescored;
    // (gv, gi): the best over every node, this step's choice
    float sv = -INFINITY, gv = my_v;
    int si = NO_INDEX, gi = my_i;
    const int owner = prev % THREADS;
    if (i > 0) {
      if (tid == owner) {
        gv = -INFINITY;
        gi = NO_INDEX;
      }
      for (int j = owner + tid * THREADS; j < n; j += THREADS * THREADS)
        better_of(sv, si, rescore(a, ev, t, j, prev), j);
      better_of(gv, gi, sv, si);
    }
    for (int off = 16; off > 0; off >>= 1) {
      better_of(sv, si, __shfl_xor_sync(FULL_MASK, sv, off),
                __shfl_xor_sync(FULL_MASK, si, off));
      better_of(gv, gi, __shfl_xor_sync(FULL_MASK, gv, off),
                __shfl_xor_sync(FULL_MASK, gi, off));
    }
    const int par = i & 1;
    if (lane == 0) {
      red_v[par][0][warp] = sv;
      red_i[par][0][warp] = si;
      red_v[par][1][warp] = gv;
      red_i[par][1][warp] = gi;
    }
    // one barrier per step: the parity buffers keep a thread that runs
    // ahead from overwriting values another is still reading
    __syncthreads();
    for (int w = 0; w < NWARPS; ++w) {
      better_of(sv, si, red_v[par][0][w], red_i[par][0][w]);
      better_of(gv, gi, red_v[par][1][w], red_i[par][1][w]);
    }
    if (i > 0 && tid == owner) {
      my_v = sv;
      my_i = si;
    }
    const bool fnd = gv > LEAN_NEG_INF / 2.0f;
    if (tid == 0) {
      const long long o = (long long)e * a.k + i;
      a.chosen[o] = fnd ? gi : -1;
      a.scores[o] = fnd ? gv : 0.0f;
      a.found[o] = fnd ? 1 : 0;
    }
    // nothing feasible: the carries stay, so no later step finds either
    if (!fnd) {
      ++i;
      break;
    }
    prev = gi;
  }
  // inactive steps, and the steps after one that found nothing
  for (int r = i + tid; r < a.k; r += THREADS) {
    const long long o = (long long)e * a.k + r;
    a.chosen[o] = -1;
    a.scores[o] = 0.0f;
    a.found[o] = 0;
  }
}

// The dynamic shared memory (the touched bitmap) the kernel is allowed on
// each device: the attribute is raised only when a launch needs more than
// the last setting (above 48 KB, N > 393216), not at every launch.
#define MAX_DEVICES 64
static size_t g_smem[MAX_DEVICES];

static cudaError_t allow_smem(size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < MAX_DEVICES && g_smem[dev] >= smem) return cudaSuccess;
  e = cudaFuncSetAttribute(place_batch_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e == cudaSuccess && dev < MAX_DEVICES) g_smem[dev] = smem;
  return e;
}

extern "C" int place_batch_launch(const PlaceArgs* args, void* stream) {
  size_t smem = (size_t)((args->n + 31) / 32) * sizeof(unsigned int);
  cudaError_t err = allow_smem(smem);
  if (err != cudaSuccess) return (int)err;
  place_batch_kernel<<<args->b, THREADS, smem, (cudaStream_t)stream>>>(
      *args);
  return (int)cudaGetLastError();
}
