// Fused placement wave for NVIDIA Hopper (sm_90a).
//
// Replaces: nomad_tpu/ops/pallas_kernel.py `fused_wave_place` (:553-603,
// the pl.pallas_call at :600), reached through `_fused_wave_run` (:606),
// `fused_wave_place_jit` (:615) and `make_fused_wave_apply` (:618). It
// computes what nomad_tpu_torch/ops/kernel.place_taskgroups_joint computes
// inside the fused envelope (ports, step penalties, preferred pins,
// distinct_hosts, shuffle, top-k; no spreads, devices, cores or network),
// and packs the result the way ops/kernel.pack_fused_wave does.
//
// What bounds it. Counting each input byte once, the live shape (B=32
// members, N=16384 nodes, T=512 steps) reads about B*N*~19 B of member
// planes plus N*~44 B of shared planes, ~10 MB: ~3 us at 3.35 TB/s. That
// is not the floor that matters. The wave is T sequential steps, and step
// t+1's feasibility depends on step t's choice, so the real floor is a
// chain of T dependent N-wide reductions (one argmax plus the top-8), each
// a full pass over the node planes followed by a block-wide reduction.
//
// Design (simple first). ONE thread block of 1024 threads runs the whole
// wave: a loop over the T steps inside the kernel, each thread striding
// over the node axis. Per step every thread scores its nodes, keeps its
// own best (value desc, permutation rank asc) and its own sorted top-8
// (value desc, index asc); a warp-shuffle + shared-memory reduction gives
// the block argmax, and eight reduction rounds over the threads' list
// heads merge the top-8. Thread 0 then applies the preferred-node pin and
// commits the chosen node into the carries, and __syncthreads() publishes
// them. Shared carries a_cpu/a_mem/a_disk/a_dyn are output or scratch
// buffers in global memory (at N=16384 they need 256 KB, more than a
// block's 227 KB of shared memory) and stay resident in L2; per-member
// carries (job_tg_count, job_any_count, port_conflict [B,N]) are scratch
// copies this kernel fills from the inputs, so no input is ever written.
// Member metrics come from the pre-wave state before the step loop, in
// the same launch: one launch per wave.
//
// What the one-block design gives up: it uses one of the card's 132 SMs,
// so each step's node pass runs at one SM's rate. A persistent multi-block
// grid (cluster/DSMEM or grid sync per step) would spread the pass; that
// is later work.
//
// Built by nomad_tpu_torch/ops/build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xptxas -v
//        -fmad=false -shared -Xcompiler -fPIC
// (-fmad=false so the score arithmetic rounds op for op like the plain
// torch version on the card; no fast-math).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define THREADS 1024
#define NWARPS (THREADS / 32)
#define TOPK 8
#define FULL_MASK 0xffffffffu

#define NEG_INF_F (-1.0e30f)

// Leaf order: mirrored by nomad_tpu_torch/ops/cuda_kernel._LEAVES.
enum Leaf {
  L_CAP_CPU, L_CAP_MEM, L_CAP_DISK,       // f32 [N]
  L_USED_CPU, L_USED_MEM, L_USED_DISK,    // f32 [N]
  L_AFF,                                  // f32 [N]
  L_FREE_DYN, L_JTC, L_JAC, L_PERM,       // i32 [N]
  L_BASE, L_PC, L_PENALTY,                // bool [N]
  L_STEP_PEN,                             // i32 [K, P]
  L_STEP_PREF,                            // i32 [K]
  L_ASK_CPU, L_ASK_MEM, L_ASK_DISK,       // f32 scalar
  L_ASK_DYN, L_DESIRED, L_NSTEPS,         // i32 scalar
  L_ASK_RES, L_ALG, L_DHJ, L_DHT,         // bool scalar
  N_LEAVES
};

struct FusedArgs {
  const void* leaf[N_LEAVES];
  long long stride[N_LEAVES];  // member stride in elements; 0 = shared
  const int* step_member;      // i32 [T]
  const int* step_local;       // i32 [T]
  float* packed;               // f32 [2T + 8B]
  int* topk_idx;               // i32 [T, TOPK]
  float* topk_scores;          // f32 [T, TOPK]
  float* a_cpu;                // f32 [N] (outputs: the wave's carry)
  float* a_mem;
  float* a_disk;
  int* a_dyn;                  // i32 [N] scratch
  int* jtc;                    // i32 [B, N] scratch
  int* jac;                    // i32 [B, N] scratch (with_distinct)
  unsigned char* pc;           // bool [B, N] scratch (with_ports)
  int* inv_perm;               // i32 [BP, N] scratch (with_shuffle)
  int n, b, t, k, p, bp;
  int with_topk, with_ports, with_distinct, with_step_pen, with_pref,
      with_shuffle;
};

template <typename T>
__device__ __forceinline__ const T* leaf_of(const FusedArgs& a, int leaf,
                                            int m) {
  return reinterpret_cast<const T*>(a.leaf[leaf]) + m * a.stride[leaf];
}

// One member's view for one step (pointers already offset to member m).
struct View {
  const float *cap_cpu, *cap_mem, *cap_disk, *used_cpu, *used_mem,
      *used_disk, *aff;
  const int *free_dyn, *step_pen;
  const unsigned char *base, *penalty;
  const int* jtc;
  const int* jac;
  const unsigned char* pc;
  float ask_cpu, ask_mem, ask_disk;
  int ask_dyn, desired;
  bool has_res, alg_spread, dhj, dht;
};

__device__ __forceinline__ View member_view(const FusedArgs& a, int m,
                                            int j) {
  View v;
  v.cap_cpu = leaf_of<float>(a, L_CAP_CPU, m);
  v.cap_mem = leaf_of<float>(a, L_CAP_MEM, m);
  v.cap_disk = leaf_of<float>(a, L_CAP_DISK, m);
  v.used_cpu = leaf_of<float>(a, L_USED_CPU, m);
  v.used_mem = leaf_of<float>(a, L_USED_MEM, m);
  v.used_disk = leaf_of<float>(a, L_USED_DISK, m);
  v.aff = leaf_of<float>(a, L_AFF, m);
  v.free_dyn = leaf_of<int>(a, L_FREE_DYN, m);
  v.step_pen = leaf_of<int>(a, L_STEP_PEN, m) + (long long)j * a.p;
  v.base = leaf_of<unsigned char>(a, L_BASE, m);
  v.penalty = leaf_of<unsigned char>(a, L_PENALTY, m);
  v.jtc = a.jtc + (long long)m * a.n;
  v.jac = a.with_distinct ? a.jac + (long long)m * a.n : nullptr;
  v.pc = a.with_ports ? a.pc + (long long)m * a.n : nullptr;
  v.ask_cpu = *leaf_of<float>(a, L_ASK_CPU, m);
  v.ask_mem = *leaf_of<float>(a, L_ASK_MEM, m);
  v.ask_disk = *leaf_of<float>(a, L_ASK_DISK, m);
  v.ask_dyn = *leaf_of<int>(a, L_ASK_DYN, m);
  v.desired = *leaf_of<int>(a, L_DESIRED, m);
  v.has_res = *leaf_of<unsigned char>(a, L_ASK_RES, m) != 0;
  v.alg_spread = *leaf_of<unsigned char>(a, L_ALG, m) != 0;
  v.dhj = *leaf_of<unsigned char>(a, L_DHJ, m) != 0;
  v.dht = *leaf_of<unsigned char>(a, L_DHT, m) != 0;
  return v;
}

// Feasibility of node i in the member's view with the current carries
// (ops/kernel._feasible restricted to the fused envelope).
__device__ __forceinline__ bool node_feasible(const FusedArgs& a,
                                              const View& v, int i) {
  float ucpu = v.used_cpu[i] + a.a_cpu[i];
  float umem = v.used_mem[i] + a.a_mem[i];
  float udisk = v.used_disk[i] + a.a_disk[i];
  bool ok = v.base[i] != 0 && (v.cap_cpu[i] - ucpu) >= v.ask_cpu &&
            (v.cap_mem[i] - umem) >= v.ask_mem &&
            (v.cap_disk[i] - udisk) >= v.ask_disk;
  if (a.with_ports) {
    bool fit_dyn = v.ask_dyn <= 0 || (v.free_dyn[i] - a.a_dyn[i]) >= v.ask_dyn;
    ok = ok && !(v.pc[i] != 0 && v.has_res) && fit_dyn;
  }
  if (a.with_distinct) {
    ok = ok && !((v.dhj && v.jac[i] > 0) || (v.dht && v.jtc[i] > 0));
  }
  return ok;
}

// Normalized score of node i (ops/kernel._score restricted to the fused
// envelope), same operation order as the torch version.
__device__ __forceinline__ float node_score(const FusedArgs& a,
                                            const View& v, int i) {
  float util_cpu = (v.used_cpu[i] + a.a_cpu[i]) + v.ask_cpu;
  float util_mem = (v.used_mem[i] + a.a_mem[i]) + v.ask_mem;
  float cap_cpu = v.cap_cpu[i], cap_mem = v.cap_mem[i];
  float fc = cap_cpu > 0.0f ? 1.0f - util_cpu / cap_cpu : 0.0f;
  float fm = cap_mem > 0.0f ? 1.0f - util_mem / cap_mem : 0.0f;
  float total = powf(10.0f, fc) + powf(10.0f, fm);
  float binpack = fminf(fmaxf(20.0f - total, 0.0f), 18.0f);
  float spreadfit = fminf(fmaxf(total - 2.0f, 0.0f), 18.0f);
  float sum = (v.alg_spread ? spreadfit : binpack) / 18.0f;
  float nplanes = 1.0f;
  float collisions = (float)v.jtc[i];
  if (collisions > 0.0f) {
    float denom = fmaxf((float)v.desired, 1.0f);
    sum = sum + (-(collisions + 1.0f) / denom);
    nplanes = nplanes + 1.0f;
  }
  bool pen = v.penalty[i] != 0;
  if (a.with_step_pen) {
    for (int q = 0; q < a.p; ++q) pen = pen || (v.step_pen[q] == i);
  }
  if (pen) {
    sum = sum + -1.0f;
    nplanes = nplanes + 1.0f;
  }
  float aff = v.aff[i];
  if (aff != 0.0f) {
    sum = sum + aff;
    nplanes = nplanes + 1.0f;
  }
  return sum / nplanes;
}

struct Cand {
  float v;
  int r;  // ordering key among equal values (rank or index), asc
  int i;  // node index
};

__device__ __forceinline__ bool better(float v1, int r1, float v2, int r2) {
  return v1 > v2 || (v1 == v2 && r1 < r2);
}

// Block-wide best candidate; `sh` holds NWARPS + 1 slots. Two barriers:
// the result slot is read after the second, and is next written only
// after the next call's first barrier.
__device__ Cand block_best(Cand c, Cand* sh) {
  for (int off = 16; off > 0; off >>= 1) {
    float v = __shfl_down_sync(FULL_MASK, c.v, off);
    int r = __shfl_down_sync(FULL_MASK, c.r, off);
    int i = __shfl_down_sync(FULL_MASK, c.i, off);
    if (better(v, r, c.v, c.r)) {
      c.v = v; c.r = r; c.i = i;
    }
  }
  int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) sh[warp] = c;
  __syncthreads();
  if (warp == 0) {
    c = sh[lane];  // NWARPS == 32: every lane has a slot
    for (int off = 16; off > 0; off >>= 1) {
      float v = __shfl_down_sync(FULL_MASK, c.v, off);
      int r = __shfl_down_sync(FULL_MASK, c.r, off);
      int i = __shfl_down_sync(FULL_MASK, c.i, off);
      if (better(v, r, c.v, c.r)) {
        c.v = v; c.r = r; c.i = i;
      }
    }
    if (lane == 0) sh[NWARPS] = c;
  }
  __syncthreads();
  return sh[NWARPS];
}

// Block-wide sums of six counters; `sh` holds NWARPS*6 + 6 ints.
__device__ void block_sum6(int* c, int* sh) {
  for (int q = 0; q < 6; ++q)
    for (int off = 16; off > 0; off >>= 1)
      c[q] += __shfl_down_sync(FULL_MASK, c[q], off);
  int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0)
    for (int q = 0; q < 6; ++q) sh[warp * 6 + q] = c[q];
  __syncthreads();
  if (warp == 0) {
    for (int q = 0; q < 6; ++q) {
      int x = sh[lane * 6 + q];
      for (int off = 16; off > 0; off >>= 1)
        x += __shfl_down_sync(FULL_MASK, x, off);
      if (lane == 0) sh[NWARPS * 6 + q] = x;
    }
  }
  __syncthreads();
  for (int q = 0; q < 6; ++q) c[q] = sh[NWARPS * 6 + q];
  __syncthreads();
}

__global__ void __launch_bounds__(THREADS, 1)
    fused_wave_kernel(const FusedArgs a) {
  __shared__ Cand sh_best[NWARPS + 1];
  __shared__ int sh_sum[NWARPS * 6 + 6];
  const int n = a.n, tid = threadIdx.x;

  // ---- scratch init: zero the shared carries, copy per-member ones ----
  for (int i = tid; i < n; i += THREADS) {
    a.a_cpu[i] = 0.0f;
    a.a_mem[i] = 0.0f;
    a.a_disk[i] = 0.0f;
    if (a.with_ports) a.a_dyn[i] = 0;
  }
  for (long long x = tid; x < (long long)a.b * n; x += THREADS) {
    int m = (int)(x / n), i = (int)(x % n);
    a.jtc[x] = leaf_of<int>(a, L_JTC, m)[i];
    if (a.with_distinct) a.jac[x] = leaf_of<int>(a, L_JAC, m)[i];
    if (a.with_ports) a.pc[x] = leaf_of<unsigned char>(a, L_PC, m)[i];
  }
  if (a.with_shuffle) {
    for (long long x = tid; x < (long long)a.bp * n; x += THREADS) {
      int m = (int)(x / n), i = (int)(x % n);
      int pos = leaf_of<int>(a, L_PERM, m)[i];
      a.inv_perm[(long long)m * n + pos] = i;
    }
  }
  __syncthreads();

  // ---- per-member metrics from the pre-wave state ----
  float* metrics = a.packed + 2 * a.t;
  for (int m = 0; m < a.b; ++m) {
    View v = member_view(a, m, 0);
    const int* jtc_in = leaf_of<int>(a, L_JTC, m);
    const int* jac_in = leaf_of<int>(a, L_JAC, m);
    const unsigned char* pc_in = leaf_of<unsigned char>(a, L_PC, m);
    int c[6] = {0, 0, 0, 0, 0, 0};
    for (int i = tid; i < n; i += THREADS) {
      bool base = v.base[i] != 0;
      bool fit_cpu = (v.cap_cpu[i] - v.used_cpu[i]) >= v.ask_cpu;
      bool fit_mem = (v.cap_mem[i] - v.used_mem[i]) >= v.ask_mem;
      bool fit_disk = (v.cap_disk[i] - v.used_disk[i]) >= v.ask_disk;
      bool fit_ports = true;
      if (a.with_ports) {
        bool fit_dyn = v.ask_dyn <= 0 || v.free_dyn[i] >= v.ask_dyn;
        fit_ports = !(pc_in[i] != 0 && v.has_res) && fit_dyn;
      }
      bool distinct_ok = true;
      if (a.with_distinct)
        distinct_ok = !((v.dhj && jac_in[i] > 0) || (v.dht && jtc_in[i] > 0));
      bool feas = base && fit_cpu && fit_mem && fit_disk && fit_ports &&
                  distinct_ok;
      c[0] += base;
      c[1] += feas;
      c[2] += base && !fit_cpu;
      c[3] += base && !fit_mem;
      c[4] += base && !fit_disk;
      c[5] += base && !fit_ports;
    }
    block_sum6(c, sh_sum);
    if (tid == 0) {
      for (int q = 0; q < 6; ++q) metrics[q * a.b + m] = (float)c[q];
      metrics[6 * a.b + m] = 0.0f;  // exhausted_devices: outside envelope
      metrics[7 * a.b + m] = 0.0f;  // exhausted_cores: outside envelope
    }
  }

  // ---- the step loop ----
  for (int t = 0; t < a.t; ++t) {
    const int member = a.step_member[t];
    const int m = min(max(member, 0), a.b - 1);
    const int j_raw = a.step_local[t];
    const int j = min(max(j_raw, 0), a.k - 1);
    const View v = member_view(a, m, j);
    const int n_steps = *leaf_of<int>(a, L_NSTEPS, m);
    const bool active = member >= 0 && j_raw < n_steps;
    const int* inv = a.with_shuffle ? a.inv_perm + (long long)(a.bp > 1 ? m : 0) * n
                                    : nullptr;

    Cand best = {-INFINITY, 0x7fffffff, 0};
    float lv[TOPK];
    int li[TOPK];
#pragma unroll
    for (int q = 0; q < TOPK; ++q) {
      lv[q] = -INFINITY;
      li[q] = 0x7fffffff;
    }
    for (int i = tid; i < n; i += THREADS) {
      float masked = NEG_INF_F;
      if (active && node_feasible(a, v, i)) masked = node_score(a, v, i);
      int r = a.with_shuffle ? inv[i] : i;
      if (better(masked, r, best.v, best.r)) {
        best.v = masked; best.r = r; best.i = i;
      }
      if (a.with_topk && masked > lv[TOPK - 1]) {
        bool placed = false;
#pragma unroll
        for (int q = TOPK - 1; q > 0; --q) {
          if (!placed) {
            if (masked > lv[q - 1]) {
              lv[q] = lv[q - 1];
              li[q] = li[q - 1];
            } else {
              lv[q] = masked;
              li[q] = i;
              placed = true;
            }
          }
        }
        if (!placed) {
          lv[0] = masked;
          li[0] = i;
        }
      }
    }
    best = block_best(best, sh_best);

    if (a.with_topk) {
      for (int q = 0; q < TOPK; ++q) {
        Cand head = {lv[0], li[0], li[0]};
        Cand win = block_best(head, sh_best);
        if (li[0] == win.i && win.i != 0x7fffffff) {
#pragma unroll
          for (int s = 0; s < TOPK - 1; ++s) {
            lv[s] = lv[s + 1];
            li[s] = li[s + 1];
          }
          lv[TOPK - 1] = -INFINITY;
          li[TOPK - 1] = 0x7fffffff;
        }
        if (tid == 0) {
          a.topk_idx[t * TOPK + q] = win.i;
          a.topk_scores[t * TOPK + q] = win.v;
        }
      }
    } else if (tid == 0) {
      for (int q = 0; q < TOPK; ++q) {
        a.topk_idx[t * TOPK + q] = 0;
        a.topk_scores[t * TOPK + q] = NEG_INF_F;
      }
    }

    if (tid == 0) {
      int idx = best.i;
      float val = best.v;
      if (a.with_pref) {
        int pref = leaf_of<int>(a, L_STEP_PREF, m)[j];
        int pcl = min(max(pref, 0), n - 1);
        if (pref >= 0 && active && node_feasible(a, v, pcl)) {
          idx = pcl;
          val = node_score(a, v, pcl);
        }
      }
      bool found = val > NEG_INF_F / 2.0f;
      a.packed[t] = found ? (float)idx : -1.0f;
      a.packed[a.t + t] = found ? val : 0.0f;
      if (found && active) {
        a.a_cpu[idx] = a.a_cpu[idx] + v.ask_cpu;
        a.a_mem[idx] = a.a_mem[idx] + v.ask_mem;
        a.a_disk[idx] = a.a_disk[idx] + v.ask_disk;
        a.jtc[(long long)m * n + idx] += 1;
        if (a.with_ports) {
          a.a_dyn[idx] += v.ask_dyn;
          if (v.has_res) a.pc[(long long)m * n + idx] = 1;
        }
        if (a.with_distinct) a.jac[(long long)m * n + idx] += 1;
      }
    }
    __syncthreads();
  }
}

extern "C" int fused_wave_launch(const FusedArgs* args, void* stream) {
  fused_wave_kernel<<<1, THREADS, 0, (cudaStream_t)stream>>>(*args);
  return (int)cudaGetLastError();
}
