// The lean placement score shared by the batched kernels.
//
// One arithmetic for csrc/place_batch.cu (replacing
// nomad_tpu/ops/pallas_kernel.py `_place_kernel`, :106-126) and
// csrc/cand_scan.cu (replacing `_cand_scan_kernel`, :294-313): binpack or
// spread fit over the cpu/mem free fractions (funcs.go:259 / :286, /18),
// then the anti-affinity, penalty and affinity planes averaged over the
// planes that apply (rank.go:588, :655, :730, :764). The operation order
// is that of the plain torch version (ops/cuda_kernel._lean_score), and
// the build passes -fmad=false, so both round alike on the card.

#pragma once

#include <math.h>

#define LEAN_NEG_INF (-1.0e30f)

// Per-node terms that do not change between steps.
struct LeanNode {
  float cc, cm, cd;   // capacities
  float aff_sum;      // (aff != 0 ? aff : 0) + (penalty ? -1 : 0)
  float extra;        // (penalty ? 1 : 0) + (aff != 0 ? 1 : 0)
  bool base;
};

__device__ __forceinline__ LeanNode lean_node(float cc, float cm, float cd,
                                              bool base, bool pen,
                                              float aff) {
  LeanNode s;
  s.cc = cc;
  s.cm = cm;
  s.cd = cd;
  s.base = base;
  bool aff_on = aff != 0.0f;
  s.aff_sum = (aff_on ? aff : 0.0f) + (pen ? -1.0f : 0.0f);
  s.extra = (pen ? 1.0f : 0.0f) + (aff_on ? 1.0f : 0.0f);
  return s;
}

__device__ __forceinline__ bool lean_feasible(const LeanNode& s, float uc,
                                              float um, float ud,
                                              float a_cpu, float a_mem,
                                              float a_disk) {
  return s.base && (s.cc - uc) >= a_cpu && (s.cm - um) >= a_mem &&
         (s.cd - ud) >= a_disk;
}

// ``coll`` is the node's job/task-group count, ``denom`` max(desired, 1).
__device__ __forceinline__ float lean_score(const LeanNode& s, float uc,
                                            float um, float coll,
                                            float a_cpu, float a_mem,
                                            bool spread, float denom) {
  float fc = s.cc > 0.0f ? 1.0f - (uc + a_cpu) / s.cc : 0.0f;
  float fm = s.cm > 0.0f ? 1.0f - (um + a_mem) / s.cm : 0.0f;
  float total = powf(10.0f, fc) + powf(10.0f, fm);
  float binpack = fminf(fmaxf(20.0f - total, 0.0f), 18.0f);
  float spreadfit = fminf(fmaxf(total - 2.0f, 0.0f), 18.0f);
  // torch divides a CUDA tensor by a Python scalar as a product with the
  // scalar's f32 reciprocal (ATen div_true_kernel_cuda); so does this
  float fit = (spread ? spreadfit : binpack) * (1.0f / 18.0f);
  bool anti_on = coll > 0.0f;
  float ssum = fit + (anti_on ? -(coll + 1.0f) / denom : 0.0f) + s.aff_sum;
  float nplanes = 1.0f + (anti_on ? 1.0f : 0.0f) + s.extra;
  return ssum / nplanes;
}

// (value desc, index asc): the first-index argmax of the Pallas kernels.
__device__ __forceinline__ bool lean_better(float v1, int i1, float v2,
                                            int i2) {
  return v1 > v2 || (v1 == v2 && i1 < i2);
}
