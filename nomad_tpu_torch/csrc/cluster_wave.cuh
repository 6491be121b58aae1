// The parts of the cluster wave kernels that hold no scoring rule.
//
// csrc/fused_wave.cu (B1), csrc/joint_wave.cu, csrc/sharded_wave.cu and
// csrc/joint_sharded_wave.cu each run a wave as one cluster of CTAs (a
// card) that own node ranges and meet once a step. They share, from here:
// the CTA's argmax slot and top-8 list, the permutation-rank loader, a
// warp's top-8 of its row entries, the cluster's top-8 from its CTAs'
// lists and its write-out, and on the host the dynamic shared memory a
// block may take and the cluster launch configuration.
// Every device function here is force-inlined, so each kernel compiles as
// it did with the code written out in place.

#pragma once

#include <cooperative_groups.h>

#include "wave_score.cuh"

#define RANK_UNROLL 8  // 16-byte permutation loads in flight

// One CTA's argmax for one step, read by every CTA after the step's
// cluster barrier.
struct __align__(16) Slot {
  unsigned k, r;  // score key, and its rank
  int i;          // node index
  float pin_v;    // the pin's masked step value (meaningful from its owner)
};

// One CTA's top-8 for one step, read by the emitting warp during the next.
struct __align__(16) TopList {
  unsigned k[TOPK];
  int i[TOPK];
};

// rank[r - lo] = the position of node g in `perm` for every node whose row
// r = row_of(g) is one of this CTA's [lo, hi), over NT threads; 16-byte
// loads where the permutation row starts 16-byte aligned.
template <int NT, typename RowOf>
__device__ __forceinline__ void load_ranks(const int* perm, int n, int lo,
                                           int hi, unsigned* rank, int tid,
                                           RowOf row_of) {
  if ((n & 3) == 0 && ((uintptr_t)perm & 15) == 0) {
    const int4* p4 = reinterpret_cast<const int4*>(perm);
    for (int g0 = tid; g0 < n / 4; g0 += RANK_UNROLL * NT) {
      int4 v[RANK_UNROLL];
#pragma unroll
      for (int u = 0; u < RANK_UNROLL; ++u) {
        const int g = g0 + u * NT;
        v[u] = g < n / 4 ? __ldg(p4 + g) : make_int4(-1, -1, -1, -1);
      }
#pragma unroll
      for (int u = 0; u < RANK_UNROLL; ++u) {
        const int pos = 4 * (g0 + u * NT);
        const int node[4] = {v[u].x, v[u].y, v[u].z, v[u].w};
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int r = row_of(node[c]);
          if (r >= lo && r < hi) rank[r - lo] = (unsigned)(pos + c);
        }
      }
    }
  } else {
    for (int pos = tid; pos < n; pos += NT) {
      const int r = row_of(__ldg(perm + pos));
      if (r >= lo && r < hi) rank[r - lo] = (unsigned)pos;
    }
  }
}

// The calling warp's sorted top-8 of its row entries (x = warp*32 + lane +
// k*NT, node lo + x) into tk/ti.
template <int NT>
__device__ __forceinline__ void warp_row_top(const unsigned* row, int lo,
                                             int cnt, int warp, int lane,
                                             unsigned* tk, int* ti) {
  unsigned lk[TOPK], ok[TOPK];
  int li[TOPK], oi[TOPK];
  list_clear(lk, li);
  for (int x = warp * 32 + lane; x < cnt; x += NT)
    list_insert(lk, li, row[x], lo + x);
  warp_top(lk, li, ok, oi);
#pragma unroll
  for (int q = 0; q < TOPK; ++q)
    if (q == lane) {
      tk[q] = ok[q];
      ti[q] = oi[q];
    }
}

// The cluster's top-8 from its NCTA CTAs' lists at `lists` (each CTA's own
// copy, written before a cluster barrier already passed), in every lane's
// (ok, oi); padding without top-k.
template <int NCTA>
__device__ __forceinline__ void cluster_top(
    cooperative_groups::cluster_group& cluster, TopList* lists,
    int with_topk, int lane, unsigned* ok, int* oi) {
  unsigned lk[TOPK];
  int li[TOPK];
  list_clear(lk, li);
  list_clear(ok, oi);
  if (with_topk) {
    if (lane < NCTA) {
      const TopList* tl = cluster.map_shared_rank(lists, lane);
#pragma unroll
      for (int q = 0; q < TOPK; ++q) {
        lk[q] = tl->k[q];
        li[q] = tl->i[q];
      }
    }
    warp_top(lk, li, ok, oi);
  }
}

// Lane q < TOPK writes entry q of step t's top-8 (ok, oi); without top-k,
// index 0 and NEG_INF_F.
__device__ __forceinline__ void write_topk(const unsigned* ok, const int* oi,
                                           int lane, int t, int with_topk,
                                           int* topk_idx,
                                           float* topk_scores) {
  if (lane < TOPK) {
    unsigned k = PAD_KEY;
    int i = 0;
#pragma unroll
    for (int q = 0; q < TOPK; ++q)
      if (q == lane) {
        k = ok[q];
        i = oi[q];
      }
    topk_idx[t * TOPK + lane] = with_topk ? i : 0;
    topk_scores[t * TOPK + lane] = with_topk ? key_score(k) : NEG_INF_F;
  }
}

// The dynamic shared memory a block of each of `kernels` may take on the
// current device (the opt-in limit less the largest static part), after
// setting their attributes there: once a device, remembered in `cache`
// (0: not set yet).
template <typename K, int NK, int ND>
static cudaError_t cluster_smem_limit(K const (&kernels)[NK],
                                      int (&cache)[ND], int* limit) {
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < ND && cache[dev] > 0) {
    *limit = cache[dev];
    return cudaSuccess;
  }
  e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev);
  if (e != cudaSuccess) return e;
  size_t static_smem = 0;
  for (K kernel : kernels) {
    cudaFuncAttributes fa;
    e = cudaFuncGetAttributes(&fa, kernel);
    if (e != cudaSuccess) return e;
    if (fa.sharedSizeBytes > static_smem) static_smem = fa.sharedSizeBytes;
  }
  *limit = optin - (int)static_smem;
  for (K kernel : kernels) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             *limit);
    if (e != cudaSuccess) return e;
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeNonPortableClusterSizeAllowed,
                             1);
    if (e != cudaSuccess) return e;
  }
  if (dev < ND) cache[dev] = *limit;
  return cudaSuccess;
}

// One cluster of NCTA CTAs of NT threads, `smem` bytes of dynamic shared
// memory each, on `stream`; `attr` holds the cluster attribute.
template <int NCTA, int NT>
static cudaLaunchConfig_t cluster_launch_config(size_t smem,
                                                cudaStream_t stream,
                                                cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(NCTA, 1, 1);
  cfg.blockDim = dim3(NT, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = NCTA;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}
