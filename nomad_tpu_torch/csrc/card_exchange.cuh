// The exchange between the clusters of a wave, shared by three kernels.
//
// csrc/sharded_wave.cu (the fused sharded wave) and
// csrc/joint_sharded_wave.cu (the joint sharded wave) run a wave over
// several cards as one cluster a card, and the cards trade each step's
// result through mailboxes in each other's memory over NVLink. They share
// from here the device side (system-scope acquire loads and release
// stores, and the bounded wait on another card's tag) and the host side
// (each mailbox zeroed on its card's stream and every card ordered after
// the others' earlier work before the launches; every card's stream made
// to wait on the end of every launched kernel after them).
// csrc/joint_wave.cu runs one wave as several clusters on one card, which
// trade each step's result through one mailbox in that card's memory: the
// same tags and bounded wait at gpu scope (ld_acquire_gpu, st_release_gpu,
// wait_tag_gpu), so no system-scope fence is paid on one card. Each kernel
// keeps its own entry layout.

#pragma once

#include <cuda_runtime.h>

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.sys.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(unsigned* p, unsigned v) {
  asm volatile("st.release.sys.u32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ unsigned long long now_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Wait until *tag reads `want`, for at most spin_ns: false past the bound.
__device__ __noinline__ bool wait_tag(const unsigned* tag, unsigned want,
                                      long long spin_ns) {
  if (ld_acquire(tag) == want) return true;
  const unsigned long long t0 = now_ns();
  while (ld_acquire(tag) != want)
    if (now_ns() - t0 > (unsigned long long)spin_ns) return false;
  return true;
}

// The same at gpu scope: the clusters of one launch on one card.
__device__ __forceinline__ unsigned ld_acquire_gpu(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release_gpu(unsigned* p, unsigned v) {
  asm volatile("st.release.gpu.u32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

__device__ __noinline__ bool wait_tag_gpu(const unsigned* tag, unsigned want,
                                          long long spin_ns) {
  if (ld_acquire_gpu(tag) == want) return true;
  const unsigned long long t0 = now_ns();
  while (ld_acquire_gpu(tag) != want)
    if (now_ns() - t0 > (unsigned long long)spin_ns) return false;
  return true;
}

#define CK(x)                                   \
  do {                                          \
    const cudaError_t e_ = (x);                 \
    if (e_ != cudaSuccess) return e_;           \
  } while (0)

// Before the launches over several cards: each card's mailbox (`mail`
// bytes) zeroed on its card's stream, then every card's stream after every
// other card's work enqueued before this wave, since a card's mailbox takes
// peer stores from the first step on. `Card` has ordinal, stream and mail.
template <typename Card>
static cudaError_t order_cards(const Card* card, int n_cards, size_t mail,
                               cudaEvent_t* ev) {
  auto stream = [&](int d) { return (cudaStream_t)card[d].stream; };
  for (int d = 0; d < n_cards; ++d) {
    CK(cudaSetDevice(card[d].ordinal));
    CK(cudaMemsetAsync(card[d].mail, 0, mail, stream(d)));
    CK(cudaEventCreateWithFlags(&ev[d], cudaEventDisableTiming));
    CK(cudaEventRecord(ev[d], stream(d)));
  }
  for (int d = 0; d < n_cards; ++d) {
    CK(cudaSetDevice(card[d].ordinal));
    for (int e = 0; e < n_cards; ++e)
      if (e != d) CK(cudaStreamWaitEvent(stream(d), ev[e], 0));
  }
  return cudaSuccess;
}

// Over several cards, after the launches: every card's stream waits on
// the end of each of the `launched` first cards' kernels, so no card's
// later work, nor the allocator, has a mailbox back before its last peer
// store. Enqueued after every launch, so no kernel waits on another's.
// Where a wait cannot be enqueued, the host waits for the kernels.
template <typename Card>
static cudaError_t join_cards(const Card* card, int n_cards, int launched,
                              cudaEvent_t* done) {
  auto stream = [&](int d) { return (cudaStream_t)card[d].stream; };
  cudaError_t first = cudaSuccess;
  auto keep = [&](cudaError_t e) {
    if (first == cudaSuccess) first = e;
    return e == cudaSuccess;
  };
  for (int d = 0; d < launched && first == cudaSuccess; ++d)
    if (keep(cudaSetDevice(card[d].ordinal)) &&
        keep(cudaEventCreateWithFlags(&done[d], cudaEventDisableTiming)))
      keep(cudaEventRecord(done[d], stream(d)));
  for (int d = 0; d < n_cards && first == cudaSuccess; ++d) {
    keep(cudaSetDevice(card[d].ordinal));
    for (int e = 0; e < launched && first == cudaSuccess; ++e)
      if (e != d) keep(cudaStreamWaitEvent(stream(d), done[e], 0));
  }
  if (first != cudaSuccess)
    for (int d = 0; d < launched; ++d)
      if (cudaSetDevice(card[d].ordinal) == cudaSuccess)
        cudaStreamSynchronize(stream(d));
  return first;
}
