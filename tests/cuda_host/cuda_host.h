// A host stand-in for the CUDA runtime, enough to compile the solver
// iteration's kernels (mav_detection_tpu_torch/csrc/farneback_iter.cu, its
// device part), the probe kernels (csrc/shift_probes.cu), the polynomial
// expansion's (csrc/farneback_expand.cu), the rates (csrc/detect_rates.cu)
// and the RAFT lookup (csrc/raft_lookup.cu) as C++ and run them on the
// CPU: one std::thread per CUDA thread, std::barrier for __syncthreads and
// __syncwarp, a per-warp exchange for the shuffles, cp.async and
// cp.async.bulk as queued copies (below). Float arithmetic is the host's
// IEEE single precision without contraction (-ffp-contract=off), as the
// kernels' -fmad=false builds are on the card, so the results compare bit
// for bit with the plain PyTorch version (tests/test_torch_kernel_host.py,
// tests/test_torch_probe_host.py; the expansion, built with contraction on
// the card, within a tolerance: tests/test_torch_expand_host.py). bf16 is a
// 16-bit pattern rounded to nearest even, as __float2bfloat16_rn does.
#pragma once
#include <algorithm>
#include <barrier>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

using std::max;
using std::min;

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __restrict__

struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
struct alignas(8) float2 { float x, y; };
struct alignas(16) float4 { float x, y, z, w; };

thread_local dim3 threadIdx, blockIdx;
thread_local std::barrier<>* g_block_bar;
thread_local std::barrier<>* g_warp_bar;
thread_local float* g_warp_buf;
thread_local float* g_smem;

inline void __syncthreads() { g_block_bar->arrive_and_wait(); }
inline void __syncwarp(unsigned = 0xffffffffu) { g_warp_bar->arrive_and_wait(); }

inline float exchange(float v, int src) {
  const int lane = threadIdx.x & 31;
  g_warp_buf[lane] = v;
  g_warp_bar->arrive_and_wait();
  const float r = g_warp_buf[src & 31];
  g_warp_bar->arrive_and_wait();
  return r;
}
inline float __shfl_xor_sync(unsigned, float v, int mask) {
  return exchange(v, (threadIdx.x & 31) ^ mask);
}
inline float __shfl_sync(unsigned, float v, int src) { return exchange(v, src); }
template <class T> inline T __ldg(const T* p) { return *p; }

struct __nv_bfloat16 { uint16_t bits; };
inline __nv_bfloat16 __float2bfloat16_rn(float f) {
  uint32_t u;
  std::memcpy(&u, &f, 4);
  if ((u & 0x7fffffffu) > 0x7f800000u) return {(uint16_t)((u >> 16) | 0x40)};
  u += 0x7fffu + ((u >> 16) & 1u);
  return {(uint16_t)(u >> 16)};
}
inline float __bfloat162float(__nv_bfloat16 b) {
  const uint32_t u = (uint32_t)b.bits << 16;
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}
struct __nv_bfloat162 { __nv_bfloat16 x, y; };
inline __nv_bfloat162 __floats2bfloat162_rn(float a, float b) {
  return {__float2bfloat16_rn(a), __float2bfloat16_rn(b)};
}
inline float __low2float(__nv_bfloat162 v) { return __bfloat162float(v.x); }
inline float __high2float(__nv_bfloat162 v) { return __bfloat162float(v.y); }

// cp.async: a started copy joins the thread's open group, commit closes
// it, and wait(n) lands every closed group but the newest n, oldest first.
// Built with CP_ASYNC_AT_START a copy lands when it is started instead. The
// card may land a copy at any moment between the two, so a kernel must give
// the same result both ways: landing at the wait shows a ring slot read
// before its copy's wait and barrier, landing at the start shows one
// overwritten while it may still be read.
struct AsyncCopy {
  float* dst;
  const float* src;
  int n;
};
thread_local std::vector<std::vector<AsyncCopy>> g_async_closed;
thread_local std::vector<AsyncCopy> g_async_open;

inline void async_copy(float* dst, const float* src, int n) {
#ifdef CP_ASYNC_AT_START
  std::memcpy(dst, src, sizeof(float) * n);
#else
  g_async_open.push_back({dst, src, n});
#endif
}
inline void async_commit() {
  g_async_closed.push_back(std::move(g_async_open));
  g_async_open.clear();
}
inline void async_wait(int n) {
  while ((int)g_async_closed.size() > n) {
    for (const AsyncCopy& c : g_async_closed.front())
      std::memcpy(c.dst, c.src, sizeof(float) * c.n);
    g_async_closed.erase(g_async_closed.begin());
  }
}

// cp.async.bulk from shared to device memory: a started copy joins the
// thread's open bulk group, commit closes it, and wait_read(n) lands every
// closed group but the newest n. Landing at the wait is the latest moment
// the card may read the shared memory, landing when started the earliest.
struct BulkCopy {
  void* dst;
  const void* src;
  int bytes;
};
thread_local std::vector<std::vector<BulkCopy>> g_bulk_closed;
thread_local std::vector<BulkCopy> g_bulk_open;

inline void bulk_copy(void* dst, const void* src, int bytes) {
#ifdef CP_ASYNC_AT_START
  std::memcpy(dst, src, bytes);
#else
  g_bulk_open.push_back({dst, src, bytes});
#endif
}
inline void bulk_commit() {
  g_bulk_closed.push_back(std::move(g_bulk_open));
  g_bulk_open.clear();
}
inline void bulk_wait_read(int n) {
  while ((int)g_bulk_closed.size() > n) {
    for (const BulkCopy& c : g_bulk_closed.front()) std::memcpy(c.dst, c.src, c.bytes);
    g_bulk_closed.erase(g_bulk_closed.begin());
  }
}

enum { cudaErrorInvalidValue = 1, cudaFuncAttributeMaxDynamicSharedMemorySize = 0 };
template <class F> inline int cudaFuncSetAttribute(F, int, int) { return 0; }

// run body() as every thread of every block of a (bx, by, bz) grid, one
// block after another; shared memory starts as NaN
template <class Fn>
void launch(unsigned bx, unsigned by, unsigned bz, int threads, size_t smem,
            Fn body) {
  std::vector<float> sm(smem / 4 + 16);
  const int warps = (threads + 31) / 32;
  std::vector<float> wbuf(32 * warps);
  for (unsigned z = 0; z < bz; ++z)
    for (unsigned y = 0; y < by; ++y)
      for (unsigned x = 0; x < bx; ++x) {
        std::fill(sm.begin(), sm.end(), std::nanf(""));
        std::barrier<> bar(threads);
        std::vector<std::barrier<>*> wb;
        for (int w = 0; w < warps; ++w)
          wb.push_back(new std::barrier<>(std::min(32, threads - 32 * w)));
        std::vector<std::thread> ths;
        for (int t = 0; t < threads; ++t)
          ths.emplace_back([&, t] {
            threadIdx = dim3(t);
            blockIdx = dim3(x, y, z);
            g_block_bar = &bar;
            g_warp_bar = wb[t / 32];
            g_warp_buf = &wbuf[32 * (t / 32)];
            g_smem = sm.data();
            body();
          });
        for (auto& th : ths) th.join();
        for (auto* p : wb) delete p;
      }
}
