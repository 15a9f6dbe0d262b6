// Probe kernels for Hopper (sm_90a) that take the Farneback iteration's
// warp apart: the integer-shift reads of its y stage, each form on its own,
// so that its cost can be timed apart from the fused kernel
// (csrc/farneback_iter.cu), whose warp they isolate.
//
// Replaces the reference's Pallas TPU probe kernels:
//   tools/gather_probe.py::chain_kernel   -> shift_chain_kernel<AXIS, SS>
//   tools/gather_probe.py::gather_kernel  -> shift_gather_kernel<AXIS, SS>
//   tools/chain_probe.py::kern (A-D)      -> y_stage_kernel<V, SS>, plus T
//
// What each computes:
//   * shift_chain: out(r, c) = sum over s = -S .. S+1, in s order from 0.0f,
//     of w_s * x[r + S + s, c] (axis 0) or x[r, c + S + s] (axis 1), with
//     w_s = [sy = s](1 - fy) + [sy = s - 1] fy and sy, fy taken at (r, c) of
//     their arrays, which have x's (padded) shape.
//   * shift_gather: (1 - fy) x[i0] + fy x[i1] along the axis, with
//     i0 = clamp(pos + (int)sy + S, 0, n - 1), i1 = clamp(i0 + 1, 0, n - 1).
//   * y_stage: the fused kernel's y stage over 5 slab planes, output the sum
//     of the planes (((A0 + A1) + A2) + A3) + A4 per (band, row, column):
//       A  the (2S+2)-step chain, the TPU kernel's shipped form;
//       B  A with the mask of step s carried to step s + 1;
//       C  select-accumulate of the floor and ceil taps over s = -S .. S,
//          then f + fy (c - f);
//       D  C with the taps and accumulators in bf16 (round to nearest
//          even, the old value kept where the mask is false), the lerp fp32;
//       T  the two taps read directly, (1 - fy) x[sy] + fy x[sy + 1]: the
//          port kernel's own y-stage form (farneback_iter.cu, the y stage),
//          with sy clipped to +-S as there.
// Built with -fmad=false (no multiply-add contraction) each kernel does the
// IEEE float operations of its plain version (ops/flow/shift_probes.py) in
// the same order, so the two are bit-equal. For integer sy in [-S, S] only
// two steps of the chain carry weight and the others add +-0, so chain,
// gather, A, B and T are bit-equal to each other as well; C and D are not
// (another lerp; bf16).
//
// Bound on the H100 (3.35 TB/s, 67 TFLOP/s fp32): bytes, every one. shift_*
// must read x once, sy and fy at the output cells once and write out once:
// 4 (n_x + 3 rows cols) B. y_stage reads the slab where it is read (rows 1 ..
// sr - 1, columns 1 .. cw - 1), sy and fy, and writes out: 4 bands (5 (sr - 1)
// (cw - 1) + 3 mrows acols) B (y_stage_bytes in the Python module).
//
// Design: the staged kernels (shift_chain, y_stage). The first design (one
// thread per output cell, every tap through __ldg) measured where its loads
// landed, not what each form costs: the same form T took 3.4x longer with sy
// drawn per cell than with sy constant over runs of 32 columns, and A's 90
// loads a cell re-read a band's 844 KB slab through L1 and L2. Now every
// input byte comes from device memory once, into shared memory, and the
// forms differ only in their arithmetic:
//   * a block is a tile of outputs with the 2S + 1 halo of its shifted axis,
//     staged by cp.async: 16-byte copies where the row pitch and the pointer
//     allow, 4-byte ones elsewhere (the timed y-stage geometries have cw = 2
//     mod 4), as farneback_iter.cu's ring does. The y stage's tile is 32
//     columns of one band across all its output rows (at most 64 a block; it
//     does not shift along x, so there is no column halo) and all five
//     planes; shift_chain's is 32 columns x 64 rows (axis 0) or 8 rows x 128
//     columns (axis 1);
//   * a thread owns a run of outputs along the shifted axis (the y stage: 4
//     rows of one column; shift_chain: 8 rows of one column on axis 0, 4
//     columns of one row on axis 1). The run's R + 2S + 1 staged taps roll
//     through its registers in order, each read from shared memory once per
//     thread, and each tap is used at once by every output of the run that
//     needs it (as step s = t - i - S of output i), so the taps of an output
//     still arrive in s order;
//   * the y stage rolls the five planes together, so each form's weights
//     (A, B) or masks (C, D) are computed once per cell and step, as the TPU
//     kernel does, and each plane keeps its own accumulator until the plane
//     sum (((A0 + A1) + A2) + A3) + A4. D holds its taps and accumulators as
//     bf16x2 pairs of planes, one 32-bit select for two planes. T reads its
//     two taps at the data-dependent row;
//   * no pipeline inside a block: it copies, waits once and computes; two to
//     five blocks an SM (registers capped by __launch_bounds__ so that the
//     chain forms keep three at 288 threads) overlap one block's copies with
//     another's arithmetic. A first version staged the planes one at a time
//     and started on each as it landed; with the planes apart, A and B kept
//     72 weights a thread across them (112 registers, one block an SM) and
//     ran at half the speed (PERF.md §6);
//   * the column tile is one warp across (32): no column halo means a wider
//     tile saves nothing, and only the last tile of a band is partial (781 =
//     24 x 32 + 13 columns at the finest layer, 93 = 2 x 32 + 29 on the fused
//     kernel's tile geometry); a band's rows fill whole runs of 4 (36 rows at
//     the finest layer, 44 on the tile geometry).
// What holds them after this (PERF.md §6): instruction issue for the
// chain and select forms (A ~430 instructions a cell: the chain's weights are
// 2 selects, a compare and an add per step, then 5 multiply-adds without
// contraction), bytes for T.
//
// S = 8 (the main path's max_shift at 752x480) is compiled in, so the tap
// loops unroll whole and every index folds; every other S runs the instance
// with S an argument (the same code, its tap loop a loop).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;   // shift_gather's and shift_chain's blocks
constexpr int kS = 8;           // the compiled-in max_shift
constexpr int kCols = 32;       // a warp across: y-stage and axis-0 chain tiles
constexpr int kYRows = 4;       // y stage: output rows a thread
constexpr int kYMaxWarps = 16;  // y stage: warps a block (64 output rows)
constexpr int kYPitch = 36;     // y stage: floats a staged row (9 chunks of 16 B)
constexpr int kChainWarps = kThreads / 32;
constexpr int kChainRows = 8;   // shift_chain axis 0: output rows a thread
constexpr int kChainCols = 4;   // shift_chain axis 1: output columns a thread

enum Variant { kA = 0, kB = 1, kC = 2, kD = 3, kT = 4 };

__host__ __device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__host__ __device__ __forceinline__ int imin(int a, int b) { return a < b ? a : b; }

// shift_chain axis 1: floats a staged row, the 32 kChainCols outputs' taps
// and 2S + 1 more, rounded up to 16-byte chunks (each lane's window loads as
// float4s)
__host__ __device__ __forceinline__ int chain_pitch1(int S) {
  return kCols * kChainCols + 4 * ((2 * S + 4) / 4);
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// The chain's weight at step s: (m ? 1 - f : 0) + (m1 ? f : 0), m the
// step's mask, m1 the mask of s - 1 (A: compared again; B: carried in m_prev)
template <bool kCarry>
__device__ __forceinline__ float chain_weight(float s_y, float f, float w0,
                                              int s, bool& m_prev) {
  const bool m = s_y == (float)s;
  const bool m1 = kCarry ? m_prev : s_y == (float)(s - 1);
  m_prev = m;
  return (m ? w0 : 0.0f) + (m1 ? f : 0.0f);
}

// The select-accumulate forms' slots: C holds one plane a slot in fp32; D
// two planes a slot in bf16x2 (planes 2p and 2p + 1; the last slot's high
// half repeats plane 4), so that one 32-bit select moves two planes' taps.
// Rounding is to nearest even, one tap at a time, as __float2bfloat16_rn.
template <int V> struct Slots;
template <> struct Slots<kC> {
  static constexpr int kN = 5;
  typedef float T;
  __device__ static __forceinline__ T pack(const float* x, int p) { return x[p]; }
  __device__ static __forceinline__ float plane(const T* v, int c) { return v[c]; }
};
template <> struct Slots<kD> {
  static constexpr int kN = 3;
  typedef __nv_bfloat162 T;
  __device__ static __forceinline__ T pack(const float* x, int p) {
    return __floats2bfloat162_rn(x[2 * p], x[imin(2 * p + 1, 4)]);
  }
  __device__ static __forceinline__ float plane(const T* v, int c) {
    return c & 1 ? __high2float(v[c >> 1]) : __low2float(v[c >> 1]);
  }
};

// x: (nr, ldx) row-major; sy, fy the same shape; out (rows, cols). A block:
// axis 0, 32 output columns x kChainWarps runs of kChainRows rows, staging
// x's rows [r0, r0 + 64 + 2S + 1) of its columns; axis 1, kChainWarps rows (a
// warp each) x 32 kChainCols output columns, staging x's columns [c0, c0 +
// 128 + 2S + 1) of its rows.
template <int AXIS, int SS>
__global__ void __launch_bounds__(kThreads, AXIS == 0 ? 4 : 6)
shift_chain_kernel(const float* __restrict__ x, const float* __restrict__ sy,
                   const float* __restrict__ fy, float* __restrict__ out,
                   int rows, int cols, int ldx, int S_arg, int vec) {
  constexpr int R = AXIS == 0 ? kChainRows : kChainCols;
  extern __shared__ __align__(16) float smem[];
  const int S = SS >= 0 ? SS : S_arg;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tr = AXIS == 0 ? kChainWarps * R : kChainWarps;
  const int tc = AXIS == 0 ? kCols : kCols * R;
  const int r0 = blockIdx.y * tr, c0 = blockIdx.x * tc;
  const int nr = imin(tr, rows - r0), nc = imin(tc, cols - c0);
  const int pitch = AXIS == 0 ? kCols : chain_pitch1(S);
  const float* src = x + (size_t)r0 * ldx + c0;
  if (AXIS == 0) {
    const int nst = nr + 2 * S + 1;   // staged rows, nc columns each
    if (vec) {   // 8 chunks a row, a warp 4 rows at a time
      const int q = lane & 7;
      if (4 * q < nc)
        for (int r = 4 * warp + (lane >> 3); r < nst; r += 4 * kChainWarps)
          cp_async16(smem + r * pitch + 4 * q, src + (size_t)r * ldx + 4 * q);
    } else if (lane < nc) {
      for (int r = warp; r < nst; r += kChainWarps)
        cp_async4(smem + r * pitch + lane, src + (size_t)r * ldx + lane);
    }
  } else if (warp < nr) {   // each warp stages its own row
    const int nst = nc + 2 * S + 1;   // staged columns
    const float* s = src + (size_t)warp * ldx;
    float* d = smem + warp * pitch;
    if (vec) {
      for (int q = lane; 4 * q < nst; q += 32) cp_async16(d + 4 * q, s + 4 * q);
    } else {
      for (int q = lane; q < nst; q += 32) cp_async4(d + q, s + q);
    }
  }
  cp_async_commit();

  // this thread's outputs: R along the shifted axis, from (orow, ocol)
  const int orow = AXIS == 0 ? r0 + warp * R : r0 + warp;
  const int ocol = AXIS == 0 ? c0 + lane : c0 + lane * R;
  float s_y[R], f[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int r = orow + (AXIS == 0 ? i : 0), c = ocol + (AXIS == 0 ? 0 : i);
    const bool ok = r < rows && c < cols;
    s_y[i] = ok ? __ldg(sy + (size_t)r * ldx + c) : 0.0f;
    f[i] = ok ? __ldg(fy + (size_t)r * ldx + c) : 0.0f;
  }
  cp_async_wait_all();
  __syncthreads();

  // The run's staged taps t = 0 .. R + 2S roll through registers (axis 1
  // four at a time, as float4s); tap t is step s = t - i - S of output i.
  const float* w = AXIS == 0 ? smem + warp * R * pitch + lane : smem + warp * pitch + lane * R;
  float acc[R], w0[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    acc[i] = 0.0f;
    w0[i] = 1.0f - f[i];
  }
  auto tap = [&](int t, float xt) {
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int s = t - i - S;
      bool m_prev = false;
      if (s >= -S && s <= S + 1)
        acc[i] = acc[i] + chain_weight<false>(s_y[i], f[i], w0[i], s, m_prev) * xt;
    }
  };
  const int nt = R + 2 * S + 1;
  if (AXIS == 0) {
#pragma unroll
    for (int t = 0; t < nt; ++t) tap(t, w[t * pitch]);
  } else {
#pragma unroll
    for (int t = 0; t < nt; t += 4) {
      const float4 v = *reinterpret_cast<const float4*>(w + t);
      tap(t, v.x);
      tap(t + 1, v.y);
      tap(t + 2, v.z);
      tap(t + 3, v.w);
    }
  }
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int r = orow + (AXIS == 0 ? i : 0), c = ocol + (AXIS == 0 ? 0 : i);
    if (r < rows && c < cols) out[(size_t)r * cols + c] = acc[i];
  }
}

// nr: rows of x (n along axis 0); ldx: its columns (n along axis 1). One
// thread per output cell, its two taps through __ldg: it reads two rows of
// 2S + 2, so there is no halo to stage, and it runs above half its bound.
template <int AXIS, int SS>
__global__ void __launch_bounds__(kThreads)
shift_gather_kernel(const float* __restrict__ x, const float* __restrict__ sy,
                    const float* __restrict__ fy, float* __restrict__ out,
                    int rows, int cols, int nr, int ldx, int S_arg) {
  const int S = SS >= 0 ? SS : S_arg;
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= (long long)rows * cols) return;
  const int r = (int)(i / cols);
  const int c = (int)(i - (long long)r * cols);
  const long long q = (long long)r * ldx + c;
  const float f = __ldg(fy + q);
  const int n = AXIS == 0 ? nr : ldx;
  const int i0 = clampi((AXIS == 0 ? r : c) + (int)__ldg(sy + q) + S, 0, n - 1);
  const int i1 = clampi(i0 + 1, 0, n - 1);
  float g0, g1;
  if (AXIS == 0) {
    g0 = __ldg(x + (long long)i0 * ldx + c);
    g1 = __ldg(x + (long long)i1 * ldx + c);
  } else {
    g0 = __ldg(x + (long long)r * ldx + i0);
    g1 = __ldg(x + (long long)r * ldx + i1);
  }
  out[i] = (1.0f - f) * g0 + f * g1;
}

// slab (bands, 5, sr, cw); sy, fy, out (bands, mrows, acols). Output cell
// (j, a) reads slab row o_f + s + j and column o_a + a of each plane. A
// block: columns [a0, a0 + 32) of band blockIdx.z, output rows [j_base,
// j_base + rb); kYRows rows a thread. Shared memory: 5 planes of (warps
// kYRows + 2S + 1) staged rows of kYPitch floats; smem column 1 + k holds
// slab column o_a + a0 + k (column 0 is there for the 16-byte copies).
template <int V, int SS>
__global__ void __launch_bounds__(kCols * kYMaxWarps, V == kT ? 3 : 2)
y_stage_kernel(const float* __restrict__ slab, const float* __restrict__ sy,
               const float* __restrict__ fy, float* __restrict__ out,
               int mrows, int acols, int sr, int cw, int o_f, int o_a,
               int S_arg, int rb, int vec) {
  constexpr int R = kYRows;
  extern __shared__ __align__(16) float smem[];
  const int S = SS >= 0 ? SS : S_arg;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int warps = (rb + R - 1) / R, nthreads = 32 * warps;
  const int band = blockIdx.z;
  const int j_base = blockIdx.y * rb, a0 = blockIdx.x * kCols;
  const int nrow = imin(rb, mrows - j_base), ncol = imin(kCols, acols - a0);
  const int nst = nrow + 2 * S + 1;                   // staged rows
  const int plane_f = (warps * R + 2 * S + 1) * kYPitch;
  const size_t plane = (size_t)sr * cw;
  // the slab at staged row 0, smem column 0
  const float* src = slab + (size_t)band * 5 * plane +
                     (size_t)(o_f - S + j_base) * cw + (o_a - 1 + a0);
  for (int c = 0; c < 5; ++c) {
    float* dst = smem + c * plane_f;
    const float* s0 = src + c * plane;
    if (vec) {
      for (int k = tid; k < nst * 9; k += nthreads) {
        const int r = k / 9, q = k - 9 * r;
        if (4 * q <= ncol) cp_async16(dst + r * kYPitch + 4 * q, s0 + (size_t)r * cw + 4 * q);
      }
    } else if (lane < ncol) {
      for (int r = warp; r < nst; r += warps)
        cp_async4(dst + r * kYPitch + 1 + lane, s0 + (size_t)r * cw + 1 + lane);
    }
  }
  cp_async_commit();

  // this thread: column a, output rows j0 .. j0 + R - 1
  const int a = a0 + lane, j0 = j_base + warp * R;
  const size_t cell0 = ((size_t)band * mrows + j0) * acols + a;
  float s_y[R], f[R], w0[R];
  int kt[R];   // T: the clipped shift
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const bool ok = lane < ncol && warp * R + r < nrow;
    s_y[r] = ok ? __ldg(sy + cell0 + (size_t)r * acols) : 0.0f;
    f[r] = ok ? __ldg(fy + cell0 + (size_t)r * acols) : 0.0f;
    w0[r] = 1.0f - f[r];
    kt[r] = (int)fminf(fmaxf(s_y[r], (float)-S), (float)S);
  }
  cp_async_wait_all();
  __syncthreads();

  // A[c][r]: plane c's y stage at output r. The run's staged rows t = 0 ..
  // R + 2S roll through registers, five planes at a time; row t is step
  // s = t - r - S of output r, whose weight (A, B) or mask (C, D) is
  // computed once for the five planes.
  const float* col = smem + warp * R * kYPitch + 1 + lane;
  float A[5][R];
  if constexpr (V == kT) {
#pragma unroll
    for (int c = 0; c < 5; ++c)
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float* p = col + c * plane_f + (r + kt[r] + S) * kYPitch;
        A[c][r] = w0[r] * p[0] + f[r] * p[kYPitch];
      }
  } else if constexpr (V == kA || V == kB) {
    bool m_prev[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      m_prev[r] = false;
#pragma unroll
      for (int c = 0; c < 5; ++c) A[c][r] = 0.0f;
    }
#pragma unroll
    for (int t = 0; t < R + 2 * S + 1; ++t) {
      float x[5];
#pragma unroll
      for (int c = 0; c < 5; ++c) x[c] = col[c * plane_f + t * kYPitch];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int s = t - r - S;
        if (s < -S || s > S + 1) continue;
        const float wgt = chain_weight<V == kB>(s_y[r], f[r], w0[r], s, m_prev[r]);
#pragma unroll
        for (int c = 0; c < 5; ++c) A[c][r] = A[c][r] + wgt * x[c];
      }
    }
  } else {   // C, D: the floor tap at steps s, the ceil tap at steps s - 1
    typedef Slots<V> Sl;
    typename Sl::T af[R][Sl::kN], ac[R][Sl::kN];
    const float zero[5] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int p = 0; p < Sl::kN; ++p) af[r][p] = ac[r][p] = Sl::pack(zero, p);
#pragma unroll
    for (int t = 0; t < R + 2 * S + 1; ++t) {
      float x[5];
      typename Sl::T xs[Sl::kN];
#pragma unroll
      for (int c = 0; c < 5; ++c) x[c] = col[c * plane_f + t * kYPitch];
#pragma unroll
      for (int p = 0; p < Sl::kN; ++p) xs[p] = Sl::pack(x, p);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int s = t - r - S;
        if (s <= S) {
          const bool m = s_y[r] == (float)s;
#pragma unroll
          for (int p = 0; p < Sl::kN; ++p) af[r][p] = m ? xs[p] : af[r][p];
        }
        if (s - 1 >= -S) {
          const bool m = s_y[r] == (float)(s - 1);
#pragma unroll
          for (int p = 0; p < Sl::kN; ++p) ac[r][p] = m ? xs[p] : ac[r][p];
        }
      }
    }
#pragma unroll
    for (int c = 0; c < 5; ++c)
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float lo = Sl::plane(af[r], c);
        A[c][r] = lo + f[r] * (Sl::plane(ac[r], c) - lo);
      }
  }
#pragma unroll
  for (int r = 0; r < R; ++r)
    if (lane < ncol && warp * R + r < nrow)
      out[cell0 + (size_t)r * acols] = (((A[0][r] + A[1][r]) + A[2][r]) + A[3][r]) + A[4][r];
}

typedef void (*ShiftChainFn)(const float*, const float*, const float*, float*,
                             int, int, int, int, int);
typedef void (*ShiftGatherFn)(const float*, const float*, const float*, float*,
                              int, int, int, int, int);
typedef void (*YStageFn)(const float*, const float*, const float*, float*, int,
                         int, int, int, int, int, int, int, int);

template <int AXIS>
ShiftChainFn chain_for(int S) {
  return S == kS ? shift_chain_kernel<AXIS, kS> : shift_chain_kernel<AXIS, -1>;
}

template <int AXIS>
ShiftGatherFn gather_for(int S) {
  return S == kS ? shift_gather_kernel<AXIS, kS> : shift_gather_kernel<AXIS, -1>;
}

template <int V>
YStageFn y_stage_for(int S) {
  return S == kS ? y_stage_kernel<V, kS> : y_stage_kernel<V, -1>;
}

ShiftChainFn pick_chain(int axis, int S) {
  return axis == 0 ? chain_for<0>(S) : chain_for<1>(S);
}

ShiftGatherFn pick_gather(int axis, int S) {
  return axis == 0 ? gather_for<0>(S) : gather_for<1>(S);
}

YStageFn pick_y_stage(int variant, int S) {
  switch (variant) {
    case kA: return y_stage_for<kA>(S);
    case kB: return y_stage_for<kB>(S);
    case kC: return y_stage_for<kC>(S);
    case kD: return y_stage_for<kD>(S);
    case kT: return y_stage_for<kT>(S);
    default: return nullptr;
  }
}

// A staged kernel's launch: grid, threads, dynamic shared memory; rows is
// the y stage's output rows a block
struct Launch {
  dim3 grid;
  int threads;
  size_t smem;
  int rows;
};

Launch chain_launch(int rows, int cols, int axis, int S) {
  Launch L;
  L.threads = kThreads;
  L.rows = axis == 0 ? kChainWarps * kChainRows : kChainWarps;
  const int tc = axis == 0 ? kCols : kCols * kChainCols;
  L.grid = dim3((cols + tc - 1) / tc, (rows + L.rows - 1) / L.rows, 1);
  L.smem = sizeof(float) * (axis == 0 ? (size_t)(L.rows + 2 * S + 1) * kCols
                                      : (size_t)kChainWarps * chain_pitch1(S));
  return L;
}

Launch y_stage_launch(int bands, int mrows, int acols, int S) {
  Launch L;
  L.rows = imin(mrows, kYRows * kYMaxWarps);
  const int warps = (L.rows + kYRows - 1) / kYRows;
  L.grid = dim3((acols + kCols - 1) / kCols, (mrows + L.rows - 1) / L.rows, bands);
  L.threads = 32 * warps;
  L.smem = sizeof(float) * 5 * (size_t)(warps * kYRows + 2 * S + 1) * kYPitch;
  return L;
}

// 16-byte copies: every copied row starts 16-byte aligned
bool aligned16(const float* p, int pitch, int col0) {
  return ((uintptr_t)p & 15) == 0 && pitch % 4 == 0 && col0 % 4 == 0;
}

// x's shape (nr, ldx) from the output's and the axis
bool shift_shape(int rows, int cols, int axis, int S, int* nr, int* ldx) {
  if (rows <= 0 || cols <= 0 || S < 0 || (axis != 0 && axis != 1)) return false;
  *nr = axis == 0 ? rows + 2 * S + 1 : rows;
  *ldx = axis == 0 ? cols : cols + 2 * S + 1;
  return (long long)*nr * *ldx < (1LL << 31);
}

}  // namespace

extern "C" {

// Above 48 KB a block's dynamic shared memory must be asked for.
static int allow_smem(const void* fn, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
}

// All tensors float32, contiguous. x, sy, fy: (rows + 2S + 1, cols) for
// axis 0, (rows, cols + 2S + 1) for axis 1; out (rows, cols). Each returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for
// arguments the kernel does not take.
int shift_chain(const float* x, const float* sy, const float* fy, float* out,
                int rows, int cols, int axis, int S, void* stream) {
  int nr, ldx;
  if (!shift_shape(rows, cols, axis, S, &nr, &ldx))
    return (int)cudaErrorInvalidValue;
  const Launch L = chain_launch(rows, cols, axis, S);
  const ShiftChainFn fn = pick_chain(axis, S);
  const int err = allow_smem((const void*)fn, L.smem);
  if (err != 0) return err;
  fn<<<L.grid, L.threads, L.smem, (cudaStream_t)stream>>>(
      x, sy, fy, out, rows, cols, ldx, S, aligned16(x, ldx, 0));
  return (int)cudaGetLastError();
}

int shift_gather(const float* x, const float* sy, const float* fy, float* out,
                 int rows, int cols, int axis, int S, void* stream) {
  int nr, ldx;
  if (!shift_shape(rows, cols, axis, S, &nr, &ldx))
    return (int)cudaErrorInvalidValue;
  const long long n = (long long)rows * cols;
  pick_gather(axis, S)<<<(unsigned)((n + kThreads - 1) / kThreads), kThreads, 0,
                         (cudaStream_t)stream>>>(x, sy, fy, out, rows, cols,
                                                 nr, ldx, S);
  return (int)cudaGetLastError();
}

// slab (bands, 5, th + 2P, tw + 2P); sy, fy (bands, th + 2m, tw + 2m + 2S +
// 1); out (bands, 1, th + 2m, tw + 2m + 2S + 1); P = S + 1 + m; variant
// 0-4 = A, B, C, D, T.
int y_stage(const float* slab, const float* sy, const float* fy, float* out,
            int bands, int th, int tw, int m, int S, int variant,
            void* stream) {
  if (bands <= 0 || bands > 65535 || th <= 0 || tw <= 0 || m < 0 || S < 0 ||
      variant < 0 || variant > kT)
    return (int)cudaErrorInvalidValue;
  const int P = S + 1 + m;
  const int sr = th + 2 * P, cw = tw + 2 * P;
  const int mrows = th + 2 * m, acols = tw + 2 * m + 2 * S + 1;
  const int o_f = P - m, o_a = P - m - S;
  const Launch L = y_stage_launch(bands, mrows, acols, S);
  const YStageFn fn = pick_y_stage(variant, S);
  const int err = allow_smem((const void*)fn, L.smem);
  if (err != 0) return err;
  fn<<<L.grid, L.threads, L.smem, (cudaStream_t)stream>>>(
      slab, sy, fy, out, mrows, acols, sr, cw, o_f, o_a, S, L.rows,
      aligned16(slab, cw, o_a - 1));
  return (int)cudaGetLastError();
}

// Launch resources of one instance: kernel 0 shift_chain, 1 shift_gather
// (sub = axis), 2 y_stage (sub = variant, mrows its output rows), at
// max_shift S. out[0] registers per thread, out[1] static shared-memory
// bytes, out[2] resident blocks per SM, out[3] threads a block, out[4]
// dynamic shared-memory bytes a block.
int shift_probe_info(int kernel, int sub, int S, int mrows, int* out) {
  const void* fn;
  int threads = kThreads;
  size_t smem = 0;
  if (kernel == 0 && (sub == 0 || sub == 1)) {
    fn = (const void*)pick_chain(sub, S);
    smem = chain_launch(1, 1, sub, S).smem;
  } else if (kernel == 1 && (sub == 0 || sub == 1)) {
    fn = (const void*)pick_gather(sub, S);
  } else if (kernel == 2 && sub >= 0 && sub <= kT && mrows > 0) {
    fn = (const void*)pick_y_stage(sub, S);
    const Launch L = y_stage_launch(1, mrows, 1, S);
    threads = L.threads;
    smem = L.smem;
  } else {
    return (int)cudaErrorInvalidValue;
  }
  int err = allow_smem(fn, smem);
  if (err != 0) return err;
  cudaFuncAttributes attr;
  err = (int)cudaFuncGetAttributes(&attr, fn);
  if (err != 0) return err;
  int blocks = 0;
  err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, threads, smem);
  out[0] = attr.numRegs;
  out[1] = (int)attr.sharedSizeBytes;
  out[2] = blocks;
  out[3] = threads;
  out[4] = (int)smem;
  return err;
}

}  // extern "C"
