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
// What each computes (one thread per output cell; loads through __ldg,
// neighbouring threads on neighbouring columns, so every load is coalesced
// along the last axis; no shared memory):
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
// (cw - 1) + 3 mrows acols) B. The chain forms do ~3 fp32 operations per step and plane
// (about 2S+2 times what the two-tap form does) but re-read their shifted
// rows from L1 and L2, not device memory; even A's ~200 operations per cell
// stay under the byte time (ops_bound in the Python module). The simple
// design is the point of a probe: each form alone, at one cell per thread,
// so that the forms differ only in their arithmetic and their loads.
//
// S = 8 (the main path's max_shift at 752x480) is compiled in, so the s
// loops unroll whole; every other S runs the instance with S an argument.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 256;
constexpr int kS = 8;   // the compiled-in max_shift

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// x: (nr, ldx) row-major; sy, fy the same shape; out (rows, cols)
template <int AXIS, int SS>
__global__ void __launch_bounds__(kThreads)
shift_chain_kernel(const float* __restrict__ x, const float* __restrict__ sy,
                   const float* __restrict__ fy, float* __restrict__ out,
                   int rows, int cols, int ldx, int S_arg) {
  const int S = SS >= 0 ? SS : S_arg;
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= (long long)rows * cols) return;
  const int r = (int)(i / cols);
  const int c = (int)(i - (long long)r * cols);
  const long long q = (long long)r * ldx + c;
  const float s_y = __ldg(sy + q);
  const float f = __ldg(fy + q);
  const float w0 = 1.0f - f;
  const long long step = AXIS == 0 ? ldx : 1;
  const float* xs = x + q + S * step;   // x at shift s = 0
  float acc = 0.0f;
#pragma unroll
  for (int s = -S; s <= S + 1; ++s) {
    const float wgt = (s_y == (float)s ? w0 : 0.0f) +
                      (s_y == (float)(s - 1) ? f : 0.0f);
    acc = acc + wgt * __ldg(xs + s * step);
  }
  out[i] = acc;
}

// nr: rows of x (n along axis 0); ldx: its columns (n along axis 1)
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

enum Variant { kA = 0, kB = 1, kC = 2, kD = 3, kT = 4 };

// slab (bands, 5, sr, cw); sy, fy, out (bands, mrows, acols). Output cell
// (j, a) reads slab row o_f + s + j and column o_a + a of each plane.
template <int V, int SS>
__global__ void __launch_bounds__(kThreads)
y_stage_kernel(const float* __restrict__ slab, const float* __restrict__ sy,
               const float* __restrict__ fy, float* __restrict__ out,
               int bands, int mrows, int acols, int sr, int cw, int o_f,
               int o_a, int S_arg) {
  const int S = SS >= 0 ? SS : S_arg;
  const long long cells = (long long)mrows * acols;
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= (long long)bands * cells) return;
  const int band = (int)(i / cells);
  const int rem = (int)(i - band * cells);
  const int j = rem / acols;
  const int a = rem - j * acols;
  const long long plane = (long long)sr * cw;
  // slab at plane 0, shift s = 0 of this cell
  const float* x0 = slab + band * 5 * plane + (long long)(o_f + j) * cw + o_a + a;
  const float s_y = __ldg(sy + i);
  const float f = __ldg(fy + i);
  float A[5];
  if (V == kA || V == kB) {
    const float w0 = 1.0f - f;
#pragma unroll
    for (int c = 0; c < 5; ++c) A[c] = 0.0f;
    bool m_prev = false;
#pragma unroll
    for (int s = -S; s <= S + 1; ++s) {
      const bool m = s_y == (float)s;
      const bool m1 = V == kA ? s_y == (float)(s - 1) : m_prev;
      const float wgt = (m ? w0 : 0.0f) + (m1 ? f : 0.0f);
#pragma unroll
      for (int c = 0; c < 5; ++c)
        A[c] = A[c] + wgt * __ldg(x0 + c * plane + (long long)s * cw);
      m_prev = m;
    }
  } else if (V == kC) {
    float af[5], ac[5];
#pragma unroll
    for (int c = 0; c < 5; ++c) af[c] = ac[c] = 0.0f;
#pragma unroll
    for (int s = -S; s <= S; ++s) {
      const bool m = s_y == (float)s;
#pragma unroll
      for (int c = 0; c < 5; ++c) {
        const float* p = x0 + c * plane + (long long)s * cw;
        af[c] = m ? __ldg(p) : af[c];
        ac[c] = m ? __ldg(p + cw) : ac[c];
      }
    }
#pragma unroll
    for (int c = 0; c < 5; ++c) A[c] = af[c] + f * (ac[c] - af[c]);
  } else if (V == kD) {
    __nv_bfloat16 af[5], ac[5];
#pragma unroll
    for (int c = 0; c < 5; ++c) af[c] = ac[c] = __float2bfloat16_rn(0.0f);
#pragma unroll
    for (int s = -S; s <= S; ++s) {
      const bool m = s_y == (float)s;
#pragma unroll
      for (int c = 0; c < 5; ++c) {
        const float* p = x0 + c * plane + (long long)s * cw;
        af[c] = m ? __float2bfloat16_rn(__ldg(p)) : af[c];
        ac[c] = m ? __float2bfloat16_rn(__ldg(p + cw)) : ac[c];
      }
    }
#pragma unroll
    for (int c = 0; c < 5; ++c) {
      const float lo = __bfloat162float(af[c]);
      A[c] = lo + f * (__bfloat162float(ac[c]) - lo);
    }
  } else {   // kT
    const float w0 = 1.0f - f;
    const int k = (int)fminf(fmaxf(s_y, (float)-S), (float)S);
#pragma unroll
    for (int c = 0; c < 5; ++c) {
      const float* p = x0 + c * plane + (long long)k * cw;
      A[c] = w0 * __ldg(p) + f * __ldg(p + cw);
    }
  }
  out[i] = (((A[0] + A[1]) + A[2]) + A[3]) + A[4];
}

typedef void (*ShiftChainFn)(const float*, const float*, const float*, float*,
                             int, int, int, int);
typedef void (*ShiftGatherFn)(const float*, const float*, const float*, float*,
                              int, int, int, int, int);
typedef void (*YStageFn)(const float*, const float*, const float*, float*, int,
                         int, int, int, int, int, int, int);

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

unsigned grid_for(long long n) { return (unsigned)((n + kThreads - 1) / kThreads); }

// x's shape (nr, ldx) from the output's and the axis
bool shift_shape(int rows, int cols, int axis, int S, int* nr, int* ldx) {
  if (rows <= 0 || cols <= 0 || S < 0 || (axis != 0 && axis != 1)) return false;
  *nr = axis == 0 ? rows + 2 * S + 1 : rows;
  *ldx = axis == 0 ? cols : cols + 2 * S + 1;
  return (long long)*nr * *ldx < (1LL << 31);
}

}  // namespace

extern "C" {

// All tensors float32, contiguous. x, sy, fy: (rows + 2S + 1, cols) for
// axis 0, (rows, cols + 2S + 1) for axis 1; out (rows, cols). Each returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for
// arguments the kernel does not take.
int shift_chain(const float* x, const float* sy, const float* fy, float* out,
                int rows, int cols, int axis, int S, void* stream) {
  int nr, ldx;
  if (!shift_shape(rows, cols, axis, S, &nr, &ldx))
    return (int)cudaErrorInvalidValue;
  pick_chain(axis, S)<<<grid_for((long long)rows * cols), kThreads, 0,
                        (cudaStream_t)stream>>>(x, sy, fy, out, rows, cols,
                                                ldx, S);
  return (int)cudaGetLastError();
}

int shift_gather(const float* x, const float* sy, const float* fy, float* out,
                 int rows, int cols, int axis, int S, void* stream) {
  int nr, ldx;
  if (!shift_shape(rows, cols, axis, S, &nr, &ldx))
    return (int)cudaErrorInvalidValue;
  pick_gather(axis, S)<<<grid_for((long long)rows * cols), kThreads, 0,
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
  if (bands <= 0 || th <= 0 || tw <= 0 || m < 0 || S < 0 || variant < 0 ||
      variant > kT)
    return (int)cudaErrorInvalidValue;
  const int P = S + 1 + m;
  const int sr = th + 2 * P, cw = tw + 2 * P;
  const int mrows = th + 2 * m, acols = tw + 2 * m + 2 * S + 1;
  pick_y_stage(variant, S)<<<grid_for((long long)bands * mrows * acols),
                             kThreads, 0, (cudaStream_t)stream>>>(
      slab, sy, fy, out, bands, mrows, acols, sr, cw, P - m, P - m - S, S);
  return (int)cudaGetLastError();
}

// Launch resources of one instance: kernel 0 shift_chain, 1 shift_gather
// (sub = axis), 2 y_stage (sub = variant), at max_shift S. out[0] registers
// per thread, out[1] static shared-memory bytes, out[2] resident blocks of
// kThreads per SM.
int shift_probe_info(int kernel, int sub, int S, int* out) {
  const void* fn;
  if (kernel == 0 && (sub == 0 || sub == 1))
    fn = (const void*)pick_chain(sub, S);
  else if (kernel == 1 && (sub == 0 || sub == 1))
    fn = (const void*)pick_gather(sub, S);
  else if (kernel == 2 && sub >= 0 && sub <= kT)
    fn = (const void*)pick_y_stage(sub, S);
  else
    return (int)cudaErrorInvalidValue;
  cudaFuncAttributes attr;
  int err = (int)cudaFuncGetAttributes(&attr, fn);
  if (err != 0) return err;
  int blocks = 0;
  err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn,
                                                           kThreads, 0);
  out[0] = attr.numRegs;
  out[1] = (int)attr.sharedSizeBytes;
  out[2] = blocks;
  return err;
}

}  // extern "C"
