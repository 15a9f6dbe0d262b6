// Farneback solver iteration for Hopper (sm_90a): one hand-written fused
// kernel, farneback_iterate_fused, one launch per Jacobi iteration.
//
// Replaces the reference's Pallas TPU kernel
//   mav_detection_tpu/ops/flow/farneback_pallas.py::farneback_iterate_pallas
//   (bodies _fused_iter_kernel / _fused_iter_kernel_element, math _iter_math).
// One block of 512 threads per TH x TW output tile (32x64; 32x32 where
// 32x64 would leave an SM without a block) works in dynamic shared memory,
// so the normal-equation planes M never leave the SM:
//   1.-2. in chunks of kCH rows of the M region (rows [y0 - m, y0 + TH + m),
//      columns [x0 - m, x0 + TW + m)), pipelined over two chunk buffers so
//      the block synchronises once per chunk: the y stage for chunk k + 1,
//      A(y, a) for five planes, each column with its own fy(a), sy(a), the
//      two R1 rows through the read-only path (__ldg); and the x stage +
//      normal equations for chunk k, each M cell at its clamped pixel (so M
//      outside the image is its edge value, as the reference's replicate
//      extension), into the M buffer;
//   3. vertical then horizontal (2m+1)-tap box sums (the vertical ones in
//      place), window mean, 2x2 solve, new flow into the second of two
//      ping-pong buffers (Jacobi).
//
// Semantics held exactly (and why a plain bilinear gather would be wrong):
//   * The warp is the TPU kernel's separable one, not true bilinear: the y
//     stage at column a uses column a's OWN fy(a), sy(a); the x stage at pixel
//     k mixes A[k+sx(k)] and A[k+sx(k)+1] with k's fx. So a pixel's result
//     uses its x-neighbour's y weights.
//   * Coordinates are clamped to the image; `inside` uses x1 < W-1, y1 < H-1
//     and zeroes fx, fy outside, while sx, sy stay clipped to +-S.
//   * R1, flow and border are edge-padded, so A(j, a) == A(j, clamp(a)): the
//     A window's column a holds A at clamp(a), and every read is at clamped
//     coordinates (a zero-filling copy such as TMA's would be wrong at every
//     image edge).
//   * The TPU chain sums 2S+2 shifted planes of which only two taps carry a
//     non-zero weight, so reading those two taps directly is the same sum.
//     Built with -fmad=false (no multiply-add contraction) the arithmetic is
//     the same sequence of IEEE float ops as the reference, in the same order;
//     the box sums keep the order too (each output's taps added from 0 up,
//     starting at 0.0f; no running sums), so one iteration is bit-exact.
//
// Bound on the H100 (3.35 TB/s, 67 TFLOP/s fp32): bytes. Per pixel and
// iteration the function must move (5 R0 + 5 R1 + 2 flow in + 2 flow out)
// x 4 B = 56 B, plus the border map once per frame: 4 (14 b H W + H W) B,
// 48.7 us at b=8 480x752 and 68.1 us at b=2 1024x1920. The fp32 operations,
// counted with the halo recompute (chip_smoke.py, fused_bound), take under
// half that. The box sum could be written as a banded matmul, but wgmma runs
// TF32 or bf16: TF32 is off in this port (the reference runs fp32 at
// "highest") and 3xTF32 breaks the bit-exact contract, so no tensor cores.
//
// Measured (PERF.md, chip_smoke.py phase 3): about 0.3 of the bound at the
// finest layers. What holds it there is not device memory: the y and x
// stages evaluate about 3.6 cells per output pixel (the halo of A and M),
// each a dependent chain of loads and ~100 instructions, at 32 warps per SM
// (shared memory allows two blocks), the halo's re-reads double the L2
// traffic, and the box sums add shared-memory traffic. The design's answers
// so far: M in shared memory (not 40 B/px more through device memory);
// tall, wide tiles with the y and x stages chunked, so A needs two chunk
// buffers instead of the whole region and the tile can grow; the vertical
// sums held in TH registers per column (each M value read once, added to
// every output row whose window holds it, in tap order) and the horizontal
// ones read as float4; m = 6 (winsize 12) compiled in, so the box loops
// unroll whole.
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 512;
constexpr int kMaxSmemBytes = 232448;   // 227 KB, the opt-in limit per block

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// Fractional weights and clipped integer shifts of pixel (y, x) under flow
// (dx, dy): the reference's coordinate block, on clamped coordinates.
__device__ __forceinline__ void warp_coords(float dx, float dy, int y, int x,
                                            int H, int W, int S, float& fx,
                                            float& fy, int& sx, int& sy) {
  const float xf = (float)x;
  const float yf = (float)y;
  const float fx_t = xf + dx;
  const float fy_t = yf + dy;
  const float x1 = floorf(fx_t);
  const float y1 = floorf(fy_t);
  fx = fx_t - x1;
  fy = fy_t - y1;
  const bool inside = (x1 >= 0.0f) && (x1 < (float)(W - 1)) &&
                      (y1 >= 0.0f) && (y1 < (float)(H - 1));
  if (!inside) {
    fx = 0.0f;
    fy = 0.0f;
  }
  sx = (int)fminf(fmaxf(x1 - xf, (float)-S), (float)S);
  sy = (int)fminf(fmaxf(y1 - yf, (float)-S), (float)S);
}

constexpr int kCH = 8;   // M-region rows per chunk of the y and x stages

// Row stride of M and the vertical sums: a multiple of 4 where the
// horizontal sums read them as float4 (NX a multiple of 4), else odd, so
// that the scalar reads of lanes NX apart fall in different banks.
__host__ __device__ __forceinline__ int m_stride(int NX, int MRW) {
  return NX % 4 == 0 ? (MRW + 3) & ~3 : MRW | 1;
}

// Shared-memory bytes of one block: two A chunk buffers 2 x 5 x kCH x AW
// and M 5 x MRH x MS (later the vertical sums, in place).
__host__ __device__ __forceinline__ size_t smem_bytes(int TH, int TW, int m,
                                                      int S) {
  const int MRW = TW + 2 * m;
  const size_t MRH = TH + 2 * m, AW = MRW + 2 * S + 1;
  const size_t MS = m_stride(TH * TW / kThreads, MRW);
  return sizeof(float) * 5 * (2 * kCH * AW + MRH * MS);
}

// MM >= 0: m = winsize / 2 fixed at compile time, so the box-sum loops
// unroll whole and their tap tests fold away; MM < 0: m from the argument.
template <int TH, int TW, int MM>
__global__ void __launch_bounds__(kThreads, 2)
iterate_fused_kernel(const float* __restrict__ R0,
                     const float* __restrict__ R1,
                     const float* __restrict__ flow,
                     const float* __restrict__ border,
                     float* __restrict__ flow_out, int H, int W, int S,
                     int m_arg, float inv_win2) {
  constexpr int NX = TH * TW / kThreads;   // outputs per thread in stage 3b
  constexpr int SEGS = TW / NX;
  static_assert(TH * TW % kThreads == 0 && TW % NX == 0, "tile vs threads");
  extern __shared__ float smem[];
  const int m = MM >= 0 ? MM : m_arg;
  const int taps = 2 * m + 1;
  const int MRH = TH + 2 * m;        // M region rows: [y0 - m, y0 + TH + m)
  const int MRW = TW + 2 * m;        // M region columns: [x0 - m, x0 + TW + m)
  const int MS = m_stride(NX, MRW);  // row stride of M and the sums
  const int AW = MRW + 2 * S + 1;    // A window: [x0 - m - S, x0 + TW + m + S]
  const float inv_aw = 1.0f / (float)AW;
  const int AP = kCH * AW;           // floats per A chunk plane
  const int MP = MRH * MS;           // floats per M plane
  float* sA = smem;                  // A chunks, 2 buffers x 5 planes
  float* sM = sA + 10 * AP;          // M region, 5 planes
  const int x0 = blockIdx.x * TW;
  const int y0 = blockIdx.y * TH;
  const int ax0 = x0 - m - S;        // image column of window column 0
  const int plane = H * W;
  const size_t bz = blockIdx.z;
  const float* fl = flow + bz * 2 * plane;
  const float* r0 = R0 + bz * 5 * plane;
  const float* r1 = R1 + bz * 5 * plane;
  float* out = flow_out + bz * 2 * plane;
  const int tid = threadIdx.x;

  // 1.-2. the y stage and the x stage in chunks of kCH rows of the M region,
  // pipelined: one phase computes A for chunk k + 1 into one buffer and M for
  // chunk k from the other, then the block synchronises once
  const int nch = (MRH + kCH - 1) / kCH;
  for (int k = -1; k < nch; ++k) {
    const int ra = (k + 1) * kCH;
    const int nAc = k + 1 < nch ? min(kCH, MRH - ra) * AW : 0;
    const int rm = k * kCH;
    const int nMc = k >= 0 ? min(kCH, MRH - rm) * MRW : 0;
    float* bufA = sA + ((k + 1) & 1) * 5 * AP;
    const float* bufM = sA + (k & 1) * 5 * AP;
    for (int i = tid; i < nAc + nMc; i += kThreads) {
      if (i < nAc) {
        // y stage: A(y, a) = (1 - fy(a)) R1[y + sy(a), a]
        //                    + fy(a) R1[y + sy(a) + 1, a]
        int rr = (int)(((float)i + 0.5f) * inv_aw);   // i / AW, then exact
        int ax = i - rr * AW;
        if (ax < 0) {
          --rr;
          ax += AW;
        } else if (ax >= AW) {
          ++rr;
          ax -= AW;
        }
        const int gy = clampi(y0 - m + ra + rr, 0, H - 1);
        const int a = clampi(ax0 + ax, 0, W - 1);
        const int q = gy * W + a;
        float fx, fy;
        int sx, sy;
        warp_coords(__ldg(fl + q), __ldg(fl + plane + q), gy, a, H, W, S, fx,
                    fy, sx, sy);
        const int qa = clampi(gy + sy, 0, H - 1) * W + a;
        const int qb = clampi(gy + sy + 1, 0, H - 1) * W + a;
        const float w0 = 1.0f - fy;
        float* dst = bufA + rr * AW + ax;
#pragma unroll
        for (int c = 0; c < 5; ++c) {
          const float* rc = r1 + c * plane;
          dst[c * AP] = w0 * __ldg(rc + qa) + fy * __ldg(rc + qb);
        }
      } else {
        // x stage and normal equations at the M cell's clamped pixel
        const int j = i - nAc;
        const int rr = j / MRW;
        const int rx = j - rr * MRW;
        const int ry = rm + rr;
        const int gy = clampi(y0 - m + ry, 0, H - 1);
        const int gx = clampi(x0 - m + rx, 0, W - 1);
        const int p = gy * W + gx;
        const float dx = __ldg(fl + p);
        const float dy = __ldg(fl + plane + p);
        float fx, fy;
        int sx, sy;
        warp_coords(dx, dy, gy, gx, H, W, S, fx, fy, sx, sy);
        // A at clamp(gx + sx), then clamp(gx + sx + 1)
        const float* a0 = bufM + rr * AW + (gx + sx - ax0);
        const float wx0 = 1.0f - fx;
        float r[5];
#pragma unroll
        for (int c = 0; c < 5; ++c)
          r[c] = wx0 * a0[c * AP] + fx * a0[c * AP + 1];

        const float bm = __ldg(border + p);
        float r4 = (__ldg(r0 + 2 * plane + p) + r[2]) * 0.5f;
        float r5 = (__ldg(r0 + 3 * plane + p) + r[3]) * 0.5f;
        float r6 = (__ldg(r0 + 4 * plane + p) + r[4]) * 0.25f;
        float r2 = (__ldg(r0 + p) - r[0]) * 0.5f;
        float r3 = (__ldg(r0 + plane + p) - r[1]) * 0.5f;
        r2 = (r2 + r4 * dy + r6 * dx) * bm;
        r3 = (r3 + r6 * dy + r5 * dx) * bm;
        r4 = r4 * bm;
        r5 = r5 * bm;
        r6 = r6 * bm;

        float* dst = sM + ry * MS + rx;
        dst[0] = r4 * r4 + r6 * r6;
        dst[MP] = (r4 + r5) * r6;
        dst[2 * MP] = r5 * r5 + r6 * r6;
        dst[3 * MP] = r4 * r2 + r6 * r3;
        dst[4 * MP] = r6 * r2 + r5 * r3;
      }
    }
    __syncthreads();
  }

  // 3a. vertical sums, in place: one (plane, column) per thread, TH
  // accumulators; row r is added to output row j's sum as its tap r - j, so
  // every sum takes its taps in order 0..2m, as the plain version does
  for (int t = tid; t < 5 * MRW; t += kThreads) {
    const int c = t / MRW;
    float* col = sM + c * MP + (t - c * MRW);
    float acc[TH];
#pragma unroll
    for (int j = 0; j < TH; ++j) acc[j] = 0.0f;
#pragma unroll
    for (int r = 0; r < MRH; ++r) {
      const float v = col[r * MS];
#pragma unroll
      for (int j = 0; j < TH; ++j) {
        const int d = r - j;
        if (d >= 0 && d < taps) acc[j] = acc[j] + v;
      }
    }
#pragma unroll
    for (int j = 0; j < TH; ++j) col[j * MS] = acc[j];
  }
  __syncthreads();

  // 3b. horizontal sums (NX outputs of one row per thread), mean, 2x2 solve
  const int ty = tid / SEGS;
  const int tx0 = (tid - ty * SEGS) * NX;
  float g[5][NX];
#pragma unroll
  for (int c = 0; c < 5; ++c) {
    const float* row = sM + c * MP + ty * MS + tx0;
    float acc[NX];
#pragma unroll
    for (int j = 0; j < NX; ++j) acc[j] = 0.0f;
    if constexpr (NX % 4 == 0) {
      // 16-byte reads: row, MS and tx0 are multiples of 4 floats, and the
      // last read ends at or before the padded row's end
#pragma unroll
      for (int k4 = 0; k4 < (NX + taps + 2) / 4; ++k4) {
        const float4 v4 = reinterpret_cast<const float4*>(row)[k4];
        const float v[4] = {v4.x, v4.y, v4.z, v4.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
#pragma unroll
          for (int j = 0; j < NX; ++j) {
            const int d = 4 * k4 + e - j;
            if (d >= 0 && d < taps) acc[j] = acc[j] + v[e];
          }
        }
      }
    } else {
#pragma unroll
      for (int k = 0; k < NX + taps - 1; ++k) {
        const float v = row[k];
#pragma unroll
        for (int j = 0; j < NX; ++j) {
          const int d = k - j;
          if (d >= 0 && d < taps) acc[j] = acc[j] + v;
        }
      }
    }
#pragma unroll
    for (int j = 0; j < NX; ++j) g[c][j] = acc[j] * inv_win2;
  }
  const int gy = y0 + ty;
  if (gy >= H) return;
#pragma unroll
  for (int j = 0; j < NX; ++j) {
    const int gx = x0 + tx0 + j;
    if (gx >= W) continue;
    const float g11 = g[0][j], g12 = g[1][j], g22 = g[2][j];
    const float h1 = g[3][j], h2 = g[4][j];
    const float idet = 1.0f / (g11 * g22 - g12 * g12 + 1e-3f);
    const int q = gy * W + gx;
    out[q] = (g11 * h2 - g12 * h1) * idet;
    out[plane + q] = (g22 * h1 - g12 * h2) * idet;
  }
}

typedef void (*KernelFn)(const float*, const float*, const float*,
                         const float*, float*, int, int, int, int, float);

// The kernel for one tile shape and m, with its dynamic shared-memory limit
// raised once, before its first launch (above 48 KB needs the opt-in).
template <int TH, int TW, int MM>
int prepare(KernelFn* kern) {
  static int err = -1;
  *kern = iterate_fused_kernel<TH, TW, MM>;
  if (err < 0)
    err = (int)cudaFuncSetAttribute(
        iterate_fused_kernel<TH, TW, MM>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmemBytes);
  return err;
}

template <int TH, int TW>
int prepare_m(int m, KernelFn* kern) {
  return m == 6 ? prepare<TH, TW, 6>(kern) : prepare<TH, TW, -1>(kern);
}

// tile 0: 32x64 (rows x columns), 1: 32x32
int select_tile(int tile, int m, int* th, int* tw, KernelFn* kern) {
  switch (tile) {
    case 0: *th = 32; *tw = 64; return prepare_m<32, 64>(m, kern);
    case 1: *th = 32; *tw = 32; return prepare_m<32, 32>(m, kern);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// All tensors float32, contiguous, channel-first: R0, R1 (b, 5, H, W), flow
// and flow_out (b, 2, H, W, distinct buffers), border (H, W). m = winsize / 2,
// inv_win2 = 1 / winsize^2. Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for arguments the kernel does not take (a block
// whose shared memory would exceed 227 KB among them).
int farneback_iterate_fused(const float* R0, const float* R1, const float* flow,
                            const float* border, float* flow_out, int b, int H,
                            int W, int S, int m, float inv_win2, int tile,
                            void* stream) {
  int th, tw;
  KernelFn kern;
  if (b <= 0 || H <= 0 || W <= 0 || S < 0 || m < 0 || b > 65535 ||
      (long long)H * W > (1LL << 31) / 5 || flow == flow_out)
    return (int)cudaErrorInvalidValue;
  const int err = select_tile(tile, m, &th, &tw, &kern);
  if (err != 0) return err;
  const size_t smem = smem_bytes(th, tw, m, S);
  if (smem > (size_t)kMaxSmemBytes) return (int)cudaErrorInvalidValue;
  const dim3 grid((W + tw - 1) / tw, (H + th - 1) / th, b);
  kern<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      R0, R1, flow, border, flow_out, H, W, S, m, inv_win2);
  return (int)cudaGetLastError();
}

// Launch resources of one tile shape at (m, S): out[0] shared-memory bytes
// per block, out[1] registers per thread, out[2] resident blocks per SM.
int farneback_iterate_fused_info(int tile, int m, int S, int* out) {
  int th, tw;
  KernelFn kern;
  int err = select_tile(tile, m, &th, &tw, &kern);
  if (err != 0) return err;
  const size_t smem = smem_bytes(th, tw, m, S);
  cudaFuncAttributes attr;
  err = (int)cudaFuncGetAttributes(&attr, kern);
  if (err != 0) return err;
  int blocks = 0;
  err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kern,
                                                           kThreads, smem);
  out[0] = (int)smem;
  out[1] = attr.numRegs;
  out[2] = blocks;
  return err;
}

}  // extern "C"
