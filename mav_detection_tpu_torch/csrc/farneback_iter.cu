// Farneback solver iteration for Hopper (sm_90a): two hand-written kernels.
//
// Replaces the reference's Pallas TPU kernel
//   mav_detection_tpu/ops/flow/farneback_pallas.py::farneback_iterate_pallas
//   (bodies _fused_iter_kernel / _fused_iter_kernel_element, math _iter_math)
// One Jacobi iteration of Farneback's polynomial-expansion solver:
//   1. farneback_update_matrices: one thread per pixel. Warp the five R1
//      coefficient planes by the current flow (y stage, then x stage), combine
//      with R0 into the normal-equation planes M = [G11, G12, G22, h1, h2]
//      scaled by the border map, and write M to a (b, 5, H, W) scratch buffer.
//   2. farneback_box_solve: one block per 32x16 output tile. Stage the tile
//      plus an m-pixel halo of each M plane in shared memory with clamped
//      (replicate-edge) reads, take the separable (2m+1)^2 box sum, divide by
//      winsize^2, solve the 2x2 system and write the new flow to the second of
//      two ping-pong buffers, so every pixel reads the previous iterate.
//
// Semantics held exactly (and why a plain bilinear gather would be wrong):
//   * The warp is the TPU kernel's separable one, not true bilinear: the y
//     stage at column a uses column a's OWN fy(a), sy(a); the x stage at pixel
//     k mixes A[k+sx(k)] and A[k+sx(k)+1] with k's fx. So a pixel's result
//     uses its x-neighbour's y weights.
//   * Coordinates are clamped to the image; `inside` uses x1 < W-1, y1 < H-1
//     and zeroes fx, fy outside, while sx, sy stay clipped to +-S.
//   * R1, flow and border are edge-padded, so A(j, a) == A(j, clamp(a)), and
//     M outside the image takes its edge value (a clamped read in kernel 2).
//   * The TPU chain sums 2S+2 shifted planes of which only two taps carry a
//     non-zero weight, so reading those two taps directly is the same sum.
//     Built with -fmad=false (no multiply-add contraction) the arithmetic is
//     the same sequence of IEEE float ops as the reference, in the same order.
//
// Bound on the H100 (3.35 TB/s, 67 TFLOP/s fp32): memory. Per pixel and
// iteration the function must move at least (5 R0 + 5 R1 + 2 flow in + 2 flow
// out) x 4 B = 56 B plus the border map once per frame (~60 B); the
// arithmetic is ~300 flops per pixel, 20x under the fp32 peak at that byte
// count. This first design pays 40 B more per pixel for M's write and re-read
// between the two kernels (~100 B in all). Kernel 1 re-reads the two warp
// columns' flow and R1 rows from L1/L2 rather than from device memory.
// Fusing both kernels through shared memory, so M never leaves the SM, is
// the next step.
#include <cuda_runtime.h>

namespace {

constexpr int kUpdBlockX = 32;
constexpr int kUpdBlockY = 8;
constexpr int kTileW = 32;   // box/solve output tile
constexpr int kTileH = 16;
constexpr int kBoxThreads = 256;
constexpr int kMaxHalo = 8;  // m = winsize / 2 up to 8 fits 48 KB of shared memory

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

// y stage at row y, column a (in the image): the five planes of
// A(y, a) = (1 - fy(a)) R1[y + sy(a), a] + fy(a) R1[y + sy(a) + 1, a].
__device__ __forceinline__ void y_stage(const float* __restrict__ fl,
                                        const float* __restrict__ r1,
                                        size_t plane, int y, int a, int H,
                                        int W, int S, float out[5]) {
  const size_t q = (size_t)y * W + a;
  float fxa, fya;
  int sxa, sya;
  warp_coords(fl[q], fl[plane + q], y, a, H, W, S, fxa, fya, sxa, sya);
  const size_t qa = (size_t)clampi(y + sya, 0, H - 1) * W + a;
  const size_t qb = (size_t)clampi(y + sya + 1, 0, H - 1) * W + a;
  const float w0 = 1.0f - fya;
#pragma unroll
  for (int c = 0; c < 5; ++c) {
    const float* rc = r1 + c * plane;
    out[c] = w0 * rc[qa] + fya * rc[qb];
  }
}

__global__ void __launch_bounds__(kUpdBlockX * kUpdBlockY)
update_matrices_kernel(const float* __restrict__ R0,
                       const float* __restrict__ R1,
                       const float* __restrict__ flow,
                       const float* __restrict__ border,
                       float* __restrict__ M, int H, int W, int S) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= W || y >= H) return;
  const size_t plane = (size_t)H * W;
  const size_t b = blockIdx.z;
  const float* fl = flow + b * 2 * plane;
  const float* r0 = R0 + b * 5 * plane;
  const float* r1 = R1 + b * 5 * plane;
  float* mo = M + b * 5 * plane;
  const size_t p = (size_t)y * W + x;

  const float dx = fl[p];
  const float dy = fl[plane + p];
  float fx, fy;
  int sx, sy;
  warp_coords(dx, dy, y, x, H, W, S, fx, fy, sx, sy);

  // x stage: the two live taps of the y-warped planes
  float a0[5], a1[5];
  y_stage(fl, r1, plane, y, clampi(x + sx, 0, W - 1), H, W, S, a0);
  y_stage(fl, r1, plane, y, clampi(x + sx + 1, 0, W - 1), H, W, S, a1);
  const float wx0 = 1.0f - fx;
  float r[5];
#pragma unroll
  for (int c = 0; c < 5; ++c) r[c] = wx0 * a0[c] + fx * a1[c];

  const float bm = border[p];
  float r4 = (r0[2 * plane + p] + r[2]) * 0.5f;
  float r5 = (r0[3 * plane + p] + r[3]) * 0.5f;
  float r6 = (r0[4 * plane + p] + r[4]) * 0.25f;
  float r2 = (r0[p] - r[0]) * 0.5f;
  float r3 = (r0[plane + p] - r[1]) * 0.5f;
  r2 = (r2 + r4 * dy + r6 * dx) * bm;
  r3 = (r3 + r6 * dy + r5 * dx) * bm;
  r4 = r4 * bm;
  r5 = r5 * bm;
  r6 = r6 * bm;

  mo[p] = r4 * r4 + r6 * r6;
  mo[plane + p] = (r4 + r5) * r6;
  mo[2 * plane + p] = r5 * r5 + r6 * r6;
  mo[3 * plane + p] = r4 * r2 + r6 * r3;
  mo[4 * plane + p] = r6 * r2 + r5 * r3;
}

__global__ void __launch_bounds__(kBoxThreads)
box_solve_kernel(const float* __restrict__ M, float* __restrict__ flow_out,
                 int H, int W, int m, float inv_win2) {
  extern __shared__ float smem[];
  const int taps = 2 * m + 1;
  const int RW = kTileW + 2 * m;
  const int RH = kTileH + 2 * m;
  float* sM = smem;                  // 5 x RH x RW: tile + halo of M
  float* sV = smem + 5 * RH * RW;    // 5 x kTileH x RW: vertical sums
  const int x0 = blockIdx.x * kTileW;
  const int y0 = blockIdx.y * kTileH;
  const size_t plane = (size_t)H * W;
  const float* Mb = M + (size_t)blockIdx.z * 5 * plane;
  float* out = flow_out + (size_t)blockIdx.z * 2 * plane;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthr = blockDim.x * blockDim.y;

  // replicate-edge M: a clamped read is the reference's edge extension
  for (int i = tid; i < RH * RW; i += nthr) {
    const int gy = clampi(y0 - m + i / RW, 0, H - 1);
    const int gx = clampi(x0 - m + i % RW, 0, W - 1);
    const size_t q = (size_t)gy * W + gx;
#pragma unroll
    for (int c = 0; c < 5; ++c) sM[c * RH * RW + i] = Mb[c * plane + q];
  }
  __syncthreads();

  // vertical (2m+1)-tap sums, accumulated in the reference's order
  for (int i = tid; i < kTileH * RW; i += nthr) {
    const int ty = i / RW;
    const int rx = i % RW;
#pragma unroll
    for (int c = 0; c < 5; ++c) {
      const float* col = sM + c * RH * RW + ty * RW + rx;
      float v = 0.0f;
      for (int d = 0; d < taps; ++d) v = v + col[d * RW];
      sV[c * kTileH * RW + i] = v;
    }
  }
  __syncthreads();

  // horizontal sums, window mean, 2x2 solve
  for (int i = tid; i < kTileH * kTileW; i += nthr) {
    const int ty = i / kTileW;
    const int tx = i % kTileW;
    const int gy = y0 + ty;
    const int gx = x0 + tx;
    if (gy >= H || gx >= W) continue;
    float g[5];
#pragma unroll
    for (int c = 0; c < 5; ++c) {
      const float* row = sV + c * kTileH * RW + ty * RW + tx;
      float h = 0.0f;
      for (int d = 0; d < taps; ++d) h = h + row[d];
      g[c] = h * inv_win2;
    }
    const float g11 = g[0], g12 = g[1], g22 = g[2], h1 = g[3], h2 = g[4];
    const float idet = 1.0f / (g11 * g22 - g12 * g12 + 1e-3f);
    const size_t q = (size_t)gy * W + gx;
    out[q] = (g11 * h2 - g12 * h1) * idet;
    out[plane + q] = (g22 * h1 - g12 * h2) * idet;
  }
}

}  // namespace

extern "C" {

// All tensors float32, contiguous, channel-first: R0, R1 and M (b, 5, H, W),
// flow (b, 2, H, W), border (H, W). Returns cudaGetLastError() after launch.
int farneback_update_matrices(const float* R0, const float* R1,
                              const float* flow, const float* border, float* M,
                              int b, int H, int W, int S, void* stream) {
  if (b <= 0 || H <= 0 || W <= 0 || S < 0 || b > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 block(kUpdBlockX, kUpdBlockY);
  const dim3 grid((W + kUpdBlockX - 1) / kUpdBlockX,
                  (H + kUpdBlockY - 1) / kUpdBlockY, b);
  update_matrices_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      R0, R1, flow, border, M, H, W, S);
  return (int)cudaGetLastError();
}

int farneback_box_solve(const float* M, float* flow_out, int b, int H, int W,
                        int m, float inv_win2, void* stream) {
  if (b <= 0 || H <= 0 || W <= 0 || m < 0 || m > kMaxHalo || b > 65535)
    return (int)cudaErrorInvalidValue;
  const int RW = kTileW + 2 * m;
  const size_t smem =
      sizeof(float) * 5 * (size_t)RW * ((kTileH + 2 * m) + kTileH);
  const dim3 block(32, kBoxThreads / 32);
  const dim3 grid((W + kTileW - 1) / kTileW, (H + kTileH - 1) / kTileH, b);
  box_solve_kernel<<<grid, block, smem, (cudaStream_t)stream>>>(
      M, flow_out, H, W, m, inv_win2);
  return (int)cudaGetLastError();
}

}  // extern "C"
