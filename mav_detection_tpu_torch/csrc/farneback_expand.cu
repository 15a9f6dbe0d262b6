// Farneback polynomial expansion of one pyramid layer for Hopper (sm_90a):
// smooth, resize and the three moment correlations of both frames of a pair
// in one launch (or two, below), the five coefficient planes written in the
// (b, 5, lh, lw) layout that farneback_iterate_fused reads.
//
// Replaces no TPU kernel: the reference leaves this product to XLA's dot
// (mav_detection_tpu/ops/flow/farneback.py::_poly_exp_pyr_cf, two dense
// matmuls against the composed (3lh, h) and (w, 3lw) matrices). The port ran
// the same two fp32 GEMMs through cuBLAS, where only a band of each output's
// h or w products is non-zero (19 taps at scale 1, 38 at 1/2, 80 at 1/4).
// This kernel multiplies the same float32 weights, band by band, and skips
// only the zeros (ops/flow/farneback_expand.py builds the bands from the
// dense matrices and holds the kernel to the matmul version).
//
// Weights arrive as groups of four outputs (kGroup): for output rows
// 4g .. 4g+3 one first input row vbase[g] and, per tap step u < UV, the taps
// of the four rows' three moments (g, xg, xxg) as 12 floats, zero where a
// row's band does not reach; the same per four output columns (hbase, UH).
// Groups whose taps are equal share one entry of the tap table (vidx[g],
// hidx[g]): a product layer has seven (its three edge groups at each side
// and the interior's), so the table stays in L1. A thread reuses each input
// it reads for 12 (vertical) or 24 (horizontal) fused multiply-adds, and the
// warp's lanes share one group's taps (one broadcast load).
//
//   t_k(i, x) = sum_u V[vidx[g]][u][i - 4g][k] in(vbase[g] + u, x)  (vertical)
//   b1, b2, b4 = t0 (g, xg, xxg); b3, b6 = t1 (g, xg); b5 = t2 g   (horizontal)
//   R = [b3 ig11, b2 ig11, b1 ig03 + b5 ig33, b1 ig03 + b4 ig33, b6 ig55]
//
// The sums run u = 0 .. U-1 from 0.0f: another order than cuBLAS's, so the
// kernel is held to a tolerance (1e-5 of the coefficients' scale) and built
// with multiply-add contraction on.
//
// Bound on the H100 (3.35 TB/s, 67 TFLOP/s fp32): each frame read once and
// its five planes written once, 4 (h w + 5 lh lw) B a frame, against the
// function's least operations, the cascade of smooth, resize and moments
// (farneback_expand.expand_ops; the bands multiply 1.1x as many at scale 1,
// 2.5x at 1/2, 3.9x at 1/4). At 1920x1024 b=8 the three layers take ~1.2
// GB (0.36 ms) and ~14 GFLOP (0.21 ms): bytes bound every layer.
//
// Design, one block of 256 threads a tile of kRows (16) output rows x tw
// output columns of one frame (blockIdx.z: frames 0 .. b-1 of prev, then of
// curr; both frames of every pair, always):
//   * the input rows and columns the tile's bands reach are copied once into
//     shared memory with cp.async (sector-coalesced along w), each row's
//     columns dealt into four runs (load_quads);
//   * vertical stage: a thread takes one row group (4 output rows) and 4
//     columns nq apart, one float4 of input (its four columns) and three of
//     taps a step for 48 multiply-adds; t0, t1, t2 go to shared memory
//     column by column (the group's 4 rows one float4, without bank
//     conflicts: the column pitch is an odd number of float4) (fused) or,
//     where a tile's window would not fit two blocks an SM, to a buffer in
//     device memory that a second launch reads (two-pass: the coarse
//     layers);
//   * horizontal stage: a thread takes one row and one column group, three
//     t values and three float4 of taps a step for 24 multiply-adds, and
//     combines its products with ig11, ig03, ig33, ig55 in
//     poly_exp_pyr_cf's order into a staging tile in shared memory, whose
//     rows the tensor memory accelerator copies out (cp.async.bulk; plain
//     stores where lw leaves rows unaligned) while the warps go on to the
//     next round.
// The loops step their pointers (shared-memory offsets immediate: kRows is
// compiled in), so that a step is its multiply-adds, its loads and a few
// adds. The column tile and the route follow from the layer's shape by one
// rule (farneback_expand.plan), with the shared memory of a block that this
// file's *_smem functions give. Measured on the H100 (PERF.md): 0.28-0.30
// of the byte bound on the finest layer at b=8, 0.09-0.14 on the coarse
// ones; the barriers between the stages at 16 warps an SM (80-120
// registers a thread) hold it there.
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 16;            // output rows of a fused or horizontal tile
constexpr int kGroup = 4;            // outputs per band group
constexpr int kTaps = 3 * kGroup;    // floats per tap step of a group
constexpr int kMaxSmemBytes = 232448;   // 227 KB, the opt-in limit per block

__host__ __device__ __forceinline__ int cdiv(int a, int b) {
  return (a + b - 1) / b;
}

// Shared-memory layouts, in floats (the only copy: the plan asks
// farneback_expand_smem): the input window's row pitch (four column runs of
// nq = ceil(wc / 4)), the t planes' column pitch (kRows rows and padding to
// an odd number of float4: the vertical stage's float4 stores of adjacent
// columns fall in distinct banks), the staging tile of the five planes (one
// round of the horizontal stage: kRows rows x 4 * 256 / kRows columns; its
// row pitch an odd number of float4 for the same reason, and 16-byte
// aligned rows for the bulk copies)
__host__ __device__ __forceinline__ int in_pitch(int wc) { return 4 * cdiv(wc, 4); }
__host__ __device__ constexpr int odd_float4s(int n) {
  return n + (n / 4 % 2 == 0 ? 4 : 8);
}
constexpr int kTp = odd_float4s(kRows);                   // t column pitch
constexpr int kPerRound = kThreads / kRows;               // column groups a round
constexpr int kSw = odd_float4s(kGroup * kPerRound);      // staging row pitch
constexpr int kStage = 5 * kRows * kSw;                   // staging floats

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// a bulk copy of the tensor memory accelerator from shared to device memory
// (both 16-byte aligned, bytes a multiple of 16), in this thread's open
// bulk group
__device__ __forceinline__ void cp_async_bulk_store(float* dst, const float* src,
                                                    int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(src);
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(dst),
               "r"(s), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// until this thread's bulk copies have read their shared memory
__device__ __forceinline__ void cp_async_bulk_wait_read0() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// this thread's shared-memory writes made visible to the bulk copies
__device__ __forceinline__ void cp_async_fence_proxy() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

constexpr int kWarps = kThreads / 32;

// rows x cols floats from src (row pitch src_pitch) to dst: element (r, c)
// to dst[r * rp + c * cp]; a warp a row at a time, its lanes along the row
__device__ __forceinline__ void load_window(float* dst, int rp, int cp, const float* src,
                                            size_t src_pitch, int rows, int cols) {
  const int lane = threadIdx.x % 32;
  for (int r = threadIdx.x / 32; r < rows; r += kWarps)
    for (int c = lane; c < cols; c += 32)
      cp_async4(dst + r * rp + c * cp, src + r * src_pitch + c);
}

// The same window for the vertical stage: each row's columns dealt out in
// four runs of nq, column q + i nq to position 4 q + i (row pitch ip >= 4
// nq), so that a thread reads its four columns as one float4; positions
// past the window's columns stay unwritten
__device__ __forceinline__ void load_quads(float* dst, int ip, int nq, const float* src,
                                           size_t src_pitch, int rows, int cols) {
  const int lane = threadIdx.x % 32;
  for (int r = threadIdx.x / 32; r < rows; r += kWarps)
    for (int cc = lane; cc < 4 * nq; cc += 32) {
      const int c = (cc >> 2) + (cc & 3) * nq;
      if (c < cols) cp_async4(dst + r * ip + cc, src + r * src_pitch + c);
    }
}

// The vertical stage over row groups g0 .. g0+ng-1 and the columns 0 ..
// 4 nq - 1 of the window `in` as load_quads lays it out (pitch ip, first
// row r0); a thread takes columns q, q + nq, q + 2 nq, q + 3 nq, one float4
// a step. kSmem: t_k of local row lr and window column c to dst[k dk + c dc
// + lr] (column by column, in shared memory); else to dst[k dk + lr dr + c]
// for rows below rows_valid and columns below cols (row by row, in device
// memory).
template <bool kSmem>
__device__ __forceinline__ void vertical_stage(
    const float* in, int ip, int r0, int g0, int ng, int nq, int cols,
    const int* __restrict__ vbase, const int* __restrict__ vidx,
    const float* __restrict__ vtaps, int UV, float* dst, size_t dk, size_t dc,
    size_t dr, int rows_valid) {
  const int items = ng * nq;
  for (int it = threadIdx.x; it < items; it += kThreads) {
    const int gl = it / nq, q = it - gl * nq;
    const int g = g0 + gl;
    const float* x = in + (__ldg(vbase + g) - r0) * ip + 4 * q;
    const float4* tq =
        reinterpret_cast<const float4*>(vtaps) + (size_t)__ldg(vidx + g) * UV * 3;
    float acc[kGroup][3][4];
#pragma unroll
    for (int r = 0; r < kGroup; ++r)
#pragma unroll
      for (int k = 0; k < 3; ++k)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][k][c] = 0.0f;
#pragma unroll 2
    for (int u = 0; u < UV; ++u, x += ip, tq += 3) {
      const float4 xv = *reinterpret_cast<const float4*>(x);
      const float v[4] = {xv.x, xv.y, xv.z, xv.w};
      const float4 ta = __ldg(tq), tb = __ldg(tq + 1), tc = __ldg(tq + 2);
      const float tap[kTaps] = {ta.x, ta.y, ta.z, ta.w, tb.x, tb.y,
                                tb.z, tb.w, tc.x, tc.y, tc.z, tc.w};
#pragma unroll
      for (int r = 0; r < kGroup; ++r)
#pragma unroll
        for (int k = 0; k < 3; ++k)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[r][k][c] += tap[3 * r + k] * v[c];
    }
    if (kSmem) {
#pragma unroll
      for (int c = 0; c < 4; ++c)
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          const float4 o = {acc[0][k][c], acc[1][k][c], acc[2][k][c], acc[3][k][c]};
          *reinterpret_cast<float4*>(dst + k * dk + (q + c * nq) * dc + kGroup * gl) = o;
        }
    } else {
#pragma unroll
      for (int r = 0; r < kGroup; ++r) {
        const int lr = kGroup * gl + r;
        if (lr >= rows_valid) break;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int col = q + c * nq;
          if (col >= cols) continue;
#pragma unroll
          for (int k = 0; k < 3; ++k) dst[k * dk + lr * dr + col] = acc[r][k][c];
        }
      }
    }
  }
}

// The horizontal stage and the epilogue of one tile of kRows rows: t
// planes in shared memory column by column (plane stride tk, column pitch
// kTp, window column 0 = input column c0), rows from output row i0, column
// groups cg0 .. cg0+ncg-1. Each round covers kPerRound column groups:
// products, their combination into the staging tile (a float4 per plane
// and thread), then the tile's rows inside the layer go out: as bulk copies
// of the tensor memory accelerator where every row is 16-byte aligned (lw a
// multiple of 4), one per row and plane, which the warps do not wait for;
// else as coalesced stores.
__device__ __forceinline__ void horizontal_stage(
    const float* t, int tk, int c0, int i0, int cg0, int ncg,
    const int* __restrict__ hbase, const int* __restrict__ hidx,
    const float* __restrict__ htaps, int UH, float ig11, float ig03, float ig33,
    float ig55, float* stage, float* __restrict__ out, int lh, int lw) {
  constexpr int kPlane = kRows * kSw;
  const int lr = threadIdx.x % kRows, cl = threadIdx.x / kRows;
  const int nrows = min(kRows, lh - i0);
  const bool bulk = lw % 4 == 0;
  for (int rc = 0; rc < ncg; rc += kPerRound) {
    float o[5][kGroup];
    if (rc + cl < ncg) {
      const int cg = cg0 + rc + cl;
      const float* x = t + (__ldg(hbase + cg) - c0) * kTp + lr;
      const float4* tq =
          reinterpret_cast<const float4*>(htaps) + (size_t)__ldg(hidx + cg) * UH * 3;
      float acc[kGroup][6];
#pragma unroll
      for (int j = 0; j < kGroup; ++j)
#pragma unroll
        for (int p = 0; p < 6; ++p) acc[j][p] = 0.0f;
#pragma unroll 2
      for (int u = 0; u < UH; ++u, x += kTp, tq += 3) {
        const float v0 = x[0], v1 = x[tk], v2 = x[2 * tk];
        const float4 ta = __ldg(tq), tb = __ldg(tq + 1), tc = __ldg(tq + 2);
        const float tap[kTaps] = {ta.x, ta.y, ta.z, ta.w, tb.x, tb.y,
                                  tb.z, tb.w, tc.x, tc.y, tc.z, tc.w};
#pragma unroll
        for (int j = 0; j < kGroup; ++j) {
          const float g = tap[3 * j], xg = tap[3 * j + 1], xxg = tap[3 * j + 2];
          acc[j][0] += g * v0;     // b1
          acc[j][1] += xg * v0;    // b2
          acc[j][2] += xxg * v0;   // b4
          acc[j][3] += g * v1;     // b3
          acc[j][4] += xg * v1;    // b6
          acc[j][5] += g * v2;     // b5
        }
      }
#pragma unroll
      for (int j = 0; j < kGroup; ++j) {
        o[0][j] = acc[j][3] * ig11;
        o[1][j] = acc[j][1] * ig11;
        o[2][j] = acc[j][0] * ig03 + acc[j][5] * ig33;
        o[3][j] = acc[j][0] * ig03 + acc[j][2] * ig33;
        o[4][j] = acc[j][4] * ig55;
      }
    }
    // the previous round's copies have read the staging tile
    if (bulk) cp_async_bulk_wait_read0();
    __syncthreads();
    if (rc + cl < ncg) {
      float* s = stage + lr * kSw + kGroup * cl;
#pragma unroll
      for (int p = 0; p < 5; ++p) {
        const float4 v = {o[p][0], o[p][1], o[p][2], o[p][3]};
        *reinterpret_cast<float4*>(s + p * kPlane) = v;
      }
    }
    if (bulk) cp_async_fence_proxy();
    __syncthreads();
    const int j0 = kGroup * (cg0 + rc);
    const int ncols = min(kGroup * min(kPerRound, ncg - rc), lw - j0);
    if (bulk) {
      if (threadIdx.x < 5 * nrows) {
        const int p = threadIdx.x / nrows, r = threadIdx.x - p * nrows;
        cp_async_bulk_store(out + ((size_t)p * lh + i0 + r) * lw + j0,
                            stage + p * kPlane + r * kSw, 4 * ncols);
      }
      cp_async_bulk_commit();
    } else {
      // a warp a row at a time; the next round's first barrier protects
      // the tile until every warp is done
      for (int rr = threadIdx.x / 32; rr < 5 * nrows; rr += kWarps) {
        const int p = rr / nrows, r = rr - p * nrows;
        float* dst = out + ((size_t)p * lh + i0 + r) * lw + j0;
        const float* src = stage + p * kPlane + r * kSw;
        for (int c = threadIdx.x % 32; c < ncols; c += 32) dst[c] = src[c];
      }
    }
  }
  // the block's shared memory must outlive the copies' reads
  if (bulk) cp_async_bulk_wait_read0();
}

// One tile of kRows rows: window, vertical stage into shared memory,
// horizontal stage.
__global__ void __launch_bounds__(kThreads, 2) expand_fused_kernel(
    const float* __restrict__ prev, const float* __restrict__ curr,
    float* __restrict__ R0, float* __restrict__ R1, int b, int h, int w, int lh,
    int lw, const int* __restrict__ vbase, const int* __restrict__ vidx,
    const float* __restrict__ vtaps, int ngv, int UV, const int* __restrict__ hbase,
    const int* __restrict__ hidx, const float* __restrict__ htaps, int ngh, int UH,
    float ig11, float ig03, float ig33, float ig55, int tw, int wr, int wc) {
  extern __shared__ float smem[];
  const int f = blockIdx.z;
  const float* src = f < b ? prev + (size_t)f * h * w : curr + (size_t)(f - b) * h * w;
  float* out = f < b ? R0 + (size_t)f * 5 * lh * lw : R1 + (size_t)(f - b) * 5 * lh * lw;
  const int i0 = blockIdx.y * kRows, g0 = i0 / kGroup;
  const int ng = min(ngv, (i0 + kRows) / kGroup) - g0;
  const int cg0 = blockIdx.x * (tw / kGroup), ncg = min(ngh - cg0, tw / kGroup);
  const int r0 = __ldg(vbase + g0);
  const int rows = min(wr, __ldg(vbase + g0 + ng - 1) + UV - r0);
  const int c0 = __ldg(hbase + cg0);
  const int cols = min(wc, __ldg(hbase + cg0 + ncg - 1) + UH - c0);
  const int ip = in_pitch(wc), nq = cdiv(cols, 4);
  float* in = smem;   // the staging tile reuses it after the vertical stage
  float* tsm = smem + max(wr * ip, kStage);
  load_quads(in, ip, nq, src + (size_t)r0 * w + c0, w, rows, cols);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  vertical_stage<true>(in, ip, r0, g0, ng, nq, cols, vbase, vidx, vtaps, UV, tsm,
                       (size_t)ip * kTp, kTp, 0, kRows);
  __syncthreads();
  horizontal_stage(tsm, ip * kTp, c0, i0, cg0, ncg, hbase, hidx, htaps, UH, ig11, ig03,
                   ig33, ig55, smem, out, lh, lw);
}

// Two-pass, first launch: the vertical stage of th output rows x tw input
// columns into t (2b, 3, lh, w).
__global__ void __launch_bounds__(kThreads, 2) expand_vertical_kernel(
    const float* __restrict__ prev, const float* __restrict__ curr,
    float* __restrict__ t, int b, int h, int w, int lh,
    const int* __restrict__ vbase, const int* __restrict__ vidx,
    const float* __restrict__ vtaps, int ngv, int UV, int th, int tw, int wr) {
  extern __shared__ float smem[];
  const int f = blockIdx.z;
  const float* src = f < b ? prev + (size_t)f * h * w : curr + (size_t)(f - b) * h * w;
  const int i0 = blockIdx.y * th, g0 = i0 / kGroup;
  const int ng = min(ngv, (i0 + th) / kGroup) - g0;
  const int j0 = blockIdx.x * tw, cols = min(tw, w - j0), nq = cdiv(cols, 4);
  const int r0 = __ldg(vbase + g0);
  const int rows = min(wr, __ldg(vbase + g0 + ng - 1) + UV - r0);
  load_quads(smem, tw, nq, src + (size_t)r0 * w + j0, w, rows, cols);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  vertical_stage<false>(smem, tw, r0, g0, ng, nq, cols, vbase, vidx, vtaps, UV,
                        t + ((size_t)f * 3 * lh + i0) * w + j0, (size_t)lh * w, 0, w,
                        lh - i0);
}

// Two-pass, second launch: the horizontal stage of a tile of kRows rows
// from t, its rows copied into shared memory column by column.
__global__ void __launch_bounds__(kThreads, 2) expand_horizontal_kernel(
    const float* __restrict__ t, float* __restrict__ R0, float* __restrict__ R1,
    int b, int w, int lh, int lw, const int* __restrict__ hbase,
    const int* __restrict__ hidx, const float* __restrict__ htaps, int ngh, int UH,
    float ig11, float ig03, float ig33, float ig55, int tw, int wc) {
  extern __shared__ float smem[];
  const int f = blockIdx.z;
  float* out = f < b ? R0 + (size_t)f * 5 * lh * lw : R1 + (size_t)(f - b) * 5 * lh * lw;
  const int i0 = blockIdx.y * kRows;
  const int cg0 = blockIdx.x * (tw / kGroup), ncg = min(ngh - cg0, tw / kGroup);
  const int c0 = __ldg(hbase + cg0);
  const int cols = min(wc, __ldg(hbase + cg0 + ncg - 1) + UH - c0);
  const int rows = min(kRows, lh - i0);
  for (int k = 0; k < 3; ++k)   // transposed: row r, column c to smem[c kTp + r]
    load_window(smem + k * wc * kTp, 1, kTp, t + (((size_t)f * 3 + k) * lh + i0) * w + c0,
                w, rows, cols);
  cp_async_commit();
  cp_async_wait_all();
  __syncthreads();
  horizontal_stage(smem, wc * kTp, c0, i0, cg0, ncg, hbase, hidx, htaps, UH, ig11, ig03,
                   ig33, ig55, smem + 3 * wc * kTp, out, lh, lw);
}

// Shared-memory bytes of a block: the fused kernel's input window (or the
// staging tile that reuses it) and three t planes, wr x wc the window; the
// vertical kernel's window of wr rows x tw columns; the horizontal
// kernel's three t planes of wc columns and the staging tile
size_t fused_smem(int wr, int wc) {
  const size_t in = (size_t)wr * in_pitch(wc);
  return 4 * ((in > (size_t)kStage ? in : (size_t)kStage) + (size_t)3 * in_pitch(wc) * kTp);
}
size_t vertical_smem(int tw, int wr) { return (size_t)4 * wr * tw; }
size_t horizontal_smem(int wc) { return 4 * ((size_t)3 * wc * kTp + kStage); }

// kind 0: fused, 1: vertical, 2: horizontal
const void* kernel_of(int kind) {
  switch (kind) {
    case 0: return (const void*)expand_fused_kernel;
    case 1: return (const void*)expand_vertical_kernel;
    case 2: return (const void*)expand_horizontal_kernel;
    default: return nullptr;
  }
}

// the dynamic shared-memory limit of each kernel raised once, before its
// first launch (above 48 KB needs the opt-in)
int prepare(int kind) {
  static int err[3] = {-1, -1, -1};
  const void* kern = kernel_of(kind);
  if (kern == nullptr) return (int)cudaErrorInvalidValue;
  int& e = err[kind];
  if (e < 0)
    e = (int)cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  kMaxSmemBytes);
  return e;
}

// both frames of b pairs (grid z 2b), lh output rows in tiles of th
bool bad_rows(int b, int th, int lh, int ngv) {
  return b <= 0 || 2 * b > 65535 || th <= 0 || th % kGroup != 0 || lh <= 0 ||
         ngv != cdiv(lh, kGroup) || cdiv(lh, th) > 65535;
}

bool bad_cols(int tw, int lw, int ngh) {
  return tw <= 0 || tw % kGroup != 0 || lw <= 0 || ngh != cdiv(lw, kGroup);
}

}  // namespace

extern "C" {

// One layer's expansion of both frames of b pairs in one launch. prev, curr
// (b, h, w) float32; R0, R1 (b, 5, lh, lw). vbase, vidx (ngv = ceil(lh /
// 4)) int32, vtaps (max(vidx) + 1, UV, 12); hbase, hidx (ngh = ceil(lw /
// 4)), htaps (max(hidx) + 1, UH, 12). Tiles of kRows rows x tw columns; wr,
// wc the largest input window of any tile (rows, columns). Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for
// arguments the kernel does not take.
int farneback_expand_fused(const float* prev, const float* curr, float* R0, float* R1,
                           int b, int h, int w, int lh, int lw, const int* vbase,
                           const int* vidx, const float* vtaps, int ngv, int UV,
                           const int* hbase, const int* hidx, const float* htaps, int ngh,
                           int UH, float ig11, float ig03, float ig33, float ig55, int tw,
                           int wr, int wc, void* stream) {
  if (bad_rows(b, kRows, lh, ngv) || bad_cols(tw, lw, ngh) || h <= 0 || w <= 0 ||
      UV <= 0 || UV > h || UH <= 0 || UH > w || wr < UV || wr > h || wc < UH || wc > w)
    return (int)cudaErrorInvalidValue;
  const size_t smem = fused_smem(wr, wc);
  if (smem > (size_t)kMaxSmemBytes) return (int)cudaErrorInvalidValue;
  const int err = prepare(0);
  if (err != 0) return err;
  const dim3 grid(cdiv(lw, tw), cdiv(lh, kRows), 2 * b);
  expand_fused_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      prev, curr, R0, R1, b, h, w, lh, lw, vbase, vidx, vtaps, ngv, UV, hbase, hidx,
      htaps, ngh, UH, ig11, ig03, ig33, ig55, tw, wr, wc);
  return (int)cudaGetLastError();
}

// Two-pass, first launch: t (2b, 3, lh, w); tiles of th output rows x tw
// input columns, wr the largest window's rows.
int farneback_expand_vertical(const float* prev, const float* curr, float* t, int b,
                              int h, int w, int lh, const int* vbase, const int* vidx,
                              const float* vtaps, int ngv, int UV, int th, int tw, int wr,
                              void* stream) {
  if (bad_rows(b, th, lh, ngv) || tw <= 0 || tw % 4 != 0 || h <= 0 || w <= 0 ||
      UV <= 0 || UV > h || wr < UV || wr > h)
    return (int)cudaErrorInvalidValue;
  const size_t smem = vertical_smem(tw, wr);
  if (smem > (size_t)kMaxSmemBytes) return (int)cudaErrorInvalidValue;
  const int err = prepare(1);
  if (err != 0) return err;
  const dim3 grid(cdiv(w, tw), cdiv(lh, th), 2 * b);
  expand_vertical_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      prev, curr, t, b, h, w, lh, vbase, vidx, vtaps, ngv, UV, th, tw, wr);
  return (int)cudaGetLastError();
}

// Two-pass, second launch: R0, R1 from t; tiles of kRows x tw output
// pixels, wc the largest window's columns (w the input width).
int farneback_expand_horizontal(const float* t, float* R0, float* R1, int b, int w,
                                int lh, int lw, const int* hbase, const int* hidx,
                                const float* htaps, int ngh, int UH, float ig11,
                                float ig03, float ig33, float ig55, int tw, int wc,
                                void* stream) {
  if (bad_rows(b, kRows, lh, cdiv(lh, kGroup)) || bad_cols(tw, lw, ngh) || w <= 0 ||
      UH <= 0 || UH > w || wc < UH || wc > w)
    return (int)cudaErrorInvalidValue;
  const size_t smem = horizontal_smem(wc);
  if (smem > (size_t)kMaxSmemBytes) return (int)cudaErrorInvalidValue;
  const int err = prepare(2);
  if (err != 0) return err;
  const dim3 grid(cdiv(lw, tw), cdiv(lh, kRows), 2 * b);
  expand_horizontal_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      t, R0, R1, b, w, lh, lw, hbase, hidx, htaps, ngh, UH, ig11, ig03, ig33, ig55, tw,
      wc);
  return (int)cudaGetLastError();
}

// Shared-memory bytes of a block of kernel `kind` (0 fused, 1 vertical, 2
// horizontal) on a tile of tw columns whose input window is wr rows x wc
// columns (the vertical kernel's wr x tw), or -1 for another kind.
long long farneback_expand_smem(int kind, int tw, int wr, int wc) {
  switch (kind) {
    case 0: return (long long)fused_smem(wr, wc);
    case 1: return (long long)vertical_smem(tw, wr);
    case 2: return (long long)horizontal_smem(wc);
    default: return -1;
  }
}

// Launch resources of kernel `kind` with `smem` bytes of shared memory a
// block: out[0] shared-memory bytes, out[1] registers per thread, out[2]
// resident blocks per SM, out[3] local-memory bytes per thread.
int farneback_expand_info(int kind, int smem, int* out) {
  const void* kern = kernel_of(kind);
  if (kern == nullptr || smem < 0 || smem > kMaxSmemBytes)
    return (int)cudaErrorInvalidValue;
  int err = prepare(kind);
  if (err != 0) return err;
  cudaFuncAttributes attr;
  err = (int)cudaFuncGetAttributes(&attr, kern);
  if (err != 0) return err;
  int blocks = 0;
  err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kern, kThreads,
                                                           smem);
  out[0] = smem;
  out[1] = attr.numRegs;
  out[2] = blocks;
  out[3] = (int)attr.localSizeBytes;
  return err;
}

}  // extern "C"
