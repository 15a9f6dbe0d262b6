// Farneback solver iteration for Hopper (sm_90a), one launch of
// farneback_iterate_fused per Jacobi iteration, on one of two designs of
// blocks: rows streamed down column strips where a layer's runs are long
// enough, the earlier design's 32-row tiles on the layers too short to stream
// (farneback_iter.fused_schedule picks; chip_smoke.py phase 3 times both at
// every layer).
//
// Replaces the reference's Pallas TPU kernel
//   mav_detection_tpu/ops/flow/farneback_pallas.py::farneback_iterate_pallas
//   (bodies _fused_iter_kernel / _fused_iter_kernel_element, math _iter_math):
// warp R1 by the flow, form the five normal-equation planes M, take their
// (2m+1)^2 box mean with replicate edges, solve the 2x2 system, write the new
// flow to the other of two buffers (Jacobi). M never leaves the SM.
//
// Semantics held exactly by both (and why a plain bilinear gather would be
// wrong):
//   * The warp is the TPU kernel's separable one, not true bilinear: the y
//     stage at column a uses column a's OWN fy(a), sy(a); the x stage at pixel
//     k mixes A[k+sx(k)] and A[k+sx(k)+1] with k's fx. So a pixel's result
//     uses its x-neighbour's y weights.
//   * Coordinates are clamped to the image; `inside` uses x1 < W-1, y1 < H-1
//     and zeroes fx, fy outside, while sx, sy stay clipped to +-S.
//   * R1, flow and border are edge-padded, so A(j, a) == A(j, clamp(a)) and
//     M outside the image is its edge value: every cell is computed at its
//     clamped pixel and every read goes through the clamp. So only rows and
//     columns inside the image are ever copied or read, and a copy that
//     zero-fills outside the image (TMA's) would never be read either.
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
// 48.7 us at b=8 480x752 and 68.1 us at b=2 1024x1920. Its own fp32
// operations, 237 per pixel at m = 6 (no halo), take a fifth of that. The
// box sum could be written as a banded matmul, but wgmma runs TF32 or bf16:
// TF32 is off in this port (the reference runs fp32 at "highest") and 3xTF32
// breaks the bit-exact contract, so no tensor cores.
//
// Why the tiles sat at ~0.3 of the bound (PERF.md, chip_smoke.py phase 3):
// not device memory but the latency of one block's serial path. A 32x64 tile
// of 512 threads (two per SM: 96,640 B of shared memory each) walks seven
// chunk phases, each ending in __syncthreads; in each a thread evaluates
// ~2.6 cells one after another, each a chain of two dependent round trips to
// L2 (flow, then the data-dependent R1 rows or R0), then a vertical-sum phase
// on 380 of 512 threads; its halo recomputes 3.6 cells per output. Launch
// time follows the waves, ~25 us per wave of 264 blocks at every layer:
// 1440 blocks at b=8 480x752 are 5.45 -> 6 waves, 0.150 ms; 1920 at b=2
// 1024x1920 8 waves, 0.213 ms; 180 at b=1 480x752 one wave, 0.025 ms (the
// tile design's times in chip_smoke.py phase 3 on an H100).
//
// What the row-streaming design (below, namespace strip) does about it:
//   * a block streams down a column strip, so A and M rows are computed once
//     per segment and the vertical halo is paid at the segment's top only:
//     (AW + MRW) / TW cells per output, 2.4 at TW = 108, against 3.6;
//   * the R1 rows the y stage may read are copied ahead into a shared-memory
//     ring with cp.async, one step before they are needed; the y stage's
//     data-dependent row pick then reads shared memory. cp.async, not TMA:
//     each row is one contiguous run of the image at any pitch (W = 150 rows
//     are 600 B, not the 16-byte multiple a tensor map needs), 16-byte copies
//     where the rows allow (W % 4 == 0, every product layer) and 4-byte ones
//     elsewhere in the same kernel, and no tensor map to encode;
//   * the coordinate block is computed once per cell: thread c's y-stage
//     cell is its own M cell's pixel, and fx, sx, dx, dy stay in registers
//     for the x stage of the next step; flow, R0 and the border are loaded
//     into registers a step ahead (plain coalesced loads);
//   * vertical sums as M rows arrive, in rolling registers (no vertical-sum
//     phase, no shared-memory traffic for them), one barrier per step;
//   * a launch geometry per layer (strip_geometry in ops/flow/
//     farneback_iter.py): one 512-thread block per SM at most (no wave
//     tail), the runs cut so that the longest takes the fewest steps.
// What holds it is instruction issue: a step costs each thread ~600
// instructions (the 2 x 65 adds of the box sums per output are the floor
// the bit-exact order leaves, then shuffles, index work, the ring) at 16
// warps a SM, so a run pays its 2m halo rows and ring fill in full. Where a
// layer's runs are short (the coarsest layer at every batch size, every
// layer but the finest at b = 1) that costs more than the tiles' halo, and
// farneback_iterate_fused runs the tile design's blocks there
// (fused_schedule: runs under 3 S rows).
#include <cuda_runtime.h>
#include <stddef.h>

namespace {

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

// ---------------------------------------------------------------------------
// The tile design (tile >= 0 in farneback_iterate_fused). One block of 512 threads per
// TH x TW output tile (32x64; 32x32 where 32x64 would leave an SM without a
// block) works in dynamic shared memory:
//   1.-2. in chunks of kCH rows of the M region (rows [y0 - m, y0 + TH + m),
//      columns [x0 - m, x0 + TW + m)), pipelined over two chunk buffers so
//      the block synchronises once per chunk: the y stage for chunk k + 1,
//      A(y, a) for five planes, each column with its own fy(a), sy(a), the
//      two R1 rows through the read-only path (__ldg); and the x stage +
//      normal equations for chunk k, each M cell at its clamped pixel, into
//      the M buffer;
//   3. vertical then horizontal (2m+1)-tap box sums (the vertical ones in
//      place, TH registers per column, each M value read once; the
//      horizontal ones read as float4), window mean, 2x2 solve, new flow out.
namespace tiled {

constexpr int kThreads = 512;

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
iterate_tiled_kernel(const float* __restrict__ R0,
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
  *kern = iterate_tiled_kernel<TH, TW, MM>;
  if (err < 0)
    err = (int)cudaFuncSetAttribute(
        iterate_tiled_kernel<TH, TW, MM>,
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

}  // namespace tiled

// ---------------------------------------------------------------------------
// The row-streaming design (tile < 0 in farneback_iterate_fused).
//
// A block of 128 x KR threads (KR = 4 rows a step) owns a column strip of
// TW outputs (its M columns [x0 - m, x0 + TW + m), MRW = TW + 2m <= 128; its A
// window AW = MRW + 2S + 1 columns from ax0 = x0 - m - S) and a run of rows
// [y0, y1), and walks down it KR rows a step. Thread (c, p), c the M column
// (warp w holds columns 32 w / KR onward, lane group p the step's row p),
// keeps everything of its column in registers; a step runs, for three
// consecutive groups g of KR M and A rows (rows k0 + KR g + p, k0 = y0 - m):
//   h. group t - 2: horizontal (2m+1)-tap sums, NX = 2 outputs per thread
//      (read as float2), mean, 2x2 solve, new flow out, on the first
//      KR ceil(TW / NX) threads only (the other warps skip the stage);
//   x. group t - 1: the x stage at the thread's own cell from the A rows in
//      shared memory, with its coordinates kept in registers from the y stage
//      of the step before, the normal equations with R0 and the border
//      loaded one step ahead; then every row's M value of the column comes
//      from its lane (shuffles) and is added into the rolling partial
//      vertical sums (below), which give one finished vertical sum per
//      thread and step, written to the V rows;
//   y. group t: the y stage of the A rows, the two R1 taps read from the
//      shared-memory ring (no load on this chain waits on L2), each thread
//      at its own column (A column c + S, the same clamped pixel as its M
//      cell) and KR (2S+1) threads at the window's edge columns;
// each only where its group lies in the run (the h stage from the first
// group with an output row), then starts the cp.async copies of the R1 rows
// that group t + 1 adds to the ring and the register loads of group t + 1's
// flow and group t's R0 and border, waits for the copies and synchronises
// once. Buffers: the R1 ring of RR = 2S + 1 + 2 KR image rows x 5 planes x AW
// (rows [lo(t), hi(t + 1)], each copied once per segment, slot = row mod RR),
// two A groups (KR rows x 5 planes x AW each) and two V groups.
//
// Rolling vertical sums: before the step at rows k..k+KR-1, thread p holds the
// partial sums of its outputs y = k - m + p + KR j whose windows [y - m,
// y + m] have started. Each row is added in order where the window holds it:
// j = 0 finishes, j >= 1 move to slot j - 1, and outputs whose window starts
// in the step enter as 0.0f + their first row. So every vertical sum adds its
// 2m+1 taps in order from 0.0f, as box_solve_ref does, with no shared-memory
// traffic.
//
// Launch geometry (farneback_iter.strip_geometry): strips of equal width;
// the b x ns columns of H rows cut into runs, one block each: each column into
// runs_per_col equal runs (never crossing into the next column), or the
// columns laid end to end and cut every rows_per_block rows (a run that
// crosses a column boundary is two segments). Each segment pays its 2m halo
// rows and its ring fill once.
namespace strip {

constexpr int kCols = 128;          // M columns of a block
constexpr int kRows = 4;            // rows a step
constexpr int kThreads = kCols * kRows;   // one thread per column and row
constexpr int kNX = 2;              // outputs per h-stage thread
constexpr int kMaxGenericM = 32;    // run-time m: partial sums in local memory
constexpr int kMaxShift = 63;       // kRows (2S + 1) edge cells <= kThreads
constexpr int kPrefetch = 1;        // steps between a ring copy and its use

// smallest v >= n with v = 32 / kRows (mod 32): rows 5 v apart then start
// 32 / kRows banks apart, so a warp's kRows rows of 32 / kRows columns hit
// 32 banks
__host__ __device__ __forceinline__ int pad_rows(int n) {
  const int cpw = 32 / kRows;
  return n + ((cpw - n) % 32 + 32) % 32;
}

struct Dims {
  int MRW, AW, AWP, VS, RR;
};

__host__ __device__ __forceinline__ Dims dims(int TW, int m, int S) {
  Dims d;
  d.MRW = TW + 2 * m;
  d.AW = d.MRW + 2 * S + 1;
  d.AWP = pad_rows(d.AW + 6);   // a 16-byte-aligned copy spans AW + 6
  d.VS = pad_rows(d.MRW + kNX - 1);   // the h stage's last read
  d.RR = 2 * S + 1 + kRows * (kPrefetch + 1);
  return d;
}

// ring RR x 5 x AWP, A 2 x kRows x 5 x AWP, V 2 x kRows x 5 x VS floats
__host__ __device__ __forceinline__ size_t smem_bytes(int TW, int m, int S) {
  const Dims d = dims(TW, m, S);
  return sizeof(float) * 5 *
         ((size_t)d.AWP * (d.RR + 2 * kRows) + 2 * kRows * (size_t)d.VS);
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

// wait until at most kPrefetch - 1 committed groups are in flight
__device__ __forceinline__ void cp_async_wait_prefetch() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPrefetch - 1) : "memory");
}

// Row i of a step is in the window of thread p's output j of the step
// (output k - m + p + kRows j, window rows [p + kRows j - 2m, p + kRows j]
// relative to the step's first row k). Where j and i decide it for every p
// in [0, kRows) the test folds at compile time.
__device__ __forceinline__ bool in_window(int i, int j, int p, int m) {
  const int lo = kRows * j - 2 * m, hi = kRows * j;
  const bool lo_ok = lo + kRows - 1 <= i ? true : (lo > i ? false : lo + p <= i);
  const bool hi_ok = hi >= i ? true : (hi + kRows - 1 < i ? false : i <= hi + p);
  return lo_ok && hi_ok;
}

// MM >= 0: m compiled in (registers for the partial sums)
template <int MM>
__global__ void __launch_bounds__(kThreads, 1)
iterate_strip_kernel(const float* __restrict__ R0, const float* __restrict__ R1,
                     const float* __restrict__ flow,
                     const float* __restrict__ border,
                     float* __restrict__ flow_out, int H, int W, int S,
                     int m_arg, float inv_win2, int TW, int ns,
                     int rows_per_block, int runs_per_col, int total) {
  constexpr int kCPW = 32 / kRows;          // columns per warp
  constexpr int NX = kNX;
  extern __shared__ float smem[];
  const int m = MM >= 0 ? MM : m_arg;
  const Dims d = dims(TW, m, S);
  float* ring = smem;
  float* sA = ring + d.RR * 5 * d.AWP;
  float* sV = sA + 2 * kRows * 5 * d.AWP;
  const int plane = H * W;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int p = lane / kCPW;                           // row of the step
  const int c = (tid >> 5) * kCPW + (lane % kCPW);     // M column
  const bool active = c < d.MRW;
  const int cc = active ? c : d.MRW - 1;   // idle columns shadow the last one
  // a warp whose columns all lie past the strip skips the own cells
  const bool warp_active = (tid >> 5) * kCPW < d.MRW;
  // this thread's edge cell of the A window: columns [0, S) and
  // [S + MRW, AW) of every row, taken from the last thread down
  const int ne = 2 * S + 1;
  const int e = kThreads - 1 - tid;
  const bool has_edge = e < kRows * ne;
  const int ep = min(e / ne, kRows - 1);
  const int ei = e - ep * ne;
  const int ea = ei < S ? ei : ei + d.MRW;
  // this thread's h-stage outputs: row hp, strip columns hx .. hx + NX - 1
  // (only threads below kRows nh have any; whole warps past them skip the
  // stage)
  const int nh = (TW + NX - 1) / NX;
  const bool has_h = tid < kRows * nh;
  const int hp = min(tid / nh, kRows - 1);
  const int hx = NX * min(tid - hp * nh, nh - 1);

  // partial vertical sums of the outputs whose windows have started,
  // kJ per plane (registers where m is compiled in, the same kJ for every p)
  constexpr int kJ = MM > 0 ? (2 * MM - 1) / kRows + 1 : kMaxGenericM;
  static_assert(MM <= 0 || ((2 * MM - kRows) / kRows + 1 == kJ &&
                            2 * MM / kRows == kJ),
                "the compiled-in m needs the same slots on every row");
  const int J = MM > 0 ? kJ
                       : (2 * m - 1 - p >= 0 ? (2 * m - 1 - p) / kRows + 1 : 0);
  const int Jn = MM > 0 ? kJ + 1 : (2 * m + kRows - 1 - p) / kRows + 1;
  float part[kJ][5];
#pragma unroll
  for (int j = 0; j < kJ; ++j)
#pragma unroll
    for (int q = 0; q < 5; ++q) part[j][q] = 0.0f;

  // this block's rows of the b x ns columns of H rows laid end to end: run
  // blockIdx of rows_per_block rows, or with runs_per_col > 0 run
  // blockIdx % runs_per_col of its column (never crossing into the next)
  int start, end;
  if (runs_per_col > 0) {
    const int col = blockIdx.x / runs_per_col;
    const int r = (blockIdx.x - col * runs_per_col) * rows_per_block;
    start = col * H + min(r, H);
    end = col * H + min(r + rows_per_block, H);
  } else {
    start = blockIdx.x * rows_per_block;
    end = min(total, start + rows_per_block);
  }
  for (int gr = start; gr < end;) {
    // one segment: rows [y0, y1) of strip sx of image bz
    const int col = gr / H;
    const int y0 = gr - col * H;
    const int y1 = min(H, y0 + (end - gr));
    gr += y1 - y0;
    const int bz = col / ns;
    const int x0 = (col - bz * ns) * TW;
    const int ax0 = x0 - m - S;
    const float* fl = flow + (size_t)bz * 2 * plane;
    const float* r0 = R0 + (size_t)bz * 5 * plane;
    const float* r1 = R1 + (size_t)bz * 5 * plane;
    float* out = flow_out + (size_t)bz * 2 * plane;
    const int k0 = y0 - m;
    const int G = (y1 - y0 + 2 * m + kRows - 1) / kRows;   // groups of rows
    // in-image columns of the A window; every read goes through the clamp,
    // so only these are copied: in 16-byte chunks from ring column 0 = image
    // column cx0 where rows are 16-byte aligned, else float by float
    const int cl = max(ax0, 0);
    const int ch = min(ax0 + d.AW - 1, W - 1);
    const int nvec = ((ch + 4) >> 2) - (cl >> 2);
    const bool vec = (W & 3) == 0 && 5 * nvec <= kThreads;
    const int cx0 = vec ? (cl & ~3) : cl;
    const int nch = vec ? nvec : ch - cl + 1;
    const int cq = tid / nch;            // this thread's plane and chunk
    const int cx = tid - cq * nch;
    const bool copier = vec && cq < 5;
    const int gx = clampi(ax0 + S + cc, 0, W - 1);   // own cell's pixel column
    const int gxe = clampi(ax0 + ea, 0, W - 1);      // edge cell's

    // R1 rows the y stage of group g reads: [lo(g), hi(g)]
    auto lo = [&](int g) {
      return max(clampi(k0 + kRows * g, 0, H - 1) - S, 0);
    };
    auto hi_row = [&](int g) {
      return min(clampi(k0 + kRows * g + kRows - 1, 0, H - 1) + S + 1, H - 1);
    };
    // copy image rows [ra, rb] (fewer than RR) of the five R1 planes into
    // the ring, row ra into slot sa
    auto copy_rows = [&](int ra, int rb, int sa) {
      if (vec) {
        if (!copier) return;
        const float* src = r1 + cq * plane + cx0 + 4 * cx;
        float* dst = ring + cq * d.AWP + 4 * cx;
        for (int r = ra, sr = sa; r <= rb; ++r) {
          cp_async16(dst + sr * 5 * d.AWP, src + r * W);
          sr = sr + 1 == d.RR ? 0 : sr + 1;
        }
        return;
      }
      const int n = (rb - ra + 1) * nch;
      for (int j = tid; j < n; j += kThreads) {
        const int ri = j / nch;
        const int x = j - ri * nch;
        int sr = sa + ri;
        sr -= sr >= d.RR ? d.RR : 0;
        float* dst = ring + sr * 5 * d.AWP + x;
        const float* src = r1 + (ra + ri) * W + cl + x;
#pragma unroll
        for (int q = 0; q < 5; ++q) cp_async4(dst + q * d.AWP, src + q * plane);
      }
    };

    // the ring's first groups, one commit group each. Slots: row r in
    // r mod RR, tracked as rows advance: islot for row staged + 1, rbs for
    // the y stage's lowest row lo(g)
    int staged = lo(0) - 1;
    int islot = lo(0) % d.RR;
    int rbs = islot;
    auto stage = [&](int g) {
      const int h1 = hi_row(g);
      if (h1 > staged) {
        copy_rows(staged + 1, h1, islot);
        islot += h1 - staged;
        islot -= islot >= d.RR ? d.RR : 0;
        staged = h1;
      }
    };
    for (int g = 0; g < kPrefetch; ++g) {
      if (g < G) stage(g);
      cp_async_commit();
    }
    // flow of group 0 at the own and the edge cell; qo is the own cell's
    // pixel offset in group t (the y stage's flow, the x stage's R0)
    float cdx, cdy, cex = 0.0f, cey = 0.0f;
    int qo = clampi(k0 + p, 0, H - 1) * W + gx;
    cdx = __ldg(fl + qo);
    cdy = __ldg(fl + plane + qo);
    if (has_edge) {
      const int qe = clampi(k0 + ep, 0, H - 1) * W + gxe;
      cex = __ldg(fl + qe);
      cey = __ldg(fl + plane + qe);
    }
    // the x stage's inputs, carried from the step before: coordinates and
    // flow of the own cell (y stage), R0 and border (loaded a step ahead)
    float sfx = 0.0f, sdx = 0.0f, sdy = 0.0f;
    int ssx = 0;
    float cr0[5] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f}, cbm = 0.0f;
    cp_async_wait_prefetch();
    __syncthreads();

    // A step runs each stage only where its group lies in the segment (the
    // tests are the same in every thread); the h stage also waits for the
    // first group with an output row in [y0, y1)
    for (int t = 0; t <= G + 1; ++t) {
      // R1 rows of group t + kPrefetch into the ring, and register loads of
      // group t + 1's flow and group t's R0 and border (clamped rows)
      if (t + kPrefetch < G) stage(t + kPrefetch);
      cp_async_commit();
      float ndx, ndy, nex = 0.0f, ney = 0.0f, nr0[5], nbm;
      const int qn = clampi(k0 + kRows * (t + 1) + p, 0, H - 1) * W + gx;
      {
        const float* f = fl + qn;
        ndx = __ldg(f);
        ndy = __ldg(f + plane);
        if (has_edge) {
          const float* fe =
              fl + clampi(k0 + kRows * (t + 1) + ep, 0, H - 1) * W + gxe;
          nex = __ldg(fe);
          ney = __ldg(fe + plane);
        }
        const float* r = r0 + qo;
#pragma unroll
        for (int u = 0; u < 5; ++u) nr0[u] = __ldg(r + u * plane);
        nbm = __ldg(border + qo);
      }

      // h. group t - 2: horizontal sums (taps 0..2m of V columns
      // [hx, hx + 2m], in order from 0.0f), mean, solve
      if (has_h && t >= 2 && kRows * (t - 1) > 2 * m) {
        const int g = t - 2;
        const int y = y0 - 2 * m + kRows * g + hp;
        const float* vrow = sV + ((g & 1) * kRows + hp) * 5 * d.VS + hx;
        float gg[NX][5];
#pragma unroll
        for (int q = 0; q < 5; ++q) {
          // taps of output hx: e = 0..2m, of hx + 1: e = 1..2m+1
          const float2* v2 =
              reinterpret_cast<const float2*>(vrow + q * d.VS);
          float a0 = 0.0f, a1 = 0.0f;
#pragma unroll
          for (int u = 0; u <= m; ++u) {
            const float2 v = v2[u];
            a0 = a0 + v.x;
            if (u > 0) a1 = a1 + v.x;
            if (u < m) a0 = a0 + v.y;
            a1 = a1 + v.y;
          }
          gg[0][q] = a0 * inv_win2;
          gg[1][q] = a1 * inv_win2;
        }
        const bool row_ok = y >= y0 && y < y1;
#pragma unroll
        for (int o = 0; o < NX; ++o) {
          const float g11 = gg[o][0], g12 = gg[o][1], g22 = gg[o][2];
          const float h1 = gg[o][3], h2 = gg[o][4];
          const float idet = 1.0f / (g11 * g22 - g12 * g12 + 1e-3f);
          const int x = x0 + hx + o;
          if (row_ok && hx + o < TW && x < W) {
            const int q = y * W + x;
            out[q] = (g11 * h2 - g12 * h1) * idet;
            out[plane + q] = (g22 * h1 - g12 * h2) * idet;
          }
        }
      }

      // x. group t - 1: x stage, normal equations, rolling vertical sums
      if (t >= 1 && t <= G && warp_active) {
        const int g = t - 1;
        const float* a0 = sA + ((g & 1) * kRows + p) * 5 * d.AWP + (gx + ssx - ax0);
        const float wx0 = 1.0f - sfx;
        float r[5];
#pragma unroll
        for (int q = 0; q < 5; ++q)
          r[q] = wx0 * a0[q * d.AWP] + sfx * a0[q * d.AWP + 1];
        const float dx = sdx, dy = sdy, bm = cbm;
        float r4 = (cr0[2] + r[2]) * 0.5f;
        float r5 = (cr0[3] + r[3]) * 0.5f;
        float r6 = (cr0[4] + r[4]) * 0.25f;
        float r2 = (cr0[0] - r[0]) * 0.5f;
        float r3 = (cr0[1] - r[1]) * 0.5f;
        r2 = (r2 + r4 * dy + r6 * dx) * bm;
        r3 = (r3 + r6 * dy + r5 * dx) * bm;
        r4 = r4 * bm;
        r5 = r5 * bm;
        r6 = r6 * bm;
        float mv[5];
        mv[0] = r4 * r4 + r6 * r6;
        mv[1] = (r4 + r5) * r6;
        mv[2] = r5 * r5 + r6 * r6;
        mv[3] = r4 * r2 + r6 * r3;
        mv[4] = r6 * r2 + r5 * r3;
        // every row's M value of this column, from the lanes of its rows;
        // then thread p's outputs j = 0..Jn-1 of the step (k - m + p +
        // kRows j) take the rows of their windows in order: j = 0 finishes,
        // j >= 1 move to slot j - 1, those not yet started begin at 0.0f
        float done[5];
#pragma unroll
        for (int q = 0; q < 5; ++q) {
          float v[kRows];
#pragma unroll
          for (int i = 0; i < kRows; ++i)
            v[i] = __shfl_sync(0xffffffffu, mv[q], (lane % kCPW) + i * kCPW);
#pragma unroll
          for (int j = 0; j < (MM >= 0 ? kJ + 1 : kMaxGenericM + 1); ++j) {
            if (MM < 0 && j >= Jn) break;
            float a = j < J ? part[j][q] : 0.0f;
#pragma unroll
            for (int i = 0; i < kRows; ++i)
              if (in_window(i, j, p, m)) a = a + v[i];
            if (j == 0)
              done[q] = a;
            else
              part[j - 1][q] = a;
          }
        }
        if (active) {
          float* vd = sV + ((g & 1) * kRows + p) * 5 * d.VS + c;
#pragma unroll
          for (int q = 0; q < 5; ++q) vd[q * d.VS] = done[q];
        }
      }

      // y. group t: A rows from the ring
      if (t < G) {
        const int g = t;
        float* Ag = sA + (g & 1) * kRows * 5 * d.AWP;
        const int rlo = lo(g);
        auto a_cell = [&](int pr, int a, int gxa, float dx, float dy,
                          bool write, float& fx, int& sx) {
          const int gy = clampi(k0 + kRows * g + pr, 0, H - 1);
          float fy;
          int sy;
          warp_coords(dx, dy, gy, gxa, H, W, S, fx, fy, sx, sy);
          int sa = rbs + clampi(gy + sy, 0, H - 1) - rlo;
          int sb = rbs + clampi(gy + sy + 1, 0, H - 1) - rlo;
          sa -= sa >= d.RR ? d.RR : 0;
          sb -= sb >= d.RR ? d.RR : 0;
          const float* pa = ring + sa * 5 * d.AWP + (gxa - cx0);
          const float* pb = ring + sb * 5 * d.AWP + (gxa - cx0);
          const float w0 = 1.0f - fy;
          if (write) {
            float* dst = Ag + pr * 5 * d.AWP + a;
#pragma unroll
            for (int q = 0; q < 5; ++q)
              dst[q * d.AWP] = w0 * pa[q * d.AWP] + fy * pb[q * d.AWP];
          }
        };
        if (warp_active) {
          a_cell(p, S + cc, gx, cdx, cdy, active, sfx, ssx);
          sdx = cdx;
          sdy = cdy;
        }
        if (has_edge) {
          float fx;
          int sx;
          a_cell(ep, ea, gxe, cex, cey, true, fx, sx);
        }
        rbs += lo(g + 1) - rlo;
        rbs -= rbs >= d.RR ? d.RR : 0;
      }

      cdx = ndx;
      cdy = ndy;
      cex = nex;
      cey = ney;
#pragma unroll
      for (int u = 0; u < 5; ++u) cr0[u] = nr0[u];
      cbm = nbm;
      qo = qn;
      cp_async_wait_prefetch();
      __syncthreads();
    }
  }
}

typedef void (*KernelFn)(const float*, const float*, const float*,
                         const float*, float*, int, int, int, int, float, int,
                         int, int, int, int);

template <int MM>
int prepare(KernelFn* kern) {
  static int err = -1;
  *kern = iterate_strip_kernel<MM>;
  if (err < 0)
    err = (int)cudaFuncSetAttribute(iterate_strip_kernel<MM>,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    kMaxSmemBytes);
  return err;
}

// the kernel for (TW, m, S), or cudaErrorInvalidValue where it cannot take
// them; *smem its shared-memory bytes
int select(int TW, int m, int S, KernelFn* kern, size_t* smem) {
  if (TW < 1 || m < 0 || S < 0 || S > kMaxShift || TW + 2 * m > kCols ||
      (m != 6 && m > kMaxGenericM))
    return (int)cudaErrorInvalidValue;
  *smem = smem_bytes(TW, m, S);
  if (*smem > (size_t)kMaxSmemBytes) return (int)cudaErrorInvalidValue;
  return m == 6 ? prepare<6>(kern) : prepare<-1>(kern);
}

}  // namespace strip

}  // namespace

extern "C" {

// One Jacobi iteration. All tensors float32, contiguous, channel-first: R0,
// R1 (b, 5, H, W), flow and flow_out (b, 2, H, W, distinct buffers), border
// (H, W). m = winsize / 2, inv_win2 = 1 / winsize^2. With tile < 0 the
// row-streaming blocks: strips of TW columns (ceil(W / TW) of them), the b x
// strips columns of H rows laid end to end and cut into runs of
// rows_per_block (or, with runs_per_col > 0, each column cut into that many
// runs of rows_per_block), one block each. With tile >= 0, the tile design's
// blocks on that tile (0: 32x64 rows x columns, 1: 32x32; the strip
// arguments unused): the layers too short to stream, and the yardstick.
// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue for
// arguments the kernel does not take (a block whose shared memory would
// exceed 227 KB among them).
int farneback_iterate_fused(const float* R0, const float* R1, const float* flow,
                            const float* border, float* flow_out, int b, int H,
                            int W, int S, int m, float inv_win2, int TW,
                            int rows_per_block, int runs_per_col, int tile,
                            void* stream) {
  if (b <= 0 || H <= 0 || W <= 0 || S < 0 || m < 0 || b > 65535 ||
      (long long)H * W > (1LL << 31) / 5 || flow == flow_out)
    return (int)cudaErrorInvalidValue;
  if (tile >= 0) {
    int th, tw;
    tiled::KernelFn kern;
    const int err = tiled::select_tile(tile, m, &th, &tw, &kern);
    if (err != 0) return err;
    const size_t smem = tiled::smem_bytes(th, tw, m, S);
    if (smem > (size_t)kMaxSmemBytes) return (int)cudaErrorInvalidValue;
    const dim3 grid((W + tw - 1) / tw, (H + th - 1) / th, b);
    kern<<<grid, tiled::kThreads, smem, (cudaStream_t)stream>>>(
        R0, R1, flow, border, flow_out, H, W, S, m, inv_win2);
    return (int)cudaGetLastError();
  }
  if (rows_per_block <= 0 || runs_per_col < 0 || TW <= 0)
    return (int)cudaErrorInvalidValue;
  strip::KernelFn kern;
  size_t smem;
  const int err = strip::select(TW, m, S, &kern, &smem);
  if (err != 0) return err;
  const int ns = (W + TW - 1) / TW;
  const long long total = (long long)b * ns * H;
  if (total >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  const long long blocks =
      runs_per_col > 0 ? (long long)b * ns * runs_per_col
                       : (total + rows_per_block - 1) / rows_per_block;
  if (blocks >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  kern<<<(int)blocks, strip::kThreads, smem, (cudaStream_t)stream>>>(
      R0, R1, flow, border, flow_out, H, W, S, m, inv_win2, TW, ns,
      rows_per_block, runs_per_col, (int)total);
  return (int)cudaGetLastError();
}

// Launch resources of the kernel farneback_iterate_fused runs for these
// arguments: out[0] shared-memory bytes per block, out[1] registers per
// thread, out[2] resident blocks per SM, out[3] local-memory bytes per thread
// (spills and run-time-indexed arrays).
int farneback_iterate_fused_info(int TW, int m, int S, int tile, int* out) {
  const void* kern;
  int threads;
  size_t smem;
  if (tile >= 0) {
    int th, tw;
    tiled::KernelFn k;
    const int err = tiled::select_tile(tile, m, &th, &tw, &k);
    if (err != 0) return err;
    kern = (const void*)k;
    threads = tiled::kThreads;
    smem = tiled::smem_bytes(th, tw, m, S);
  } else {
    strip::KernelFn k;
    const int err = strip::select(TW, m, S, &k, &smem);
    if (err != 0) return err;
    kern = (const void*)k;
    threads = strip::kThreads;
  }
  cudaFuncAttributes attr;
  int err = (int)cudaFuncGetAttributes(&attr, kern);
  if (err != 0) return err;
  int blocks = 0;
  err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kern,
                                                           threads, smem);
  out[0] = (int)smem;
  out[1] = attr.numRegs;
  out[2] = blocks;
  out[3] = (int)attr.localSizeBytes;
  return err;
}

}  // extern "C"
