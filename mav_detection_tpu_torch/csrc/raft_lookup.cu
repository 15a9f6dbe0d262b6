// The published RAFT's all-pairs lookup for Hopper (sm_90a): every pixel's
// (2r+1)^2 bilinear taps at each level of the correlation pyramid, from one
// read of the pixel's window of its own map, in one launch an iteration.
//
// Replaces no TPU kernel: the reference's lookup is XLA gathers
// (mav_detection_tpu/models/raft.py). The port ran it as
// models/raft_lookup.py::lookup_ref, ``grid_sample(align_corners=True)`` on
// b h w one-channel maps a level after building a (b h w, 9, 9, 2) grid, then
// a cat, a permute and a copy: 45 device operations an iteration at 4
// levels. lookup_ref stays the plain version (CPU tensors, and the yardstick
// on the card).
//
// One thread a pixel of the lanes' 1/8-resolution grid, blockIdx.y the
// level. The taps' offsets are whole pixels, so all taps of a pixel and
// level lie in one window of its map: (2r+2)^2 entries, one more row and
// column for the rounding below, at most kWin x kWin. Each warp stages its
// 32 pixels' windows in shared memory, a pixel at a time with the warp's
// lanes across the window's cells (a load instruction then reads ~3 rows of
// one map, not 32 maps), only the cells its taps read, zeros outside the
// map, as cp.async copies that no thread waits for until the last is
// issued (all 32 windows in flight: waiting on plain loads a few pixels at
// a time took 0.140 ms an iteration at b=8, the copies 0.091); then each
// thread forms its pixel's taps from its own window and writes them to the
// (b, levels (2r+1)^2, h, w) float32 output that convc1 reads, channel
// level (2r+1)^2 + ix (2r+1) + iy (the x offset slowest, the published
// order), coalesced along w.
//
// Arithmetic: as bilinear_sampler_zeros + ATen's native CUDA grid_sample
// (bilinear, zeros, align_corners) compute each tap: the centre coords /
// 2^level (exact), plus the offset, plus 1 where a map one pixel high or
// wide gets its zero border, normalised (2 x) * (1 / (size - 1)) - 1 (the
// card's division by a scalar is a multiply by its reciprocal) and
// unnormalised ((g + 1) / 2) (size - 1), each rounded as float32 (built with
// -fmad=false); floor, the four weights (x1 - x)(y1 - y), (x - x0)(y1 - y),
// (x1 - x)(y - y0), (x - x0)(y - y0), and the corners summed nw, ne, sw, se
// with fused multiply-adds, as nvcc contracts ATen's sum. The round trip
// can move a tap's floor by one against its neighbours' (a coordinate on a
// whole pixel comes back a few ulps under it), hence the window's extra row
// and column. A pixel whose window misses the map reads 0 at every tap (as
// ATen: a NaN or infinite coordinate reads 0, far outside reads 0).
//
// Bound on the H100 (3.35 TB/s): the windows read once and the taps written
// once. At b=8, 60x94 (levels 60x94, 30x47, 15x23, 7x11): 10 rows of 40 B a
// pixel and level (7 at 7x11), ~113 MB at 32-byte sectors, and 58.5 MB of
// taps, 51 us an iteration (raft_lookup.lookup_bound); the kernel 91 us
// there. No atomics; a replay gives the same bits every time; nothing
// allocated, no sync.
#include <cuda_runtime.h>

#include <climits>
#include <cmath>

constexpr int kRadius = 4;
constexpr int kSide = 2 * kRadius + 1;            // taps along one axis
constexpr int kWin = kSide + 2;                   // window along one axis
constexpr int kCells = kWin * kWin;
constexpr int kPitch = 33;                        // words a window cell: 32 lanes + 1
constexpr int kWarps = 2;
constexpr int kThreads = 32 * kWarps;
constexpr int kLoads = (kCells + 31) / 32;        // a lane's cells of one window
constexpr int kMaxLevels = 4;

struct Pyramid {
  const float* vol[kMaxLevels];   // (b h w, th, tw) float32 each
  int th[kMaxLevels];
  int tw[kMaxLevels];
};

constexpr size_t lookup_smem() { return (size_t)kWarps * kCells * kPitch * sizeof(float); }

// a 4-byte copy from device to shared memory that the thread does not wait
// for, in its open group
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

// a[l] with constant indices (a dynamic index into the kernel's parameter
// would copy it to local memory)
template <class T>
__device__ __forceinline__ T level_of(const T (&a)[kMaxLevels], int l) {
  return l == 0 ? a[0] : l == 1 ? a[1] : l == 2 ? a[2] : a[3];
}

// One axis of a pixel's taps: for the offsets d = -r..r of the level's
// coordinate c, the floor of each tap's source index relative to the first
// tap's (rel), the weight of the lower neighbour (hi - x) and of the upper
// (x - lo). Returns whether any tap's neighbours meet the map (size entries,
// pad: its one-pixel zero border); origin is the first tap's floor in the
// map's own indices, extent the last tap's floor relative to it plus one
// (the window's last entry the taps read).
__device__ __forceinline__ bool axis_taps(float c, int size, int pad, int* rel, float* lower,
                                          float* upper, float* origin, float* extent) {
  const float span = (float)(size + 2 * pad - 1);
  const float inv = 1.0f / span;
  float first = 0.0f, last = 0.0f;
#pragma unroll
  for (int k = 0; k < kSide; ++k) {
    float x = c + (float)(k - kRadius);
    if (pad) x = x + 1.0f;
    const float g = (2.0f * x) * inv - 1.0f;
    const float ix = ((g + 1.0f) * 0.5f) * span;
    const float f = floorf(ix);
    if (k == 0) first = f;
    last = f;
    // in [0, kWin - 2] wherever the window meets the map (the source index
    // grows with the offset, by 2r +- a few ulps over the axis); clamped so
    // that no tap of any coordinate indexes outside its window
    rel[k] = (int)fminf(fmaxf(f - first, 0.0f), (float)(kWin - 2));
    lower[k] = (f + 1.0f) - ix;
    upper[k] = ix - f;
  }
  *origin = first - (float)pad;
  *extent = last - first + 1.0f;
  return last + 1.0f >= (float)pad && first <= (float)(size - 1 + pad);
}

__global__ void __launch_bounds__(kThreads)
    lookup_kernel(Pyramid pyr, const float* __restrict__ coords, int npix, int hw,
                  int levels, float* __restrict__ out) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31;
  float* win = smem + (threadIdx.x >> 5) * (kCells * kPitch);
  const int l = blockIdx.y;
  const float* vol = level_of(pyr.vol, l);
  const int th = level_of(pyr.th, l), tw = level_of(pyr.tw, l);
  const int pad = (th == 1 || tw == 1) ? 1 : 0;
  const long long map = (long long)th * tw;
  const int warp0 = blockIdx.x * kThreads + (threadIdx.x & ~31);
  const int p = warp0 + lane;
  const bool valid = p < npix;
  const int n = valid ? p / hw : 0, q = valid ? p - n * hw : 0;
  const float scale = 1.0f / (float)(1 << l);
  const float cx = valid ? coords[2LL * n * hw + q] * scale : 0.0f;
  const float cy = valid ? coords[(2LL * n + 1) * hw + q] * scale : 0.0f;

  int relx[kSide], rely[kSide];
  float ex[kSide], wx[kSide], sy[kSide], ny[kSide];
  float ox, oy, lx, ly;
  const bool hx = axis_taps(cx, tw, pad, relx, ex, wx, &ox, &lx);
  const bool hy = axis_taps(cy, th, pad, rely, sy, ny, &oy, &ly);
  const bool hit = valid && hx && hy;

  // the warp's windows, a pixel at a time, the lanes across its cells: the
  // cells the taps read, copied without waiting (zeros outside the map);
  // a pixel whose taps are all 0 reads none
  const float mx = hit ? ox : 0.0f, my = hit ? oy : 0.0f;
  const float kx = hit ? lx : -1.0f, ky = hit ? ly : -1.0f;
  int cr[kLoads], cc[kLoads];
#pragma unroll
  for (int k = 0; k < kLoads; ++k) {
    cr[k] = (lane + 32 * k) / kWin;
    cc[k] = (lane + 32 * k) % kWin;
  }
  const int count = min(32, npix - warp0);
#pragma unroll 4
  for (int j = 0; j < 32; ++j) {
    if (j >= count) break;
    const int x0 = (int)__shfl_sync(0xffffffffu, mx, j);
    const int y0 = (int)__shfl_sync(0xffffffffu, my, j);
    const int xn = (int)__shfl_sync(0xffffffffu, kx, j);
    const int yn = (int)__shfl_sync(0xffffffffu, ky, j);
    const float* src = vol + (long long)(warp0 + j) * map;
#pragma unroll
    for (int k = 0; k < kLoads; ++k) {
      const int cell = lane + 32 * k;
      if (cell < kCells && cr[k] <= yn && cc[k] <= xn) {
        const int y = y0 + cr[k], x = x0 + cc[k];
        if ((unsigned)y < (unsigned)th && (unsigned)x < (unsigned)tw)
          cp_async4(win + cell * kPitch + j, src + (long long)y * tw + x);
        else
          win[cell * kPitch + j] = 0.0f;
      }
    }
  }
  cp_async_commit();
  cp_async_wait_all();
  __syncwarp();
  if (!valid) return;

  float* dst = out + ((long long)n * levels + l) * kSide * kSide * hw + q;
  if (!hit) {
#pragma unroll
    for (int t = 0; t < kSide * kSide; ++t) dst[(long long)t * hw] = 0.0f;
    return;
  }
  const float* own = win + lane;
#pragma unroll
  for (int i = 0; i < kSide; ++i) {
#pragma unroll
    for (int j = 0; j < kSide; ++j) {
      const float* c = own + (rely[j] * kWin + relx[i]) * kPitch;
      float acc = 0.0f;
      acc = fmaf(c[0], ex[i] * sy[j], acc);                       // (x0, y0)
      acc = fmaf(c[kPitch], wx[i] * sy[j], acc);                  // (x0 + 1, y0)
      acc = fmaf(c[kWin * kPitch], ex[i] * ny[j], acc);           // (x0, y0 + 1)
      acc = fmaf(c[(kWin + 1) * kPitch], wx[i] * ny[j], acc);     // (x0 + 1, y0 + 1)
      dst[(long long)(i * kSide + j) * hw] = acc;
    }
  }
}

extern "C" {

// The taps of b lanes of h x w pixels: coords (b, 2, h, w) float32
// (x then y), levels volumes (b h w, th_l, tw_l) float32, each contiguous;
// out (b, levels (2r+1)^2, h, w) float32. radius must be kRadius.
int raft_lookup(const float* v0, const float* v1, const float* v2, const float* v3, int th0,
                int tw0, int th1, int tw1, int th2, int tw2, int th3, int tw3, int levels,
                const float* coords, int b, int h, int w, int radius, float* out,
                void* stream) {
  const long long npix = (long long)b * h * w;
  if (radius != kRadius || levels < 1 || levels > kMaxLevels || b <= 0 || h <= 0 ||
      w <= 0 || npix > INT_MAX - kThreads || coords == nullptr || out == nullptr)
    return (int)cudaErrorInvalidValue;
  const Pyramid pyr = {{v0, v1, v2, v3}, {th0, th1, th2, th3}, {tw0, tw1, tw2, tw3}};
  for (int l = 0; l < levels; ++l)
    if (pyr.vol[l] == nullptr || pyr.th[l] <= 0 || pyr.tw[l] <= 0)
      return (int)cudaErrorInvalidValue;
  const int blocks = (int)((npix + kThreads - 1) / kThreads);
  lookup_kernel<<<dim3(blocks, levels), kThreads, lookup_smem(), (cudaStream_t)stream>>>(
      pyr, coords, (int)npix, h * w, levels, out);
  return (int)cudaGetLastError();
}

// Launch resources on the current card: shared-memory bytes a block,
// registers a thread, blocks per SM, local-memory bytes a thread.
int raft_lookup_info(int* out) {
  cudaFuncAttributes attr;
  int err = (int)cudaFuncGetAttributes(&attr, lookup_kernel);
  if (err != 0) return err;
  int blocks = 0;
  err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, lookup_kernel, kThreads,
                                                           lookup_smem());
  out[0] = (int)lookup_smem();
  out[1] = attr.numRegs;
  out[2] = blocks;
  out[3] = (int)attr.localSizeBytes;
  return err;
}

}  // extern "C"
