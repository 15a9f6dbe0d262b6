// The detection step's per-frame rates for Hopper (sm_90a): every count of
// pipeline/detector.py's rates stage from one read of segmentation, the two
// detection masks, the sky estimate, depth and the raw GT flow.
//
// Replaces no TPU kernel: the reference computes these counts with XLA's
// reductions (mav_detection_tpu/pipeline/detector.py, _tpr_fpr three times,
// masked_mean_flow, the drone size and get_simple_bounding_box_device). The
// port ran them as eager PyTorch, about 140 device operations a batch of
// eight (a dozen int32 passes over the frame per rate pair), and derotated
// the whole GT flow into a (n, h, w, 2) buffer that only the drone's mean
// read. ops/image/detect_rates.py keeps that plain version (rates_ref) and
// holds this kernel to it.
//
// Three launches a batch of n frames:
//   1. rates_max_kernel: per frame max(depth) and max(segmentation), partial
//      maxima of nbp blocks a frame (the depth rule's and the box's
//      thresholds need the whole frame first);
//   2. rates_count_kernel: each block reduces its frame's nbp partial maxima
//      (a fixed order), takes the thresholds 0.8f * dmax and 0.1f * smax as
//      the plain code rounds them in float32, then reads a run of kThreads x
//      items pixels once and counts, per frame:
//        pos   seg > 127             (neg = h w - pos)
//        tp    mask && seg >= 1      (gt * 255 mask > 127, upstream's product)
//        fp    mask && seg <= 254    ((255 - gt) * 255 mask > 127)
//        the same two for the fixed mask,
//        sky_gt  depth > 0.8 dmax, sky_tp  sky_gt && sky, sky  sky
//        the box: rows and columns of seg > 0.1 smax, min and max,
//        the derotated GT flow times the drone mask (seg > 127), summed, the
//        rotational field computed inline as derotation_field computes it
//        (the same float32 operations in the same order; built with
//        -fmad=false, no contraction);
//   3. rates_finish_kernel: one block a frame sums the count blocks'
//      partials in a fixed order and writes the scalars of FrameOutputs.
// No atomics: a replay gives the same bits every time.
//
// Bound on the H100 (3.35 TB/s): the inputs read once, 16 B a pixel (seg,
// the two masks and sky 1 B each, depth 4, the GT flow 8; depth once for
// the batch where it comes expanded with batch stride 0), 46 MB at 752x480
// b=8, 14 us (detect_rates.rates_bound). The arithmetic (the field's ~20
// float32 operations a pixel) is 30x under the bytes. Loads are coalesced
// runs of kThreads pixels per array; a thread keeps its counts in registers,
// walks its pixels' row and column incrementally (no division a pixel) and
// has four pixels' loads in flight (the loop unrolled by 4: 9 % faster than
// one at a time at b=8 752x480, 4 % at b=1).
#include <cuda_runtime.h>

#include <climits>
#include <cmath>

constexpr int kThreads = 256;
// integer partials of a count block: the counts, then the box
enum { kPos, kTp, kFp, kTpFixed, kFpFixed, kSkyGt, kSkyTp, kSky, kCounts };
enum { kYmin = kCounts, kYmax, kXmin, kXmax, kInts };
constexpr int kSums = 2;   // the drone's derotated GT flow, u and v (double)
// 180 / pi as torch multiplies a float32 tensor by the Python float
constexpr float kDegrees = (float)(180.0 / 3.14159265358979323846);

// max that keeps a NaN, as torch.max does
__device__ __forceinline__ float nan_max(float m, float v) {
  return (v > m || v != v) ? v : m;
}

// shared memory of a count or finish block: kSums doubles and kInts ints a
// thread
constexpr size_t reduce_smem() {
  return (size_t)kThreads * (kSums * sizeof(double) + kInts * sizeof(int));
}

// Sum the block's per-thread partials in a fixed tree; thread 0 ends with
// the block's totals in si[j * kThreads] and sd[j * kThreads].
__device__ void reduce_block(int* si, double* sd, int t) {
  __syncthreads();
  for (int k = kThreads / 2; k > 0; k >>= 1) {
    if (t < k) {
      for (int j = 0; j < kCounts; ++j) si[j * kThreads + t] += si[j * kThreads + t + k];
      for (int j = kYmin; j < kInts; j += 2) {
        si[j * kThreads + t] = min(si[j * kThreads + t], si[j * kThreads + t + k]);
        si[(j + 1) * kThreads + t] =
            max(si[(j + 1) * kThreads + t], si[(j + 1) * kThreads + t + k]);
      }
      for (int j = 0; j < kSums; ++j) sd[j * kThreads + t] += sd[j * kThreads + t + k];
    }
    __syncthreads();
  }
}

// Launch 1, grid (nbp, n): block b of frame f reduces pixels b kThreads + t
// + i nbp kThreads; maxes (n, nbp, 2) gets its max(depth), max(seg).
__global__ void __launch_bounds__(kThreads)
rates_max_kernel(const unsigned char* __restrict__ seg, long long seg_bs,
                 const float* __restrict__ depth, long long depth_bs, int hw, int nbp,
                 float* __restrict__ maxes) {
  extern __shared__ float smem[];
  const int t = threadIdx.x, f = blockIdx.y, b = blockIdx.x;
  const unsigned char* s = seg + f * seg_bs;
  const float* d = depth + f * depth_bs;
  float dm = -INFINITY;
  int sm = 0;
  for (long long p = (long long)b * kThreads + t; p < hw; p += (long long)nbp * kThreads) {
    dm = nan_max(dm, d[p]);
    sm = max(sm, (int)s[p]);
  }
  float* sdm = smem;
  float* ssm = smem + kThreads;
  sdm[t] = dm;
  ssm[t] = (float)sm;
  __syncthreads();
  for (int k = kThreads / 2; k > 0; k >>= 1) {
    if (t < k) {
      sdm[t] = nan_max(sdm[t], sdm[t + k]);
      ssm[t] = fmaxf(ssm[t], ssm[t + k]);
    }
    __syncthreads();
  }
  if (t == 0) {
    maxes[2 * ((long long)f * nbp + b)] = sdm[0];
    maxes[2 * ((long long)f * nbp + b) + 1] = ssm[0];
  }
}

// Launch 2, grid (nb, n): block b of frame f counts pixels b kThreads items
// .. (b + 1) kThreads items - 1, thread t every kThreads-th from the run's
// t-th. ints (n, nb, kInts), sums (n, nb, kSums).
__global__ void __launch_bounds__(kThreads)
rates_count_kernel(const unsigned char* __restrict__ seg, long long seg_bs,
                   const unsigned char* __restrict__ total, long long total_bs,
                   const unsigned char* __restrict__ fixed, long long fixed_bs,
                   const unsigned char* __restrict__ sky, long long sky_bs,
                   const float* __restrict__ depth, long long depth_bs,
                   const float* __restrict__ flow, long long flow_bs,
                   const float* __restrict__ omega, const float* __restrict__ dt, int h,
                   int w, int items, int nbp, const float* __restrict__ maxes, int nb,
                   int* __restrict__ ints, double* __restrict__ sums) {
  extern __shared__ float smem[];
  double* sd = reinterpret_cast<double*>(smem);
  int* si = reinterpret_cast<int*>(sd + kSums * kThreads);
  const int t = threadIdx.x, f = blockIdx.y, b = blockIdx.x;

  // the frame's maxima from the pre-pass partials, in a fixed order
  float* sdm = reinterpret_cast<float*>(si);
  float* ssm = sdm + kThreads;
  float dm = -INFINITY, sm = 0.0f;
  for (int i = t; i < nbp; i += kThreads) {
    dm = nan_max(dm, maxes[2 * ((long long)f * nbp + i)]);
    sm = fmaxf(sm, maxes[2 * ((long long)f * nbp + i) + 1]);
  }
  sdm[t] = dm;
  ssm[t] = sm;
  __syncthreads();
  for (int k = kThreads / 2; k > 0; k >>= 1) {
    if (t < k) {
      sdm[t] = nan_max(sdm[t], sdm[t + k]);
      ssm[t] = fmaxf(ssm[t], ssm[t + k]);
    }
    __syncthreads();
  }
  // depth > 0.8 * dmax and seg > 0.1 * smax, the products rounded to float32
  const float dthr = 0.8f * sdm[0];
  const float sthr = 0.1f * ssm[0];
  __syncthreads();

  const unsigned char* sg = seg + f * seg_bs;
  const unsigned char* tm = total + f * total_bs;
  const unsigned char* fx = fixed + f * fixed_bs;
  const unsigned char* sk = sky + f * sky_bs;
  const float* dp = depth + f * depth_bs;
  const float2* fl = reinterpret_cast<const float2*>(flow + f * flow_bs);
  // derotation_field's float32 terms: omega, width dt / 2, height dt / 2
  const float o0 = omega[3 * f], o1 = omega[3 * f + 1], o2 = omega[3 * f + 2];
  const float wf = (float)w, hf = (float)h;
  const float su = wf * dt[f] / 2.0f, sv = hf * dt[f] / 2.0f;

  const int hw = h * w;
  const int start = b * kThreads * items;
  const int end = min(hw, start + kThreads * items);
  int p = start + t;
  int y = p / w, x = p - y * w;
  int c[kCounts] = {0, 0, 0, 0, 0, 0, 0, 0};
  int ymin = INT_MAX, ymax = -1, xmin = INT_MAX, xmax = -1;
  double au = 0.0, av = 0.0;
#pragma unroll 4
  for (; p < end; p += kThreads) {
    const int s = sg[p];
    const int pos = s > 127, lo = s >= 1, hi = s <= 254;
    const int m0 = tm[p] != 0, m1 = fx[p] != 0;
    const int gt_sky = dp[p] > dthr, est_sky = sk[p] != 0;
    c[kPos] += pos;
    c[kTp] += m0 & lo;
    c[kFp] += m0 & hi;
    c[kTpFixed] += m1 & lo;
    c[kFpFixed] += m1 & hi;
    c[kSkyGt] += gt_sky;
    c[kSkyTp] += gt_sky & est_sky;
    c[kSky] += est_sky;
    if ((float)s > sthr) {
      ymin = min(ymin, y);
      ymax = max(ymax, y);
      xmin = min(xmin, x);
      xmax = max(xmax, x);
    }
    // derotation_field at (x, y), then (gt - field) * mask, summed
    const float xn = -((float)x / wf - 0.5f) * 2.0f;
    const float yn = -((float)y / hf - 0.5f) * 2.0f;
    const float u = (o0 * xn * yn - o1 * (xn * xn) - o1 + o2 * yn) * su;
    const float v = (-o2 * xn + o0 + o0 * (yn * yn) - o1 * xn * yn) * sv;
    const float mk = pos ? 1.0f : 0.0f;
    const float2 g = fl[p];
    au += (double)((g.x - u) * mk);
    av += (double)((g.y - v) * mk);
    x += kThreads;
    while (x >= w) {
      x -= w;
      ++y;
    }
  }
  for (int j = 0; j < kCounts; ++j) si[j * kThreads + t] = c[j];
  si[kYmin * kThreads + t] = ymin;
  si[kYmax * kThreads + t] = ymax;
  si[kXmin * kThreads + t] = xmin;
  si[kXmax * kThreads + t] = xmax;
  sd[t] = au;
  sd[kThreads + t] = av;
  reduce_block(si, sd, t);
  if (t == 0) {
    const long long o = (long long)f * nb + b;
    for (int j = 0; j < kInts; ++j) ints[o * kInts + j] = si[j * kThreads];
    for (int j = 0; j < kSums; ++j) sums[o * kSums + j] = sd[j * kThreads];
  }
}

// Launch 3, grid (n): frame f's nb partials summed in a fixed order, then
// out (9 n float32): tpr, fpr, tpr_fixed, fpr_fixed, sky_tpr, sky_fpr,
// center_phi (n each), drone_flow_pixels (n, 2); size (n int64). Counts go
// to float32 before each division, as _tpr_fpr's do (an empty class gives
// NaN); an empty box gives -1s, as get_simple_bounding_box_device's.
__global__ void __launch_bounds__(kThreads)
rates_finish_kernel(const int* __restrict__ ints, const double* __restrict__ sums, int nb,
                    int n, int hw, const float* __restrict__ gt_foe, float* __restrict__ out,
                    long long* __restrict__ size) {
  extern __shared__ float smem[];
  double* sd = reinterpret_cast<double*>(smem);
  int* si = reinterpret_cast<int*>(sd + kSums * kThreads);
  const int t = threadIdx.x, f = blockIdx.x;
  int c[kInts] = {0, 0, 0, 0, 0, 0, 0, 0, INT_MAX, -1, INT_MAX, -1};
  double a[kSums] = {0.0, 0.0};
  for (int i = t; i < nb; i += kThreads) {
    const int* q = ints + ((long long)f * nb + i) * kInts;
    for (int j = 0; j < kCounts; ++j) c[j] += q[j];
    c[kYmin] = min(c[kYmin], q[kYmin]);
    c[kYmax] = max(c[kYmax], q[kYmax]);
    c[kXmin] = min(c[kXmin], q[kXmin]);
    c[kXmax] = max(c[kXmax], q[kXmax]);
    for (int j = 0; j < kSums; ++j) a[j] += sums[((long long)f * nb + i) * kSums + j];
  }
  for (int j = 0; j < kInts; ++j) si[j * kThreads + t] = c[j];
  for (int j = 0; j < kSums; ++j) sd[j * kThreads + t] = a[j];
  reduce_block(si, sd, t);
  if (t != 0) return;
  const int pos = si[kPos * kThreads], neg = hw - pos;
  const int sky_gt = si[kSkyGt * kThreads], sky_tp = si[kSkyTp * kThreads];
  const int sky_fp = si[kSky * kThreads] - sky_tp;
  out[f] = (float)si[kTp * kThreads] / (float)pos;
  out[n + f] = (float)si[kFp * kThreads] / (float)neg;
  out[2 * n + f] = (float)si[kTpFixed * kThreads] / (float)pos;
  out[3 * n + f] = (float)si[kFpFixed * kThreads] / (float)neg;
  out[4 * n + f] = (float)sky_tp / (float)sky_gt;
  out[5 * n + f] = (float)sky_fp / (float)(hw - sky_gt);
  // the box [x0, y0, x1, y1], -1s where no pixel passed
  const bool none = si[kXmax * kThreads] < 0;
  const float x0 = none ? -1.0f : (float)si[kXmin * kThreads];
  const float y0 = none ? -1.0f : (float)si[kYmin * kThreads];
  const float x1 = none ? -1.0f : (float)si[kXmax * kThreads];
  const float y1 = none ? -1.0f : (float)si[kYmax * kThreads];
  const float cx = (x0 + x1) / 2.0f, cy = (y0 + y1) / 2.0f;
  out[6 * n + f] = atan2f(cy - gt_foe[2 * f + 1], cx - gt_foe[2 * f]) * kDegrees;
  out[7 * n + 2 * f] = (float)sd[0] / (float)pos;
  out[7 * n + 2 * f + 1] = (float)sd[kThreads] / (float)pos;
  size[f] = pos;
}

extern "C" {

static int cdiv(long long a, long long b) { return (int)((a + b - 1) / b); }

static bool bad_frame(int n, int h, int w) {
  return n <= 0 || h <= 0 || w <= 0 || (long long)h * w > INT_MAX - 2LL * kThreads * 64;
}

// Launch 1: seg (uint8) and depth (float32) frames at batch strides seg_bs
// and depth_bs elements (0: one frame for the batch), each frame's h w
// contiguous; nbp blocks a frame, 1 .. kThreads; maxes (n, nbp, 2).
int detect_rates_max(const unsigned char* seg, long long seg_bs, const float* depth,
                     long long depth_bs, int n, int h, int w, int nbp, float* maxes,
                     void* stream) {
  if (bad_frame(n, h, w) || nbp <= 0 || nbp > kThreads || seg_bs < 0 || depth_bs < 0)
    return (int)cudaErrorInvalidValue;
  rates_max_kernel<<<dim3(nbp, n), kThreads, 2 * kThreads * sizeof(float),
                     (cudaStream_t)stream>>>(seg, seg_bs, depth, depth_bs, h * w, nbp, maxes);
  return (int)cudaGetLastError();
}

// Launch 2: total, fixed and sky masks as bytes (torch.bool), the GT flow
// (float32, (h, w, 2) a frame, 8-byte aligned), omega (n, 3) and dt (n)
// float32; items pixels a thread, nb = ceil(h w / (kThreads items)) blocks
// a frame; ints (n, nb, 12), sums (n, nb, 2).
int detect_rates_count(const unsigned char* seg, long long seg_bs,
                       const unsigned char* total, long long total_bs,
                       const unsigned char* fixed, long long fixed_bs,
                       const unsigned char* sky, long long sky_bs, const float* depth,
                       long long depth_bs, const float* flow, long long flow_bs,
                       const float* omega, const float* dt, int n, int h, int w, int items,
                       int nbp, const float* maxes, int* ints, double* sums, void* stream) {
  if (bad_frame(n, h, w) || items <= 0 || items > 64 || nbp <= 0 || nbp > kThreads ||
      seg_bs < 0 || total_bs < 0 || fixed_bs < 0 || sky_bs < 0 || depth_bs < 0 ||
      flow_bs < 0 || flow_bs % 2 != 0)
    return (int)cudaErrorInvalidValue;
  const int nb = cdiv((long long)h * w, (long long)kThreads * items);
  rates_count_kernel<<<dim3(nb, n), kThreads, reduce_smem(), (cudaStream_t)stream>>>(
      seg, seg_bs, total, total_bs, fixed, fixed_bs, sky, sky_bs, depth, depth_bs, flow,
      flow_bs, omega, dt, h, w, items, nbp, maxes, nb, ints, sums);
  return (int)cudaGetLastError();
}

// Launch 3: gt_foe (n, 2) float32; out (9 n) float32, size (n) int64.
int detect_rates_finish(const int* ints, const double* sums, int n, int h, int w, int items,
                        const float* gt_foe, float* out, long long* size, void* stream) {
  if (bad_frame(n, h, w) || items <= 0 || items > 64) return (int)cudaErrorInvalidValue;
  const int nb = cdiv((long long)h * w, (long long)kThreads * items);
  rates_finish_kernel<<<n, kThreads, reduce_smem(), (cudaStream_t)stream>>>(
      ints, sums, nb, n, h * w, gt_foe, out, size);
  return (int)cudaGetLastError();
}

}  // extern "C"
