// Runs the detection step's rates kernels on the CPU (see cuda_host.h):
//   rates_main n h w nbp items seg_bs total_bs fixed_bs sky_bs depth_bs flow_bs
// stdin holds segmentation (uint8), the total and fixed masks and sky (bytes
// 0 or 1), depth and the GT flow (float32), each (n - 1) x its batch stride
// + one frame's elements (h w, 2 h w for the flow; batch stride 0: one
// frame for the batch), then omega (n, 3), dt (n) and gt_foe (n, 2)
// float32; stdout gets out (9 n float32) then size (n int64).
#include <cstdio>
#include <cstdlib>

#include "rates.h"

template <class T>
static bool read(std::vector<T>& v) {
  return fread(v.data(), sizeof(T), v.size(), stdin) == v.size();
}

int main(int argc, char** argv) {
  if (argc != 12) return 2;
  long long a[11];
  for (int i = 0; i < 11; ++i) a[i] = atoll(argv[i + 1]);
  const int n = (int)a[0], h = (int)a[1], w = (int)a[2], nbp = (int)a[3], items = (int)a[4];
  const long long *bs = a + 5, hw = (long long)h * w;
  auto elems = [&](long long stride, long long frame) { return stride * (n - 1) + frame; };
  std::vector<unsigned char> seg(elems(bs[0], hw)), total(elems(bs[1], hw)),
      fixed(elems(bs[2], hw)), sky(elems(bs[3], hw));
  std::vector<float> depth(elems(bs[4], hw)), flow(elems(bs[5], 2 * hw)), omega(3 * n),
      dt(n), foe(2 * n);
  if (!read(seg) || !read(total) || !read(fixed) || !read(sky) || !read(depth) ||
      !read(flow) || !read(omega) || !read(dt) || !read(foe))
    return 3;
  const int nb = (int)((hw + (long long)kThreads * items - 1) / ((long long)kThreads * items));
  std::vector<float> maxes((size_t)n * nbp * 2, std::nanf("")), out(9 * n, std::nanf(""));
  std::vector<int> ints((size_t)n * nb * kInts, -7);
  std::vector<double> sums((size_t)n * nb * kSums, std::nan(""));
  std::vector<long long> size(n, -7);
  launch(nbp, n, 1, kThreads, 2 * kThreads * sizeof(float), [&] {
    rates_max_kernel(seg.data(), bs[0], depth.data(), bs[4], (int)hw, nbp, maxes.data());
  });
  launch(nb, n, 1, kThreads, reduce_smem(), [&] {
    rates_count_kernel(seg.data(), bs[0], total.data(), bs[1], fixed.data(), bs[2],
                       sky.data(), bs[3], depth.data(), bs[4], flow.data(), bs[5],
                       omega.data(), dt.data(), h, w, items, nbp, maxes.data(), nb,
                       ints.data(), sums.data());
  });
  launch(n, 1, 1, kThreads, reduce_smem(), [&] {
    rates_finish_kernel(ints.data(), sums.data(), nb, n, (int)hw, foe.data(), out.data(),
                        size.data());
  });
  fwrite(out.data(), sizeof(float), out.size(), stdout);
  fwrite(size.data(), sizeof(long long), size.size(), stdout);
  return 0;
}
