// Runs the polynomial expansion's kernels on the CPU (see cuda_host.h):
//   expand_main fused b h w lh lw UV UH nv nh tw wr wc < in > out
//   expand_main two b h w lh lw UV UH nv nh thv twv wr twh wc < in > out
//   expand_main smem kind tw wr wc        (a block's shared-memory bytes)
// stdin holds prev and curr (b,h,w) float32, vbase and vidx (ceil(lh/4))
// int32, vtaps (nv,UV,12) float32, hbase and hidx (ceil(lw/4)) int32, htaps
// (nh,UH,12) float32 and ig11, ig03, ig33, ig55; stdout gets R0 then R1
// (b,5,lh,lw).
#include <cstdio>
#include <cstdlib>
#include <cstring>

#include "expand.h"

template <class T>
static bool read(std::vector<T>& v) {
  return fread(v.data(), sizeof(T), v.size(), stdin) == v.size();
}

static size_t smem_of(int kind, int tw, int wr, int wc) {
  return kind == 0 ? fused_smem(wr, wc) : kind == 1 ? vertical_smem(tw, wr)
                                                    : horizontal_smem(wc);
}

int main(int argc, char** argv) {
  if (argc < 2) return 2;
  int a[16] = {0};
  for (int i = 2; i < argc && i < 18; ++i) a[i - 2] = atoi(argv[i]);
  if (!strcmp(argv[1], "smem")) {
    printf("%zu\n", smem_of(a[0], a[1], a[2], a[3]));
    return 0;
  }
  if (argc < 14) return 2;
  const bool fused = !strcmp(argv[1], "fused");
  const int b = a[0], h = a[1], w = a[2], lh = a[3], lw = a[4];
  const int UV = a[5], UH = a[6], nv = a[7], nh = a[8];
  const int ngv = (lh + 3) / 4, ngh = (lw + 3) / 4;
  const size_t nin = (size_t)b * h * w, nout = (size_t)b * 5 * lh * lw;
  std::vector<float> prev(nin), curr(nin), vtaps((size_t)nv * UV * 12),
      htaps((size_t)nh * UH * 12), ig(4), R0(nout, std::nanf("")), R1(nout, std::nanf(""));
  std::vector<int> vbase(ngv), vidx(ngv), hbase(ngh), hidx(ngh);
  if (!read(prev) || !read(curr) || !read(vbase) || !read(vidx) || !read(vtaps) ||
      !read(hbase) || !read(hidx) || !read(htaps) || !read(ig))
    return 3;
  const float *p = prev.data(), *c = curr.data(), *vt = vtaps.data(), *ht = htaps.data();
  const int *vb = vbase.data(), *vi = vidx.data(), *hb = hbase.data(), *hi = hidx.data();
  float *r0 = R0.data(), *r1 = R1.data();
  if (fused) {
    const int tw = a[9], wr = a[10], wc = a[11];
    launch((lw + tw - 1) / tw, (lh + kRows - 1) / kRows, 2 * b, kThreads,
           fused_smem(wr, wc), [&] {
             expand_fused_kernel(p, c, r0, r1, b, h, w, lh, lw, vb, vi, vt, ngv, UV, hb, hi,
                                 ht, ngh, UH, ig[0], ig[1], ig[2], ig[3], tw, wr, wc);
           });
  } else {
    const int thv = a[9], twv = a[10], wr = a[11], twh = a[12], wc = a[13];
    std::vector<float> t((size_t)2 * b * 3 * lh * w, std::nanf(""));
    float* tb = t.data();
    launch((w + twv - 1) / twv, (lh + thv - 1) / thv, 2 * b, kThreads,
           vertical_smem(twv, wr), [&] {
             expand_vertical_kernel(p, c, tb, b, h, w, lh, vb, vi, vt, ngv, UV, thv, twv, wr);
           });
    launch((lw + twh - 1) / twh, (lh + kRows - 1) / kRows, 2 * b, kThreads,
           horizontal_smem(wc), [&] {
             expand_horizontal_kernel(tb, r0, r1, b, w, lh, lw, hb, hi, ht, ngh, UH, ig[0],
                                      ig[1], ig[2], ig[3], twh, wc);
           });
  }
  fwrite(R0.data(), 4, nout, stdout);
  fwrite(R1.data(), 4, nout, stdout);
  return 0;
}
