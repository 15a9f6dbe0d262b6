// Runs the RAFT lookup's kernel on the CPU (see cuda_host.h):
//   lookup_main b h w levels th0 tw0 [th1 tw1 ...] < in > out
//   lookup_main smem                      (a block's shared-memory bytes)
// stdin holds coords (b, 2, h, w) float32, then each level's volume
// (b h w, th, tw) float32; stdout gets the taps (b, levels 81, h, w)
// float32.
#include <cstdio>
#include <cstdlib>
#include <cstring>

#include "lookup.h"

template <class T>
static bool read(std::vector<T>& v) {
  return fread(v.data(), sizeof(T), v.size(), stdin) == v.size();
}

int main(int argc, char** argv) {
  if (argc == 2 && !strcmp(argv[1], "smem")) {
    printf("%zu\n", lookup_smem());
    return 0;
  }
  if (argc < 5) return 2;
  const int b = atoi(argv[1]), h = atoi(argv[2]), w = atoi(argv[3]), levels = atoi(argv[4]);
  if (levels < 1 || levels > kMaxLevels || argc != 5 + 2 * levels) return 2;
  const int npix = b * h * w;
  std::vector<float> coords((size_t)npix * 2);
  if (!read(coords)) return 3;
  std::vector<std::vector<float>> vols(levels);
  Pyramid pyr = {};
  for (int l = 0; l < levels; ++l) {
    pyr.th[l] = atoi(argv[5 + 2 * l]);
    pyr.tw[l] = atoi(argv[6 + 2 * l]);
    vols[l].resize((size_t)npix * pyr.th[l] * pyr.tw[l]);
    if (!read(vols[l])) return 3;
    pyr.vol[l] = vols[l].data();
  }
  std::vector<float> out((size_t)npix * levels * kSide * kSide, std::nanf(""));
  launch((npix + kThreads - 1) / kThreads, levels, 1, kThreads, lookup_smem(),
         [&] { lookup_kernel(pyr, coords.data(), npix, h * w, levels, out.data()); });
  fwrite(out.data(), sizeof(float), out.size(), stdout);
  return 0;
}
