// Runs one staged probe kernel of csrc/shift_probes.cu on the CPU (see
// cuda_host.h):
//   probes chain AXIS rows cols S < x sy fy > out
//   probes ystage VARIANT bands th tw m S < slab sy fy > out
// stdin holds the inputs as float32 in that order, stdout gets the output,
// stderr "vec=0|1": whether the staging took 16-byte copies. The launch is
// the C interface's: the same Launch helpers and the same alignment test on
// this process's buffers.
#include <cstdio>
#include <cstdlib>
#include <cstring>

#include "probes.h"

static bool read_all(std::vector<float>& v) {
  return fread(v.data(), 4, v.size(), stdin) == v.size();
}

int main(int argc, char** argv) {
  if (argc < 6) return 2;
  std::vector<float> out;
  int vec = 0;
  if (!strcmp(argv[1], "chain")) {
    const int axis = atoi(argv[2]), rows = atoi(argv[3]), cols = atoi(argv[4]);
    const int S = atoi(argv[5]);
    int nr, ldx;
    if (!shift_shape(rows, cols, axis, S, &nr, &ldx)) return 2;
    std::vector<float> x((size_t)nr * ldx), sy(x.size()), fy(x.size());
    if (!read_all(x) || !read_all(sy) || !read_all(fy)) return 3;
    out.assign((size_t)rows * cols, std::nanf(""));
    const Launch L = chain_launch(rows, cols, axis, S);
    const ShiftChainFn fn = pick_chain(axis, S);
    vec = aligned16(x.data(), ldx, 0);
    launch(L.grid.x, L.grid.y, L.grid.z, L.threads, L.smem, [&] {
      fn(x.data(), sy.data(), fy.data(), out.data(), rows, cols, ldx, S, vec);
    });
  } else {
    if (argc < 8) return 2;
    const int variant = atoi(argv[2]), bands = atoi(argv[3]), th = atoi(argv[4]);
    const int tw = atoi(argv[5]), m = atoi(argv[6]), S = atoi(argv[7]);
    const int P = S + 1 + m, sr = th + 2 * P, cw = tw + 2 * P;
    const int mrows = th + 2 * m, acols = tw + 2 * m + 2 * S + 1;
    std::vector<float> slab((size_t)bands * 5 * sr * cw);
    std::vector<float> sy((size_t)bands * mrows * acols), fy(sy.size());
    if (!read_all(slab) || !read_all(sy) || !read_all(fy)) return 3;
    out.assign(sy.size(), std::nanf(""));
    const Launch L = y_stage_launch(bands, mrows, acols, S);
    const YStageFn fn = pick_y_stage(variant, S);
    vec = aligned16(slab.data(), cw, P - m - S - 1);
    launch(L.grid.x, L.grid.y, L.grid.z, L.threads, L.smem, [&] {
      fn(slab.data(), sy.data(), fy.data(), out.data(), mrows, acols, sr, cw,
         P - m, P - m - S, S, L.rows, vec);
    });
  }
  fwrite(out.data(), 4, out.size(), stdout);
  fprintf(stderr, "vec=%d\n", vec);
  return 0;
}
