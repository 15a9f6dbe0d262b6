// Runs one kernel of the solver iteration on the CPU (see cuda_host.h):
//   main strip|tiled b H W S m A B C < in.bin > out.bin
// strip: A = strip width, B = rows per run, C = runs per column (0: the
// global cut); tiled: A =
// tile index (0: 32x64, 1: 32x32). stdin holds R0, R1 (b,5,H,W), the flow
// (b,2,H,W), the border (H,W) and 1 / winsize^2 as float32; stdout gets the
// new flow (b,2,H,W).
#include <cstdio>
#include <cstdlib>
#include <cstring>

#include "kernels.h"

int main(int argc, char** argv) {
  if (argc < 8) return 2;
  const bool strip_design = !strcmp(argv[1], "strip");
  const int b = atoi(argv[2]), H = atoi(argv[3]), W = atoi(argv[4]);
  const int S = atoi(argv[5]), m = atoi(argv[6]), A = atoi(argv[7]);
  const size_t n5 = (size_t)b * 5 * H * W, n2 = (size_t)b * 2 * H * W;
  std::vector<float> R0(n5), R1(n5), fl(n2), bor((size_t)H * W), out(n2, std::nanf(""));
  float inv = 0.0f;
  if (fread(R0.data(), 4, n5, stdin) != n5 || fread(R1.data(), 4, n5, stdin) != n5 ||
      fread(fl.data(), 4, n2, stdin) != n2 ||
      fread(bor.data(), 4, (size_t)H * W, stdin) != (size_t)H * W ||
      fread(&inv, 4, 1, stdin) != 1)
    return 3;
  const float *r0 = R0.data(), *r1 = R1.data(), *f = fl.data(), *bd = bor.data();
  float* o = out.data();
  if (strip_design) {
    const int rows = atoi(argv[8]), rpc = atoi(argv[9]);
    const int ns = (W + A - 1) / A, total = b * ns * H;
    const int blocks = rpc > 0 ? b * ns * rpc : (total + rows - 1) / rows;
    const size_t smem = strip::smem_bytes(A, m, S);
    auto run = [&](auto kern) {
      launch(blocks, 1, 1, strip::kThreads, smem, [&] {
        kern(r0, r1, f, bd, o, H, W, S, m, inv, A, ns, rows, rpc, total);
      });
    };
    m == 6 ? run(strip::iterate_strip_kernel<6>) : run(strip::iterate_strip_kernel<-1>);
  } else {
    const int th = 32, tw = A == 0 ? 64 : 32;
    const size_t smem = tiled::smem_bytes(th, tw, m, S);
    auto run = [&](auto kern) {
      launch((W + tw - 1) / tw, (H + th - 1) / th, b, tiled::kThreads, smem,
             [&] { kern(r0, r1, f, bd, o, H, W, S, m, inv); });
    };
    if (A == 0) m == 6 ? run(tiled::iterate_tiled_kernel<32, 64, 6>) : run(tiled::iterate_tiled_kernel<32, 64, -1>);
    else m == 6 ? run(tiled::iterate_tiled_kernel<32, 32, 6>) : run(tiled::iterate_tiled_kernel<32, 32, -1>);
  }
  fwrite(out.data(), 4, n2, stdout);
  return 0;
}
