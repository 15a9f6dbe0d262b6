"""The solver iteration's CUDA source, compiled for the host and run on the
CPU, against its plain PyTorch version, bit for bit.

``mav_detection_tpu_torch/csrc/farneback_iter.cu`` runs only on the card
(``tests/test_torch_cuda_kernels.py``, marker ``cuda``). Here its device
part is compiled as C++ by g++ over ``tests/cuda_host/cuda_host.h`` (one
host thread per CUDA thread, barriers, warp shuffles, cp.async as queued
copies; ``-ffp-contract=off`` as the card's ``-fmad=false``) and each kernel
is run on small seeded inputs: ``farneback_iterate_fused``'s row-streaming
kernel with m compiled in and at run time, 16- and 4-byte copies, the
global and the per-column cut of rows; its tile design on both tiles. The
row-streaming kernel runs twice, its ring copies landing at their wait and
landing when started: the two ends of the window in which the card may land
them, so that a ring slot read too early or overwritten too soon changes the
result. It checks the
kernels' index logic, ring timing and operation order on every tier-1 run;
the card's memory model beyond that window, speed and the card's own
compiler are the card tests' and ``chip_smoke.py``'s.
"""
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from cuda_host_build import LANDING, build_host, host_source

from mav_detection_tpu_torch.ops.flow import farneback as tf
from mav_detection_tpu_torch.ops.flow import farneback_iter as ti

SOURCE = Path(ti.__file__).resolve().parents[2] / "csrc" / "farneback_iter.cu"
ASYNC_COPY = {"cp_async4": "async_copy(dst, src, 1);",
              "cp_async16": "async_copy(dst, src, 4);",
              "cp_async_commit": "async_commit();",
              "cp_async_wait_prefetch": "async_wait(kPrefetch - 1);"}


@pytest.fixture(scope="module")
def host_binaries(tmp_path_factory):
    """The kernels built for the host, one binary per ``LANDING``."""
    src = host_source(SOURCE, ASYNC_COPY,
                      {"extern __shared__ float smem[];": "float* smem = g_smem;"})
    return build_host(tmp_path_factory.mktemp("cuda_host"), "kernels.h", src, "main.cpp")


def _inputs(b, h, w, seed):
    rng = np.random.default_rng(seed)
    R0 = rng.standard_normal((b, 5, h, w)).astype(np.float32) * 10
    R1 = (R0 + rng.standard_normal((b, 5, h, w))).astype(np.float32)
    flow = (rng.standard_normal((b, 2, h, w)) * 6).astype(np.float32)
    border = (tf.border_scale_map(h, w, "cpu").numpy() if min(h, w) >= 6
              else rng.random((h, w)).astype(np.float32))
    return R0, R1, flow, border


def _run(binary, args, b, h, w, S, win, seed=0):
    R0, R1, flow, border = _inputs(b, h, w, seed)
    stdin = b"".join(a.tobytes() for a in (R0, R1, flow, border,
                                           np.float32(1.0 / (win * win))))
    res = subprocess.run([str(binary), *map(str, args)], input=stdin,
                         capture_output=True, check=True, timeout=600)
    got = torch.from_numpy(np.frombuffer(res.stdout, np.float32).reshape(b, 2, h, w).copy())
    t = [torch.from_numpy(a) for a in (R0, R1, flow, border)]
    want = ti.box_solve_ref(ti.update_matrices_ref(*t, S), win)
    return got, want


@pytest.mark.parametrize("landing", sorted(LANDING))
@pytest.mark.parametrize("b,h,w,S,win,strip,rows,runs_per_col", [
    (1, 24, 32, 8, 12, 32, 24, 0),     # rows 16-byte aligned: 16-byte copies
    (2, 45, 67, 8, 12, 40, 13, 0),     # odd W: 4-byte copies; runs cross columns
    (1, 40, 376, 8, 12, 94, 10, 4),    # four strips, each column in 4 runs
    (2, 33, 96, 16, 9, 48, 7, 0),      # S = 16, m = 4 at run time
    (1, 30, 40, 8, 15, 40, 9, 0),      # m = 7 at run time
    (1, 12, 13, 3, 2, 13, 4, 0),       # m = 1
    (1, 20, 1, 8, 12, 1, 6, 0),        # one column
    (1, 7, 9, 0, 12, 9, 3, 3),         # S = 0, an image shorter than the halo
])
def test_fused_kernel_on_the_host_bit_exact(host_binaries, landing, b, h, w, S, win,
                                            strip, rows, runs_per_col):
    ti.strip_launch_smem(strip, win, S)   # a shape the card takes
    if runs_per_col:
        rows = -(-h // runs_per_col)
    got, want = _run(host_binaries[landing], ["strip", b, h, w, S, win // 2, strip,
                                              rows, runs_per_col], b, h, w, S, win)
    assert torch.equal(got, want)


@pytest.mark.parametrize("b,h,w,S,win,tile", [(1, 45, 67, 8, 12, 0), (2, 40, 70, 8, 9, 1)])
def test_tiled_kernel_on_the_host_bit_exact(host_binaries, b, h, w, S, win, tile):
    got, want = _run(host_binaries["at_wait"], ["tiled", b, h, w, S, win // 2, tile],
                     b, h, w, S, win)
    assert torch.equal(got, want)
