"""The staged probe kernels' CUDA source, compiled for the host and run on
the CPU, against their plain PyTorch versions, bit for bit.

``mav_detection_tpu_torch/csrc/shift_probes.cu`` runs only on the card
(``tests/test_torch_cuda_kernels.py``, marker ``cuda``, and ``chip_smoke.py``
phase ``probes``). Here its device part is compiled as C++ by g++ over
``tests/cuda_host/cuda_host.h`` (one host thread per CUDA thread, barriers,
cp.async as queued copies, bf16 rounded to nearest even;
``-ffp-contract=off`` as the card's ``-fmad=false``) and the staged kernels
run on small seeded inputs through ``tests/cuda_host/probes_main.cpp``, which
launches them as the C interface does: ``shift_chain`` on both axes at S = 1,
8 (compiled in) and 16 (the run-time-S instance), on and off its tiles, with
16- and 4-byte copies; every ``y_stage`` form on a tile-width remainder, a
geometry narrower than one tile, bands taller than one block, sy in runs
of columns, both copy widths and both instances. Each runs twice, its copies
landing at their wait and landing when started: the two ends of the window
in which the card may land them. It checks the kernels' index logic, copy
timing and operation order on every tier-1 run; the card's compiler, memory
model beyond that window and speed are the card tests' and the chip
script's.
"""
import re
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from cuda_host_build import LANDING, build_host, host_source

from mav_detection_tpu_torch.ops.flow import shift_probes as sp

SOURCE = Path(sp.__file__).resolve().parents[2] / "csrc" / "shift_probes.cu"
ASYNC_COPY = {"cp_async4": "async_copy(dst, src, 1);",
              "cp_async16": "async_copy(dst, src, 4);",
              "cp_async_commit": "async_commit();",
              "cp_async_wait_all": "async_wait(0);"}
SMEM = "extern __shared__ __align__(16) float smem[];"


@pytest.fixture(scope="module")
def probe_binaries(tmp_path_factory):
    """The probes built for the host, one binary per ``LANDING``."""
    src = host_source(SOURCE, ASYNC_COPY, {"#include <cuda_bf16.h>\n": "",
                                           SMEM: "float* smem = g_smem;"})
    return build_host(tmp_path_factory.mktemp("probe_host"), "probes.h", src,
                      "probes_main.cpp")


def _run(binary, args, inputs, shape):
    stdin = b"".join(t.numpy().astype(np.float32).tobytes() for t in inputs)
    res = subprocess.run([str(binary), *map(str, args)], input=stdin,
                         capture_output=True, check=True, timeout=600)
    vec = int(re.search(rb"vec=(\d)", res.stderr).group(1))
    got = torch.from_numpy(np.frombuffer(res.stdout, np.float32).reshape(shape).copy())
    return got, vec


CHAIN_SHAPES = [(37, 45), (70, 64), (13, 131)]   # off the tiles; two row tiles; 16-byte rows


def _chain_vec(rows, cols, S, axis):
    """16-byte copies: x's rows (cols, or cols + 2S + 1 on axis 1) whole chunks."""
    return int(sp.shift_x_shape(rows, cols, S, axis)[1] % 4 == 0)


def test_cases_cover_both_copy_widths():
    for axis in (0, 1):
        assert {_chain_vec(r, c, S, axis) for r, c in CHAIN_SHAPES for S in (1, 8, 16)} == {0, 1}
    assert {_y_vec(sp.YGeometry(S, th, tw, m)) for S, th, tw, m, *_ in Y_CASES} == {0, 1}


@pytest.mark.parametrize("landing", sorted(LANDING))
@pytest.mark.parametrize("rows,cols", CHAIN_SHAPES)
@pytest.mark.parametrize("S", [1, 8, 16])
@pytest.mark.parametrize("axis", [0, 1])
def test_shift_chain_on_the_host_bit_exact(probe_binaries, landing, axis, S, rows, cols):
    x, sy, fy = sp.shift_inputs(np.random.default_rng(7 * S + axis), rows, cols, S, axis)
    got, vec = _run(probe_binaries[landing], ["chain", axis, rows, cols, S],
                    (x, sy, fy), (rows, cols))
    assert vec == _chain_vec(rows, cols, S, axis)
    assert torch.equal(got, sp.shift_chain_ref(x, sy, fy, S, axis))
    assert torch.equal(got, sp.shift_gather_ref(x, sy, fy, S, axis))


def _y_vec(g):
    return int(g.cw % 4 == 0 and (g.o_a - 1) % 4 == 0)


# S, th, tw, m, bands, sy-run
Y_CASES = [
    (1, 5, 37, 3, 2, 1),     # 46 columns: a tile and 14; 11 rows: the last run of 3
    (1, 3, 8, 2, 2, 1),      # 15 columns, narrower than one tile; 16-byte copies
    (8, 24, 40, 6, 2, 1),    # S compiled in, the finest layer's rows; 69 columns
    (8, 24, 40, 5, 1, 4),    # sy in runs of 4 columns; 16-byte copies; 34 rows
    (16, 7, 50, 6, 2, 1),    # the run-time-S instance, 16-byte copies
    (2, 60, 20, 3, 1, 3),    # 66 rows: two blocks down the band; sy in runs of 3
    (8, 24, 752, 6, 1, 32),  # one band of the finest layer, sy in runs of 32
]


@pytest.mark.parametrize("landing", sorted(LANDING))
@pytest.mark.parametrize("S,th,tw,m,bands,sy_run", Y_CASES)
@pytest.mark.parametrize("variant", sp.VARIANTS)
def test_y_stage_on_the_host_bit_exact(probe_binaries, landing, variant, S, th, tw, m,
                                       bands, sy_run):
    g = sp.YGeometry(S, th, tw, m)
    slab, sy, fy = sp.y_stage_inputs(np.random.default_rng(S + th), g, bands)
    if sy_run > 1:   # as the chain probe's --sy-run
        a = torch.arange(g.acols)
        sy = sy[:, :, a - a % sy_run].contiguous()
    got, vec = _run(probe_binaries[landing],
                    ["ystage", sp.VARIANTS.index(variant), bands, th, tw, m, S],
                    (slab, sy, fy), (bands, 1, g.mrows, g.acols))
    assert vec == _y_vec(g)
    want = sp.y_stage_ref(slab, sy, fy, S, m, variant)
    assert torch.equal(got, want)
    if variant in ("B", "T"):
        assert torch.equal(got, sp.y_stage_ref(slab, sy, fy, S, m, "A"))
