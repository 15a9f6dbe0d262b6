"""The polynomial expansion's band kernel, compiled for the host and run on
the CPU, against ``poly_exp_pyr_cf``'s plain version (the two matmuls).

``mav_detection_tpu_torch/csrc/farneback_expand.cu`` runs only on the card
(``tests/test_torch_cuda_kernels.py``, marker ``cuda``). Here its device
part is compiled as C++ by g++ over ``tests/cuda_host/cuda_host.h`` (one
host thread per CUDA thread, barriers, cp.async as queued copies landing at
their wait or when started) and run on small seeded frames: the fused
route and the two-pass route, at the pyramid's scales 1, 1/2 and 1/4, odd
sizes, b = 1 to 3, both frames of each pair in one launch. The launch plan
is checked on the product's layers, with the source's own shared-memory
count (``expand_main smem``). The kernel
sums the band's products in another order than the matmuls, so it is held
within 1e-5 of the coefficients' scale, as the matmuls are held to XLA's
(``tests/test_torch_farneback.py``). The band layout itself is checked bit
for bit: scattered back, the bands give the dense matrices.
"""
import functools
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from cuda_host_build import LANDING, build_host, host_source

from mav_detection_tpu_torch.ops.flow import farneback as tf
from mav_detection_tpu_torch.ops.flow import farneback_expand as fe

SOURCE = Path(fe.__file__).resolve().parents[2] / "csrc" / "farneback_expand.cu"
ASYNC_COPY = {"cp_async4": "async_copy(dst, src, 1);",
              "cp_async_commit": "async_commit();",
              "cp_async_wait_all": "async_wait(0);",
              "cp_async_bulk_store": "bulk_copy(dst, src, bytes);",
              "cp_async_bulk_commit": "bulk_commit();",
              "cp_async_bulk_wait_read0": "bulk_wait_read(0);",
              "cp_async_fence_proxy": ""}
TOL = 1e-5


@pytest.fixture(scope="module")
def host_binaries(tmp_path_factory):
    """The kernels built for the host, one binary per ``LANDING``."""
    src = host_source(SOURCE, ASYNC_COPY,
                      {"extern __shared__ float smem[];": "float* smem = g_smem;"})
    return build_host(tmp_path_factory.mktemp("expand_host"), "expand.h", src,
                      "expand_main.cpp")


@pytest.fixture(scope="module")
def host_smem(host_binaries):
    """The CUDA source's shared-memory bytes of a block (``fe.plan``'s
    ``smem``), from the host build."""
    binary = str(host_binaries["at_wait"])

    @functools.lru_cache(maxsize=None)
    def smem(kind, tw, wr, wc):
        return int(subprocess.run([binary, "smem", *map(str, (kind, tw, wr, wc))],
                                  capture_output=True, check=True, text=True).stdout)
    return smem


def _plan(args, b, smem):
    """``fe.plan`` of the layer ``args`` for the b pairs' 2b frames."""
    h, w, lh, lw = args[:4]
    return fe.plan(tf._expand_bands_np(*args), 2 * b, h, w, lh, lw, smem)


def _layer_args(h, w, scale):
    """``_poly_pyr_mats_np``'s arguments for the layer at ``scale``, with the
    smoothing ``_farneback_cf`` uses there."""
    sigma = (1.0 / scale - 1.0) * 0.5
    smooth = tf._gaussian_kernel(max(int(round(sigma * 5)) | 1, 3), sigma)
    return (h, w, int(round(h * scale)), int(round(w * scale)), smooth, 8, 1.2)


def _frames(b, h, w, seed):
    rng = np.random.default_rng(seed)
    return [(rng.random((b, h, w)) * 255).astype(np.float32) for _ in range(2)]


def _run(binary, b, args, launches, seed=0):
    h, w, lh, lw = args[:4]
    bands = tf._expand_bands_np(*args)
    *_, ig11, ig03, ig33, ig55 = tf._poly_exp_moments(8, 1.2)
    prev, curr = _frames(b, h, w, seed)
    stdin = b"".join(np.ascontiguousarray(a).tobytes() for a in (
        prev, curr, *bands[:6], np.array([ig11, ig03, ig33, ig55], np.float32)))
    if len(launches) == 1:
        (k,) = launches
        route = ["fused", k.tw, k.wr, k.wc]
    else:
        v, hz = launches
        route = ["two", v.th, v.tw, v.wr, hz.tw, hz.wc]
    argv = [route[0], b, h, w, lh, lw, bands.vtaps.shape[1], bands.htaps.shape[1],
            len(bands.vtaps), len(bands.htaps), *route[1:]]
    res = subprocess.run([str(binary), *map(str, argv)],
                         input=stdin, capture_output=True, check=True, timeout=600)
    out = np.frombuffer(res.stdout, np.float32).reshape(2, b, 5, lh, lw)
    for got, frame in zip(out, (prev, curr)):
        want = tf.poly_exp_pyr_cf(torch.from_numpy(frame), args[4], lh, lw, 8, 1.2).numpy()
        assert np.isfinite(got).all()
        assert np.abs(got - want).max() <= TOL * np.abs(want).max()


@pytest.mark.parametrize("landing", sorted(LANDING))
@pytest.mark.parametrize("b,h,w,scale", [
    (1, 40, 56, 1.0),       # both frames of a pair in one launch (bulk copies out)
    (3, 37, 53, 1.0),       # odd sizes, b = 3
    (1, 45, 67, 0.5),       # scale 1/2: 38-tap bands, odd layer
    (3, 36, 52, 0.5),
    (1, 72, 100, 0.25),     # scale 1/4: 80-tap bands over the whole frame
])
def test_fused_route_on_the_host(host_binaries, host_smem, landing, b, h, w, scale):
    args = _layer_args(h, w, scale)
    launches = _plan(args, b, host_smem)
    assert [k.kernel for k in launches] == ["farneback_expand_fused"]
    _run(host_binaries[landing], b, args, launches)


@pytest.mark.parametrize("landing", sorted(LANDING))
@pytest.mark.parametrize("b,h,w,scale,tv,twh", [
    (1, 72, 100, 0.25, (16, 32), 32),
    (3, 37, 53, 1.0, (32, 64), 32),    # odd w: a last quad past w
    (1, 45, 67, 0.5, (16, 64), 64),
    (2, 64, 96, 0.5, (32, 32), 32),    # lw = 48: rows out as bulk copies
])
def test_two_pass_route_on_the_host(host_binaries, host_smem, landing, b, h, w, scale,
                                    tv, twh):
    """The vertical launch into device memory, then the horizontal one, on
    tiles given here (the plan takes this route where a fused tile would not
    fit two blocks an SM: the coarse layers of large frames)."""
    args = _layer_args(h, w, scale)
    bands = tf._expand_bands_np(*args)
    v = fe._vertical(bands, 2 * b, args[2], w, *tv, host_smem)
    hz = fe._horizontal(bands, 2 * b, args[2], args[3], twh, host_smem)
    _run(host_binaries[landing], b, args, (v, hz))


@pytest.mark.parametrize("w", [70, 72])
@pytest.mark.parametrize("tw", [32, 128, 256])
def test_fused_tiles_on_the_host(host_binaries, host_smem, tw, w):
    """Fused tiles other than the plan's: several column tiles with ragged
    edges, one staging round and several; rows out as stores (w = 70) and
    as bulk copies (72, rows 16-byte aligned)."""
    args = _layer_args(50, w, 1.0)
    launch = fe._fused(tf._expand_bands_np(*args), 4, 50, w, tw, host_smem)
    _run(host_binaries["at_wait"], 2, args, (launch,), seed=1)


def _dense_from_band(start, taps, m):
    """The (n, m) matrix whose row i holds taps[i] from column start[i] on."""
    n, K = taps.shape
    M = np.zeros((n, m), np.float32)
    np.put_along_axis(M, start[:, None] + np.arange(K)[None, :], taps, axis=1)
    return M


def _dense_from_groups(base, index, table, n, m):
    """The (3 n, m) matrix of ``group_band``'s layout."""
    U = table.shape[1]
    g = table.reshape(len(table), U, fe.GROUP, 3)
    M = np.zeros((3 * n, m), np.float32)
    for i in range(n):
        cols = base[i // fe.GROUP] + np.arange(U)
        for k in range(3):
            M[k * n + i, cols] = g[index[i // fe.GROUP], :, i % fe.GROUP, k]
    return M


@pytest.mark.parametrize("h,w,scale", [
    (480, 752, 1.0), (480, 752, 0.5), (480, 752, 0.25), (1024, 1920, 0.25),
    (37, 53, 0.5), (45, 67, 0.25)])
def test_bands_scatter_back_to_the_dense_matrices(h, w, scale):
    """The compact bands and the kernel's groups of four, scattered back to
    dense, are ``_poly_pyr_mats_np``'s V and Hm bit for bit; equal groups
    share one entry of the tap table (seven at most on these layers: three
    edge groups at each side and the interior's)."""
    args = _layer_args(h, w, scale)
    V, Hm = tf._poly_pyr_mats_np(*args)
    sv, tv = fe.compact_band(V)
    sh, th = fe.compact_band(Hm.T)
    assert np.array_equal(_dense_from_band(sv, tv, h), V)
    assert np.array_equal(_dense_from_band(sh, th, w).T, Hm)
    b = tf._expand_bands_np(*args)
    for base, index, table, M, n, m in ((b.vbase, b.vidx, b.vtaps, V, args[2], h),
                                        (b.hbase, b.hidx, b.htaps, Hm.T, args[3], w)):
        U = table.shape[1]
        assert base.min() >= 0 and base.max() + U <= m and np.all(np.diff(base) >= 0)
        assert np.array_equal(_dense_from_groups(base, index, table, n, m), M)
        assert len(table) == len(np.unique(table, axis=0)) <= 7
    assert (b.Kv, b.Kh) == (tv.shape[1], th.shape[1])


@pytest.mark.parametrize("h,w,b,routes", [
    (480, 752, 8, ("fused 16x192", "fused 16x64", "vertical 32x128 + horizontal 16x64")),
    (1024, 1920, 8, ("fused 16x192", "fused 16x64", "vertical 32x128 + horizontal 16x64")),
    (480, 752, 1, ("fused 16x192", "fused 16x64", "vertical 32x128 + horizontal 16x64")),
    (96, 128, 2, ("fused 16x192", "fused 16x192", "fused 16x192"))])
def test_plan_per_layer(host_smem, h, w, b, routes):
    """The product's three layers by the plan's one rule: fused on the
    widest tile whose block fits two an SM, two passes at scale 1/4 of the
    large frames (80-tap bands: no fused tile fits); every block within the
    shared memory a block may have, two an SM on these layers."""
    params = tf.tuned_flow_params(h, w)
    got = []
    for scale in tf._pyramid_scales(h, w, params):
        launches = _plan(_layer_args(h, w, scale), b, host_smem)
        got.append(" + ".join(f"{k.kernel.split('_')[-1]} {k.th}x{k.tw}" for k in launches))
        for k in launches:
            assert k.blocks >= 1 and k.tw in fe.COLS
            assert k.smem <= fe.TWO_BLOCKS_SMEM
    assert tuple(got) == routes
