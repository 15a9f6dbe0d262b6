"""The RAFT lookup's gather kernel, compiled for the host and run on the CPU,
against the plain version (``raft_lookup.lookup_ref``: ``grid_sample`` with
``align_corners=True`` on one-channel maps, zeros outside, the levels
concatenated and moved to channels).

``mav_detection_tpu_torch/csrc/raft_lookup.cu`` runs only on the card
(``tests/test_torch_cuda_kernels.py``, marker ``cuda``). Here its device
part is compiled as C++ by g++ over ``tests/cuda_host/cuda_host.h`` (one
host thread per CUDA thread, the warp's shuffles and barrier, the window's
cp.async copies landing at their wait in one binary and when started in
the other, which must give the same bits) and run on
small seeded pyramids from ``build_corr_pyramid``: b = 1 to 3, odd grids,
four levels down to 1x1, maps one pixel high or wide (sampled through their
zero border), coordinates on whole pixels (where the sampler's round trip
can move a tap's floor), on half pixels, near and beyond the border, far
outside and not finite. The kernel repeats the card's float32 arithmetic
(the normalisation by a reciprocal, fused multiply-adds); the CPU's plain
version divides and sums without fusing, so a tap's source index may differ
by an ulp, under 2^-19 at the tests' indices (below 32), which moves the tap
by that share of the difference of two entries, at most twice the volume's
largest magnitude: held within ``TOL`` = 4e-6 of that magnitude (the
largest seen, 1.2e-6). Taps read from the wrong window, order, level or
border are off by the volume's scale.
"""
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from cuda_host_build import build_host, host_source

from mav_detection_tpu_torch.models import raft as R
from mav_detection_tpu_torch.models import raft_lookup as rl

SOURCE = Path(rl.__file__).resolve().parents[1] / "csrc" / "raft_lookup.cu"
TOL = 4e-6


ASYNC_COPY = {"cp_async4": "async_copy(dst, src, 1);",
              "cp_async_commit": "async_commit();",
              "cp_async_wait_all": "async_wait(0);"}


@pytest.fixture(scope="module")
def host_binary(tmp_path_factory):
    """The kernel built for the host, one binary per ``LANDING`` of the
    window's cp.async copies (at their wait, when started)."""
    src = host_source(SOURCE, ASYNC_COPY,
                      {"extern __shared__ float smem[];": "float* smem = g_smem;"})
    return build_host(tmp_path_factory.mktemp("lookup_host"), "lookup.h", src,
                      "lookup_main.cpp")


def _pyramid(b, h, w, th, tw, levels, seed):
    g = torch.Generator().manual_seed(seed)
    return R.build_corr_pyramid(torch.randn(b, h, w, th, tw, generator=g) * 3, levels)


def _run(binaries, pyramid, coords):
    """The kernel's taps, the same bits from both binaries."""
    b, _, h, w = coords.shape
    shapes = [int(s) for v in pyramid for s in v.shape[3:]]
    stdin = coords.contiguous().numpy().tobytes() + b"".join(
        v.contiguous().numpy().tobytes() for v in pyramid)
    taps = []
    for binary in binaries.values():
        res = subprocess.run([str(binary), *map(str, (b, h, w, len(pyramid), *shapes))],
                             input=stdin, capture_output=True, check=True, timeout=600)
        taps.append(np.frombuffer(res.stdout, np.float32).reshape(b, 81 * len(pyramid), h, w))
    assert all(np.array_equal(t, taps[0]) for t in taps[1:])
    return torch.from_numpy(taps[0].copy())


def _check(binary, pyramid, coords):
    got = _run(binary, pyramid, coords)
    want = rl.lookup_ref(pyramid, coords, 4)
    assert got.shape == want.shape
    scale = float(max(v.abs().max() for v in pyramid))
    err = float((got - want).abs().max())
    assert err <= TOL * scale, (err, scale)
    return got, want


def _coords(b, h, w, seed, spread):
    g = torch.Generator().manual_seed(seed)
    return R.coords_grid(b, h, w, "cpu") + torch.randn(b, 2, h, w, generator=g) * spread


@pytest.mark.parametrize("b,h,w,th,tw,levels", [
    (1, 5, 7, 8, 12, 4),      # b = 1, odd grid, four levels down to 1x1
    (2, 3, 5, 9, 11, 4),      # odd maps: 9x11, 4x5, 2x2, 1x1
    (3, 4, 3, 12, 10, 3),     # b = 3, three levels
    (2, 5, 4, 2, 9, 2),       # level 1 one pixel high (1x4)
    (2, 3, 5, 11, 3, 2),      # level 1 one pixel wide (5x1)
    (1, 6, 5, 1, 7, 1),       # a single level one pixel high
])
def test_taps_match_the_plain_version(host_binary, b, h, w, th, tw, levels):
    pyr = _pyramid(b, h, w, th, tw, levels, seed=b * 100 + th * 10 + tw)
    _check(host_binary, pyr, _coords(b, h, w, seed=th + tw, spread=4))


def test_whole_and_half_pixel_coordinates(host_binary):
    """Whole pixels (the first iteration's coordinates, whose round trip
    through the normalisation can come back a few ulps under the pixel),
    half pixels, and quarter pixels near the border, at every level."""
    b, h, w = 2, 5, 7
    pyr = _pyramid(b, h, w, 8, 12, 4, seed=3)
    base = R.coords_grid(b, h, w, "cpu")
    for shift in (0.0, 0.5, -0.5, 0.25, 7.75, -3.5):
        got, want = _check(host_binary, pyr, base + shift)
    # on whole pixels the centre tap of level 0 is the map's entry, but for
    # the round trip's last bits
    got, _ = _check(host_binary, pyr, base)
    ys, xs = torch.meshgrid(torch.arange(h), torch.arange(w), indexing="ij")
    centre = pyr[0][:, ys, xs, ys, xs]
    scale = float(pyr[0].abs().max())
    assert torch.allclose(got[:, 40], centre, rtol=0, atol=TOL * scale)


def test_far_outside_and_non_finite_coordinates(host_binary):
    """Coordinates far outside every level and one offset short of the map
    read 0 at every tap, as the sampler's zeros do; so do coordinates that
    are not finite (ATen's CUDA sampler sends them outside; the CPU's
    ``grid_sample`` is not asked)."""
    b, h, w = 2, 4, 5
    pyr = _pyramid(b, h, w, 8, 12, 4, seed=9)
    coords = _coords(b, h, w, seed=1, spread=3)
    coords[0, 0, 0, 0] = 1e4
    coords[0, 1, 1, 2] = -1e6
    coords[1, 0, 2, 1] = -14.0          # one offset short of the map at level 0
    got, want = _check(host_binary, pyr, coords)
    assert torch.equal(got[0, :, 0, 0], torch.zeros(324))
    assert torch.equal(got[0, :, 1, 2], torch.zeros(324))
    assert torch.equal(got[1, :81, 2, 1], torch.zeros(81))
    for bad in (float("nan"), float("inf"), -float("inf"), 3.0e38, -3.0e38):
        c = coords.clone()
        c[1, 0, 0, 0] = bad
        c[1, 1, 3, 4] = bad
        taps = _run(host_binary, pyr, c)
        assert torch.equal(taps[1, :, 0, 0], torch.zeros(324)), bad
        assert torch.equal(taps[1, :, 3, 4], torch.zeros(324)), bad
        assert torch.equal(taps[0], got[0]) and torch.equal(taps[1, :, 1], got[1, :, 1])


def test_tap_order_and_zero_border(host_binary):
    """On a volume whose entry at (ty, tx) is 1 + tx + 100 ty: tap i * 9 + j
    reads x + d_i, y + d_j (the x offset slowest), 0 outside the map."""
    th, tw = 6, 7
    ty, tx = torch.meshgrid(torch.arange(th), torch.arange(tw), indexing="ij")
    vol = (1 + tx + 100 * ty).to(torch.float32).view(1, 1, 1, th, tw)
    coords = torch.tensor([2.0, 3.0]).view(1, 2, 1, 1)
    got, _ = _check(host_binary, [vol], coords)
    d = range(-4, 5)
    want = [1 + (2 + dx) + 100 * (3 + dy) if 0 <= 2 + dx < tw and 0 <= 3 + dy < th else 0
            for dx in d for dy in d]
    assert got.view(81).tolist() == pytest.approx(want, rel=0, abs=TOL * 507)


def test_smem_and_plan(host_binary):
    """The plan at the product's shape (b=8, 60x94 at 1/8 of 752x480, four
    levels) and a tiny one, with the source's own shared memory a block."""
    smem = int(subprocess.run([str(host_binary["at_wait"]), "smem"], capture_output=True,
                              check=True, text=True).stdout)
    assert rl.plan(8, 60, 94, 4) == rl.Plan(blocks=705, levels=4, smem=smem)
    assert smem == 2 * 11 * 11 * 33 * 4
    assert rl.plan(1, 3, 5, 2) == rl.Plan(1, 2, smem)


def test_bytes_and_bound():
    """At the product's shape: 10 rows of 40 B a pixel and level (7 at 7x11)
    at 2.125 sectors a row, the taps and the coordinates; bytes bound."""
    shapes = [(60, 94), (30, 47), (15, 23), (7, 11)]
    npix = 8 * 60 * 94
    assert rl.lookup_bytes(8, 60, 94, shapes) == round(npix * (37 * 2.125 * 32 + 324 * 4 + 8))
    ms, by = rl.lookup_bound(8, 60, 94, shapes)
    assert by == "bytes" and abs(ms - rl.lookup_bytes(8, 60, 94, shapes) / 3.35e9) < 1e-12
    assert rl.lookup_bytes(1, 1, 1, [(1, 1)]) == round(32 + 324 + 8)


def test_cpu_tensors_take_the_plain_version():
    """Off the card ``lookup_corr_all_pairs`` is ``lookup_ref``, and so is
    the name ``models.raft`` keeps; ``lookup_cuda`` refuses CPU tensors, and
    any radius but the published one before it looks at a tensor."""
    pyr = _pyramid(2, 3, 4, 8, 12, 4, seed=2)
    coords = _coords(2, 3, 4, seed=2, spread=2)
    want = rl.lookup_ref(pyr, coords, 4)
    assert R.lookup_corr_all_pairs is rl.lookup_corr_all_pairs
    assert torch.equal(rl.lookup_corr_all_pairs(pyr, coords, 4), want)
    assert rl.lookup_corr_all_pairs(pyr, coords, 3).shape == (2, 4 * 49, 3, 4)
    with pytest.raises(ValueError, match="coords must be a contiguous torch.float32 CUDA"):
        rl.lookup_cuda(pyr, coords, 4)
    with pytest.raises(ValueError, match="radius 4"):
        rl.lookup_cuda(pyr, coords, 3)
    with pytest.raises(ValueError, match="1 to 4 levels"):
        rl.lookup_cuda(pyr + pyr[-1:], coords, 4)
