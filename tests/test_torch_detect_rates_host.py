"""The detection step's rates kernel, compiled for the host and run on the
CPU, against the plain version (``detect_rates.rates_ref``: ``_tpr_fpr`` on
both masks and the sky, ``masked_mean_flow`` over the derotated GT flow, the
device box and ``center_phi``).

``mav_detection_tpu_torch/csrc/detect_rates.cu`` runs only on the card
(``tests/test_torch_cuda_kernels.py``, marker ``cuda``). Here its device
part is compiled as C++ by g++ over ``tests/cuda_host/cuda_host.h`` (one
host thread per CUDA thread, barriers) and run on small seeded frames: b = 1
to 3, odd sizes, several blocks a frame, segmentation values on both sides
of upstream's integer-product thresholds, an empty drone and empty classes
(NaN), all sky, zero and NaN depth, depth expanded over the batch (batch
stride 0), a NaN GT FoE and non-zero IMU rates. Counts and the rates made
of them are exact; the drone's mean flow (summed in double by the kernel,
in float32 by the plain version) within 1e-6 of the derotated flow's scale;
``center_phi`` within 1e-6 relative (the host's atan2f and torch's differ
in the last bits).
"""
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from cuda_host_build import build_host, host_source

from mav_detection_tpu_torch.ops.geometry.derotation import derotate
from mav_detection_tpu_torch.ops.image import detect_rates as dr

SOURCE = Path(dr.__file__).resolve().parents[2] / "csrc" / "detect_rates.cu"
FLOW_TOL = 1e-6
PHI_RTOL = 1e-6


@pytest.fixture(scope="module")
def host_binary(tmp_path_factory):
    src = host_source(SOURCE, {}, {"extern __shared__ float smem[];": "float* smem = g_smem;"})
    return build_host(tmp_path_factory.mktemp("rates_host"), "rates.h", src,
                      "rates_main.cpp")["at_wait"]


def _inputs(n, h, w, seed, seg_values=(0, 256), drone=0.3, shared_depth=False):
    """Seeded frames: segmentation drawn from ``seg_values`` on a ``drone``
    share of the pixels (0 elsewhere), random masks and sky, a depth ramp
    with noise, GT flow, IMU rates, dt and GT FoE."""
    rng = np.random.default_rng(seed)
    lo, hi = seg_values
    seg = np.where(rng.random((n, h, w)) < drone,
                   rng.integers(lo, hi, (n, h, w)), 0).astype(np.uint8)
    total, fixed, sky = (rng.random((n, h, w)) < p for p in (0.2, 0.35, 0.4))
    ramp = np.linspace(1.0, 100.0, h, dtype=np.float32)[:, None]
    dshape = (h, w) if shared_depth else (n, h, w)
    depth = (ramp + rng.random(dshape) * 20).astype(np.float32)
    flow = (rng.standard_normal((n, h, w, 2)) * 3).astype(np.float32)
    omega = (rng.standard_normal((n, 3)) * 0.2).astype(np.float32)
    dt = rng.uniform(0.02, 0.1, n).astype(np.float32)
    foe = np.stack([rng.uniform(0, w, n), rng.uniform(0, h, n)], -1).astype(np.float32)
    return dict(seg=seg, total=total, fixed=fixed, sky=sky, depth=depth, flow=flow,
                omega=omega, dt=dt, foe=foe)


def _run(binary, x, nbp, items):
    n, h, w = x["seg"].shape
    hw = h * w
    depth_bs = 0 if x["depth"].ndim == 2 else hw
    argv = [n, h, w, nbp, items, hw, hw, hw, hw, depth_bs, 2 * hw]
    stdin = b"".join(np.ascontiguousarray(x[k]).tobytes() for k in (
        "seg", "total", "fixed", "sky", "depth", "flow", "omega", "dt", "foe"))
    res = subprocess.run([str(binary), *map(str, argv)], input=stdin,
                         capture_output=True, check=True, timeout=600)
    out = np.frombuffer(res.stdout[:36 * n], np.float32)
    size = np.frombuffer(res.stdout[36 * n:], np.int64)
    return dr.Rates(*(out[i * n:(i + 1) * n] for i in range(6)), size,
                    out[7 * n:].reshape(n, 2), out[6 * n:7 * n])


def _reference(x):
    n, h, w = x["seg"].shape
    t = {k: torch.from_numpy(v) for k, v in x.items()}
    depth = t["depth"].expand(n, h, w)
    return dr.rates_ref(t["seg"], t["total"], t["fixed"], t["sky"], depth, t["flow"],
                        t["omega"], t["dt"], t["foe"]), t


def _check(binary, x, nbp, items):
    got = _run(binary, x, nbp, items)
    want, t = _reference(x)
    for k in ("tpr", "fpr", "tpr_fixed", "fpr_fixed", "sky_tpr", "sky_fpr"):
        assert np.array_equal(getattr(got, k), getattr(want, k).numpy(), equal_nan=True), k
    assert np.array_equal(got.drone_size_pixels, want.drone_size_pixels.numpy())
    wf = want.drone_flow_pixels.numpy()
    scale = derotate(t["flow"], t["omega"], t["dt"]).abs().amax(dim=(1, 2, 3)).numpy()
    assert np.array_equal(np.isnan(got.drone_flow_pixels), np.isnan(wf))
    err = np.nan_to_num(np.abs(got.drone_flow_pixels - wf)).max(axis=1)
    assert np.all(err <= FLOW_TOL * scale), (err, scale)
    np.testing.assert_allclose(got.center_phi, want.center_phi.numpy(), rtol=PHI_RTOL,
                               atol=0, equal_nan=True)
    return got


@pytest.mark.parametrize("n,h,w,nbp,items", [
    (1, 40, 56, 1, 1),        # b = 1, one pre-pass block, many count blocks
    (3, 37, 53, 3, 2),        # odd sizes, runs that end inside a row
    (2, 19, 23, 2, 64),       # one count block a frame, most of it idle
    (3, 50, 301, 5, 3),       # rows wider than a block's run of 256 pixels
    (2, 301, 7, 256, 1),      # rows narrower: a run crosses many rows
])
def test_counts_match_the_plain_version(host_binary, n, h, w, nbp, items):
    _check(host_binary, _inputs(n, h, w, seed=h * w + n), nbp, items)


@pytest.mark.parametrize("seg_values", [(1, 128), (128, 255), (254, 256), (0, 2)])
def test_integer_product_thresholds(host_binary, seg_values):
    """Values 1-127 are no drone but count as true positives of a mask (255
    seg mask > 127 for seg >= 1); 128-254 are drone and still false
    positives ((255 - seg) 255 mask > 127 for seg <= 254); 255 is never a
    false positive, 0 never a true one. With no drone pixel but true
    positives, the TPR is upstream's tp / 0: infinite."""
    got = _check(host_binary, _inputs(2, 33, 45, seed=7, seg_values=seg_values, drone=0.6),
                 3, 2)
    if seg_values == (1, 128):
        assert np.all(got.drone_size_pixels == 0) and np.all(np.isposinf(got.tpr))


def test_empty_drone_and_empty_classes(host_binary):
    """No drone (segmentation all 0): NaN TPRs and mean flow, size 0, the
    box's -1s in center_phi; all 255: NaN FPRs (no negative pixel)."""
    x = _inputs(2, 29, 31, seed=3)
    x["seg"][0] = 0
    x["seg"][1] = 255
    got = _check(host_binary, x, 2, 1)
    assert np.isnan(got.tpr[0]) and np.isnan(got.tpr_fixed[0]) and got.drone_size_pixels[0] == 0
    assert np.all(np.isnan(got.drone_flow_pixels[0]))
    assert np.isnan(got.fpr[1]) and np.isnan(got.fpr_fixed[1])
    assert got.drone_size_pixels[1] == 29 * 31


@pytest.mark.parametrize("case", ["all_sky", "zero_depth", "nan_depth", "shared_depth"])
def test_sky_rates(host_binary, case):
    """All sky (constant depth: every pixel above 0.8 of the max; the sky
    FPR has no negative pixel), zero depth (none above: the sky TPR has no
    positive pixel), one NaN in depth (torch's max keeps it: no pixel
    above), and one depth frame expanded over the batch (batch stride 0)."""
    x = _inputs(3, 31, 37, seed=11, shared_depth=case == "shared_depth")
    if case == "all_sky":
        x["depth"][:] = 42.0
        x["sky"][:] = True
    elif case == "zero_depth":
        x["depth"][:] = 0.0
    elif case == "nan_depth":
        x["depth"][1, 5, 7] = np.nan
    got = _check(host_binary, x, 3, 1)
    if case == "all_sky":
        assert np.all(got.sky_tpr == 1) and np.all(np.isnan(got.sky_fpr))
    elif case == "zero_depth":
        assert np.all(np.isnan(got.sky_tpr))
    elif case == "nan_depth":
        assert np.isnan(got.sky_tpr[1]) and not np.isnan(got.sky_tpr[0])


def test_nan_gt_foe_and_rates(host_binary):
    """A NaN GT FoE gives a NaN center_phi; zero IMU rates leave the GT flow
    as it is, large ones move the drone's mean."""
    x = _inputs(3, 27, 35, seed=5)
    x["foe"][1] = np.nan
    x["omega"][0] = 0.0
    x["omega"][2] *= 25
    got = _check(host_binary, x, 2, 2)
    assert np.isnan(got.center_phi[1]) and not np.isnan(got.center_phi[0])


@pytest.mark.parametrize("n,h,w,sms,want", [
    (8, 480, 752, 132, (132, 11, 129)),
    (8, 1024, 1920, 132, (132, 59, 131)),
    (1, 480, 752, 132, (256, 4, 353)),
    (1, 9, 9, 132, (1, 4, 1)),
])
def test_plan(n, h, w, sms, want):
    """About a wave of pre-pass blocks (at most 256 a frame) and of count
    blocks (4 to 64 pixels a thread), at the product's shapes and a tiny
    one."""
    p = dr.plan(n, h, w, sms)
    assert tuple(p) == want
    assert p.blocks * dr.THREADS * p.items >= h * w > (p.blocks - 1) * dr.THREADS * p.items


def test_bytes_and_bound():
    """16 B a pixel (12 where one depth frame serves the batch); bytes bound
    by far at the product's shape."""
    assert dr.rates_bytes(8, 480, 752) == 16 * 8 * 480 * 752 + 8 * 44
    assert dr.rates_bytes(8, 480, 752, depth_frames=1) == (12 * 8 + 4) * 480 * 752 + 8 * 44
    ms, by = dr.rates_bound(8, 480, 752)
    assert by == "bytes" and abs(ms - dr.rates_bytes(8, 480, 752) / 3.35e9) < 1e-12


def test_cpu_tensors_take_the_plain_version():
    """Off the card ``detection_rates`` is ``rates_ref``; ``rates_cuda``
    refuses CPU tensors."""
    want, t = _reference(_inputs(2, 12, 14, seed=1))
    args = (t["seg"], t["total"], t["fixed"], t["sky"], t["depth"], t["flow"], t["omega"],
            t["dt"], t["foe"])
    got = dr.detection_rates(*args)
    torch.testing.assert_close(tuple(got), tuple(want), rtol=0, atol=0, equal_nan=True)
    with pytest.raises(ValueError, match="segmentation must be a torch.uint8 CUDA tensor"):
        dr.rates_cuda(*args)
