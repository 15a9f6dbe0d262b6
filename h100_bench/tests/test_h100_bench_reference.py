"""The frozen reference agrees with the port at a small size on the CPU,
and its control departs from it."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from h100_bench import scene
from h100_bench.reference import detect as ref_detect
from h100_bench.reference import farneback as ref_flow
from mav_detection_tpu_torch.ops.flow.farneback import farneback_flow_batch, tuned_flow_params
from mav_detection_tpu_torch.pipeline.detector import DetectionStep, detect_frame_batch_scalars

FLOW = {"levels": 2, "pyr_scale": 0.5, "winsize": 12, "iterations": 6, "poly_n": 8,
        "poly_sigma": 1.2, "max_shift": 8, "level_iters": [2, 3, 8]}
SCENE = {"height": 64, "width": 96, "horizon": 0.35, "max_flow_px": 3.0,
         "omega_amp": 0.004, "dt": 0.05, "drone_radius": 5.0, "drone_speed_px": 2.0}


@pytest.fixture(scope="module")
def frames():
    return scene.render(SCENE, 5, 123456789012, "cpu")


def test_scene_is_drawn_from_the_seed(frames):
    again = scene.render(SCENE, 5, 123456789012, "cpu")
    other = scene.render(SCENE, 5, 7, "cpu")
    assert torch.equal(frames["gray"], again["gray"])
    assert not torch.equal(frames["gray"], other["gray"])
    assert frames["gray"].dtype == torch.uint8 and frames["bgr"].shape == (5, 64, 96, 3)
    assert frames["seg"].max() == 255 and frames["sky"].any()


def test_flow_matches_the_port(frames):
    prev, curr = frames["gray"][:-1], frames["gray"][1:]
    assert tuned_flow_params(64, 96).max_shift == FLOW["max_shift"]
    ours = ref_flow.flow(prev, curr, {"flow": FLOW})
    port = farneback_flow_batch(prev, curr, None, "cpu")
    assert ours.shape == port.shape == (4, 64, 96, 2)
    assert torch.allclose(ours, port, atol=1e-4, rtol=0)
    assert float(ours.abs().max()) > 0.5       # the scene moves


def test_tf32_control_departs(frames):
    prev, curr = frames["gray"][:-1], frames["gray"][1:]
    fp32 = ref_flow.flow(prev, curr, {"flow": FLOW})
    tf32 = ref_flow.flow(prev, curr, {"flow": FLOW}, None, ref_flow.CONTROL_PRECISION)
    gap = float(torch.linalg.vector_norm(fp32 - tf32, dim=-1).mean())
    assert gap > 1e-4


def test_detection_matches_the_port(frames):
    prev, curr = frames["gray"][:-1], frames["gray"][1:]
    flow = ref_flow.flow(prev, curr, {"flow": FLOW})
    n, N = 4, 64
    g = torch.Generator().manual_seed(3)
    syx = torch.stack([torch.randint(0, 64, (n, 2 * N), generator=g),
                       torch.randint(0, 96, (n, 2 * N), generator=g)], -1)
    args = (flow, torch.zeros_like(flow), frames["omega"][:n], torch.full((n,), 0.05),
            frames["seg"][:n], frames["sky"][:n], frames["depth"].expand(n, 64, 96),
            torch.tensor([[40.0, 22.0]] * n))
    port = detect_frame_batch_scalars(*args, sample_yx=syx, config=DetectionStep(foe_samples=N))
    ours = ref_detect.scalars(*args, syx, N)
    for key in ("foe", "tpr", "fpr", "tpr_fixed", "fpr_fixed", "sky_tpr", "sky_fpr",
                "drone_size_pixels", "drone_flow_pixels", "center_phi"):
        a = getattr(port, key).to(torch.float32)
        b = ours[key]
        assert torch.allclose(a, b, atol=1e-5, rtol=1e-5, equal_nan=True), key
    pts, valid, scores = ref_detect.candidates(
        ref_detect.derotate(flow, args[2], args[3]), syx, N)
    assert torch.equal(ref_detect.vote(pts, scores), ours["foe"])
    assert np.isfinite(ours["foe"].numpy()).all()
