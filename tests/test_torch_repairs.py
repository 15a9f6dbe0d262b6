"""Two gates of the port held on the CPU: the north star's first accuracy
gate (Farneback against cv2 at 752x480) and the SkyUNet's bf16 loss
against the JAX package's.

* EPE vs cv2 < 0.1 px at 752x480 on the 16-px interior, with the product's
  ``tuned_flow_params`` and bench.py's oracle call
  (``calcOpticalFlowFarneback(prev8, curr8, None, 0.4, 1, 12, 10, 8, 1.2,
  0)``, ``bench.py:238-243``); the reference reads 0.0495 px.
* The bf16 sky loss on the draws of the card test
  ``test_train_step_on_card_matches_cpu[sky-bf16]`` (64x96, b=2,
  ``draw_scenes(..., manual_seed(3))``), per example, against ``sky_loss``
  of the JAX package with ``SkyUNet(dtype=bfloat16)``: within 1 %
  (measured 0.25-0.3 %: the convolutions and GroupNorm sum in other orders
  under oneDNN and XLA, and bf16 keeps 8 bits). With the bias fused into
  the convolution's one rounding, as the port had it, the gap was 3 %
  (0.19178 against 0.19792 on the second example): Flax adds the bias to
  the convolution's bf16 result. In fp32 within 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mav_detection_tpu.models import pretrained as jpre
from mav_detection_tpu.models import sky_segmentation as jsky
from mav_detection_tpu_torch.cli.train import _gray3
from mav_detection_tpu_torch.data.scene import epe_interior, make_scene
from mav_detection_tpu_torch.data.synthgen import draw_scenes, generate_batch
from mav_detection_tpu_torch.models import pretrained as tpre
from mav_detection_tpu_torch.models.sky_segmentation import SkyUNet, sky_loss
from mav_detection_tpu_torch.ops.flow.farneback import farneback_flow, tuned_flow_params

torch.set_num_threads(1)

CV2_GATE_PX = 0.1
SKY_LOSS_RTOL = {"bf16": 1e-2, "fp32": 1e-5}
DTYPES = {"bf16": (torch.bfloat16, jnp.bfloat16), "fp32": (torch.float32, jnp.float32)}


def test_farneback_752x480_within_the_cv2_gate():
    cv2 = pytest.importorskip("cv2")
    prev, curr, gt = make_scene(0)
    ref = cv2.calcOpticalFlowFarneback(prev, curr, None, 0.4, 1, 12, 10, 8, 1.2, 0)
    flow = farneback_flow(prev, curr, tuned_flow_params(480, 752), device="cpu").numpy()
    assert epe_interior(flow, ref) < CV2_GATE_PX
    assert epe_interior(flow, gt) < 0.40          # bench.py:415's gate beside it


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_sky_loss_matches_jax(dtype):
    t_dtype, j_dtype = DTYPES[dtype]
    draws = draw_scenes(2, 64, 96, generator=torch.Generator().manual_seed(3))
    sc = generate_batch(2, 64, 96, draws=draws, device="cpu")
    model = SkyUNet()
    model.load_state_dict(tpre.load_sky_params())
    with torch.no_grad():
        got = sky_loss(model, _gray3(sc.img1), sc.sky, t_dtype).numpy()
    params, net = jpre.load_sky_params(), jsky.SkyUNet(dtype=j_dtype)
    ref = np.asarray(jax.vmap(lambda im, gt: jsky.sky_loss(params, net, im, gt))(
        jnp.asarray(_gray3(sc.img1).numpy()), jnp.asarray(sc.sky.numpy())))
    np.testing.assert_allclose(got, ref, rtol=SKY_LOSS_RTOL[dtype])
