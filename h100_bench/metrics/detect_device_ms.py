"""``detect_device_ms`` (Detection step, moves ``step_frames_per_s``):
the program's ``detect_frame_batch_scalars`` on a fixed flow (the program's
own, of a fixed batch of the ring) with the cell's inputs, in a replayed
CUDA graph, device ms per frame pair (CUDA events). None outside a step
cell or off the card."""
from __future__ import annotations

from h100_bench import timing
from mav_detection_tpu_torch.pipeline.detector import detect_frame_batch_scalars

REPS = 20


def read(run):
    st = run.state
    if run.device.type != "cuda" or "flow_of" not in st:
        return None
    B = st["batch"]
    flow = st["flow_of"](st["frames"][:B], st["frames"][1:B + 1])
    args = (flow, st["gt_flow"], st["omega"][:B], st["dts"], st["seg"][:B],
            st["sky"][:B], st["depth_b"], st["foe_b"])
    syx = st["syx"][0]
    return timing.graph_ms(lambda: detect_frame_batch_scalars(*args, sample_yx=syx,
                                                              config=st["det"]),
                           REPS) / B
