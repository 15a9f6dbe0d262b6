"""Ground-truth optical flow from camera matrices + depth, on the tensor's
device (``mav_detection_tpu.data.airsim_flow``, there in JAX).

Unproject each pixel of frame i along its camera ray scaled by depth, advance
the moving target's world points by its displacement inside its segmentation
mask, reproject into camera i+1, and take the screen-space difference: flow
sampled at the FIRST frame's pixels, as the flow kernels report it, for pair
(i, i+1) at index i (both divergences of the reference's writer from the
original tool, kept as they are). Batched 4x4 homogeneous transforms over
the whole image, in fp32.

The matrix helpers (``parse_view_proj``, ``pinhole_view_proj``,
``format_view_proj``) are numpy, copied.
"""
from __future__ import annotations

import json
from typing import Any, Dict, Tuple

import numpy as np
import torch

from mav_detection_tpu_torch.utils.device import resolve_device


def _apply_mat4(mat: torch.Tensor, vec4: torch.Tensor) -> torch.Tensor:
    """(4,4) x (..., 4) homogeneous transform."""
    return torch.einsum("ij,...j->...i", mat, vec4)


def world_to_screen(view_proj: torch.Tensor, screen_res: Tuple[int, int],
                    world_pos: torch.Tensor) -> torch.Tensor:
    """World (..., 3) -> screen pixels (..., 2) through a UE4-style VP matrix."""
    ones = torch.ones(world_pos.shape[:-1] + (1,), dtype=world_pos.dtype,
                      device=world_pos.device)
    pos = _apply_mat4(view_proj, torch.cat([world_pos, ones], dim=-1))
    rhw = 1.0 / pos[..., 3]
    ndc_x = pos[..., 0] * rhw
    ndc_y = pos[..., 1] * rhw
    sx = (ndc_x * 0.5 + 0.5) * screen_res[0]
    sy = (-ndc_y * 0.5 + 0.5) * screen_res[1]
    return torch.stack([sx, sy], dim=-1)


def screen_to_world(view_proj_inv: torch.Tensor, screen_res: Tuple[int, int],
                    screen_pos: torch.Tensor, depth: torch.Tensor) -> torch.Tensor:
    """Screen pixels + metric depth -> world positions via two unprojected
    points per pixel defining the camera ray (UE4 deprojection scheme)."""
    nx = screen_pos[..., 0] / screen_res[0]
    ny = screen_pos[..., 1] / screen_res[1]
    sx = 2.0 * (nx - 0.5)
    sy = 2.0 * ((1.0 - ny) - 0.5)

    def unproject(z: float) -> torch.Tensor:
        p = torch.stack([sx, sy, torch.full_like(sx, z), torch.ones_like(sx)], dim=-1)
        h = _apply_mat4(view_proj_inv, p)
        return h[..., :3] / h[..., 3:4]

    ray_start = unproject(1.0)
    ray_end = unproject(0.5)
    direction = ray_end - ray_start
    direction = direction / torch.linalg.norm(direction, dim=-1, keepdim=True)
    return ray_start + direction * depth[..., None]


def calculate_flow(view_proj1: torch.Tensor, view_proj2: torch.Tensor,
                   screen_res: Tuple[int, int], depth: torch.Tensor,
                   drone_displacement: torch.Tensor,
                   segmentation: torch.Tensor) -> torch.Tensor:
    """Flow (h, w, 2) for pair (frame1, frame2), sampled at frame1's pixels,
    on the inputs' device, in fp32.

    Unprojects every frame-1 pixel through ``view_proj1`` scaled by frame-1
    ``depth`` (Euclidean, in world units: the caller scales AirSim meters to
    UE4 centimeters), advances the moving target's world points by
    ``drone_displacement`` where ``segmentation`` > 0, reprojects through
    ``view_proj2``, and differences in screen space.
    """
    h, w = depth.shape
    dev = depth.device
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=dev),
                            torch.arange(w, dtype=torch.float32, device=dev),
                            indexing="ij")
    pixels = torch.stack([xs, ys], dim=-1)
    vp1 = view_proj1.to(torch.float32)
    world = screen_to_world(torch.linalg.inv(vp1), screen_res, pixels,
                            depth.to(torch.float32))
    moving = (segmentation > 0)[..., None]
    world = world + moving * drone_displacement.to(torch.float32)[None, None, :]
    screen2 = world_to_screen(view_proj2.to(torch.float32), screen_res, world)
    return screen2 - pixels


def parse_view_proj(state: Dict[str, Any]) -> np.ndarray:
    """UE4 dumps the matrix as a bracketed row-major string of the TRANSPOSED
    (row-vector convention) matrix; whitespace-split (robust to the double
    spaces bracket removal leaves behind) and transpose back."""
    s = state["Drone1"]["ue4"]["viewProjectionMatrix"]
    values = [float(x) for x in s.replace("[", " ").replace("]", " ").split()]
    return np.array(values).reshape(4, 4).T


def pinhole_view_proj(position: np.ndarray, yaw: float, focal: float,
                      screen_res: Tuple[int, int],
                      near: float = 1.0) -> np.ndarray:
    """UE4-style view-projection matrix for a yaw-only NED pinhole camera.

    The camera looks along body +x (world heading ``yaw``), +z down; the
    matrix maps world homogeneous points to clip space such that
    ``world_to_screen`` reproduces ``px = W/2 + f*right/fwd``,
    ``py = H/2 - f*up/fwd`` — the projection ``MockSimClient`` renders with,
    so mock captures, depths, and matrices are mutually consistent.
    Reversed-Z row (clip_z = near, clip_w = fwd) keeps the matrix invertible
    and puts ``screen_to_world``'s z=1.0 unprojection ~``near`` units from
    the camera (UE4's deprojection scheme).
    """
    w, h = screen_res
    cy, sy = np.cos(yaw), np.sin(yaw)
    fwd = np.array([cy, sy, 0.0])
    right = np.array([-sy, cy, 0.0])
    up = np.array([0.0, 0.0, -1.0])
    view = np.eye(4)
    for row, axis in enumerate((right, up, fwd)):
        view[row, :3] = axis
        view[row, 3] = -float(axis @ position)
    proj = np.array([
        [2.0 * focal / w, 0.0, 0.0, 0.0],
        [0.0, 2.0 * focal / h, 0.0, 0.0],
        [0.0, 0.0, 0.0, near],
        [0.0, 0.0, 1.0, 0.0],
    ])
    return proj @ view


def format_view_proj(vp: np.ndarray) -> str:
    """Serialize to the UE4 string format ``parse_view_proj`` reads (the
    transpose, bracketed rows)."""
    rows = [" ".join(f"{v:.9g}" for v in row) for row in np.asarray(vp).T]
    return " ".join(f"[{r}]" for r in rows)


def pair_inputs(dataset, i: int, states) -> Tuple[np.ndarray, np.ndarray,
                                                  np.ndarray, np.ndarray,
                                                  np.ndarray]:
    """Host inputs of ``calculate_flow`` for pair (i, i+1) of a SimDataset:
    both view-projection matrices, the target's displacement over the pair
    (cm), frame i's depth (cm) and segmentation channel."""
    from mav_detection_tpu_torch.data.dataset import imread, read_pfm

    with open(states[i]) as f:
        s1 = json.load(f)
    with open(states[i + 1]) as f:
        s2 = json.load(f)
    dt = dataset.get_delta_time(i + 1)
    vel = s1["Drone2"]["ue4"]["linearVelocity"]
    disp = np.array([vel["X"], vel["Y"], vel["Z"]]) * dt * 100.0
    if not np.isfinite(disp).all():
        disp = np.zeros(3)
    depth = read_pfm(f"{dataset.depth_path}/image_{i:05d}.pfm") * 100.0
    seg = imread(f"{dataset.seg_path}/image_{i:05d}.png")
    if seg.ndim == 3:
        seg = seg[..., 0]
    return parse_view_proj(s1), parse_view_proj(s2), disp, depth, seg


def calculate_flow_packed(packed: torch.Tensor, screen_res: Tuple[int, int]
                          ) -> torch.Tensor:
    """``calculate_flow`` over one flat fp32 tensor holding both matrices
    (16 + 16), the displacement (3), the depth (h * w) and the segmentation
    (h * w), in that order: the layout of one upload per pair."""
    w, h = screen_res
    vp1 = packed[:16].view(4, 4)
    vp2 = packed[16:32].view(4, 4)
    disp = packed[32:35]
    depth = packed[35:35 + h * w].view(h, w)
    seg = packed[35 + h * w:].view(h, w)
    return calculate_flow(vp1, vp2, screen_res, depth, disp, seg)


def pack_pair(vp1, vp2, disp, depth, seg) -> np.ndarray:
    """``pair_inputs``' arrays as the one flat fp32 array that
    ``calculate_flow_packed`` reads."""
    return np.concatenate([np.ravel(vp1), np.ravel(vp2), np.ravel(disp),
                           np.ravel(depth), np.ravel(seg)]).astype(np.float32)


def write_sequence_gt_flow(dataset) -> None:
    """GT flow files (``.flo`` and ``flow_to_color`` PNGs) for every
    consecutive state pair of a SimDataset, computed on ``dataset.device``:
    one upload and one pull per pair."""
    from mav_detection_tpu_torch.core.flo import write_flow
    from mav_detection_tpu_torch.data.dataset import imwrite
    from mav_detection_tpu_torch.ops.image.visualize import flow_to_color

    dev = resolve_device(dataset.device)
    states = dataset.get_state_filenames()
    res = dataset.capture_size

    for i in range(len(states) - 1):
        packed = torch.from_numpy(pack_pair(*pair_inputs(dataset, i, states)))
        flow = calculate_flow_packed(packed.to(dev), res).cpu().numpy()
        write_flow(f"{dataset.gt_of_path}/image_{i:05d}.flo", flow)
        imwrite(f"{dataset.gt_of_vis_path}/image_{i:05d}.png", flow_to_color(flow))
        if i % max(len(states) // 10, 1) == 0:
            dataset.logger.info(f"GT flow {i / max(len(states) - 1, 1) * 100:.1f}%")
