"""Paper-figure and analysis generators (``mav_detection_tpu.eval.figures``).

The original project's analysis scripts as functions over the framework's
artifacts: TPR/FPR against flow sweeps, FoE-error histograms and their
comparison with the published statistics, per-pixel FoE angular-error maps,
the radial-error histogram with its threshold model, and IMU time series.

Every number is computed on the host with numpy, except the angular-error
map, which runs the port's ``get_phi`` on the device. matplotlib is imported
lazily on the Agg backend; where it cannot be imported (a CUDA host need not
have it), each figure is skipped with one warning and every returned number
is kept.
"""
from __future__ import annotations

import glob
import logging
import os
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from mav_detection_tpu_torch.core.frame_result import FrameResult
from mav_detection_tpu_torch.data.dataset import create_if_not_exists
from mav_detection_tpu_torch.utils.device import resolve_device

logger = logging.getLogger("mav_detection_tpu_torch")


def _plt(figure: str):
    """``matplotlib.pyplot`` on the Agg backend, or None (with one warning
    naming ``figure``) where matplotlib cannot be imported."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        logger.warning(f"matplotlib cannot be imported: skipping the figure "
                       f"{figure}; its numbers are still returned")
        return None
    return plt


def load_frame_results(results_dir: str) -> List[FrameResult]:
    out = []
    for path in sorted(glob.glob(os.path.join(results_dir, "image_*.json"))):
        out.append(FrameResult.from_json_file(path))
    return out


# ------------------------------------------------------------- get_figures
def tpr_fpr_vs_flow(run_results: Dict[str, str], out_dir: str = "media/output"
                    ) -> Dict[str, np.ndarray]:
    """TPR/FPR as a function of mean target flow magnitude across runs.

    ``run_results`` maps a label (e.g. the sweep's flow speed) to a results
    directory. Reproduces the ``tpr_fpr_vs_flow`` figure family
    (reference ``get_figures.py:200-224``).
    """
    plt = _plt("tpr_fpr_vs_flow")
    create_if_not_exists(out_dir)
    flows, tprs, fprs = [], [], []
    for label, rdir in sorted(run_results.items()):
        frames = load_frame_results(rdir)
        if not frames:
            continue
        fx = np.array([f.drone_flow_pixels[0] for f in frames], float)
        fy = np.array([f.drone_flow_pixels[1] for f in frames], float)
        mag = np.hypot(fx, fy)
        flows.append(np.nanmean(mag))
        tprs.append(np.nanmean([f.tpr_fixed for f in frames]))
        fprs.append(np.nanmean([f.fpr_fixed for f in frames]))
    flows_a, tprs_a, fprs_a = map(np.asarray, (flows, tprs, fprs))
    order = np.argsort(flows_a)
    out = {"flow": flows_a[order], "tpr": tprs_a[order], "fpr": fprs_a[order]}
    if plt is None:
        return out

    for name, vals in (("tpr_vs_flow", tprs_a), ("fpr_vs_flow", fprs_a)):
        plt.figure()
        plt.grid()
        plt.plot(flows_a[order], vals[order], marker="o")
        plt.xlabel("Mean target flow [px/frame]")
        plt.ylabel("TPR" if "tpr" in name else "FPR")
        plt.savefig(os.path.join(out_dir, f"{name}.png"), bbox_inches="tight")
        plt.close()
    plt.figure()
    plt.grid()
    plt.plot(flows_a[order], tprs_a[order], marker="o", label="TPR")
    plt.plot(flows_a[order], fprs_a[order], marker="s", label="FPR")
    plt.xlabel("Mean target flow [px/frame]")
    plt.legend()
    plt.savefig(os.path.join(out_dir, "tpr_fpr_vs_flow.png"), bbox_inches="tight")
    plt.close()
    return out


def foe_error_histograms(results_dirs: Dict[str, str],
                         out_dir: str = "media/output",
                         outlier_threshold: float = 50.0) -> Dict[str, Dict]:
    """Per-run FoE error mean/std with inlier protocol (get_figures.py:144-197)."""
    plt = _plt("foe-error")
    create_if_not_exists(out_dir)
    stats = {}
    if plt is not None:
        plt.figure()
        plt.grid()
    for label, rdir in results_dirs.items():
        frames = load_frame_results(rdir)
        err = np.array([
            [f.foe_dense[0] - f.foe_gt[0], f.foe_dense[1] - f.foe_gt[1]]
            for f in frames if f.foe_gt is not None], float)
        err = err[np.isfinite(err).all(axis=1)]
        inl = err[(np.abs(err) < outlier_threshold).all(axis=1)]
        if len(inl):
            stats[label] = {"mean": inl.mean(0).tolist(), "std": inl.std(0).tolist(),
                            "outliers": int(len(err) - len(inl))}
            if plt is not None:
                plt.hist(np.linalg.norm(inl, axis=1), bins=25, alpha=0.5, label=label)
    if plt is None:
        return stats
    plt.xlabel("FoE error [px]")
    plt.ylabel("Frequency [frames]")
    plt.legend()
    plt.savefig(os.path.join(out_dir, "foe-error.png"), bbox_inches="tight")
    plt.close()
    return stats


def tpr_surface_3d(run_results: Dict[float, str],
                   out_dir: str = "media/output",
                   kappa_bins: int = 40) -> Dict[str, np.ndarray]:
    """3-D TPR surface over (kappa, flow magnitude) across a sweep of runs.

    ``run_results`` maps each run's nominal flow magnitude (px/frame) to its
    results directory. Per run, TPR is binned over the kappa angle (the
    target's direction seen from the GT FoE); the binned curves stack into a
    surface. Reproduces ``tpr_flow_vs_phi`` (reference
    ``get_figures.py:81-115``): jet-colored surface, z in [0, 1], kappa axis
    reversed 180 -> 0.
    """
    from mav_detection_tpu_torch.eval.validator import binned_mean_std

    plt = _plt("tpr_flow_vs_phi")
    create_if_not_exists(out_dir)
    bins = np.linspace(-180, 0, kappa_bins)
    flows = sorted(run_results)
    Z = np.zeros((len(flows), kappa_bins))
    x_centers = None
    for r, f in enumerate(flows):
        frames = load_frame_results(run_results[f])
        phi = np.array([fr.center_phi for fr in frames], float)
        tpr = np.array([fr.tpr for fr in frames], float)
        curve = binned_mean_std(phi, tpr, bins)
        if x_centers is None:
            x_centers = bins
        Z[r] = np.nan_to_num(curve[:, 1], nan=0.0)
    out = {"kappa": x_centers, "flows": np.asarray(flows, float), "tpr": Z}
    if plt is None:
        return out

    X, Y = np.meshgrid(x_centers, np.asarray(flows, float))
    fig, ax = plt.subplots(subplot_kw={"projection": "3d"})
    from matplotlib import cm

    surf = ax.plot_surface(X, Y, Z, cmap=cm.jet, linewidth=0,
                           antialiased=False, vmax=1)
    ax.set_zlim(0, 1)
    ax.set_xlabel(r"$\kappa$ [deg]")
    ax.set_ylabel("OF magnitude [px/frame]")
    ax.set_zlabel("True Positive Rate")
    ax.set_ylim(bottom=0)
    ax.set_xlim(180, 0)
    fig.colorbar(surf, shrink=0.7, aspect=10, ax=ax, pad=0.12)
    for ext in ("png", "eps"):
        plt.savefig(os.path.join(out_dir, f"tpr_flow_vs_phi.{ext}"),
                    bbox_inches="tight")
    plt.close(fig)
    return out


# Published FoE-error statistics of the original thesis, per flight
# direction: the baseline the overlay figure annotates against.
PUBLISHED_FOE_STATS = {
    "center": {"mean": (2.81, -7.18), "std": (4.9, 6.4)},
    "left": {"mean": (9.16, -7.44), "std": (9.6, 5.6)},
    "right": {"mean": (-8.09, -2.37), "std": (6.5, 5.0)},
}


def foe_error_published_comparison(results_dirs: Dict[str, str],
                                   out_dir: str = "media/output",
                                   outlier_threshold: float = 50.0
                                   ) -> Dict[str, Dict]:
    """Per-direction FoE x/y error step-histograms annotated with the
    reference's PUBLISHED means/stds (reference ``get_figures.py:144-197``):
    two stacked subplots (x errors / y errors), one step histogram per
    direction, legend entries carrying mean±std.

    ``results_dirs`` maps direction labels (``center``/``left``/``right`` or
    arbitrary) to results directories; measured stats are returned alongside
    the published values so parity can be asserted numerically.
    """
    plt = _plt("foe-error")
    create_if_not_exists(out_dir)
    axes = []
    if plt is not None:
        fig, axes = plt.subplots(nrows=2, ncols=1)
    out: Dict[str, Dict] = {}
    edges = np.linspace(-outlier_threshold, outlier_threshold, 40)
    for label, rdir in results_dirs.items():
        frames = load_frame_results(rdir)
        err = np.array([
            [f.foe_dense[0] - f.foe_gt[0], f.foe_dense[1] - f.foe_gt[1]]
            for f in frames if f.foe_gt is not None], float)
        err = err[np.isfinite(err).all(axis=1)]
        inl = err[(np.abs(err) < outlier_threshold).all(axis=1)]
        if not len(inl):
            continue
        mean, std = inl.mean(0), inl.std(0)
        pub = PUBLISHED_FOE_STATS.get(label)
        out[label] = {"mean": mean.tolist(), "std": std.tolist(),
                      "published": pub}
        for k, ax in enumerate(axes):
            leg = f"{label} ({mean[k]:.02f}$\\pm${std[k]:.01f} px)"
            if pub:
                leg += (f" | published {pub['mean'][k]:.02f}"
                        f"$\\pm${pub['std'][k]:.01f}")
            ax.hist(err[:, k], edges, histtype="step", label=leg)
            if pub:
                ax.axvline(pub["mean"][k], ls="--", lw=1, alpha=0.6)
    if plt is None:
        return out
    for k, ax in enumerate(axes):
        ax.set_xlabel(f"FoE error ({'xy'[k]}) [pixels]")
        ax.set_ylabel("Frequency [frames]")
        ax.grid()
        ax.legend(fontsize=7)
    fig.tight_layout()
    for ext in ("png", "eps"):
        plt.savefig(os.path.join(out_dir, f"foe-error.{ext}"),
                    bbox_inches="tight")
    plt.close(fig)
    return out


# ------------------------------------------------------------ foe_analysis
def foe_angular_error_map(dataset, n_frames: int = 100, cap_deg: float = 43.0,
                          out_path: Optional[str] = None,
                          device: Union[str, torch.device] = "cuda") -> np.ndarray:
    """Average per-pixel angle between measured flow and the GT-FoE ray over
    the first ``n_frames`` pairs (frames without a GT FoE skipped), capped at
    ``cap_deg``: the phi map of every frame on ``device``, summed there in
    frame order, one pull."""
    from mav_detection_tpu_torch.ops.geometry import get_phi

    dev = resolve_device(device)
    n = min(n_frames, dataset.N - 1)
    flows, foes = [], []
    for i in range(n):
        foe = dataset.get_gt_foe(i)
        if foe is None:
            continue
        flows.append(np.asarray(dataset.get_flow_uv(i), np.float32))
        foes.append(np.asarray(foe, np.float32))
    if not flows:
        raise ValueError("dataset provides no GT FoE")
    phi = get_phi(torch.as_tensor(np.stack(flows)).to(dev),
                  torch.as_tensor(np.stack(foes)).to(dev))
    acc = phi[0]
    for k in range(1, len(flows)):
        acc = acc + phi[k]
    # divide by the frames actually accumulated, not the frames attempted
    avg = acc.cpu().numpy() / len(flows)
    avg = np.minimum(avg, cap_deg)
    if out_path:
        from mav_detection_tpu_torch.data.dataset import imwrite
        from mav_detection_tpu_torch.ops.image.visualize import apply_colormap

        imwrite(out_path, apply_colormap(avg.astype(np.float32), max_value=cap_deg))
    return avg


# -------------------------------------------------------- plot_radial_error
def radial_error_model(flow_mag: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """The fitted dynamic-threshold band 0.25 ± (0.5 + 8/|OF|) degrees
    (reference ``plot_radial_error.py:51-55``)."""
    band = 0.5 + 8.0 / np.maximum(flow_mag, 1e-6)
    return 0.25 + band, 0.25 - band


def radial_error_histogram(dataset, n_frames: Optional[int] = None,
                           out_path: str = "media/output/radial_error.png"
                           ) -> Dict[str, np.ndarray]:
    """2-D histogram of radial-angle error vs flow magnitude with the
    threshold model overlaid; gathers (|OF|, angle-error) pairs from measured
    vs GT flow like ``Processor.analyze_radial_error`` + the plot script."""
    plt = _plt("radial_error")
    create_if_not_exists(os.path.dirname(out_path) or ".")
    n = min(n_frames or dataset.N - 1, dataset.N - 1)
    mags, errs = [], []
    for i in range(n):
        flow = np.asarray(dataset.get_flow_uv(i), float)
        gt = dataset.get_gt_of(i)
        if gt is None:
            continue
        gt = np.asarray(gt, float)
        sky = np.asarray(dataset.get_sky_segmentation(i), bool)
        mag = np.linalg.norm(flow, axis=-1)
        ang = np.degrees(np.arctan2(flow[..., 1], flow[..., 0])
                         - np.arctan2(gt[..., 1], gt[..., 0]))
        ang = (ang + 180) % 360 - 180
        keep = ~sky
        mags.append(mag[keep].ravel())
        errs.append(ang[keep].ravel())
    mag_all = np.concatenate(mags)
    err_all = np.concatenate(errs)
    if plt is None:
        return {"mag": mag_all, "err": err_all}

    plt.figure()
    h = plt.hist2d(mag_all, np.abs(err_all), bins=(40, 40),
                   range=[[0, max(mag_all.max(), 1e-3)], [0, 20]], cmin=1)
    xs = np.linspace(0.2, max(mag_all.max(), 1.0), 200)
    hi, lo = radial_error_model(xs)
    plt.plot(xs, hi, "r-", label=r"$0.25 + (0.5 + 8/|OF|)$")
    plt.xlabel("|OF| [px/frame]")
    plt.ylabel("radial angle error [deg]")
    plt.legend()
    plt.colorbar(h[3])
    plt.savefig(out_path, bbox_inches="tight")
    plt.close()
    return {"mag": mag_all, "err": err_all}


# --------------------------------------------------------------- plot_states
def plot_states(dataset, out_path: str = "media/output/states.png") -> None:
    """IMU/orientation time series over a sequence (reference plot_states.py)."""
    plt = _plt("states")
    create_if_not_exists(os.path.dirname(out_path) or ".")
    times, omegas = [], []
    for i in range(1, dataset.N):
        times.append(dataset.get_time(i))
        omegas.append(np.asarray(dataset.get_angular_difference(i - 1, i), float))
    omegas_a = np.stack(omegas)
    if plt is None:
        return
    plt.figure()
    plt.grid()
    for k, name in enumerate(("pitch", "yaw", "roll")):
        plt.plot(times, omegas_a[:, k], label=name)
    plt.xlabel("time [s]")
    plt.ylabel("angular difference [rad/frame]")
    plt.legend()
    plt.savefig(out_path, bbox_inches="tight")
    plt.close()


# --------------------------------------------------------------- utilities
def remove_empty_segmentations(seg_dir: str) -> int:
    """Delete all-black segmentation masks (reference ``remove_empty.py``)."""
    from mav_detection_tpu_torch.data.dataset import imread

    removed = 0
    for path in sorted(glob.glob(os.path.join(seg_dir, "image_*.png"))):
        if imread(path).sum() == 0:
            os.remove(path)
            removed += 1
    return removed


def expected_pixel_flow(velocity_ms: float, distance_m: float, fov_deg: float,
                        image_width: int, fps: float) -> float:
    """Field-experiment geometry: expected apparent flow in px/frame for a
    target crossing at ``distance_m`` (reference ``etc/experiment.py:42-55``)."""
    focal_px = (image_width / 2) / np.tan(np.deg2rad(fov_deg) / 2)
    angular_rate = velocity_ms / distance_m  # rad/s
    return float(focal_px * angular_rate / fps)
