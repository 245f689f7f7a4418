"""Host-side matplotlib plots + .npy dumps for the eval metrics (port of
vitslam_tpu/viz/plots.py): x-z trajectory overlay with paired error lines,
twin-axis RPE plot, scale-factor plot, Chamfer histogram, each saving a PNG
and a .npy data dump. matplotlib is imported inside each function, so the
package imports where it is not installed (the metrics plot only when given
a path).
"""
from __future__ import annotations

import numpy as np


def _pyplot():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_ate(pred_xyz, gt_xyz, rmse, rmse_per_dim, title, outpath):
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(6, 6))
    ax.plot(gt_xyz[:, 0], gt_xyz[:, 2], "k-", label="Ground Truth")
    ax.plot(pred_xyz[:, 0], pred_xyz[:, 2], "b-", label="Prediction")
    for (x1, _, z1), (x2, _, z2) in zip(gt_xyz, pred_xyz):
        ax.plot([x1, x2], [z1, z2], "r-", alpha=0.5, lw=0.5)
    ax.set_xlabel("x [m]")
    ax.set_ylabel("z [m]")
    ax.legend()
    if title:
        fig.suptitle(title, fontsize=10, fontweight="bold")
    ax.set_title(
        f"ATE RMSE: {rmse:.3f} m, per-dim RMSE: x:{rmse_per_dim[0]:.3f} m, "
        f"y:{rmse_per_dim[1]:.3f} m, z:{rmse_per_dim[2]:.3f} m",
        fontsize=10,
    )
    png = f"{outpath}traj_ate.png"
    plt.savefig(png, dpi=300)
    np.save(
        f"{outpath}traj_ate.npy",
        {"pred_xyz": pred_xyz, "gt_xyz": gt_xyz, "rmse": np.array(rmse),
         "rmse_per_dim": np.array(rmse_per_dim)},
    )
    plt.close(fig)
    return png


def plot_rpe(trans_error, rot_error_deg, trans_rmse, rot_rmse, title, outpath):
    plt = _pyplot()
    steps = range(len(trans_error))
    fig, ax1 = plt.subplots(figsize=(7, 4))
    ax1.plot(steps, trans_error, "b-", label="Translational Error [m]")
    ax1.set_xlabel("Frame index")
    ax1.set_ylabel("Translation [m]", color="b")
    ax1.tick_params(axis="y", labelcolor="b")
    ax2 = ax1.twinx()
    ax2.plot(steps, rot_error_deg, "r-", label="Rotational Error [deg]")
    ax2.set_ylabel("Rotation [deg]", color="r")
    ax2.tick_params(axis="y", labelcolor="r")
    if title:
        fig.suptitle(title, fontsize=10, fontweight="bold")
    ax1.set_title(
        f"Trans RMSE: {trans_rmse:.3f} m, Rot RMSE: {rot_rmse:.3f} deg",
        fontsize=10,
    )
    fig.tight_layout()
    png = f"{outpath}traj_rpe.png"
    plt.savefig(png, dpi=300)
    np.save(
        f"{outpath}traj_rpe.npy",
        {"steps": np.arange(len(trans_error)), "trans_error": trans_error,
         "rot_error": rot_error_deg, "trans_rmse": np.array(trans_rmse),
         "rot_rmse": np.array(rot_rmse)},
    )
    plt.close(fig)
    return png


def plot_scale_consistency(scale_factors, scale_var, title, outpath):
    plt = _pyplot()
    steps = range(1, len(scale_factors) + 1)
    fig, ax1 = plt.subplots(figsize=(7, 4))
    ax1.plot(steps, scale_factors, "b-", label="Per-frame Scale Factors")
    ax1.set_xlabel("Frame index")
    ax1.set_ylabel("Scale factor")
    if title:
        fig.suptitle(title, fontsize=10, fontweight="bold")
    ax1.set_title(f"Scale Variance: {scale_var:.3f}", fontsize=10)
    png = f"{outpath}traj_scale_cons.png"
    plt.savefig(png, dpi=300)
    np.save(
        f"{outpath}traj_scale_cons.npy",
        {"steps": np.arange(1, len(scale_factors) + 1),
         "scale_factors": scale_factors, "scale_var": np.array(scale_var)},
    )
    plt.close(fig)
    return png


def plot_chamfer_hist(d_pred_to_gt, d_gt_to_pred, results, title, outpath):
    plt = _pyplot()
    fig, axes = plt.subplots(1, 2, figsize=(10, 4))
    axes[0].hist(np.sqrt(d_pred_to_gt), bins=100, color="b", alpha=0.7)
    axes[0].set_title("pred -> GT distances [m]")
    axes[1].hist(np.sqrt(d_gt_to_pred), bins=100, color="g", alpha=0.7)
    axes[1].set_title("GT -> pred distances [m]")
    label = ", ".join(f"{k}: {v:.4f}" for k, v in results.items())
    if title:
        fig.suptitle(f"{title}\n{label}", fontsize=9, fontweight="bold")
    else:
        fig.suptitle(label, fontsize=9)
    fig.tight_layout()
    png = f"{outpath}chamfer.png"
    plt.savefig(png, dpi=300)
    np.save(
        f"{outpath}chamfer.npy",
        {"pred_to_gt": d_pred_to_gt, "gt_to_pred": d_gt_to_pred,
         **{k: np.array(v) for k, v in results.items()}},
    )
    plt.close(fig)
    return png
