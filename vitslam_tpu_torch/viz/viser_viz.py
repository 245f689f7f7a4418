"""Interactive 3D viewer via viser (port of vitslam_tpu/viz/viser_viz.py),
host-side.

The preparation is the port's own: the point cloud from unprojected depth
maps (else the point maps) with colours, confidences and frame indices
(``build_point_cloud``, on the port's geometry), the sky mask that
multiplies the confidences (``run_sky_segmentation``), the scene recentred
on the points. ``viser`` and ``onnxruntime`` are optional and imported only
where they are used; without them the entry points raise ImportError.
"""
from __future__ import annotations

import numpy as np
import torch

from ..geometry import closed_form_inverse_se3, unproject_depth_to_points


def require_viser():
    try:
        import viser

        return viser
    except ImportError as e:
        raise ImportError(
            "viser is not installed in this environment; install `viser` to "
            "use the interactive visualizer (predictions can still be dumped "
            "with Metrics.save_dict_for_visualization and viewed elsewhere)."
        ) from e


def build_point_cloud(pred_dict: dict):
    """(points (P, 3), colours (P, 3), confidence (P,), frame index (P,))
    from a prediction dict (S-leading, no batch): unprojected depths when
    it has them, else the point maps."""
    images = np.asarray(pred_dict["images"])  # (S, 3, H, W) in [0, 1]
    S, _, H, W = images.shape
    if "depth" in pred_dict:
        as_t = lambda k: torch.as_tensor(np.asarray(pred_dict[k]))[None]  # noqa: E731
        pts = unproject_depth_to_points(as_t("depth"), as_t("extrinsic"),
                                        as_t("intrinsic"))[0].numpy()
        conf = np.asarray(pred_dict["depth_conf"])
    else:
        pts = np.asarray(pred_dict["world_points"])
        conf = np.asarray(pred_dict["world_points_conf"])
    colors = np.transpose(images, (0, 2, 3, 1)).reshape(-1, 3)
    frame_idx = np.repeat(np.arange(S), H * W)
    return pts.reshape(-1, 3), colors, conf.reshape(-1), frame_idx


def sky_mask_confidence(conf: np.ndarray, masks) -> np.ndarray:
    """conf (S*H*W,) times a keep mask per frame: a segmentation map
    (H, W) per frame, where values below 32 are sky."""
    out = conf.reshape(len(masks), *np.asarray(masks[0]).shape).copy()
    for s, mask in enumerate(masks):
        out[s] *= (np.asarray(mask) >= 32).astype(np.float32)
    return out.reshape(conf.shape)


def run_sky_segmentation(images: np.ndarray, conf: np.ndarray,
                         model_path: str = "skyseg.onnx") -> np.ndarray:
    """Multiply confidences by the sky mask of an ONNX segmentation model
    run at 320x320 (needs onnxruntime, cv2 and the model file)."""
    try:
        import cv2
        import onnxruntime as ort
    except ImportError as e:
        raise ImportError("sky segmentation needs onnxruntime + cv2") from e
    sess = ort.InferenceSession(model_path)
    _, _, H, W = images.shape
    masks = []
    for img in images:
        inp = cv2.resize((np.transpose(img, (1, 2, 0)) * 255.0).astype(np.float32),
                         (320, 320)) / 255.0
        pred = sess.run(None, {sess.get_inputs()[0].name: inp.transpose(2, 0, 1)[None]})[0]
        masks.append(cv2.resize(pred.squeeze(), (W, H)))
    return sky_mask_confidence(conf, masks)


def viser_wrapper(pred_dict: dict, port: int = 8080, init_conf_threshold: float = 50.0,
                  background_mode: bool = False, mask_sky: bool = False):
    """Serve an interactive reconstruction viewer of pred_dict (S-leading,
    no batch): images (S, 3, H, W) in [0, 1], extrinsic (S, 3, 4),
    intrinsic (S, 3, 3), and depth/depth_conf or
    world_points/world_points_conf."""
    viser = require_viser()

    points, colors, conf, frame_idx = build_point_cloud(pred_dict)
    if mask_sky:
        conf = run_sky_segmentation(np.asarray(pred_dict["images"]), conf)
    center = points.mean(axis=0)
    points = points - center
    c2w = closed_form_inverse_se3(
        torch.as_tensor(np.asarray(pred_dict["extrinsic"], np.float32))).numpy()
    c2w[:, :3, 3] -= center

    server = viser.ViserServer(port=port)
    server.gui.configure_theme(titlebar_content=None, control_layout="collapsible")
    threshold_slider = server.gui.add_slider(
        "confidence percentile", min=0.0, max=100.0, step=1.0,
        initial_value=init_conf_threshold)
    frame_options = ["all"] + [str(i) for i in range(len(c2w))]
    frame_select = server.gui.add_dropdown("show frame", frame_options, "all")
    cloud = server.scene.add_point_cloud("/points", points=points, colors=colors,
                                         point_size=0.02)

    def update_cloud(_=None):
        keep = conf >= np.percentile(conf, threshold_slider.value)
        if frame_select.value != "all":
            keep &= frame_idx == int(frame_select.value)
        cloud.points = points[keep]
        cloud.colors = colors[keep]

    threshold_slider.on_update(update_cloud)
    frame_select.on_update(update_cloud)
    update_cloud()

    images = np.asarray(pred_dict["images"])
    H, W = images.shape[-2:]
    intrinsic = np.asarray(pred_dict["intrinsic"])
    for i, pose in enumerate(c2w):
        fov = 2 * np.arctan2(H / 2, float(intrinsic[i, 1, 1]))
        frustum = server.scene.add_camera_frustum(
            f"/cameras/{i}", fov=float(fov), aspect=W / H, scale=0.1,
            image=(np.transpose(images[i], (1, 2, 0)) * 255).astype(np.uint8),
            wxyz=viser.transforms.SO3.from_matrix(pose[:3, :3]).wxyz,
            position=pose[:3, 3])

        def _attach(frustum=frustum):
            @frustum.on_click
            def _(_event):
                for client in server.get_clients().values():
                    client.camera.wxyz = frustum.wxyz
                    client.camera.position = frustum.position

        _attach()

    if not background_mode:
        import time

        while True:
            time.sleep(1.0)
    return server
