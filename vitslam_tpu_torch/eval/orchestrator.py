"""Metrics orchestrator: batch-level and full-sequence evaluation (port of
vitslam_tpu/eval/orchestrator.py).

* per-batch metrics on the chunked outputs (``compute_batch_metrics``),
  with the ICP point clouds capped at ``max_points_for_icp_batch``;
* full-sequence evaluation (``compute_full_sequence_metrics``): one random
  (or every) sequence, streamed through ``ChunkedPipeline`` at a fixed chunk
  width and overlap with GT alignment, prepared (``max_points_for_icp_full_seq``
  cap) and scored on the pipeline's device, with per-sequence key prefixes
  and plots when a ``log_dir`` is set;
* the alignment diagnostics (``log_additional_data``);
* in a gang of ranks, each metric's states are concatenated over all ranks
  in rank order before ``compute`` (the reference's ``dist_reduce_fx="cat"``;
  ``parallel.allgather_rows`` through each metric's ``gather_fn`` hook);
* the viser viewer of one sequence (``visualize_sequence``,
  ``viz.viser_viz``).
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..config.loader import instantiate
from ..geometry import pose_encoding_to_extri, pose_encoding_to_extri_intri
from ..parallel import allgather_rows, is_distributed
from ..slam.chunking import normalize_extrinsics_and_points
from .prepare import prepare_data_for_metrics
from .trajectory import _np


def log_additional_data(pred: dict, log: dict) -> None:
    """Alignment diagnostics: mean alignment scale, per-frame and per-chunk
    transform magnitudes, memory-token cosine similarity."""
    if "alignment_scales" in pred:
        log["avg_alignment_scale"] = float(np.mean(_np(pred["alignment_scales"])))
    for key, name in (("frame_se3_enc", "frame"), ("chunk_sim3_enc", "chunk")):
        if key not in pred:
            continue
        enc = _np(pred[key])
        log[f"avg_per_{name}_trans_norm"] = float(np.linalg.norm(enc[..., :3], axis=-1).mean())
        q = enc[..., 3:7]
        q = q / np.clip(np.linalg.norm(q, axis=-1, keepdims=True), 1e-8, None)
        log[f"avg_per_{name}_quat_magnitude"] = float(
            (2.0 * np.sqrt(np.clip(1 - q[..., -1] ** 2, 0, None))).mean())
        if name == "chunk" and enc.shape[-1] == 8:
            log["avg_per_chunk_scale"] = float(enc[..., 7].mean())
    if "memory_tokens" in pred and pred["memory_tokens"] is not None:
        mem = _np(pred["memory_tokens"])
        B, N = mem.shape[:2]
        if N > 1:
            m = mem / np.clip(np.linalg.norm(mem, axis=-1, keepdims=True), 1e-8, None)
            sim = np.einsum("bnd,bmd->bnm", m, m)
            off = sim * (1.0 - np.eye(N)[None])
            log["avg_memory_token_similarity"] = float(off.sum() / (B * N * (N - 1)))


def gather_sequences(datasets: Sequence, use_random_sequences: bool,
                     rng: Optional[np.random.Generator] = None) -> list:
    """(dataset, seq_index, seq_name, n_frames) tuples: one random, or all."""
    rng = rng or np.random.default_rng()
    if use_random_sequences:
        ds = datasets[int(rng.integers(0, len(datasets)))]
        j = int(rng.integers(0, ds.sequence_list_len))
        return [(ds, j, ds.get_seq_name(j), ds.seq_frame_num[j])]
    return [(ds, j, ds.get_seq_name(j), ds.seq_frame_num[j])
            for ds in datasets for j in range(ds.sequence_list_len)]


def get_sequence_data(dataset, seq_index: int, seq_name: str, seq_num_frames: int) -> dict:
    """A whole sequence with a batch axis, GT re-expressed in the first
    camera's frame (scale_by_points=False, as the reference's eval)."""
    seq = dataset.get_data(seq_index, -1, None, np.arange(seq_num_frames))
    batch = {k: np.asarray(v)[None] for k, v in seq.items() if isinstance(v, np.ndarray)}
    e, _, world, _ = normalize_extrinsics_and_points(
        torch.as_tensor(batch["extrinsics"]), cam_points=torch.as_tensor(batch["cam_points"]),
        world_points=torch.as_tensor(batch["world_points"]),
        depths=torch.as_tensor(batch["depths"]),
        point_masks=torch.as_tensor(batch["point_masks"]), scale_by_points=False)
    batch["extrinsics"] = e.numpy()
    batch["world_points"] = world.numpy()
    batch["dataset_name"] = type(dataset).__name__
    batch["seq_name"] = seq["seq_name"]
    return batch


class Metrics:
    def __init__(self, mode: str = "test", overlap=(1, 1), chunk_width=(5, 5),
                 gt_alignment_type: str = "scale_from_poses",
                 full_seq_sample_mode: str = "chunk_overlap", use_random_sequences: bool = True,
                 max_points_for_icp_batch: int = 250000,
                 max_points_for_icp_full_seq: int = 500000,
                 trajectory_metrics: Optional[list] = None,
                 reconstruction_metrics: Optional[list] = None, visualize: bool = False,
                 save_for_visualization: bool = False, log_dir: Optional[str] = None, **_):
        self.mode = mode
        first = lambda v: v[0] if isinstance(v, (list, tuple)) else v  # noqa: E731
        as_range = lambda v: tuple(v) if isinstance(v, (list, tuple)) else (v, v)  # noqa: E731
        self.num_overlap = first(overlap)
        self.chunk_width = first(chunk_width)
        # validation samples width and overlap within these ranges per step
        self.overlap_range = as_range(overlap)
        self.chunk_width_range = as_range(chunk_width)
        self.gt_alignment_type = gt_alignment_type
        self.full_seq_sample_mode = full_seq_sample_mode
        self.use_random_sequences = use_random_sequences
        self.max_points_for_icp_batch = max_points_for_icp_batch
        self.max_points_for_icp_full_seq = max_points_for_icp_full_seq
        self.visualize = visualize
        self.save_for_visualization = save_for_visualization
        self.log_dir = log_dir
        # in a gang: concatenate metric states over every rank before compute
        gather_fn = allgather_rows if is_distributed() else None

        def build(entries):
            out = []
            for e in entries or []:
                m = instantiate(e) if isinstance(e, dict) else e
                if gather_fn is not None and getattr(m, "_gather", None) is None:
                    m._gather = gather_fn
                out.append(m)
            return out

        self.trajectory_metrics = build(trajectory_metrics)
        self.reconstruction_metrics = build(reconstruction_metrics)

    def _wants_points(self, preds: dict) -> bool:
        return bool(self.reconstruction_metrics) and ("world_points" in preds or "depth" in preds)

    # --- entry point --------------------------------------------------------
    def __call__(self, predictions: dict, batch: dict, pipeline,
                 datasets: Optional[Sequence] = None) -> tuple[dict, dict]:
        batch_metrics: dict = {}
        seq_metrics: dict = {}
        if self.trajectory_metrics or self._wants_points(predictions):
            batch_metrics = self.compute_batch_metrics(predictions, batch, pipeline.device)
            if datasets:
                seq_metrics = self.compute_full_sequence_metrics(datasets, pipeline)
        if self.visualize and datasets:
            self.visualize_sequence(datasets[0], pipeline)
        return batch_metrics, seq_metrics

    def compute_batch_metrics(self, predictions: dict, batch: dict, device=None) -> dict:
        out: dict = {}
        log_additional_data(predictions, out)
        want_points = self._wants_points(predictions)
        pred_poses, gt_poses, pred_pts, gt_pts = prepare_data_for_metrics(
            predictions, batch, max_points_icp=self.max_points_for_icp_batch,
            want_points=want_points, want_poses=bool(self.trajectory_metrics), device=device)
        title = f"seq: {batch.get('seq_name', [''])[0]}"
        prefix = f"{self.log_dir}/batch_" if self.log_dir else None
        for metric in self.trajectory_metrics:
            for b in range(pred_poses.shape[0]):
                metric.update(pred_poses[b], gt_poses[b])
            out.update(metric.compute())
            metric.reset()
            if prefix:
                metric.plot(pred_poses[0], gt_poses[0], title, prefix)
        if want_points:
            for metric in self.reconstruction_metrics:
                for p, g in zip(pred_pts, gt_pts):
                    if len(p) and len(g):
                        metric.update(p, g)
                out.update(metric.compute())
                metric.reset()
                if prefix and len(pred_pts[0]) and len(gt_pts[0]):
                    metric.plot(pred_pts[0], gt_pts[0], title, prefix)
        return out

    def run_sequence(self, seq_data: dict, pipeline) -> dict:
        """Full-sequence streaming inference + GT alignment."""
        preds, _ = pipeline.run_sequence(
            seq_data, sample_mode=self.full_seq_sample_mode, chunk_width=self.chunk_width,
            num_overlap=self.num_overlap, gt_alignment_type=self.gt_alignment_type)
        return preds

    def sequence_metrics(self, preds: dict, seq_data: dict, device=None,
                         title: str = "", img_path: Optional[str] = None) -> dict:
        """The metrics of one sequence's predictions, computed on ``device``
        (plots and .npy dumps under ``img_path`` when it is given)."""
        per_seq: dict = {}
        log_additional_data(preds, per_seq)
        pred_poses, gt_poses, pred_pts, gt_pts = prepare_data_for_metrics(
            preds, seq_data, max_points_icp=self.max_points_for_icp_full_seq,
            want_points=self._wants_points(preds), want_poses=bool(self.trajectory_metrics),
            device=device)
        for metric in self.trajectory_metrics:
            per_seq.update(metric.plot(pred_poses[0], gt_poses[0], title, img_path)[0])
        if pred_pts is not None:
            for metric in self.reconstruction_metrics:
                per_seq.update(metric.plot(pred_pts[0], gt_pts[0], title, img_path)[0])
        return per_seq

    def compute_full_sequence_metrics(self, datasets, pipeline, rng=None) -> dict:
        all_metrics: dict = {}
        for ds, j, seq_name, n_frames in gather_sequences(datasets, self.use_random_sequences,
                                                          rng):
            seq_data = get_sequence_data(ds, j, seq_name, n_frames)
            preds = self.run_sequence(seq_data, pipeline)
            name = seq_data["dataset_name"]
            if self.use_random_sequences:
                prefix_key = "seq_metrics/"
                img_path = f"{self.log_dir}/seq_" if self.log_dir else None
            else:
                prefix_key = f"{name}_{seq_name}/"
                img_path = f"{self.log_dir}/[{name}_{seq_name}]_" if self.log_dir else None
            if self.save_for_visualization and img_path:
                self.save_dict_for_visualization(preds, seq_data, img_path)
            per_seq = self.sequence_metrics(preds, seq_data, pipeline.device,
                                            f"{name}_seq[{seq_name}]", img_path)
            all_metrics.update({prefix_key + k: v for k, v in per_seq.items()})
        return all_metrics

    # --- visualization -------------------------------------------------------
    @staticmethod
    def _viz_dict(preds: dict, seq_data: dict) -> dict:
        image_hw = tuple(np.asarray(seq_data["images"]).shape[-2:])
        pe = torch.as_tensor(preds["pose_enc"]).float().cpu()
        if pe.shape[-1] == 9:
            extr, intr = pose_encoding_to_extri_intri(pe, image_hw)
        else:
            extr = pose_encoding_to_extri(pe)[..., :3, :4]
            intr = torch.as_tensor(seq_data["intrinsics"])
        out = {"extrinsic": _np(extr)[0], "intrinsic": _np(intr)[0]}
        if "images" not in preds:
            out["images"] = np.asarray(seq_data["images"])[0]
        for k in ("images", "world_points", "world_points_conf", "depth", "depth_conf"):
            if k in preds:
                out[k] = _np(preds[k])[0]
        return out

    def visualize_sequence(self, dataset, pipeline):
        """Serve the first sequence's predictions in the viser viewer. Without
        viser it raises ImportError before the sequence runs."""
        from ..viz.viser_viz import require_viser, viser_wrapper

        require_viser()
        seq_name = dataset.get_seq_name(0)
        seq_data = get_sequence_data(dataset, 0, seq_name, dataset.seq_frame_num[0])
        preds = self.run_sequence(seq_data, pipeline)
        return viser_wrapper(self._viz_dict(preds, seq_data), background_mode=False)

    def save_dict_for_visualization(self, preds: dict, seq_data: dict, save_path: str):
        np.save(f"{save_path}visualization_data.npy", self._viz_dict(preds, seq_data))
        gt = {
            "images": np.asarray(seq_data["images"])[0],
            "intrinsic": np.asarray(seq_data["intrinsics"])[0],
            "extrinsic": np.asarray(seq_data["extrinsics"])[0],
            "world_points": np.asarray(seq_data["world_points"])[0],
            "world_points_conf": np.asarray(seq_data["point_masks"])[0].astype(float),
            "depth": np.asarray(seq_data["depths"])[0][..., None],
        }
        gt["depth_conf"] = gt["world_points_conf"]
        np.save(f"{save_path}visualization_data_gt.npy", gt)
