"""KV-merge quality sweep (port of scripts/kv_merge_quality.py): the opt-in
KV compression of the global attention (``global_merge_pool`` /
``global_merge_stride``, ``models/aggregator.py``) swept over the 75/30
VKITTI fixture sequence, recording ATE / RPE / Chamfer and their deltas
against the exact path for both training-free variants (point- and
pose-aligned).

    python -m vitslam_tpu_torch.kv_merge_quality [--workdir DIR] [--frames 90]
        [--chunk 75] [--overlap 30] [--device cuda|cpu] [--report PATH]

Kept from the script: the six settings and two families, the small bf16
backbone of ``small_kwargs()``, the fixture (Scene01/clone, 56x84, seed 7)
read by ``VKittiDataset`` and ``get_sequence_data``, the full product
pipeline (``ChunkedPipeline.run_sequence`` with ``chunk_overlap`` and
``scale_from_poses``, ``prepare_data_for_metrics`` with an ICP cap of 2,000
points, ATE, RPE and Chamfer) and the report's table with its columns and
Delta% rule. Each family's weights are drawn once from a ``torch.Generator``
(seed 5) into the exact model and loaded into the model of every setting
(the merge has no parameters), so the numbers are not the JAX report's.
``run_setting`` runs one (family, setting) row. The models run on
``--device`` (the GPU unless the caller asks for the CPU); at the default
sizes the exact rows' global attention (1 x 675 tokens, 2 heads of 32) is
kernel K1 and the merged rows' (474-495 keys) is plain. Each row prints its
attention routes and kernel launches. The report goes to ``--report``
(default ``<workdir>/KV_MERGE_QUALITY.md``), never to the JAX package's
docs/KV_MERGE_QUALITY.md.
"""
from __future__ import annotations

import argparse
import os
import os.path as osp
import shutil
import tempfile
import time

import numpy as np

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
JAX_REPORT = osp.join(REPO, "docs", "KV_MERGE_QUALITY.md")

# (pool, stride): non-anchor frames' patch KV average-pooled pool x pool;
# every stride-th frame stays exact
SETTINGS = [None, (2, 5), (2, 10), (4, 5), (4, 10), (8, 10)]
FAMILIES = ("point", "pose")
KEYS = ["ATE", "RPE_trans", "RPE_rot", "chamfer_distance"]
WEIGHT_SEED = 5
FIXTURE_HW = (56, 84)
FIXTURE_SEED = 7
MAX_POINTS_ICP = 2000


def small_kwargs(dtype=None) -> dict:
    """The script's small backbone (a 2 x 2 patch grid at 28 x 28), bf16
    unless ``dtype`` says otherwise."""
    import torch

    return dict(img_size=28, patch_size=14, embed_dim=64, depth=4, num_heads=2,
                patch_embed_depth=2, intermediate_layers=(0, 1, 2, 3),
                dtype=dtype or torch.bfloat16, enable_camera=True)


def family_model(family: str, setting=None, device="cuda", dtype=None):
    """The ``family`` model ("point" or "pose") under ``setting`` ((pool,
    stride) or None for exact), on ``device``, weights not yet drawn; its
    blocks follow VITSLAM_MLP_TAIL and VITSLAM_INT8 as the presets' do."""
    from .models import PointAlignedVGGT, PoseAlignedVGGT
    from .models.presets import switch_overrides

    kw = dict(small_kwargs(dtype), **switch_overrides())
    if family == "point":
        cls, kw = PointAlignedVGGT, dict(kw, enable_depth=False, enable_point=True)
    elif family == "pose":
        cls, kw = PoseAlignedVGGT, dict(kw, enable_depth=True, enable_point=False)
    else:
        raise ValueError(f"family must be point or pose, got {family!r}")
    if setting:
        kw.update(global_merge_pool=setting[0], global_merge_stride=setting[1])
    return cls(**kw, device=device).eval()


def family_weights(family: str, device="cuda", dtype=None, seed: int = WEIGHT_SEED) -> dict:
    """The family's weights: the exact model's state drawn from a
    ``torch.Generator`` seeded with ``seed``."""
    import torch

    from .nn.layers import init_weights

    model = family_model(family, None, device, dtype)
    init_weights(model, torch.Generator(device=device).manual_seed(seed))
    return model.state_dict()


def tag(setting) -> str:
    return "exact" if setting is None else f"p{setting[0]}s{setting[1]}"


def load_sequence(root: str, frames: int) -> dict:
    """The fixture's Scene01/clone sequence as the eval reads it."""
    from .data.base import CommonConfig
    from .data.vkitti import VKittiDataset
    from .eval.orchestrator import get_sequence_data

    cc = CommonConfig(img_size=28, patch_size=14, fix_aspect_ratio=1.0, training=False)
    ds = VKittiDataset(cc, split="test", VKitti_DIR=root, sequence_ids=["01"],
                       settings=["clone"])
    return get_sequence_data(ds, 0, ds.get_seq_name(0), frames)


def sequence_metrics(preds: dict, seq: dict) -> dict:
    """ATE, RPE and (with points) Chamfer of one sequence's predictions,
    after the ICP of ``prepare_data_for_metrics`` (cap MAX_POINTS_ICP)."""
    from .eval.prepare import prepare_data_for_metrics
    from .eval.reconstruction import ChamferDistanceMetrics
    from .eval.trajectory import AbsoluteTrajectoryError, RelativePoseError

    pred_poses, gt_poses, pred_pts, gt_pts = prepare_data_for_metrics(
        preds, seq, max_points_icp=MAX_POINTS_ICP, want_points=True, want_poses=True)
    vals = {}
    vals.update(AbsoluteTrajectoryError().plot(pred_poses[0], gt_poses[0], "t", None)[0])
    vals.update(RelativePoseError().plot(pred_poses[0], gt_poses[0], "t", None)[0])
    if pred_pts is not None:
        vals.update(ChamferDistanceMetrics().plot(pred_pts[0], gt_pts[0], "t", None)[0])
    return {k: float(v) for k, v in vals.items() if np.isscalar(v)}


def predict(family: str, setting, seq: dict, weights: dict, chunk: int = 75,
            overlap: int = 30, device="cuda", dtype=None) -> tuple:
    """The ``family`` model under ``setting`` with ``weights`` over ``seq``
    through ``ChunkedPipeline.run_sequence`` (``chunk_overlap``,
    ``scale_from_poses``). Returns (predictions on the host, seconds,
    attention routes taken, kernel launches)."""
    import torch

    from .bench import launch_counters
    from .ops import ROUTE_COUNTS
    from .slam import ChunkedPipeline

    model = family_model(family, setting, device, dtype)
    model.load_state_dict(weights)
    counters = launch_counters()
    routes0 = dict(ROUTE_COUNTS)
    launches0 = {name: fn.launches for name, fn in counters.items()}
    t0 = time.time()
    preds, _ = ChunkedPipeline(model).run_sequence(
        seq, sample_mode="chunk_overlap", chunk_width=chunk, num_overlap=overlap,
        gt_alignment_type="scale_from_poses")
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    secs = time.time() - t0
    routes = {r: n - routes0.get(r, 0) for r, n in ROUTE_COUNTS.items()
              if n != routes0.get(r, 0)}
    launches = {name: fn.launches - launches0[name] for name, fn in counters.items()}
    return preds, secs, routes, launches


def run_setting(family: str, setting, seq: dict, weights: dict, chunk: int = 75,
                overlap: int = 30, device="cuda", dtype=None) -> tuple:
    """One row of the sweep: ``predict`` then ``sequence_metrics``. Returns
    (metrics, seconds, attention routes taken, kernel launches); the
    seconds count the whole pipeline and the metrics."""
    t0 = time.time()
    preds, _, routes, launches = predict(family, setting, seq, weights, chunk, overlap,
                                         device, dtype)
    vals = sequence_metrics(preds, seq)
    return vals, time.time() - t0, routes, launches


def sweep(seq: dict, chunk: int = 75, overlap: int = 30, device="cuda") -> list:
    """Every (family, setting) row in bf16: [(family, tag, metrics, seconds,
    routes, launches)], each family's weights drawn once."""
    rows = []
    for fam in FAMILIES:
        weights = family_weights(fam, device)
        for setting in SETTINGS:
            vals, secs, routes, launches = run_setting(fam, setting, seq, weights, chunk,
                                                       overlap, device)
            rows.append((fam, tag(setting), vals, secs, routes, launches))
            fired = {k: v for k, v in launches.items() if v}
            print(f"[kvq] {fam}/{tag(setting)}: {({k: round(v, 4) for k, v in vals.items()})} "
                  f"in {secs:.2f} s; routes {routes}; launches {fired}", flush=True)
    return rows


def _pick(vals: dict, key: str):
    for k, v in vals.items():
        if key.lower() in k.lower():
            return v
    return None


def report(rows: list, frames: int, chunk: int, overlap: int, where: str) -> str:
    """The script's report over ``rows`` (``sweep``'s): one table row per
    (family, setting), each metric with its delta (merged - exact) / exact
    in percent."""
    lines = [
        "# KV-merge quality sweep (synthetic weights, 75/30 fixture)",
        "",
        f"`python -m vitslam_tpu_torch.kv_merge_quality --frames {frames} --chunk {chunk} "
        f"--overlap {overlap}` on {where} — small random backbone (the port's seeded "
        f"generator), VKITTI fixture Scene01/clone, {frames} frames, chunk "
        f"{chunk}/{overlap}. Deltas are (merged - exact)/exact; the speed axis is "
        "`VITSLAM_TOKEN_MERGE=<pool>,<stride> python -m vitslam_tpu_torch.bench` on the "
        "flagship point-aligned model at 75/30.",
        "",
        "**How to read this (random weights):** the sweep executes the FULL product "
        "pipeline (backbone -> heads -> chunk merge -> GT alignment -> ICP -> metrics) "
        "under every merge setting, so it gates *integration* and bounds the *perturbation "
        "scale*. The signed direction of the deltas is NOT quality evidence: random-weight "
        "predictions are chaos, and KV averaging smooths them. A quality-vs-speed call needs "
        "trained weights (`python -m vitslam_tpu_torch.kv_merge_trained` re-evaluates the "
        "learning-loop demo's trained head); until then the merge stays opt-in "
        "(`VITSLAM_TOKEN_MERGE`).",
        "",
        "| variant | setting | " + " | ".join(f"{k} (Δ%)" for k in KEYS) + " |",
        "|---|---|" + "---|" * len(KEYS),
    ]
    exacts = {row[0]: row[2] for row in rows if row[1] == "exact"}
    for fam, tg, vals, *_ in rows:
        cells = []
        for k in KEYS:
            v, e = _pick(vals, k), _pick(exacts[fam], k)
            if v is None:
                cells.append("—")
            elif tg == "exact" or not e:
                cells.append(f"{v:.4f}")
            else:
                cells.append(f"{v:.4f} ({100 * (v - e) / e:+.1f}%)")
        lines.append(f"| {fam} | {tg} | " + " | ".join(cells) + " |")
    return "\n".join(lines) + "\n"


def report_path(path, default_dir: str) -> str:
    """``path`` (or ``<default_dir>/KV_MERGE_QUALITY.md``) as an absolute
    path; the JAX package's docs/KV_MERGE_QUALITY.md is refused."""
    out = osp.abspath(path or osp.join(default_dir, "KV_MERGE_QUALITY.md"))
    if osp.realpath(out) == osp.realpath(JAX_REPORT):
        raise SystemExit(f"{JAX_REPORT} is the JAX package's report; write elsewhere")
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workdir", default=osp.join(tempfile.gettempdir(), "kv_merge_quality"))
    ap.add_argument("--frames", type=int, default=90)
    ap.add_argument("--chunk", type=int, default=75)
    ap.add_argument("--overlap", type=int, default=30)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--report", default=None,
                    help="where the markdown report goes (default <workdir>/KV_MERGE_QUALITY.md)")
    args = ap.parse_args(argv)
    out_path = report_path(args.report, args.workdir)
    from .bench import card, require_device
    from .utils.fixtures import write_vkitti_fixture

    device = require_device(args.device)
    shutil.rmtree(args.workdir, ignore_errors=True)
    root = osp.join(args.workdir, "vkitti")
    write_vkitti_fixture(root, scene="01", setting="clone", n_frames=args.frames,
                         hw=FIXTURE_HW, seed=FIXTURE_SEED)
    seq = load_sequence(root, args.frames)
    t0 = time.time()
    rows = sweep(seq, args.chunk, args.overlap, device)
    secs = time.time() - t0
    where = f"{device}, {card()}" if device.type == "cuda" else str(device)
    text = report(rows, args.frames, args.chunk, args.overlap, where)
    os.makedirs(osp.dirname(out_path), exist_ok=True)
    with open(out_path, "w") as f:
        f.write(text)
    print(f"[kvq] report -> {out_path} (sweep {secs:.1f} s)")
    print(text)
    return dict(rows=rows, report=out_path, seconds=secs)


if __name__ == "__main__":
    main()
