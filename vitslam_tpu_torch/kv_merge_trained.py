"""KV-merge quality on the trained learning-loop checkpoint (port of
scripts/kv_merge_trained.py): the AlignmentHead that
``python -m vitslam_tpu_torch.learning_loop_demo`` trained on its frozen
random backbone, re-evaluated on the same held-out fixture under each
KV-merge setting. The merge has no parameters, so the exactly trained
weights load unchanged; the model sits at a loss minimum of the exact
features, so a delta's sign measures what the approximation costs.

    python -m vitslam_tpu_torch.kv_merge_trained [--demo-dir DIR]
        [--device cuda|cpu] [--report PATH]

Kept from the script: ``find_ckpt`` over ``<demo-dir>/ckpt`` (read with
``io/checkpoint.py::load_checkpoint``, which takes the port's train state
and the JAX package's), ``SETTINGS`` and the ``CHUNK_W`` guard (a setting
the aggregator would run exact, pool 1 or a stride at or above the 5-frame
chunk, raises), the demo's test config with its overrides and the merge
keywords (``learning_loop_demo.run_test``, whose ``cli.build_from_config``
reads ``VITSLAM_MLP_TAIL`` and ``VITSLAM_INT8``), the metric keys, the
worst-delta lines, and the splice of the section between the TRAINED-SWEEP
markers of the report, default ``<demo-dir>/KV_MERGE_QUALITY.md`` (never
the JAX package's docs/KV_MERGE_QUALITY.md). The port's train state holds
the trainable tensors only; the frozen backbone and heads are the test
model's seeded init, which is the init the demo trained over (the same
model config and ``seed_value``). The script's per-setting eval cache is
dropped: it was there for CPU evals of minutes each, and one setting's eval
takes seconds on the card.
"""
from __future__ import annotations

import argparse
import glob
import os
import os.path as osp
import tempfile
import time

BEGIN = "<!-- TRAINED-SWEEP-BEGIN -->"
END = "<!-- TRAINED-SWEEP-END -->"

# (pool, stride) settings that mean something at the demo's scale: a 2 x 2
# patch grid, so any pool >= 2 collapses a non-anchor frame's patch KV to
# one token and the anchor stride carries the signal (stride 2: every other
# frame exact; stride 3: anchors at in-chunk frames 0 and 3 of 5). The
# aggregator merges only when S > stride, so with the test config's chunk
# width of 5 a stride-5 setting would run exact: CHUNK_W guards that.
SETTINGS = [None, (2, 2), (2, 3)]
CHUNK_W = 5  # test_featureAlignedVGGT_vkitti.yaml chunk_width
METRIC_TAGS = ("ate_rmse", "rpe_trans_rmse", "rpe_rot_rmse", "chamfer_distance_rmse")
EVAL_SCENES = '["01", "02"]'
EVAL_FRAMES = 14


def find_ckpt(demo_dir: str) -> str:
    """The newest checkpoint under ``<demo_dir>/ckpt``: the latest link
    first, else any step checkpoint."""
    pats = [osp.join(demo_dir, "ckpt", "_latest_checkpoints", "*.ckpt"),
            osp.join(demo_dir, "ckpt", "**", "*.ckpt")]
    for p in pats:
        hits = sorted(glob.glob(p, recursive=True), key=os.path.getmtime)
        hits = [h for h in hits if osp.isfile(h)]
        if hits:
            return hits[-1]
    raise FileNotFoundError(f"no checkpoint under {demo_dir}/ckpt: run "
                            "python -m vitslam_tpu_torch.learning_loop_demo first")


def check_setting(setting) -> None:
    """Raise on a setting that would silently run exact: the aggregator
    merges only with pool > 1 and S > stride (S = CHUNK_W)."""
    if setting is None:
        return
    pool, stride = setting
    if not (pool > 1 and CHUNK_W > stride):
        raise ValueError(f"setting {setting} would silently disable merging (the aggregator "
                         f"needs pool > 1 and S > stride; S = {CHUNK_W})")


def splice(doc: str, block: str) -> str:
    """``doc`` with the text between the markers replaced by ``block`` (which
    carries the markers), or ``block`` appended; the rest is kept."""
    if BEGIN in doc and END in doc:
        head, rest = doc.split(BEGIN, 1)
        _, tail = rest.split(END, 1)
        return head + block.rstrip("\n") + tail
    return doc.rstrip("\n") + "\n\n" + block if doc.strip() else block


def section(rows: list, step: int, where: str) -> str:
    """The report's section over ``rows`` [(tag, metrics, seconds)], exact
    first: the table with each delta against exact, then each merged
    setting's worst delta."""
    keys = sorted({k for _, vals, _ in rows for k in vals if any(t in k for t in METRIC_TAGS)})
    exact = rows[0][1]
    lines = [
        BEGIN,
        "",
        "## Trained-checkpoint sweep (the quality signs that MEAN something)",
        "",
        f"`python -m vitslam_tpu_torch.kv_merge_trained` on {where} — the {step}-step trained "
        "feature-aligned checkpoint of `python -m vitslam_tpu_torch.learning_loop_demo`, "
        "re-evaluated under each merge setting on the same held-out fixture. The merge is "
        "parameter-free so the exact-trained weights load unchanged; the model is at a loss "
        "minimum w.r.t. exact features, so these deltas are genuine approximation cost "
        "(unlike the random-weight table, whose signs the caveat paragraph disclaims).",
        "",
        "At demo scale (2x2 patch grid) the pool axis is saturated — every pool>=2 collapses "
        "non-anchor patch KV to one token — so the table reads along the anchor-stride axis: "
        "p2s2 = every other frame exact, p2s3 = anchors at in-chunk frames 0 and 3 (3 of 5 "
        "frames merged). A stride >= the 5-frame chunk width would silently disable merging "
        "(aggregator requires S > stride), so the module rejects such settings.",
        "",
        "| setting | " + " | ".join(keys) + " |",
        "|---|" + "---|" * len(keys),
    ]
    for tg, vals, _ in rows:
        cells = []
        for k in keys:
            v = vals.get(k)
            if v is None:
                cells.append("—")
            elif tg == "exact" or not exact.get(k):
                cells.append(f"{v:.4f}")
            else:
                cells.append(f"{v:.4f} ({100 * (v - exact[k]) / exact[k]:+.1f}%)")
        lines.append(f"| {tg} | " + " | ".join(cells) + " |")
    lines.append("")
    for tg, vals, _ in rows[1:]:
        ds = [100 * (vals[k] - exact[k]) / exact[k] for k in keys if exact.get(k)]
        worst = max(ds) if ds else float("nan")
        lines.append(f"- {tg}: worst trajectory-metric delta {worst:+.1f}%")
    lines += ["", END]
    return "\n".join(lines) + "\n"


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--demo-dir", default=osp.join(tempfile.gettempdir(), "learning_loop_demo"))
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--report", default=None,
                    help="the report to splice into (default <demo-dir>/KV_MERGE_QUALITY.md)")
    args = ap.parse_args(argv)
    from .kv_merge_quality import report_path, tag

    out_path = report_path(args.report, args.demo_dir)
    from .bench import card, require_device
    from .io.checkpoint import load_checkpoint
    from .learning_loop_demo import FEATURE_OV, _data_ov, run_test

    device = require_device(args.device)
    ckpt_path = find_ckpt(args.demo_dir)
    raw = load_checkpoint(ckpt_path)
    weights = {**raw.get("frozen", {}), **raw["trainable"]}
    step = int(raw["step"])
    print(f"[kvt] checkpoint {ckpt_path} (step {step}, {len(raw['trainable'])} trained tensors)")
    root = osp.join(args.demo_dir, "vkitti")
    if not osp.isdir(root):
        raise FileNotFoundError(f"demo fixture missing at {root}")

    rows = []
    for setting in SETTINGS:
        check_setting(setting)
        tg = tag(setting)
        ov = (FEATURE_OV + _data_ov("test", root, EVAL_SCENES, fix_img_num=EVAL_FRAMES)
              + ["seed_value=0", f"logging.log_dir={args.demo_dir}/logs_kvt"])
        if setting:
            ov += [f"model.global_merge_pool={setting[0]}",
                   f"model.global_merge_stride={setting[1]}"]
        t0 = time.time()
        vals = run_test("test_featureAlignedVGGT_vkitti", ov, str(device), graft=weights,
                        labels=(f"trained+{tg}",))[0]
        rows.append((tg, {k: float(v) for k, v in vals.items()}, time.time() - t0))
    where = f"{device}, {card()}" if device.type == "cuda" else str(device)
    block = section(rows, step, where)
    doc = ""
    if osp.isfile(out_path):
        with open(out_path) as f:
            doc = f.read()
    os.makedirs(osp.dirname(out_path), exist_ok=True)
    with open(out_path, "w") as f:
        f.write(splice(doc, block))
    print(f"[kvt] report section -> {out_path}")
    print(block)
    return dict(rows=rows, step=step, report=out_path, checkpoint=ckpt_path)


if __name__ == "__main__":
    main()
