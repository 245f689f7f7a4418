"""Learning-loop demo (port of scripts/learning_loop_demo.py): train the
feature-aligned model's AlignmentHead on the synthetic VKITTI fixture and
show its trajectory metrics against its random init and against the
training-free point- and pose-aligned baselines on the same frozen
backbone weights.

    python -m vitslam_tpu_torch.learning_loop_demo [--workdir DIR]
        [--steps 300] [--device cuda|cpu] [--report PATH]

Kept from the script: the tiny model overrides (a 2-block backbone at
28x28), the data overrides, the four configs
(train_featureAlignedVGGT_vkitti, then the feature-, point- and
pose-aligned test configs), ``graft_backbone`` (on the port's parameter
dicts), the training on Scene02 with Scene01 held out, the four rows and
the trained-against-init deltas. The fixture is written by
``utils.fixtures.write_vkitti_fixture`` (the reference's files, byte for
byte). Every model is built by ``cli.build_from_config`` on ``--device``
(the GPU unless the caller asks for the CPU; its blocks follow
``VITSLAM_MLP_TAIL`` and ``VITSLAM_INT8``), its weights seeded from the
port's own generator, so the numbers are not the JAX report's; the report
puts that report's deltas beside the port's. The report goes to
``--report`` (default ``<workdir>/LEARNING_LOOP_DEMO.md``), never to the
JAX package's docs/LEARNING_LOOP_DEMO.md, which this module only reads.
"""
from __future__ import annotations

import argparse
import csv
import os
import os.path as osp
import re
import shutil
import subprocess
import tempfile
import time

import numpy as np

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
CONFIGS = osp.join(REPO, "configs")
JAX_REPORT = osp.join(REPO, "docs", "LEARNING_LOOP_DEMO.md")

# the script's overrides: a 2-block backbone at 28x28 (4 patches a frame)
MODEL_OV = [
    "model.embed_dim=64",
    "model.depth=2",
    "model.num_heads=2",
    "model.patch_embed_depth=1",
    "model.intermediate_layers=[0, 1, 1, 1]",
    "model.enable_point=true",
]
FEATURE_OV = MODEL_OV + ["model.num_memory_tokens=4"]
METRIC_TAGS = ("ate_rmse", "rpe_trans_rmse", "rpe_rot_rmse", "chamfer_distance_rmse")
# the fixture's frames in the train scene (02) and the held-out one (01);
# the test mode runs over both whole
SCENE_FRAMES = (40, 16)


def _data_ov(split: str, root: str, scene_ids, fix_img_num: int = 0) -> list:
    ov = [
        f"vkitti_dir={root}",
        "img_size=28",
        f"data.{split}.common_config.fix_aspect_ratio=1.0",
        f"data.{split}.dataset_configs_or_datasets.0.sequence_ids={scene_ids}",
        f"data.{split}.dataset_configs_or_datasets.0.settings=[clone]",
        f"data.{split}.dataset_configs_or_datasets.0.common_conf.fix_aspect_ratio=1.0",
    ]
    if fix_img_num:
        ov += [
            f"data.{split}.common_config.fix_img_num={fix_img_num}",
            f"data.{split}.dataset_configs_or_datasets.0.common_conf.fix_img_num={fix_img_num}",
            f"data.{split}.img_nums=[{fix_img_num}, {fix_img_num}]",
        ]
    return ov


def graft_backbone(dst: dict, src: dict) -> tuple:
    """Copy every tensor of ``src`` whose name ``dst`` also has into a copy
    of ``dst`` (parameter name -> tensor), so every model family evaluates
    the same backbone weights: the script's recursive intersection of the
    shared top-level modules, on flat names. Returns (the grafted dict, the
    shared top-level modules). A shared name of another shape raises."""
    top = lambda d: {n.split(".")[0] for n in d}  # noqa: E731
    shared = sorted(top(dst) & top(src))
    if not shared:
        raise ValueError(f"no shared modules between {sorted(top(dst))} and {sorted(top(src))}")
    out, copied = dict(dst), 0
    for name in dst.keys() & src.keys():
        if tuple(np.shape(dst[name])) != tuple(np.shape(src[name])):
            raise ValueError(f"leaf {name} shape differs: {tuple(np.shape(dst[name]))} vs "
                             f"{tuple(np.shape(src[name]))}")
        out[name] = src[name]
        copied += 1
    if not copied:
        raise ValueError("graft copied nothing")
    return out, shared


def _load(model, params: dict) -> None:
    """Copy ``params`` (name -> tensor) into ``model``'s parameters; every
    parameter must be given."""
    import torch

    own = dict(model.named_parameters())
    missing = sorted(set(own) - set(params))
    if missing:
        raise KeyError(f"parameters not given: {missing[:5]} ({len(missing)})")
    with torch.no_grad():
        for n, p in own.items():
            p.copy_(params[n])


def _snapshot(model) -> dict:
    return {n: p.detach().clone() for n, p in model.named_parameters()}


def run_test(cfg_name: str, overrides: list, device: str, params=(), graft=None,
             labels=("",)) -> list:
    """The test mode of ``cfg_name`` (one model built), once with the
    model's parameters set to each of ``params``, or once with its seeded
    init and ``graft``'s shared tensors grafted on; the full-sequence
    metrics of each run."""
    from .cli import build_from_config
    from .config.loader import compose
    from .train.trainer import Trainer

    cfg = compose(cfg_name, CONFIGS, overrides=overrides)
    # given parameters replace every seeded one: no init to draw then
    model, loss, metrics, _, test_data = build_from_config(cfg, device=device,
                                                           init=graft is not None)
    if graft is not None:
        grafted, shared = graft_backbone(_snapshot(model), graft)
        params = [grafted]
        print(f"[demo] {labels[0]} shares backbone modules: {shared}")
    results = []
    for p, label in zip(params, labels):
        _load(model, p)
        trainer = Trainer(cfg, model, loss, val_data=test_data, metrics=metrics)
        t0 = time.time()
        out = trainer.test()
        print(f"[demo] test({label}) in {time.time() - t0:.1f}s: "
              f"{ {k: round(float(v), 4) for k, v in out.items()} }")
        results.append({k: float(v) for k, v in out.items()})
    return results


def train(root: str, workdir: str, steps: int, device: str):
    """The feature-aligned model trained ``steps`` steps on Scene02:
    (init parameters, trained parameters, seconds, the logged objectives)."""
    from .cli import build_from_config
    from .config.loader import compose
    from .train.trainer import Trainer

    train_ov = (
        FEATURE_OV
        + _data_ov("train", root, '["02"]', fix_img_num=12)
        + _data_ov("val", root, '["01"]', fix_img_num=14)
        + [
            "seed_value=0",
            f"max_steps={steps}",
            f"val_epoch_freq={steps}",
            "max_img_per_gpu=12",
            "chunk_width=[6, 6]",
            "num_overlap=[2, 2]",
            "shape_buckets=[[6, 2]]",
            f"checkpoint.save_dir={workdir}/ckpt",
            f"checkpoint.save_freq={steps}",
            "checkpoint.resume_from_checkpoint=false",
            f"logging.log_dir={workdir}/logs",
            "logging.log_freq=10",
            # the backbone and its heads stay frozen, so the baselines see
            # the weights training saw
            "optim.frozen_module_names=[\"*aggregator*\", \"*camera_head*\","
            " \"*depth_head*\", \"*point_head*\"]",
        ]
    )
    cfg = compose("train_featureAlignedVGGT_vkitti", CONFIGS, overrides=train_ov)
    model, loss, metrics, train_data, val_data = build_from_config(cfg, device=device)
    trainer = Trainer(cfg, model, loss, train_data=train_data, val_data=val_data,
                      metrics=metrics, shape_buckets=cfg.get("shape_buckets"))
    trainer.init_state()
    init = _snapshot(model)
    print(f"[demo] training {steps} steps on the Scene02 fixture on {device} ...")
    t0 = time.time()
    trainer.fit()
    if device.startswith("cuda"):
        import torch

        torch.cuda.synchronize()
    secs = time.time() - t0
    print(f"[demo] trained in {secs:.1f}s")
    objectives = []
    if trainer.logger.path and osp.isfile(trainer.logger.path):
        with open(trainer.logger.path) as f:
            objectives = [(int(r["step"]), float(r["objective"])) for r in csv.DictReader(f)
                          if r.get("objective")]
    return init, _snapshot(model), secs, objectives


def _mean(m: dict, tag: str) -> float:
    vs = [v for k, v in m.items() if k.endswith(tag)]
    return sum(vs) / len(vs) if vs else float("nan")


def jax_deltas(path: str = JAX_REPORT) -> dict:
    """tag -> the JAX report's trained-against-init delta in percent."""
    if not osp.isfile(path):
        return {}
    with open(path) as f:
        text = f.read()
    return {m.group(1): float(m.group(2)) for m in
            re.finditer(r"- mean (\w+): init [\d.]+ -> trained [\d.]+ \(([+-][\d.]+)%\)", text)}


def card() -> str:
    """The card's name and power limit as nvidia-smi gives them, or why not."""
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30, check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "no nvidia-smi"


def report(results: dict, steps: int, device: str, train_secs: float, eval_secs: float,
           objectives: list) -> str:
    keys = sorted({k for m in results.values() for k in m if any(t in k for t in METRIC_TAGS)})
    where = f"{device}, {card()}" if device.startswith("cuda") else device
    lines = [
        "# Learning-loop demo (the PyTorch port): trained feature alignment vs "
        "training-free baselines",
        "",
        f"Generated by `python -m vitslam_tpu_torch.learning_loop_demo --steps {steps} "
        f"--device {device}` on {where}: training {train_secs:.1f} s, the four evaluations "
        f"{eval_secs:.1f} s.",
        "",
        "All four rows run the same frozen backbone (the aggregator and the camera, depth and "
        "point heads grafted from the feature-aligned init); only the AlignmentHead differs "
        f"(its init against {steps} steps on the Scene02 fixture; Scene01 is held out). The "
        "weights come from the port's own seeded generator, not from the JAX package's init, "
        "so these numbers are not the JAX report's (docs/LEARNING_LOOP_DEMO.md); its deltas "
        "stand beside the port's below. Synthetic fixture data: this checks the loop, not "
        "real-world quality.",
        "",
        "| metric | feature@init | feature@trained | point-aligned | pose-aligned |",
        "|---|---|---|---|---|",
    ]
    for k in keys:
        row = [k] + [("-" if results[c].get(k) is None else f"{results[c][k]:.4f}")
                     for c in ("feature_init", "feature_trained", "point", "pose")]
        lines.append("| " + " | ".join(row) + " |")
    theirs = jax_deltas()
    lines += ["", "Trained-vs-init deltas (mean over both scenes; negative = trained is "
              "better), beside the JAX report's:", "",
              "| metric | init | trained | delta | JAX report's delta |", "|---|---|---|---|---|"]
    for tag in METRIC_TAGS:
        a, b = _mean(results["feature_init"], tag), _mean(results["feature_trained"], tag)
        delta = f"{100 * (b - a) / a:+.1f}%" if np.isfinite(a) and np.isfinite(b) and a > 0 \
            else "-"
        j = f"{theirs[tag]:+.1f}%" if tag in theirs else "-"
        lines.append(f"| mean {tag} | {a:.4f} | {b:.4f} | {delta} | {j} |")
    if objectives:
        lines += ["", "Training objective (logged every 10 steps): "
                  + ", ".join(f"step {s}: {o:.4g}" for s, o in objectives)]
    return "\n".join(lines) + "\n"


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workdir", default=osp.join(tempfile.gettempdir(), "learning_loop_demo"))
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--report", default=None,
                    help="where the markdown report goes (default <workdir>/LEARNING_LOOP_DEMO.md)")
    args = ap.parse_args(argv)
    report_path = osp.abspath(args.report or osp.join(args.workdir, "LEARNING_LOOP_DEMO.md"))
    if osp.realpath(report_path) == osp.realpath(JAX_REPORT):
        raise SystemExit(f"{JAX_REPORT} is the JAX package's report; write elsewhere")
    if args.device.startswith("cuda"):
        import torch

        if not torch.cuda.is_available():
            raise SystemExit("learning_loop_demo: torch.cuda.is_available() is False; "
                             "the demo runs on the GPU unless --device cpu is given")
    from .utils.fixtures import write_vkitti_fixture

    shutil.rmtree(args.workdir, ignore_errors=True)
    root = osp.join(args.workdir, "vkitti")
    # train scene (02) and held-out scene (01), geometrically consistent
    train_frames, held_out = SCENE_FRAMES
    write_vkitti_fixture(root, scene="02", setting="clone", n_frames=train_frames, hw=(56, 84),
                         seed=3)
    write_vkitti_fixture(root, scene="01", setting="clone", n_frames=held_out, hw=(56, 84),
                         seed=5)

    init, trained, train_secs, objectives = train(root, args.workdir, args.steps, args.device)
    t0 = time.time()
    eval_scenes, n = '["01", "02"]', 14
    feat_ov = (FEATURE_OV + _data_ov("test", root, eval_scenes, fix_img_num=n)
               + ["seed_value=0", f"logging.log_dir={args.workdir}/logs_eval"])
    results = dict(zip(("feature_init", "feature_trained"), run_test(
        "test_featureAlignedVGGT_vkitti", feat_ov, args.device, params=(init, trained),
        labels=("feature@init", "feature@trained"))))
    for name, cfg_name in (("point", "test_pointAlignedWrappedVGGT_vkitti"),
                           ("pose", "test_poseAlignedWrappedVGGT_vkitti")):
        base_ov = (MODEL_OV + _data_ov("test", root, eval_scenes, fix_img_num=n)
                   + ["seed_value=0", "chunk_width=[5, 5]", "num_overlap=[1, 1]",
                      f"logging.log_dir={args.workdir}/logs_eval"])
        if name == "pose":  # pose-aligned disables the point head; keep the shared modules
            base_ov = [o for o in base_ov if "enable_point" not in o]
        results[name] = run_test(cfg_name, base_ov, args.device, graft=init, labels=(name,))[0]
    eval_secs = time.time() - t0
    text = report(results, args.steps, args.device, train_secs, eval_secs, objectives)
    os.makedirs(osp.dirname(report_path), exist_ok=True)
    with open(report_path, "w") as f:
        f.write(text)
    print(f"[demo] report written to {report_path}")
    print(text)
    return dict(results=results, train_s=train_secs, eval_s=eval_secs, report=report_path,
                objectives=objectives)


if __name__ == "__main__":
    main()
