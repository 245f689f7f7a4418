"""Command line entry point (port of vitslam_tpu/cli.py, the reference's
``training/run_model.py``):

    python -m vitslam_tpu_torch.cli --config test_featureAlignedVGGT_vkitti \\
        [--config-dir configs] [--device cuda|cpu] [--set key=value ...]

``--config`` selects the experiment, whose ``mode`` (train / validate /
test) comes from the config; ``--set a.b=c`` overrides a dotted path before
interpolation. The model is built on ``--device`` (the GPU unless the
caller asks for the CPU) with its weights drawn from ``seed_value``, then
loaded from ``checkpoint.model_checkpoint_path`` (and
``checkpoint.from_pretrained`` as the fallback) when the config names one.
The fused block tails of the backbone (kernel K5) follow the reference's
switch ``VITSLAM_MLP_TAIL`` (1 = both sites, mlp, proj; default off), read
here once. Runs over several nodes belong to the distributed slice.
"""
from __future__ import annotations

import argparse
import os
import sys

# VITSLAM_MLP_TAIL -> Block(mlp_tail=...) (the reference's _tail_sites)
MLP_TAIL_ENV = {"": "off", "0": "off", "off": "off", "xla": "off", "auto": "off",
                "1": "both", "mlp": "mlp", "proj": "proj"}


def mlp_tail_from_env(environ=os.environ) -> str:
    """The fused tail sites the reference would take under its
    ``VITSLAM_MLP_TAIL`` switch (an unknown value is off, as there)."""
    return MLP_TAIL_ENV.get(environ.get("VITSLAM_MLP_TAIL", "0"), "off")


def build_from_config(cfg, device: str = "cuda", mlp_tail: str = "off"):
    """Instantiate (model, loss, metrics, train_data, val/test data) from a
    composed config; the model on ``device``, seeded from ``seed_value``,
    then loaded from the config's checkpoint if it names one."""
    import torch

    from .config.loader import instantiate
    from .io.checkpoint import load_model_params
    from .nn.layers import init_weights

    seed = int(cfg.get("seed_value", 42))
    model = instantiate(cfg["model"], device=torch.device(device), mlp_tail=mlp_tail)
    init_weights(model, torch.Generator(device=device).manual_seed(seed))
    model.eval()
    loss = instantiate(cfg["loss"])
    metrics = instantiate(cfg["metrics"]) if "metrics" in cfg else None

    data_cfg = cfg.get("data", {})
    train_data = instantiate(data_cfg["train"]) if "train" in data_cfg else None
    val_data = None
    for split in ("val", "test"):
        # default_dataset.yaml ships val/test templates without datasets:
        # only a split the experiment filled is built
        if data_cfg.get(split, {}).get("dataset_configs_or_datasets"):
            val_data = instantiate(data_cfg[split])
    if train_data is not None:
        train_data.seed = seed

    ckpt_cfg = cfg.get("checkpoint", {})
    explicit = ckpt_cfg.get("model_checkpoint_path")
    pretrained = ckpt_cfg.get("from_pretrained")
    if explicit:
        load_model_params(explicit, model, fallback_path=pretrained)
    elif pretrained and os.path.exists(str(pretrained)):
        load_model_params(pretrained, model)
    elif pretrained:
        print(f"warning: pretrained checkpoint {pretrained!r} not found locally; "
              "starting from the seeded weights", file=sys.stderr)
    return model, loss, metrics, train_data, val_data


def main(argv=None):
    parser = argparse.ArgumentParser(description="vitslam_tpu_torch runner")
    parser.add_argument("--config", required=True)
    parser.add_argument("--config-dir", default="configs")
    parser.add_argument("--device", default="cuda",
                        help="where the model runs: cuda (default) or cpu")
    parser.add_argument("--num_nodes", type=int, default=1)
    parser.add_argument("--set", action="append", default=[], metavar="KEY=VALUE",
                        dest="overrides")
    args = parser.parse_args(argv)
    if args.num_nodes > 1:
        raise NotImplementedError("runs over more than one node are not ported yet: they "
                                  "belong to the distributed slice of the port (ROADMAP "
                                  "queue 1)")

    from .config.loader import compose
    from .train.trainer import Trainer

    cfg = compose(args.config, args.config_dir, overrides=args.overrides)
    model, loss, metrics, train_data, val_data = build_from_config(
        cfg, device=args.device, mlp_tail=mlp_tail_from_env())
    trainer = Trainer(cfg, model, loss, train_data=train_data, val_data=val_data,
                      metrics=metrics, shape_buckets=cfg.get("shape_buckets"))
    mode = cfg.get("mode", "train")
    if mode == "train":
        return trainer.fit()
    if mode == "validate":
        result = trainer.validate(0)
    elif mode == "test":
        result = trainer.test()
    else:
        raise ValueError(f"unknown mode {mode!r}")
    print(result)
    return result


if __name__ == "__main__":
    main()
