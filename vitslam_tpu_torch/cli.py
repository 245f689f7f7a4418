"""Command line entry point (port of vitslam_tpu/cli.py, the reference's
``training/run_model.py``):

    python -m vitslam_tpu_torch.cli --config test_featureAlignedVGGT_vkitti \\
        [--config-dir configs] [--device cuda|cpu] [--set key=value ...] \\
        [--num_devices N] [--num_nodes M --coordinator host:port --process_id k]

``--config`` selects the experiment, whose ``mode`` (train / validate /
test) comes from the config; ``--set a.b=c`` overrides a dotted path before
interpolation. The model is built on ``--device`` (the GPU unless the
caller asks for the CPU) with its weights drawn from ``seed_value``, then
loaded from ``checkpoint.model_checkpoint_path`` (and
``checkpoint.from_pretrained`` as the fallback) when the config names one,
each a checkpoint of the port or of the reference (``io/checkpoint.py``).
The model follows ``VITSLAM_MLP_TAIL`` and ``VITSLAM_INT8`` as every preset
does (``models/presets.py``), read when ``build_from_config`` builds it.

Several ranks: one reference command covers all of a host's devices, so
``--num_devices N`` makes this command a launcher that starts N ranks on
this node (``parallel.spawn_gang``), each the same command on
``cuda:<local rank>`` (or on the CPU with ``--device cpu``), and prints
each rank's output when all have finished. ``--num_nodes``,
``--coordinator`` (rank 0's host:port, needed with more than one node) and
``--process_id`` (this node's index) place the node in the gang: rank =
process_id * N + local rank. The backend is NCCL with ``--device cuda`` and
gloo with ``--device cpu``. The trainer then trains data-parallel over every
rank (``train.trainer``).
"""
from __future__ import annotations

import argparse
import math
import os
import sys

# the switch readers stay importable from here
from .models.presets import int8_from_env, mlp_tail_from_env, switch_overrides  # noqa: F401


def build_from_config(cfg, device: str = "cuda", mlp_tail: str | None = None,
                      int8: bool | None = None, init: bool = True):
    """Instantiate (model, loss, metrics, train_data, val/test data) from a
    composed config; the model on ``device``, its block switches from
    ``VITSLAM_MLP_TAIL`` / ``VITSLAM_INT8`` unless ``mlp_tail`` / ``int8``
    is given, seeded from ``seed_value`` (unless ``init`` is False: the
    caller then fills every parameter), then loaded from the config's
    checkpoint if it names one."""
    import torch

    from .config.loader import instantiate
    from .io.checkpoint import load_model_params
    from .nn.layers import init_weights

    seed = int(cfg.get("seed_value", 42))
    given = {k: v for k, v in dict(mlp_tail=mlp_tail, int8=int8).items() if v is not None}
    model = instantiate(cfg["model"], device=torch.device(device),
                        **{**switch_overrides(), **given})
    if init:
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


def rank_argv(argv, local_rank: int, coordinator: str) -> list[str]:
    """The command line of one rank started by the launcher."""
    return [sys.executable, "-m", "vitslam_tpu_torch.cli", *argv, "--local_rank",
            str(local_rank), "--coordinator", coordinator]


def launch(args, argv) -> list[str]:
    """Start this node's ranks and wait for them; returns their outputs."""
    from .parallel import clean_env, spawn_gang

    fixed = args.coordinator
    if args.num_nodes > 1 and (fixed is None or args.process_id is None):
        raise ValueError("--num_nodes > 1 needs --coordinator host:port and --process_id")
    per_node = max(args.num_devices, 1)
    # with a coordinator given, every node rendezvouses at it, so a failed
    # rendezvous cannot move to a fresh port
    outs, _ = spawn_gang(
        lambda i, port: rank_argv(argv, i, fixed or f"localhost:{port}"), per_node,
        timeout=math.inf, retries=0 if fixed else 2,
        env=clean_env({"LOCAL_WORLD_SIZE": str(per_node)}))
    for i, out in enumerate(outs):
        print(f"--- rank {(args.process_id or 0) * per_node + i} ---\n{out}")
    return outs


def _join_gang(args) -> str:
    """Join the gang as one rank; returns the rank's device."""
    import torch

    from .parallel import init_distributed

    per_node = max(args.num_devices, 1)
    rank = (args.process_id or 0) * per_node + args.local_rank
    os.environ["LOCAL_RANK"] = str(args.local_rank)
    os.environ.setdefault("LOCAL_WORLD_SIZE", str(per_node))
    if args.device.startswith("cuda"):
        torch.cuda.set_device(args.local_rank)
        device, backend = f"cuda:{args.local_rank}", "nccl"
    elif args.device == "cpu":
        device, backend = "cpu", "gloo"
    else:
        raise ValueError(f"--device must be cuda or cpu, got {args.device!r}")
    init_distributed(backend, args.coordinator, per_node * args.num_nodes, rank)
    return device


def main(argv=None):
    parser = argparse.ArgumentParser(description="vitslam_tpu_torch runner")
    parser.add_argument("--config", required=True)
    parser.add_argument("--config-dir", default="configs")
    parser.add_argument("--device", default="cuda",
                        help="where the model runs: cuda (default) or cpu")
    parser.add_argument("--num_nodes", type=int, default=1)
    parser.add_argument("--num_devices", type=int, default=0,
                        help="ranks to start on this node, one per GPU (cuda:0..N-1), or CPU "
                             "ranks with --device cpu (0 or 1: this process alone)")
    parser.add_argument("--coordinator", default=None,
                        help="host:port of rank 0's rendezvous (multi-node)")
    parser.add_argument("--process_id", type=int, default=None,
                        help="this node's index (multi-node)")
    parser.add_argument("--local_rank", type=int, default=None, help=argparse.SUPPRESS)
    parser.add_argument("--set", action="append", default=[], metavar="KEY=VALUE",
                        dest="overrides")
    argv = list(sys.argv[1:] if argv is None else argv)
    args = parser.parse_args(argv)
    distributed = max(args.num_devices, 1) * args.num_nodes > 1
    if distributed and args.local_rank is None:
        return launch(args, argv)
    if args.device.startswith("cuda"):
        import torch

        if not torch.cuda.is_available():
            raise SystemExit("vitslam_tpu_torch.cli: torch.cuda.is_available() is False; "
                             "the model runs on the GPU unless --device cpu is given")

    from .config.loader import compose
    from .train.trainer import Trainer

    device = _join_gang(args) if distributed else args.device
    cfg = compose(args.config, args.config_dir, overrides=args.overrides)
    if args.num_devices:
        cfg["num_devices"] = args.num_devices
    model, loss, metrics, train_data, val_data = build_from_config(cfg, device=device)
    try:
        trainer = Trainer(cfg, model, loss, train_data=train_data, val_data=val_data,
                          metrics=metrics, shape_buckets=cfg.get("shape_buckets"))
        return _run_mode(trainer, cfg.get("mode", "train"))
    finally:
        if distributed:
            import torch.distributed as dist

            dist.destroy_process_group()


def _run_mode(trainer, mode: str):
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
