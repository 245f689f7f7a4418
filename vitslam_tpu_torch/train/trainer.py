"""Trainer (port of vitslam_tpu/train/trainer.py): per step a batch from
``train_data``, a random (chunk width, overlap) with the reference's
validity rules (or from ``shape_buckets``), first-frame GT normalisation,
chunking, the train step, CSV logging, and checkpoints with resume through
the ``_latest`` link. Seeding as in the reference: numpy draws from
``(seed + node) * max_steps``, the dropout and loss draws from a
``torch.Generator`` seeded with ``seed + node``, where ``node`` is
``parallel.node_index()`` (the counterpart of ``jax.process_index()``).

``train_data`` is any object whose ``get_loader(epoch)`` yields batches of
numpy arrays. ``validate`` (every ``val_epoch_freq`` steps) and ``test`` run
``ChunkedPipeline.run_sequence`` with GT alignment and score it with the
``eval.Metrics`` orchestrator, logging through the CSV logger.

Data parallelism: in a gang of more than one rank (``parallel``; the CLI's
``--num_devices``), the trainer lays the ranks out as a data mesh. The
ranks of a node share their node's seed, so they draw the same global
batch and chunk shapes; each takes its rows when B divides over the data
axis, else the whole batch (``train_step``), and the step's loss is the
global batch's. Every rank of the data group must draw the same chunk
shapes (a step checks it). Logging and checkpoint writes happen on rank 0.
Tensor parallelism (``num_model_shards`` > 1) and the orbax (sharded)
checkpoint backend belong to part 2 of the distributed slice and raise
NotImplementedError.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..io.checkpoint import CheckpointManager, load_checkpoint
from ..parallel import (
    allgather_rows,
    is_distributed,
    make_mesh,
    node_index,
    rank,
    replicate,
    shard_batch,
)
from ..slam import ChunkedPipeline, chunk_batch, generate_chunks, merge_chunk_outputs
from ..slam.chunking import normalize_extrinsics_and_points
from .logging_utils import CSVLogger, StepProgress
from .losses import MultitaskLoss
from .optim import build_optimizer, freeze_params
from .train_step import TrainState, make_train_step


def sample_chunk_shapes(rng: np.random.Generator, S: int, chunk_width_range, overlap_range,
                        buckets=None) -> tuple[int, int]:
    """A random (chunk_width, overlap): at least one full chunk fits and
    overlap < width. With ``buckets``, a random valid bucket entry instead.
    The numpy draws are the reference's, so one seed gives one sequence."""
    if buckets:
        valid = [(w, o) for (w, o) in buckets if S / w > 1 and o < w]
        if valid:
            w, o = valid[int(rng.integers(0, len(valid)))]
            return int(w), int(o)
    rev_w = np.arange(chunk_width_range[1], chunk_width_range[0] - 1, -1)
    max_w = int(rev_w[int(np.argmax((S / rev_w) > 1))])
    w = int(rng.integers(chunk_width_range[0], max_w + 1))
    rev_o = np.arange(overlap_range[1], overlap_range[0] - 1, -1)
    max_o = int(rev_o[int(np.argmax(rev_o < w))])
    o = int(rng.integers(overlap_range[0], max_o + 1))
    return w, o


def _part_2(what: str):
    raise NotImplementedError(f"{what} is not ported yet: it belongs to part 2 of the "
                              "distributed slice of the port (ROADMAP queue 1)")


class Trainer:
    def __init__(self, cfg: dict, model, loss: MultitaskLoss, train_data=None,
                 val_data=None, metrics=None, freeze_patterns=None, shape_buckets=None):
        self.cfg = cfg
        self.model = model
        self.loss = loss
        self.train_data = train_data
        self.val_data = val_data
        self.metrics = metrics
        self.shape_buckets = shape_buckets

        if int(cfg.get("num_model_shards", 1)) > 1:
            _part_2("tensor parallelism (num_model_shards > 1)")
        ckpt_cfg = cfg.get("checkpoint", {})
        if str(ckpt_cfg.get("backend", "msgpack")) == "orbax":
            _part_2("the orbax (sharded) checkpoint backend")
        # one data mesh over every rank of the gang (the reference's mesh
        # over all devices); a single process has none
        self.mesh = make_mesh(n_model=1) if is_distributed() else None
        if int(cfg.get("num_devices", 0)) > 1 and self.mesh is None:
            raise RuntimeError("num_devices > 1 needs a gang of ranks: launch with "
                               "python -m vitslam_tpu_torch.cli --num_devices N")

        self.max_steps = int(cfg.get("max_steps", 1000))
        self.sample_mode = cfg.get("sample_mode", "chunk_overlap")
        self.gt_alignment_type = cfg.get("gt_alignment_type", "scale_from_depths")
        cw = cfg.get("chunk_width", [3, 20])
        ov = cfg.get("num_overlap", [1, 5])
        self.chunk_width_range = cw if isinstance(cw, (list, tuple)) else [cw, cw]
        self.overlap_range = ov if isinstance(ov, (list, tuple)) else [ov, ov]
        self.val_freq = int(cfg.get("val_epoch_freq", 250))
        self.accum_steps = int(cfg.get("accum_steps", 1))
        self.exp_name = cfg.get("exp_name", "experiment")

        self.loss.setup_scheduling(self.max_steps)
        optim_cfg = cfg.get("optim", {})
        lr_opts = optim_cfg.get("options", {}).get("lr", {})
        self.optim_kwargs = dict(
            max_lr=float(lr_opts.get("max_value", 5e-5)),
            min_lr=float(lr_opts.get("min_value", 1e-8)),
            total_steps=self.max_steps,
            warmup_percent=float(lr_opts.get("linear_steps", 0.05)),
            weight_decay=float(optim_cfg.get("optimizer", {}).get("weight_decay", 0.05)),
            grad_clip_norm=float(optim_cfg.get("gradient_clip", {}).get("max_norm", 1.0)),
            accum_steps=self.accum_steps)
        self.freeze_patterns = list(freeze_patterns if freeze_patterns is not None
                                    else optim_cfg.get("frozen_module_names", []))

        log_cfg = cfg.get("logging", {})
        self.logger = CSVLogger(log_cfg.get("log_dir", "logs"), self.exp_name,
                                write=rank() == 0)
        self.log_freq = int(log_cfg.get("log_freq", 10))
        self.ckpt = CheckpointManager(ckpt_cfg.get("save_dir", "ckpt"), self.exp_name,
                                      save_freq=int(ckpt_cfg.get("save_freq", 500)))
        self.resume = bool(ckpt_cfg.get("resume_from_checkpoint", False))

        self.seed = int(cfg.get("seed_value", 42))
        # node-offset seeding: the ranks of a node stand for the devices of
        # one reference process and draw one global batch
        node = node_index()
        self.rng_np = np.random.default_rng((self.seed + node) * self.max_steps)
        self.generator = torch.Generator().manual_seed(self.seed + node)
        self.state: Optional[TrainState] = None
        self.schedule = None
        self._step_cache: dict = {}

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    # --- state -----------------------------------------------------------
    def init_state(self, sample_batch: Optional[dict] = None) -> TrainState:
        """Freeze by the patterns, build the optimizer over the trainable
        parameters, and resume from the ``_latest`` link when asked to.
        (The model already holds its weights; ``sample_batch`` is accepted
        for the reference's signature.)"""
        trainable = freeze_params(self.model, self.freeze_patterns)
        optimizer, self.schedule = build_optimizer(trainable, **self.optim_kwargs)
        self.state = TrainState(trainable=trainable, optimizer=optimizer, step=0)
        if self.mesh is not None:
            replicate(trainable, self.mesh)
        if self.resume:
            path = self.ckpt.resume_path()
            if path:
                self.restore(load_checkpoint(path))
                print(f"resumed from {path} at step {self.state.step}")
        return self.state

    def state_dict(self) -> dict:
        """The train state as saved: trainable tensors by name, optimizer
        state, step."""
        s = self.state
        return {"trainable": {n: p.detach() for n, p in s.trainable.items()},
                "optimizer": s.optimizer.state_dict(), "step": s.step}

    def restore(self, saved: dict) -> None:
        with torch.no_grad():
            for n, p in self.state.trainable.items():
                p.copy_(saved["trainable"][n])
        self.state.optimizer.load_state_dict(saved["optimizer"])
        self.state.step = int(saved["step"])

    def _get_step_fn(self, num_overlap: int):
        if num_overlap not in self._step_cache:
            self._step_cache[num_overlap] = make_train_step(
                self.model, self.loss, num_overlap, gt_alignment_type=self.gt_alignment_type,
                use_gt_poses=self.sample_mode in ("chunk_gt", "two_chunks"),
                data_group=None if self.mesh is None else self.mesh.group("data"))
        return self._step_cache[num_overlap]

    @staticmethod
    def normalize_batch(batch: dict) -> dict:
        """First-frame-centric GT normalisation before the forward pass
        (scale_by_points=False, as the reference's training)."""
        if "extrinsics" not in batch:
            return batch
        out = dict(batch)
        world = batch.get("world_points")
        e, _, w, _ = normalize_extrinsics_and_points(
            torch.as_tensor(batch["extrinsics"]),
            world_points=None if world is None else torch.as_tensor(world))
        out["extrinsics"] = e.numpy()
        if w is not None:
            out["world_points"] = w.numpy()
        return out

    def _prepare_chunks(self, batch: dict, width: int, overlap: int):
        batch = self.normalize_batch(batch)
        S = batch["images"].shape[1]
        indices = generate_chunks(S, self.sample_mode, width, overlap)
        chunks_np = chunk_batch({k: v for k, v in batch.items() if isinstance(v, np.ndarray)},
                                indices)
        merged_np = merge_chunk_outputs(chunks_np, 0)
        # the chunks: this rank's rows when the batch divides over the data
        # axis, else all of them; the merged GT is the global batch's
        B = batch["images"].shape[0]
        if self.mesh is not None and B % self.mesh.size("data") == 0:
            chunks_np = [shard_batch(c, self.mesh) for c in chunks_np]
        dev = self.device
        put = lambda d: {k: torch.as_tensor(v, device=dev) for k, v in d.items()}  # noqa: E731
        return tuple(put(c) for c in chunks_np), put(merged_np)

    # --- loops -------------------------------------------------------------
    def fit(self) -> TrainState:
        if self.train_data is None:
            raise ValueError("fit() needs train_data")
        progress = StepProgress(self.max_steps, self.log_freq)
        start_step = 0
        if self.state is None:
            self.init_state(next(self.train_data.get_loader(epoch=0)))
            start_step = self.state.step
        for step in range(start_step, self.max_steps):
            batch = next(self.train_data.get_loader(epoch=step))
            S = batch["images"].shape[1]
            width, overlap = sample_chunk_shapes(self.rng_np, S, self.chunk_width_range,
                                                 self.overlap_range, self.shape_buckets)
            if self.mesh is not None:
                self._check_same_shapes(step, batch["images"].shape, width, overlap)
            chunks, merged = self._prepare_chunks(batch, width, overlap)
            self.state, metrics = self._get_step_fn(overlap)(self.state, chunks, merged,
                                                             self.generator)
            if step % self.log_freq == 0 and rank() == 0:
                host = {k: float(v) for k, v in metrics.items()}
                host["train/chunk_width"] = width
                host["train/chunk_overlap"] = overlap
                host["train/lr"] = float(self.schedule(step))
                self.logger.log_metrics(host, step)
                progress.update(step, host)
            if (step + 1) % self.val_freq == 0:
                self.validate(step)
            self.ckpt.maybe_save(step + 1, self.state_dict())
        self.ckpt.finish()
        return self.state

    def _check_same_shapes(self, step: int, images_shape, width: int, overlap: int) -> None:
        """Every rank of the data group must run the step on one batch shape
        and one (width, overlap): the predictions are gathered over it."""
        mine = np.asarray([[*images_shape, width, overlap]])
        every = allgather_rows(mine, self.mesh.group("data"))
        if (every != mine).any():
            raise ValueError(f"step {step}: the data-parallel ranks drew different batch "
                             f"shapes / (width, overlap): {every.tolist()}")

    def current_params(self) -> dict:
        """name -> parameter of the model (trained and frozen)."""
        return dict(self.model.named_parameters())

    def validate(self, step: int = 0) -> dict:
        """One validation batch through the chunk pipeline at a width and
        overlap drawn from the metrics' ranges (numpy seeded by seed and
        step), GT-aligned; its losses at this step, the batch metrics and
        the full-sequence metrics, logged under ``val/``."""
        if self.val_data is None or self.metrics is None:
            return {}
        pipeline = ChunkedPipeline(self.model)
        if self.metrics.log_dir is None:
            self.metrics.log_dir = self.logger.log_dir
        batch = self.normalize_batch(next(self.val_data.get_loader(epoch=step)))
        S = batch["images"].shape[1]
        val_rng = np.random.default_rng(self.seed * 100003 + step)
        width, overlap = sample_chunk_shapes(val_rng, S, self.metrics.chunk_width_range,
                                             self.metrics.overlap_range)
        preds, merged = pipeline.run_sequence(
            {k: v for k, v in batch.items() if isinstance(v, np.ndarray)},
            sample_mode=self.metrics.full_seq_sample_mode, chunk_width=width,
            num_overlap=overlap, gt_alignment_type=self.gt_alignment_type)
        val_losses = {"chunk_width": float(width), "chunk_overlap": float(overlap)}
        try:
            losses = self.loss(preds, merged, step,
                               torch.Generator().manual_seed(self.seed * 100003 + step))
            val_losses.update({k: float(v) for k, v in losses.items()})
        except (KeyError, ValueError) as e:  # heads disabled / keys missing
            val_losses["loss_error"] = float("nan")
            print(f"val loss skipped: {e!r}")
        batch_metrics, seq_metrics = self.metrics(preds, merged, pipeline,
                                                  self.val_data.datasets)
        out = {**val_losses, **batch_metrics, **seq_metrics}
        if rank() == 0:
            self.logger.log_metrics({f"val/{k}": v for k, v in out.items()}, step)
        return out

    def test(self) -> dict:
        """The full-sequence metrics of the model as it stands (its trained
        or loaded weights), logged at step 0."""
        if self.val_data is None or self.metrics is None:
            raise ValueError("test() needs val_data and metrics")
        if self.metrics.log_dir is None:
            self.metrics.log_dir = self.logger.log_dir
        seq_metrics = self.metrics.compute_full_sequence_metrics(
            self.val_data.datasets, ChunkedPipeline(self.model),
            rng=np.random.default_rng(self.seed))
        if rank() == 0:
            self.logger.log_metrics(seq_metrics, 0)
        return seq_metrics
