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
shapes (a step checks it). Logging and msgpack checkpoint writes happen on
rank 0.

Tensor parallelism (``num_model_shards`` = n > 1): the gang's W ranks form
a (W / n, n) (data, model) mesh, and ``init_state`` shards the model's
parameters over ``model`` (``parallel.shard_params_model``): trainable and
frozen tensors and the optimizer's moments are held as slices, as the JAX
package shards its whole TrainState. A model group lies within one node
(n divides ``LOCAL_WORLD_SIZE``), as the JAX package keeps ``model`` within
a process, so its ranks share their node's seed and draw the same batch,
chunk shapes, dropout and loss offsets; a step checks that too. The
msgpack checkpoint gathers the whole tensors and is the file one process
would write; a resume slices it again. ``checkpoint.backend: orbax``
writes sharded checkpoints (``io/sharded_ckpt.py``), every rank its part.
Resuming also takes a train state the JAX package saved (a flax msgpack
file: ``io.checkpoint.load_checkpoint``).
"""
from __future__ import annotations

import os
import zlib
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..io.checkpoint import CheckpointManager, load_checkpoint
from ..io.sharded_ckpt import ShardedCheckpointManager, as_dtensors
from ..parallel import (
    allgather_rows,
    is_distributed,
    make_mesh,
    node_index,
    rank,
    replicate,
    shard_batch,
    shard_params_model,
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

        # one (data, model) mesh over every rank of the gang (the
        # reference's mesh over all devices); a single process has none
        n_model = int(cfg.get("num_model_shards", 1))
        world = dist.get_world_size() if is_distributed() else 1
        if n_model < 1 or world % n_model:
            raise ValueError(f"num_model_shards={n_model} does not divide the {world} rank(s) "
                             "of the gang (launch with python -m vitslam_tpu_torch.cli "
                             "--num_devices N)")
        per_node = int(os.environ.get("LOCAL_WORLD_SIZE", "1"))
        if per_node % n_model:
            raise ValueError(f"num_model_shards={n_model} does not divide the {per_node} ranks "
                             "of a node: a model group must lie within one node")
        self.mesh = make_mesh(n_data=world // n_model, n_model=n_model) if is_distributed() \
            else None
        if int(cfg.get("num_devices", 0)) > 1 and self.mesh is None:
            raise RuntimeError("num_devices > 1 needs a gang of ranks: launch with "
                               "python -m vitslam_tpu_torch.cli --num_devices N")
        self.shards = None  # the tensor-parallel layout, once init_state shards the model
        ckpt_cfg = cfg.get("checkpoint", {})
        backend = str(ckpt_cfg.get("backend", "msgpack"))
        if backend not in ("msgpack", "orbax"):
            raise ValueError(f"checkpoint.backend must be 'msgpack' or 'orbax', got {backend!r}")
        self.sharded_ckpt = backend == "orbax"

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
        manager = ShardedCheckpointManager if self.sharded_ckpt else CheckpointManager
        self.ckpt = manager(ckpt_cfg.get("save_dir", "ckpt"), self.exp_name,
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
        """Shard the model over the mesh's model axis (once), freeze by the
        patterns, build the optimizer over the trainable parameters, and
        resume from the ``_latest`` link when asked to. (The model already
        holds its weights; ``sample_batch`` is accepted for the reference's
        signature.)"""
        if self.mesh is not None and self.shards is None:
            self.shards = shard_params_model(self.model, self.mesh)
        trainable = freeze_params(self.model, self.freeze_patterns)
        optimizer, self.schedule = build_optimizer(trainable, **self.optim_kwargs,
                                                   shards=self.shards)
        self.state = TrainState(trainable=trainable, optimizer=optimizer, step=0)
        if self.mesh is not None:
            replicate(trainable, self.mesh)
        if self.resume:
            path = self.ckpt.resume_path()
            if path:
                if self.sharded_ckpt:
                    self._restore_sharded()
                else:
                    self.restore(load_checkpoint(path))
                print(f"resumed from {path} at step {self.state.step}")
        return self.state

    def whole(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """The whole tensor of a trainable parameter ``name`` (or of its
        gradient or moment) from this rank's: gathered over the model group
        under tensor parallelism (every rank of the group calls it)."""
        return t if self.shards is None else self.shards.full(name, t)

    def _local(self, name: str, t: torch.Tensor) -> torch.Tensor:
        return t if self.shards is None else self.shards.local(name, t)

    def state_dict(self) -> dict:
        """The train state as the msgpack backend saves it: trainable
        tensors by name, optimizer state, step; under tensor parallelism the
        whole tensors, gathered over the model group (every rank calls
        it)."""
        s = self.state
        opt = s.optimizer.state_dict()
        for key in ("mu", "nu", "acc"):
            if opt[key] is not None:
                opt[key] = {n: self.whole(n, t) for n, t in opt[key].items()}
        return {"trainable": {n: self.whole(n, p.detach()) for n, p in s.trainable.items()},
                "optimizer": opt, "step": s.step}

    def sharded_state_dict(self) -> dict:
        """The train state as the sharded backend saves it: this rank's
        tensors, the sliced ones as DTensors viewing them (so a load fills
        the live state in place)."""
        s = self.state
        opt = s.optimizer.state_dict()
        return {"trainable": as_dtensors({n: p.detach() for n, p in s.trainable.items()},
                                         self.shards),
                "optimizer": {"count": opt["count"], "mini_step": opt["mini_step"],
                              **{k: as_dtensors(opt[k], self.shards)
                                 for k in ("mu", "nu", "acc") if opt[k] is not None}},
                "step": s.step}

    def _save_state(self) -> dict:
        return self.sharded_state_dict() if self.sharded_ckpt else self.state_dict()

    def _restore_sharded(self) -> None:
        with torch.no_grad():
            saved = self.ckpt.restore(self.sharded_state_dict())
        opt = self.state.optimizer
        opt.count, opt.mini_step = int(saved["optimizer"]["count"]), \
            int(saved["optimizer"]["mini_step"])
        self.state.step = int(saved["step"])

    def restore(self, saved: dict) -> None:
        """Load a whole-tensor train state (the msgpack backend's, or a JAX
        package train state read by ``load_checkpoint``, whose frozen
        tensors are loaded too) into the model and the optimizer, slicing
        the sharded names. A saved tensor the model cannot place, or a
        trainable tensor the state lacks, is a KeyError naming it."""
        params = dict(self.model.named_parameters())
        trainable = self.state.trainable
        for group, names in (("trainable", trainable), ("frozen", params)):
            unknown = sorted(set(saved.get(group, {})) - set(names))
            if unknown:
                raise KeyError(f"{group} tensors of the checkpoint the model cannot place: "
                               f"{unknown[:5]} ({len(unknown)})")
        missing = sorted(set(trainable) - set(saved["trainable"]))
        if missing:
            raise KeyError(f"trainable tensors missing from the checkpoint: {missing[:5]} "
                           f"({len(missing)})")
        with torch.no_grad():
            for group in ("trainable", "frozen"):
                for n, t in saved.get(group, {}).items():
                    params[n].copy_(self._local(n, t))
        opt = dict(saved["optimizer"])
        if (opt.get("acc") is None) != (self.state.optimizer.acc is None):
            held = "lacks" if opt.get("acc") is None else "holds"
            raise KeyError(f"optimizer acc: the checkpoint {held} accumulated gradients, "
                           f"this trainer's accum_steps is {self.accum_steps}")
        for key in ("mu", "nu", "acc"):
            if opt.get(key) is not None:
                opt[key] = {n: self._local(n, t) for n, t in opt[key].items()}
        self.state.optimizer.load_state_dict(opt)
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
                self._check_same_draws(step, batch["images"].shape, width, overlap)
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
            self.ckpt.maybe_save(step + 1, self._save_state)
        self.ckpt.finish()
        return self.state

    def _check_same_draws(self, step: int, images_shape, width: int, overlap: int) -> None:
        """Every rank of the mesh must run the step on one batch shape and
        one (width, overlap) (the predictions are gathered over the data
        group), and the ranks of a model group on one generator state too
        (they compute one replicated loss, dropout and offsets included)."""
        draws = zlib.crc32(self.generator.get_state().numpy().tobytes())
        every = allgather_rows(np.asarray([[*images_shape, width, overlap, draws]]))
        shapes, draws = every[:, :-1], every[:, -1].reshape(self.mesh.size("data"), -1)
        if (shapes != shapes[0]).any():
            raise ValueError(f"step {step}: the ranks drew different batch shapes / "
                             f"(width, overlap): {shapes.tolist()}")
        if (draws != draws[:, :1]).any():
            raise ValueError(f"step {step}: the ranks of a model group hold different "
                             f"generator states: {draws.tolist()}")

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
