"""Training of the AlignmentHead on the frozen backbone (port of
vitslam_tpu/train): losses, optimizer, the train step and the trainer."""
from .logging_utils import CSVLogger, StepProgress
from .losses import MultitaskLoss, compute_warmup_weight
from .optim import (
    AdamW,
    build_optimizer,
    freeze_params,
    global_norm,
    partition_params,
    warmup_cosine_schedule,
)
from .train_step import TrainState, loss_and_grads, make_train_step, merge_outputs_traced
from .trainer import Trainer, sample_chunk_shapes

__all__ = [
    "AdamW", "CSVLogger", "MultitaskLoss", "StepProgress", "TrainState", "Trainer",
    "build_optimizer", "compute_warmup_weight", "freeze_params", "global_norm",
    "loss_and_grads", "make_train_step", "merge_outputs_traced", "partition_params",
    "sample_chunk_shapes", "warmup_cosine_schedule",
]
