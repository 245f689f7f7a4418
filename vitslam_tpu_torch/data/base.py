"""Base dataset: common config, target shapes, shared chunk sampling (port
of vitslam_tpu/data/base.py): sample a temporal subsampling step from
``chunk_subsampling`` such that a full window still fits, then a random
window of ``img_per_seq`` frames.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np

from .preprocess import get_target_shape, process_one_image


@dataclass
class CommonConfig:
    """The shared dataset knobs (reference: default_dataset.yaml common_config
    + augs block)."""
    img_size: int = 518
    patch_size: int = 14
    debug: bool = False
    training: bool = True
    inside_random: bool = False
    overlapping: bool = True
    fix_seq_img_num: int = -1
    subsampling_step: int = 1
    fix_img_num: int = -1
    fix_aspect_ratio: float = -1.0
    chunk_subsampling: Sequence[int] = (1, 1)
    augs: Optional[dict] = None

    def __post_init__(self):
        if self.augs and "chunk_subsampling" in self.augs:
            self.chunk_subsampling = tuple(self.augs["chunk_subsampling"])


class BaseDataset:
    def __init__(self, common_conf: CommonConfig):
        self.common_conf = common_conf
        self.debug = common_conf.debug
        self.training = common_conf.training
        self.inside_random = common_conf.inside_random
        self.overlapping = common_conf.overlapping
        self.fix_seq_img_num = common_conf.fix_seq_img_num
        self.subsampling_step = common_conf.subsampling_step
        self.chunk_subsampling = common_conf.chunk_subsampling
        self.fixed_num_images = common_conf.fix_img_num
        self.fixed_aspect_ratio = common_conf.fix_aspect_ratio
        self.len_train = 0
        self.sequence_list: list[str] = []
        self.seq_frame_num: list[int] = []

    def __len__(self) -> int:
        return self.len_train

    # --- shared helpers ---------------------------------------------------
    def get_target_shape(self, aspect_ratio: float) -> np.ndarray:
        return get_target_shape(aspect_ratio, self.common_conf.img_size,
                                self.common_conf.patch_size)

    def process_one_image(self, *args, **kwargs):
        return process_one_image(*args, **kwargs)

    def adjust_frame_num(self, frame_num: int) -> int:
        """Apply global subsampling + fixed-length caps to a raw count."""
        if self.subsampling_step > 1:
            frame_num = int(np.ceil(frame_num / self.subsampling_step))
        if 0 < self.fix_seq_img_num < frame_num:
            frame_num = self.fix_seq_img_num
        return frame_num

    def sample_ids(self, frame_num: int, img_per_seq: int,
                   rng: Optional[np.random.Generator] = None) -> np.ndarray:
        """Sample the frame ids of one training window (shared logic)."""
        rng = rng or np.random.default_rng()
        if self.debug:
            ids = np.arange(img_per_seq)
        elif self.overlapping:
            lo, hi = self.chunk_subsampling
            rev = np.arange(hi, lo - 1, -1)
            valid = np.ceil(frame_num / rev) >= img_per_seq
            max_step = int(rev[int(np.argmax(valid))])
            step = int(rng.integers(lo, max_step + 1))
            eff = int(np.ceil(frame_num / step)) if step > 1 else frame_num
            start = int(rng.integers(0, max(1, eff - img_per_seq + 1)))
            ids = np.arange(start, start + img_per_seq)
            if step > 1:
                ids = ids * step
        else:
            if self.fixed_num_images <= 0:
                raise ValueError(
                    "non-overlapping chunk sampling needs fix_img_num > 0"
                )
            k = self.fixed_num_images
            starts = np.arange(0, frame_num - k + 1, k)
            if len(starts) * k < frame_num:
                starts = np.append(starts, frame_num - k)
            start = int(rng.choice(starts))
            ids = np.arange(start, start + img_per_seq)
        if self.subsampling_step > 1:
            ids = ids * self.subsampling_step
        return ids

    def resolve_sampling(self, img_per_seq: Optional[int],
                         aspect_ratio: float):
        if self.fixed_num_images > 0:
            img_per_seq = self.fixed_num_images
        if self.fixed_aspect_ratio > 0:
            aspect_ratio = self.fixed_aspect_ratio
        return img_per_seq, aspect_ratio

    @staticmethod
    def stack_batch(seq_name: str, ids: np.ndarray, frames: dict) -> dict:
        """Stack per-frame lists into (S, ...) arrays + metadata."""
        out = {
            "seq_name": seq_name,
            "ids": np.asarray(ids),
            "frame_num": len(frames["images"]),
        }
        for k, v in frames.items():
            out[k] = np.stack(v).astype(
                np.float32 if k != "point_masks" else np.float32
            )
        return out

    # --- abstract ----------------------------------------------------------
    def get_data(self, seq_index=None, img_per_seq=None, seq_name=None,
                 ids=None, aspect_ratio: float = 1.0) -> dict:
        raise NotImplementedError

    def get_seq_name(self, seq_index: int) -> str:
        raise NotImplementedError
