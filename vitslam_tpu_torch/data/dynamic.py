"""Dynamic batching: ComposedDataset + DynamicDataset + loader (port of
vitslam_tpu/data/dynamic.py): per-epoch (the trainer asks for one epoch per
step) sampling of images-per-sequence from ``img_nums``, batch size
max_img_per_gpu // img_per_seq, aspect-ratio choice, exposing ``.datasets``
and ``.seed``. A plain-Python iterator with a background thread prefetching
the next host batch while the device computes; batches are numpy dicts.
"""
from __future__ import annotations

import queue
import threading
from typing import Iterator, Optional, Sequence

import numpy as np

from .base import BaseDataset

STRING_KEYS = ("seq_name",)


def collate(samples: list[dict]) -> dict:
    """Stack per-sequence dicts into (B, S, ...) arrays."""
    out: dict = {}
    for k in samples[0]:
        vals = [s[k] for s in samples]
        if k in STRING_KEYS:
            out[k] = vals
        elif np.isscalar(vals[0]):
            out[k] = np.asarray(vals)
        else:
            out[k] = np.stack([np.asarray(v) for v in vals])
    return out


class ComposedDataset:
    """Concatenation of datasets with proportional index mapping
    (reference: vggt ComposedDataset instantiated from dataset configs)."""

    def __init__(self, datasets: Sequence[BaseDataset]):
        self.datasets = list(datasets)
        self._lengths = [len(d) for d in self.datasets]

    def __len__(self):
        return sum(self._lengths)

    def pick(self, rng: np.random.Generator) -> BaseDataset:
        w = np.asarray(self._lengths, np.float64)
        return self.datasets[int(rng.choice(len(w), p=w / w.sum()))]


class DynamicDataset:
    """Per-step dynamically batched sampler over a ComposedDataset."""

    def __init__(
        self,
        dataset_configs_or_datasets,
        img_nums: Sequence[int] = (4, 40),
        max_img_per_gpu: int = 48,
        aspect_ratios: Sequence[float] = (1.0,),
        seed: int = 0,
        num_prefetch: int = 2,
        steps_per_epoch: int = 1,
        common_config: Optional[dict] = None,
        **_,
    ):
        # reference API parity: DynamicTorchDataset reads img_nums /
        # fix_aspect_ratio out of its common_config block
        if common_config:
            img_nums = common_config.get("img_nums", img_nums)
            far = common_config.get("fix_aspect_ratio", -1)
            if far and far > 0:
                aspect_ratios = (far,)
        if isinstance(dataset_configs_or_datasets, ComposedDataset):
            self.base_dataset = dataset_configs_or_datasets
        else:
            self.base_dataset = ComposedDataset(dataset_configs_or_datasets)
        empty = [type(d).__name__ for d in self.base_dataset.datasets
                 if getattr(d, "sequence_list_len", 0) == 0]
        if empty:
            raise ValueError(
                f"dataset(s) found no sequences: {empty} — check the data "
                "directory paths in the config (e.g. --set vkitti_dir=...)"
            )
        self.img_nums = tuple(img_nums)
        self.max_img_per_gpu = max_img_per_gpu
        self.aspect_ratios = tuple(aspect_ratios)
        self.seed = seed
        self.num_prefetch = num_prefetch
        self.steps_per_epoch = steps_per_epoch

    @property
    def datasets(self):
        return self.base_dataset.datasets

    def sample_batch(self, rng: np.random.Generator) -> dict:
        img_per_seq = int(rng.integers(self.img_nums[0], self.img_nums[1] + 1))
        batch_size = max(1, self.max_img_per_gpu // img_per_seq)
        aspect = float(rng.choice(np.asarray(self.aspect_ratios)))
        ds = self.base_dataset.pick(rng)
        samples = []
        for _ in range(batch_size):
            seq_index = int(rng.integers(0, ds.sequence_list_len))
            samples.append(
                ds.get_data(seq_index=seq_index, img_per_seq=img_per_seq,
                            aspect_ratio=aspect, rng=rng)
            )
        return collate(samples)

    def get_loader(self, epoch: int = 0) -> Iterator[dict]:
        """One epoch = ``steps_per_epoch`` batches, deterministically seeded
        by (seed, epoch); a background thread prefetches the next batch."""
        rng = np.random.default_rng((self.seed, epoch))
        q: "queue.Queue" = queue.Queue(maxsize=self.num_prefetch)
        n = self.steps_per_epoch

        def produce():
            for _ in range(n):
                q.put(self.sample_batch(rng))
            q.put(None)

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        while True:
            item = q.get()
            if item is None:
                return
            yield item
