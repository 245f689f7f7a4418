"""ChunkedPipeline — the streaming driver around the per-chunk model step
(port of vitslam_tpu/slam/pipeline.py). ``train=True`` runs the models'
training forward with autograd and keeps every output on the device (the
trainer's own step, ``train/train_step.py``, runs its chunk loop itself).

Two drivers give the same numbers:

* sequential (``encode_batch=1``): one full model step per chunk;
* two-stage (``encode_batch > 1``): the chunk-independent encode runs
  batched over up to ``encode_batch`` chunks stacked along B, then the cheap
  recurrent alignment runs chunk by chunk. With B == 1 the patch embedding
  runs once per unique frame of the group (consecutive chunks share their
  overlap frames). Unlike the JAX driver, the unique frames are not padded
  to an 8-frame bucket: that padding only saves XLA recompiles.

Each chunk's outputs are fetched to the host one chunk behind, as in the
reference: right after chunk i is queued its outputs start copying on a
side stream into pinned host memory, and chunk i's host dict is made (the
host waits for that copy) only after chunk i + 1 has been queued, so the
host queues the next chunk while the device finishes this one. Only the
fixed-size context state stays on the device. Inputs go to the device
through pinned memory without a wait. The GT alignment
(``slam/gt_alignment.py``) runs on the host outputs:
``per_chunk_scale_from_poses`` per chunk before the merge, every other type
on the merged predictions.

Chunk-parallel serving (``mesh``, a ``parallel.Mesh``): the two-stage
driver, which a mesh always takes, splits each stacked encode group over
the mesh's data ranks (chunks are independent, so the encode needs no
communication), pads a tail group by repeating its last chunk, gathers the
raw outputs over the data group and drops the padding; every rank then
runs the sequential alignment over all chunks, so every rank returns the
same predictions. The unique-frame embed dedup is off under a mesh, as in
the reference.
"""
from __future__ import annotations

import random
from typing import Optional

import numpy as np
import torch

from ..geometry import pad_to_4x4
from ..ops.transfer import to_device
from ..parallel.mesh import all_gather
from .chunking import chunk_batch, generate_chunks, merge_chunk_outputs
from .gt_alignment import align_outputs, per_chunk_scale_from_poses


class ChunkedPipeline:
    """Drives a chunk-aligned model over an arbitrary-length sequence."""

    def __init__(self, model, train: bool = False, encode_batch: int = 1, mesh=None):
        """train: the models' training forward (the AlignmentHead's frame
        dropout and block recomputation), outputs kept on the device with
        autograd; the two-stage driver is for inference only, as in the
        reference. encode_batch > 1: the two-stage driver. mesh: chunk-
        parallel serving over the mesh's data ranks (always two-stage)."""
        self.model = model
        self.train = train
        self.encode_batch = encode_batch
        self.mesh = mesh
        if mesh is not None and encode_batch % mesh.size("data"):
            raise ValueError(f"encode_batch {encode_batch} must be a multiple of the 'data' "
                             f"mesh axis size {mesh.size('data')}")
        self._copy_stream = None

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    def _to_device(self, x) -> torch.Tensor:
        return to_device(x, self.device)

    def step(self, images, num_overlap: int, state=None, gt_pose0=None,
             rng: Optional[torch.Generator] = None):
        """One chunk step. images (B, S, 3, H, W); ``rng`` draws the head's
        frame dropout when training."""
        with torch.inference_mode(not self.train):
            return self.model(self._to_device(images), num_overlap, state, gt_pose0,
                              self.train, rng)

    def run_sequence(self, batch: dict, sample_mode: str = "chunk_overlap",
                     chunk_width: int = 5, num_overlap: int = 1,
                     gt_alignment_type: str = "none", seq_width: int = -1,
                     rng: Optional[torch.Generator] = None, keep_images: bool = False,
                     merge_overlap: Optional[int] = None,
                     py_rng: Optional[random.Random] = None) -> tuple[dict, dict]:
        """Run the chunk-and-align loop over a batch with 'images'
        (B, N, 3, H, W) and optional GT keys ('extrinsics', 'depths',
        'point_masks', 'world_points', ...), then the GT alignment of
        ``gt_alignment_type`` (``seq_width`` as in ``align_outputs``).

        rng: the training forward's dropout generator. keep_images: each
        chunk's images join its outputs (inference). merge_overlap: the
        frames deduplicated at the merge, ``num_overlap`` by default
        (training passes 0 to keep the overlap frames). py_rng: the random
        draws of ``generate_chunks`` (``two_chunks``).

        Returns (predictions, merged GT batch), merged along frames: on the
        host, or with ``train`` on the device with autograd."""
        with torch.inference_mode(not self.train):
            images = batch["images"]
            indices = generate_chunks(images.shape[1], sample_mode, chunk_width, num_overlap,
                                      rng=py_rng)
            chunks = chunk_batch(batch, indices)
            use_gt = sample_mode in ("chunk_gt", "two_chunks")

            raw_per_chunk = None
            if (self.encode_batch > 1 or self.mesh is not None) and not self.train:
                raw_per_chunk = self._encode_all(chunks, indices, images)

            state = None
            chunk_outputs: list[dict] = []
            pending = None  # the previous chunk's fetch, finished after this one is queued
            for i, chunk in enumerate(chunks):
                gt_poses = None
                if use_gt and "extrinsics" in chunk:
                    gt_poses = pad_to_4x4(self._to_device(chunk["extrinsics"]).float())
                if raw_per_chunk is not None:
                    outputs, state = self.model.align_chunk(
                        raw_per_chunk[i], tuple(chunk["images"].shape), num_overlap,
                        state, gt_poses)
                else:
                    outputs, state = self.step(chunk["images"], num_overlap, state, gt_poses, rng)
                if self.train:
                    chunk_outputs.append(outputs)
                    continue
                fetch = self._fetch(outputs)
                if keep_images:
                    fetch[0]["images"] = torch.as_tensor(chunk["images"])
                if pending is not None:
                    chunk_outputs.append(self._wait(pending))
                pending = fetch
            if pending is not None:
                chunk_outputs.append(self._wait(pending))

            if gt_alignment_type == "per_chunk_scale_from_poses":
                chunk_outputs = per_chunk_scale_from_poses(chunk_outputs, chunks)
            mo = num_overlap if merge_overlap is None else merge_overlap
            if sample_mode in ("chunk_gt", "two_chunks", "all"):
                mo = 0
            predictions = merge_chunk_outputs(chunk_outputs, mo)
            merged_batch = merge_chunk_outputs(chunks, mo)
            predictions = align_outputs(predictions, merged_batch, gt_alignment_type, seq_width,
                                        image_size_hw=tuple(images.shape[-2:]))
            return predictions, merged_batch

    def _fetch(self, outputs: dict):
        """Start copying one chunk's outputs to the host: on CUDA into pinned
        host tensors on a side stream that first waits for the work queued
        so far; returns (host dict, (event, outputs)), the device tensors
        held until the event has passed. On the CPU the plain copy."""
        if self.device.type != "cuda":
            return {k: v.cpu() for k, v in outputs.items()}, None
        if self._copy_stream is None:
            self._copy_stream = torch.cuda.Stream(self.device)
        self._copy_stream.wait_stream(torch.cuda.current_stream(self.device))
        host = {}
        with torch.cuda.stream(self._copy_stream):
            for k, v in outputs.items():
                host[k] = torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
                host[k].copy_(v, non_blocking=True)
            done = torch.cuda.Event()
            done.record(self._copy_stream)
        return host, (done, outputs)

    @staticmethod
    def _wait(fetch) -> dict:
        """The host dict of a fetch, once its copies have landed."""
        host, pending = fetch
        if pending is not None:
            pending[0].synchronize()
        return host

    def _encode_all(self, chunks: list[dict], indices, seq_images) -> list:
        """Stage 1 of the two-stage driver: batch same-shape chunks along B,
        run the chunk-independent encode, split the raw outputs per chunk."""
        raws: list = [None] * len(chunks)
        dedup = self.mesh is None and chunks[0]["images"].shape[0] == 1
        i = 0
        while i < len(chunks):
            shape = tuple(chunks[i]["images"].shape)
            group = [i]
            while (len(group) < self.encode_batch and i + len(group) < len(chunks)
                   and tuple(chunks[i + len(group)]["images"].shape) == shape):
                group.append(i + len(group))
            imgs = [self._to_device(chunks[g]["images"]) for g in group]
            if self.mesh is not None:
                # a tail group is padded to a multiple of the data axis by
                # repeating its last chunk (dropped after the gather)
                imgs += [imgs[-1]] * ((-len(imgs)) % self.mesh.size("data"))
            stacked = torch.cat(imgs)

            tokens = None
            if dedup:
                ids = np.concatenate([np.asarray(indices[g]) for g in group])
                uniq, inv = np.unique(ids, return_inverse=True)
                if len(uniq) < len(ids):
                    frames = self._to_device(np.asarray(seq_images)[:, uniq])
                    emb = self.model.embed_frames(frames)  # (1, F, P, C)
                    tok = emb[0][self._to_device(inv)]
                    tokens = tok.reshape(len(group), shape[1], *tok.shape[1:])

            if self.mesh is None:
                raw = self.model.encode_chunks(stacked, tokens)
            else:
                raw = self._encode_sharded(stacked)
            B = shape[0]
            for k, g in enumerate(group):
                raws[g] = {key: v[k * B:(k + 1) * B] for key, v in raw.items()}
            i += len(group)
        return raws

    def _encode_sharded(self, stacked: torch.Tensor) -> dict:
        """The encode of a stacked group split over the data ranks: this
        rank's contiguous share of the rows, then the raw outputs of every
        rank gathered back in stacking order."""
        n, i = self.mesh.size("data"), self.mesh.index("data")
        rows = stacked.shape[0] // n
        raw = self.model.encode_chunks(stacked[i * rows:(i + 1) * rows])
        return {k: all_gather(v, self.mesh.group("data"), dim=0) for k, v in raw.items()}
