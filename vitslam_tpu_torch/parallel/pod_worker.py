"""Pod-topology worker: one rank of a gang whose nodes hold ``n_local``
ranks each (port of vitslam_tpu/parallel/pod_worker.py).

    python -m vitslam_tpu_torch.parallel.pod_worker RANK PORT WORLD N_LOCAL [DEVICE]

joins a gloo gang of WORLD ranks at localhost:PORT (on DEVICE, "cpu" by
default; "cuda" puts every rank on card 0, several ranks sharing it). The
mesh is (data = WORLD / N_LOCAL, model = N_LOCAL) with LOCAL_WORLD_SIZE =
N_LOCAL: data parallelism across nodes, tensor parallelism within one, as
the JAX package lays a pod out. Two full train steps (chunk loop,
multi-task loss, AdamW) of a small FeatureAlignedVGGT with model-axis-
sharded parameters, one batch row a data rank, so the data group's
gradient sum and the model group's parameter gathers both run. Every rank
prints each step's objective (the loss is the global batch's: the same on
every rank) and "pod worker RANK: OK" at the end.
"""
from __future__ import annotations

import math
import os
import sys

import torch
import torch.distributed as dist

# a small FeatureAlignedVGGT whose heads are 64 wide (the attention kernels'
# head dim on the card); its frames are 98 x 182 on the card (96 tokens, as
# chip_smoke.py's reference phase) and 28 x 42 on the CPU
MODEL_KW = dict(embed_dim=128, num_heads=2, depth=2, patch_embed_depth=1,
                intermediate_layers=(0, 1, 1, 1), align_embed_dim=64, align_dec_dim=32,
                num_memory_tokens=4, enable_point=False)
FREEZE = ["*aggregator*", "*camera_head*", "*depth_head*"]
LOSS_CFG = dict(cameraPose={"weight": 1.0, "loss_type": "l1"},
                cameraPoseRel={"weight": 0.5, "loss_type": "l1", "large_offset": 5},
                depth={"weight": 0.1, "valid_range": 0.98},
                perFrameReg={"weight": 5.0}, perChunkReg={"weight": 5.0}, total_steps=100)
FRAMES = 7


def frame_size(device: str) -> tuple[int, int]:
    return (98, 182) if device == "cuda" else (28, 42)


def small_model(device: str, seed: int = 0):
    """The seeded small model (fp32 on the CPU, the preset's bf16 on the
    card)."""
    from ..models import small_feature_aligned

    kw = dict(MODEL_KW, img_size=frame_size(device)[0])
    if device == "cpu":
        kw["dtype"] = torch.float32
    return small_feature_aligned(device=device, seed=seed, **kw)


def train_case(rows: int, device: str, mesh=None):
    """The synthetic batch of ``rows`` samples chunked at width 4 / overlap
    1: (chunk batches, this rank's rows of them when ``mesh`` is given; the
    merged GT of the whole batch)."""
    from ..slam import chunk_batch, generate_chunks, merge_chunk_outputs
    from ..utils import make_synthetic_batch
    from .mesh import shard_batch

    H, W = frame_size(device)
    batch = make_synthetic_batch(B=rows, N=FRAMES, H=H, W=W, seed=11)
    chunks = chunk_batch(batch, generate_chunks(FRAMES, "chunk_overlap", 4, 1))
    merged = merge_chunk_outputs(chunks, 0)
    if mesh is not None:
        chunks = [shard_batch(c, mesh) for c in chunks]
    put = lambda d: {k: torch.as_tensor(v, device=device) for k, v in d.items()}  # noqa: E731
    return tuple(put(c) for c in chunks), put(merged)


def train_steps(model, chunks, merged, steps: int, mesh=None, shards=None) -> list[float]:
    """``steps`` train steps of ``model`` (the head trainable) on one batch;
    the objectives."""
    from ..train import MultitaskLoss, TrainState, build_optimizer, freeze_params
    from ..train import make_train_step

    trainable = freeze_params(model, FREEZE)
    opt, _ = build_optimizer(trainable, max_lr=1e-4, total_steps=100, shards=shards)
    state = TrainState(trainable=trainable, optimizer=opt)
    step = make_train_step(model, MultitaskLoss(**LOSS_CFG), 1,
                           data_group=None if mesh is None else mesh.group("data"))
    objectives = []
    for _ in range(steps):
        state, metrics = step(state, chunks, merged, torch.Generator().manual_seed(1))
        objectives.append(float(metrics["objective"]))
    return objectives


def main(argv) -> None:
    rank, port, world, n_local = (int(a) for a in argv[:4])
    device = argv[4] if len(argv) > 4 else "cpu"
    from .mesh import init_distributed, make_mesh, shard_params_model, sync_global_devices

    if device == "cuda":
        torch.cuda.set_device(0)
    else:
        torch.set_num_threads(1)
    os.environ["LOCAL_WORLD_SIZE"] = str(n_local)
    init_distributed("gloo", f"localhost:{port}", world, rank)
    try:
        mesh = make_mesh(n_data=world // n_local, n_model=n_local)
        model = small_model(device)
        shards = shard_params_model(model, mesh)
        chunks, merged = train_case(mesh.size("data"), device, mesh)
        sync_global_devices("pod-workers-up")
        for i, obj in enumerate(train_steps(model, chunks, merged, 2, mesh, shards)):
            if not math.isfinite(obj):
                raise AssertionError(f"non-finite objective {obj}")
            print(f"pod worker {rank}: step {i} objective {obj:.6f}", flush=True)
        sync_global_devices("pod-workers-done")
    finally:
        dist.destroy_process_group()
    print(f"pod worker {rank}: OK mesh=({world // n_local}x{n_local}) node "
          f"{rank // n_local}", flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
