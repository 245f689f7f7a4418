"""The flagship train step's benchmark at the reference's train setting (the
port's counterpart of the JAX package's ``scripts/train_bench.py``).

Times the frozen-backbone train step through ``train/train_step.py::
make_train_step``: the flagship FeatureAlignedVGGT (its default temporal
head), 518x154 frames, the backbone and the camera and depth heads frozen
(``"*aggregator*"``, ``"*camera_head*"``, ``"*depth_head*"``, as
configs/train_featureAlignedVGGT_vkitti.yaml), the shipped loss weights and
warm-ups, AdamW at 5e-5 with weight decay 0.05 and clipping at 1.0,
``scale_from_depths`` GT alignment, over (chunk width, overlap) buckets, 2
chunks a step, on a seeded synthetic GT batch. Then a short fixed-batch
descent (``--descent-steps``) from step 7000, past every loss warm-up.

    python -m vitslam_tpu_torch.train_bench [--steps N] [--buckets 3:1,10:3,20:5]
        [--descent-steps 6] [--device cuda|cpu] [--small]

Prints one JSON line per bucket: {"bucket": "w3_o1", "sec_per_step",
"steps_per_sec", "frames_per_step", "frames_per_sec", "compile_s" (the
first, untimed step: allocations and library autotuning; nothing is
compiled), "build_s" (the CUDA kernels' nvcc build), "objective", and the
model's "mlp_tail", "int8" and "token_merge" (``presets.model_switches``:
the presets read VITSLAM_MLP_TAIL, VITSLAM_INT8 and VITSLAM_TOKEN_MERGE)}, and
{"descent_objectives": [...]} after the last bucket. Each step ends with a
host read of the objective. It needs CUDA unless ``--device cpu`` is given;
``--small`` is the small model at width 224 (the tests' CPU runs).
"""
from __future__ import annotations

import argparse
import json
import sys
import time

FREEZE = ["*aggregator*", "*camera_head*", "*depth_head*"]
# configs/train_featureAlignedVGGT_vkitti.yaml's loss weights and warm-ups
LOSS = dict(
    cameraPose={"weight": 1.0, "warmup_percent": 0.02, "warmup_type": "linear",
                "loss_type": "l1"},
    cameraPoseRel={"weight": 0.5, "warmup_start_percent": 0.02, "warmup_percent": 0.02,
                   "warmup_type": "linear", "loss_type": "l1"},
    depth={"weight": 0.1, "warmup_start_percent": 0.02, "warmup_percent": 0.02,
           "warmup_type": "linear", "valid_range": 0.98},
    perFrameReg={"weight": 5.0, "warmup_start_percent": 0.01, "warmup_percent": 0.01,
                 "warmup_type": "linear"},
    perChunkReg={"weight": 5.0, "warmup_percent": 0.01, "warmup_type": "linear"},
)
TOTAL_STEPS = 70000


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--buckets", default="3:1,10:3,20:5")
    ap.add_argument("--descent-steps", type=int, default=6)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--small", action="store_true",
                    help="the small model at width 224 instead of the flagship")
    args = ap.parse_args(argv)

    import torch

    from .bench import build_kernels, require_device
    from .data.preprocess import get_target_shape
    from .models import presets
    from .slam import chunk_batch, generate_chunks, merge_chunk_outputs
    from .train import MultitaskLoss, TrainState, build_optimizer, freeze_params, make_train_step
    from .utils import make_synthetic_batch

    device = require_device(args.device)
    build_s = build_kernels(device)
    W = 224 if args.small else 518
    H = int(get_target_shape(0.3, W, 14)[0])
    loss = MultitaskLoss(**LOSS)
    loss.setup_scheduling(TOTAL_STEPS)
    t0 = time.perf_counter()
    model = (presets.small_feature_aligned if args.small else presets.flagship)(device=device,
                                                                             seed=0)
    trainable = freeze_params(model, FREEZE)
    print(f"# init {time.perf_counter() - t0:.1f}s, {len(trainable)} trainable tensors",
          file=sys.stderr)

    def fence(metrics) -> float:  # a host read ends the step
        return float(metrics["objective"])

    def put(d: dict) -> dict:
        return {k: torch.as_tensor(v, device=device) for k, v in d.items()}

    buckets = [tuple(int(x) for x in b.split(":")) for b in args.buckets.split(",")]
    for width, overlap in buckets:
        n_frames = width + (width - overlap)  # 2 chunks
        batch = make_synthetic_batch(B=1, N=n_frames, H=H, W=W, seed=3)
        chunks_np = chunk_batch(batch, generate_chunks(n_frames, "chunk_overlap", width, overlap))
        chunks = tuple(put(c) for c in chunks_np)
        merged = put(merge_chunk_outputs(chunks_np, 0))
        # a fresh optimizer for every bucket, over the same parameters
        opt, _ = build_optimizer(trainable, max_lr=5e-5, min_lr=1e-8, total_steps=TOTAL_STEPS,
                                 warmup_percent=0.05, weight_decay=0.05, grad_clip_norm=1.0)
        state = TrainState(trainable=trainable, optimizer=opt)
        step_fn = make_train_step(model, loss, overlap, "scale_from_depths")

        def gen(seed: int):
            return torch.Generator(device=device).manual_seed(seed)

        t0 = time.perf_counter()
        state, metrics = step_fn(state, chunks, merged, gen(1))
        fence(metrics)
        compile_s = time.perf_counter() - t0

        t0 = time.perf_counter()
        for i in range(args.steps):
            state, metrics = step_fn(state, chunks, merged, gen(i))
            fence(metrics)
        dt = (time.perf_counter() - t0) / args.steps
        print(json.dumps({
            "bucket": f"w{width}_o{overlap}", "sec_per_step": round(dt, 3),
            "steps_per_sec": round(1 / dt, 4), "frames_per_step": n_frames,
            "frames_per_sec": round(n_frames / dt, 2), "compile_s": round(compile_s, 1),
            "build_s": round(build_s, 2), "objective": round(fence(metrics), 4),
            **presets.model_switches(model),
        }), flush=True)

        if (width, overlap) == buckets[-1] and args.descent_steps:
            # past every loss warm-up (the weights ramp over the first ~1,400
            # of 70,000 steps: a rising objective before is the weights growing)
            state.step = 7000
            state, metrics = step_fn(state, chunks, merged, gen(999))
            objs = [round(fence(metrics), 4)]
            for i in range(args.descent_steps):
                state, metrics = step_fn(state, chunks, merged, gen(1000 + i))
                objs.append(round(fence(metrics), 4))
            print(json.dumps({"descent_objectives": objs}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
