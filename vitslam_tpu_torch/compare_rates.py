"""New-frames/s of the flagship 5/1 and the point-aligned 75/30 pipelines
(sequential driver, seeded weights, 17 and 165 random 518x154 frames),
each with the fused block tails off and on (mlp_tail="both", K5), and the
steps/s of the global-mode AlignmentHead's train step at bucket (20, 5)
(K3 with lse and K4), for the package found under ROOT, so that two
checkouts can be compared in one run on one card:

    python3 vitslam_tpu_torch/compare_rates.py PARENT_ROOT
    python3 vitslam_tpu_torch/compare_rates.py .

(run as a script path, not with -m, so that ROOT's package is the one
imported). Prints, per pipeline, the walls of three runs and the best
rate of the last two (the first warms cuBLAS/cuDNN and builds kernels),
and for the train step the walls of four steps and the best rate of the
last three.
"""
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch


def main(root: Path) -> None:
    sys.path.insert(0, str(root))
    import vitslam_tpu_torch
    from vitslam_tpu_torch.models import flagship, flagship_point_aligned
    from vitslam_tpu_torch.slam import ChunkedPipeline

    if not Path(vitslam_tpu_torch.__file__).resolve().is_relative_to(root):
        raise SystemExit(f"imported {vitslam_tpu_torch.__file__}, not the package under {root}")
    rng = np.random.default_rng(0)
    for label, ctor, n, w, o, tail in (("5/1", flagship, 17, 5, 1, "off"),
                                       ("tail 5/1", flagship, 17, 5, 1, "both"),
                                       ("75/30 point", flagship_point_aligned, 165, 75, 30, "off"),
                                       ("tail 75/30 point", flagship_point_aligned, 165, 75, 30,
                                        "both")):
        model = ctor(device="cuda", seed=0, mlp_tail=tail)
        batch = {"images": rng.uniform(0, 1, size=(1, n, 3, 154, 518)).astype(np.float32)}
        pipe = ChunkedPipeline(model)
        walls = []
        for _ in range(3):
            torch.cuda.synchronize()
            t = time.perf_counter()
            pipe.run_sequence(batch, chunk_width=w, num_overlap=o)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t)
        print(f"{root.name} {label}: walls {[round(x, 3) for x in walls]} s, "
              f"best {n / min(walls[1:]):.2f} new-frames/s, last {n / walls[-1]:.2f}")
        del model, pipe
        torch.cuda.empty_cache()
    train_rate(root)


def train_rate(root: Path, steps: int = 3) -> None:
    """Steps of flagship(temporal_attention=False) without its point head,
    the training config's train keys, a synthetic 40-frame GT batch at
    bucket (20, 5): 12 K3-with-lse and 12 K4 calls a step."""
    from vitslam_tpu_torch.models import flagship
    from vitslam_tpu_torch.train import MultitaskLoss, Trainer
    from vitslam_tpu_torch.train.config import VKITTI_TRAIN_CFG
    from vitslam_tpu_torch.utils import make_synthetic_batch

    model = flagship(device="cuda", seed=0, enable_point=False, temporal_attention=False)
    with tempfile.TemporaryDirectory() as tmp:
        cfg = dict(VKITTI_TRAIN_CFG, logging={"log_dir": f"{tmp}/logs"},
                   checkpoint={"save_dir": f"{tmp}/ckpt"})
        trainer = Trainer(cfg, model, MultitaskLoss(**cfg["loss"]))
        state = trainer.init_state()
        chunks, merged = trainer._prepare_chunks(
            make_synthetic_batch(B=1, N=40, H=154, W=518, seed=3), 20, 5)
        step_fn = trainer._get_step_fn(5)
        walls = []
        for _ in range(1 + steps):
            torch.cuda.synchronize()
            t = time.perf_counter()
            _, metrics = step_fn(state, chunks, merged, trainer.generator)
            float(metrics["objective"])
            walls.append(time.perf_counter() - t)
    print(f"{root.name} train global (20, 5): walls {[round(x, 3) for x in walls]} s, "
          f"best {1 / min(walls[1:]):.3f} steps/s, last {1 / walls[-1]:.3f}")
    del model, trainer
    torch.cuda.empty_cache()


if __name__ == "__main__":
    main(Path(sys.argv[1]).resolve())
