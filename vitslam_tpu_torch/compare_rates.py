"""New-frames/s of the flagship 5/1 and the point-aligned 75/30 pipelines
(sequential driver, seeded weights, 17 and 165 random 518x154 frames) for
the package found under ROOT, so that two checkouts can be compared in one
run on one card:

    python3 vitslam_tpu_torch/compare_rates.py PARENT_ROOT
    python3 vitslam_tpu_torch/compare_rates.py .

(run as a script path, not with -m, so that ROOT's package is the one
imported). Prints, per pipeline, the walls of three runs and the best
rate of the last two (the first warms cuBLAS/cuDNN and builds kernels).
"""
import sys
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
    for label, ctor, n, w, o in (("5/1", flagship, 17, 5, 1),
                                 ("75/30 point", flagship_point_aligned, 165, 75, 30)):
        model = ctor(device="cuda", seed=0)
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


if __name__ == "__main__":
    main(Path(sys.argv[1]).resolve())
