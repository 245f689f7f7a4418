"""Dry run of the port's parallelism over N ranks (port of
``__graft_entry__.py::dryrun_multichip``):

    python -m vitslam_tpu_torch.parallel.dryrun [N] [--device cpu|cuda]

Three gangs of gloo ranks (on the CPU, or all on card 0, sharing it):

1. N ranks as a (N / 2, 2) (data, model) mesh (N odd: (N, 1)) take one
   train step of a small FeatureAlignedVGGT with its parameters sharded
   over ``model``: a finite objective, the same on every rank;
2. the sequence-parallel encode of one N-frame chunk of a small
   PointAlignedVGGT over all N ranks, held on each rank against the
   unsharded encode of the same chunk;
3. a 2-node pod (``pod_worker``, N even and at least 4): LOCAL_WORLD_SIZE =
   N / 2, data parallelism across the nodes and tensor parallelism within
   each, two steps, whose nodes print the same objectives.

Prints one "dryrun_multichip ok: ..." line a phase; any failure raises.
"""
from __future__ import annotations

import argparse
import math
import re
import sys
import time
from pathlib import Path

import torch
import torch.distributed as dist

ROOT = Path(__file__).resolve().parents[2]
# the sequence-parallel model: the pod model's backbone widths
SP_KW = dict(embed_dim=128, num_heads=2, depth=2, patch_embed_depth=1,
             intermediate_layers=(0, 1, 1, 1))
# rel-L2 of the sequence-parallel encode against the unsharded one, per
# output: each query row sees the same keys in the same order, so in fp32 on
# the CPU the JAX dryrun's 1e-3; in bf16 on the card a rank's one frame runs
# the GEMMs and convolutions at another batch than the unsharded four,
# whose algorithms round otherwise (1.1e-2 / 1.3e-2 on points / poses, H100
# 80GB HBM3, 700 W): chip_smoke.py's DRIVER_RTOL for bf16 at other batch
# shapes
SP_RTOL = {"cpu": 1e-3, "cuda": 3e-2}
GANG_TIMEOUT = 600.0


def _worker(rank: int, port: int, world: int, device: str) -> None:
    """Phases 1 and 2 on one rank."""
    from ..models import PointAlignedVGGT
    from ..nn.layers import init_weights
    from ..utils import make_synthetic_batch
    from .mesh import init_distributed, make_mesh, shard_params_model
    from .pod_worker import frame_size, small_model, train_case, train_steps
    from .seq import gather_sequence, sequence_parallel_encode

    if device == "cuda":
        torch.cuda.set_device(0)
    else:
        torch.set_num_threads(1)
    init_distributed("gloo", f"localhost:{port}", world, rank)
    try:
        n_model = 2 if world % 2 == 0 else 1
        mesh = make_mesh(n_data=world // n_model, n_model=n_model)
        model = small_model(device)
        shards = shard_params_model(model, mesh)
        chunks, merged = train_case(mesh.size("data"), device, mesh)
        (obj,) = train_steps(model, chunks, merged, 1, mesh, shards)
        every = [None] * world
        dist.all_gather_object(every, obj)
        if not math.isfinite(obj) or len(set(every)) != 1:
            raise AssertionError(f"train step objectives {every}")
        print(f"[dryrun rank {rank}] train step mesh=({world // n_model}x{n_model}) "
              f"objective {obj:.6f}, {len(shards.dims)} tensors sharded", flush=True)

        H, W = frame_size(device)
        kw = dict(SP_KW, img_size=H,
                  dtype=torch.float32 if device == "cpu" else torch.bfloat16, device=device)
        group = make_mesh(n_data=1, n_model=world).group("model")
        sp_model, ref_model = (
            init_weights(PointAlignedVGGT(**kw, seq_group=g),
                         torch.Generator(device=device).manual_seed(2)).eval()
            for g in (group, None))
        images = torch.as_tensor(make_synthetic_batch(B=1, N=world, H=H, W=W, seed=2)["images"],
                                 device=device)
        with torch.no_grad():
            got = gather_sequence(sequence_parallel_encode(sp_model, images, group), group)
            want = ref_model.encode_chunks(images)
        errs = {k: (torch.linalg.vector_norm((got[k] - want[k]).float())
                    / torch.linalg.vector_norm(want[k].float()).clamp_min(1e-30)).item()
                for k in want}
        if set(got) != set(want) or not all(e <= SP_RTOL[device] for e in errs.values()):
            raise AssertionError(f"sequence-parallel encode drift: {errs}")
        print(f"[dryrun rank {rank}] sequence-parallel encode over (1x{world}) vs unsharded: "
              f"rel-L2 max {max(errs.values()):.2e} ({', '.join(sorted(want))})", flush=True)
    finally:
        dist.destroy_process_group()
    print(f"[dryrun rank {rank}] OK", flush=True)


def _gang(argv_for, world: int, env_extra: dict) -> list[str]:
    from .spawn import clean_env, spawn_gang

    outs, _ = spawn_gang(argv_for, world, timeout=GANG_TIMEOUT, retries=1, cwd=str(ROOT),
                         env=clean_env(dict(env_extra, PYTHONPATH=str(ROOT))))
    return outs


def dryrun_multichip(n: int, device: str = "cpu") -> None:
    """The three phases over ``n`` ranks on ``device``; raises on any
    failure."""
    t0 = time.time()
    outs = _gang(lambda r, port: [sys.executable, "-m", "vitslam_tpu_torch.parallel.dryrun",
                                  "--worker", str(r), str(port), str(n), "--device", device],
                 n, {"LOCAL_WORLD_SIZE": str(n)})
    for r, o in enumerate(outs):
        if f"[dryrun rank {r}] OK" not in o:
            raise AssertionError(f"dryrun rank {r} did not finish:\n{o[-3000:]}")
    lines = [line for line in outs[0].splitlines() if line.startswith("[dryrun rank 0]")]
    print("dryrun_multichip ok: " + "; ".join(line.split("] ", 1)[1] for line in lines[:-1]))
    if n >= 4 and n % 2 == 0:
        n_local = n // 2
        outs = _gang(lambda r, port: [sys.executable, "-m", "vitslam_tpu_torch.parallel.pod_worker",
                                      str(r), str(port), str(n), str(n_local), device],
                     n, {"LOCAL_WORLD_SIZE": str(n_local)})
        objs = [re.findall(r"objective ([-\d.]+)", o) for o in outs]
        if not objs[0] or any(o != objs[0] for o in objs):
            raise AssertionError(f"pod ranks disagree: {objs}")
        for r, o in enumerate(outs):
            if f"pod worker {r}: OK" not in o:
                raise AssertionError(f"pod worker {r} did not finish:\n{o[-3000:]}")
        print(f"dryrun_multichip ok: 2-node x {n_local}-rank pod, data across the nodes and "
              f"model within, two train steps, objectives {objs[0]} on every rank")
    print(f"dryrun_multichip DONE in {time.time() - t0:.0f} s on {device}")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("n", nargs="?", type=int, default=4)
    p.add_argument("--device", default="cpu", choices=("cpu", "cuda"))
    p.add_argument("--worker", nargs=3, type=int, metavar=("RANK", "PORT", "WORLD"),
                   help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.worker:
        _worker(*args.worker, args.device)
    else:
        dryrun_multichip(args.n, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
