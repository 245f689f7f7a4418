"""Where the time goes in the port's slices on one GPU, under torch.profiler
(seeded random weights, synthetic 518x154 sequences): the flagship 5/1
pipeline over 17 frames per driver (slice 1), the flagship point-aligned
model at chunk 75 / overlap 30 over 165 frames, sequential (slice 2), and
one train step of the flagship's global-mode AlignmentHead at bucket
(20, 5) on a 40-frame GT batch (slice 3); plus K1 beside torch's SDPA flash
backend as a yardstick at the 5/1 attention shapes. ``--tail-only``
profiles one 5/1 chunk of the flagship with the fused block tails (K5)
off and with both sites on (slice 4).

    python -m vitslam_tpu_torch.profile_slice [--out profile_out] [--train-only | --tail-only]

Prints, per run: wall seconds of a steady run, device-busy seconds (the
union of kernel intervals in the trace), the idle share, and the kernels
grouped by family with their device time. Writes a gzipped Chrome trace
per run under --out. Needs CUDA. The profiler slows the host side, so
its wall times and idle shares are upper bounds; time the runs without it
with chip_smoke.py.
"""
from __future__ import annotations

import argparse
import gzip
import json
import re
import time
from collections import defaultdict
from pathlib import Path

import numpy as np
import torch

FAMILIES = [  # (family, regex on the kernel name), first match wins
    ("K5 mlp_tail", r"mlp_tail_"),
    ("K1 qk_prep", r"qk_prep_kernel"),
    ("K1 fused_qkv_attention", r"fused_qkv_attention_kernel"),
    ("K4 flash backward (dq, dk/dv)", r"flash_bwd_"),
    # K2 and K3 are one CUDA kernel; slice 2's main path launches only K2,
    # slice 3's train step both (K2 in the backbone, K3 with lse in the head)
    ("K2/K3 flash_attention", r"flash_attention_kernel"),
    ("conv (cuDNN)", r"fprop|conv|cudnn|implicit|winograd|dgrad"),
    ("gemm (cuBLAS)", r"gemm|cutlass|xmma|nvjet|cublas|Kernel2"),
    ("softmax", r"softmax"),
    ("reduction (mean/norm)", r"reduce|norm"),
    ("copy / cast", r"copy|cast|Memcpy|Memset|fill"),
    ("elementwise", r"elementwise|vectorized|unrolled"),
]


def _family(name: str) -> str:
    for fam, pat in FAMILIES:
        if re.search(pat, name, re.IGNORECASE):
            return fam
    return "other"


def _busy_seconds(events) -> float:
    """Union of the kernel intervals (us) -> seconds."""
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in events)
    busy, end = 0.0, -1.0
    for s, e in spans:
        if s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy * 1e-6


def profile_driver(model, batch, encode_batch: int, out: Path, label: str,
                   width: int = 5, overlap: int = 1) -> dict:
    from .slam import ChunkedPipeline

    pipe = ChunkedPipeline(model, encode_batch=encode_batch)
    return profile_run(lambda: pipe.run_sequence(batch, chunk_width=width, num_overlap=overlap),
                       out, label)


def profile_train(out: Path, label: str = "train_global_20_5") -> dict:
    """One Trainer step (after a warm-up step) of flagship(temporal_attention
    =False) without its point head, with the train keys of the training
    config, at bucket (20, 5) on a synthetic 40-frame GT batch: 3 chunks of
    20, 20 and 10 frames."""
    from .models import flagship
    from .train import MultitaskLoss, Trainer
    from .train.config import VKITTI_TRAIN_CFG
    from .utils import make_synthetic_batch

    model = flagship(device="cuda", seed=0, enable_point=False, temporal_attention=False)
    cfg = dict(VKITTI_TRAIN_CFG, exp_name=label, logging={"log_dir": str(out / "logs")},
               checkpoint={"save_dir": str(out / "ckpt")})
    trainer = Trainer(cfg, model, MultitaskLoss(**cfg["loss"]))
    state = trainer.init_state()
    batch = make_synthetic_batch(B=1, N=40, H=154, W=518, seed=3)
    chunks, merged = trainer._prepare_chunks(batch, 20, 5)
    step_fn = trainer._get_step_fn(5)

    def step():
        _, metrics = step_fn(state, chunks, merged, trainer.generator)
        float(metrics["objective"])

    return profile_run(step, out, label)


def profile_run(fn, out: Path, label: str) -> dict:
    """Run ``fn`` once to warm up, then once under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    trace = out / f"trace_{label}.json"
    prof.export_chrome_trace(str(trace))
    raw = trace.read_bytes()
    trace.unlink()
    (out / f"trace_{label}.json.gz").write_bytes(gzip.compress(raw))
    events = [e for e in json.loads(raw)["traceEvents"]
              if e.get("cat") == "kernel" and "dur" in e]
    by_family: dict = defaultdict(float)
    by_name: dict = defaultdict(float)
    for e in events:
        by_family[_family(e["name"])] += e["dur"] * 1e-6
        by_name[e["name"][:90]] += e["dur"] * 1e-6
    busy = _busy_seconds(events)
    return dict(wall_s=wall, busy_s=busy, idle_share=1.0 - busy / wall,
                kernels=len(events),
                families=dict(sorted(by_family.items(), key=lambda kv: -kv[1])),
                top=dict(sorted(by_name.items(), key=lambda kv: -kv[1])[:12]))


def sdpa_yardstick() -> list[dict]:
    """K1 (no prep, online max) vs torch SDPA's flash backend on the same
    q/k/v at the main path's shapes; ms per call from CUDA events around 30
    back-to-back calls after a warm-up."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from .ops.fused_attention import fused_qkv_attention

    def per_call(fn, iters=30):
        fn()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(iters):
            fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b) / iters

    rows = []
    g = torch.Generator(device="cuda").manual_seed(0)
    for B, N in ((5, 412), (20, 412), (1, 2060), (4, 2060)):
        qkv = torch.randn((B, N, 3 * 1024), generator=g, device="cuda").to(torch.bfloat16)
        q, k, v = (qkv[..., i * 1024:(i + 1) * 1024].reshape(B, N, 16, 64).transpose(1, 2)
                   .contiguous() for i in range(3))
        k1 = per_call(lambda: fused_qkv_attention(qkv, num_heads=16))
        with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
            fl = per_call(lambda: F.scaled_dot_product_attention(q, k, v))
        flop = 4.0 * B * 16 * N * N * 64
        rows.append(dict(B=B, N=N, k1_ms=k1, sdpa_flash_ms=fl,
                         k1_tflops=flop / k1 / 1e9, sdpa_tflops=flop / fl / 1e9))
    return rows


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="profile_out")
    ap.add_argument("--train-only", action="store_true",
                    help="profile only the train step of slice 3")
    ap.add_argument("--tail-only", action="store_true",
                    help="profile only one 5/1 chunk with mlp_tail off and both")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_slice needs a CUDA GPU")
    import subprocess

    from .models import flagship, flagship_point_aligned

    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    report = {"device": smi.stdout.strip() or torch.cuda.get_device_name(0)}
    if args.train_only:
        report["train_global_20_5"] = profile_train(out)
        print(json.dumps(report, indent=1))
        return
    if args.tail_only:
        batch = {"images": rng.uniform(0, 1, size=(1, 5, 3, 154, 518)).astype(np.float32)}
        for tail in ("off", "both"):
            model = flagship(device="cuda", seed=0, mlp_tail=tail)
            report[f"chunk_5_1_tail_{tail}"] = profile_driver(model, batch, 1, out,
                                                              f"chunk_5_1_tail_{tail}")
            del model
            torch.cuda.empty_cache()
        print(json.dumps(report, indent=1))
        return
    batch = {"images": rng.uniform(0, 1, size=(1, 17, 3, 154, 518)).astype(np.float32)}
    model = flagship(device="cuda", seed=0)
    for label, eb in (("sequential", 1), ("encode_batch4", 4)):
        report[label] = profile_driver(model, batch, eb, out, label)
    report["sdpa_yardstick"] = sdpa_yardstick()
    del model
    torch.cuda.empty_cache()
    batch = {"images": rng.uniform(0, 1, size=(1, 165, 3, 154, 518)).astype(np.float32)}
    model = flagship_point_aligned(device="cuda", seed=0)
    report["point_75_30_sequential"] = profile_driver(model, batch, 1, out, "point_75_30",
                                                      width=75, overlap=30)
    del model
    torch.cuda.empty_cache()
    report["train_global_20_5"] = profile_train(out)
    print(json.dumps(report, indent=1))


if __name__ == "__main__":
    main()
