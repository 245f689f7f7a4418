#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (vitslam_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each printing its lines; any failure raises and exits non-zero:

1. device     — needs CUDA; prints torch.version.cuda, nvcc's version and
                the card's name and power limit (nvidia-smi).
2. build      — builds the CUDA kernels from csrc/ with nvcc (sm_90a), one
                nvcc per source, all at once; per library ptxas' registers
                and spills and the SASS counts of HGMMA (wgmma), UTMALDG
                (TMA loads) and HMMA (mma.sync): every library must be wgmma
                + TMA (HGMMA and UTMALDG nonzero, HMMA zero).
3. kernels    — K1 (fused qkv attention) and its prep kernel, K2 (flat
                streaming attention, also at the sequence-parallel shape)
                and K3 (flash attention forward)
                against their plain PyTorch versions in bf16 at the main
                paths' shapes (dh 64, 16 heads), and the K3 kernel's
                in-kernel q fold bit for bit against torch's; max error,
                device time per call (a back-to-back run), single-call time,
                plain and SDPA times, bound.
4. reference  — a small model with dh 64 through ChunkedPipeline on the GPU
                (bf16, K1) and on the CPU (fp32, plain math), same weights.
5. slice 5/1  — the flagship FeatureAlignedVGGT (seeded random weights) over
                a synthetic 17-frame 518x154 sequence, chunk 5 / overlap 1,
                sequential and two-stage (encode_batch=4) drivers; each
                driver (which fetches a chunk's outputs one chunk behind
                on a side stream) bit-equal to the same work with a
                blocking .cpu() after every chunk, its device idle share
                from one torch.profiler window, and the host syncs left in
                the sequential driver's chunks (torch's sync debug mode).
   checkpoints — the reference's checkpoint format (flax msgpack, written
                here by write_flax_checkpoint: the machine has no flax):
                the flagship's AlignmentHead as model_checkpoint_path over
                the whole flagship (5.3 GB) under "model" as the fallback,
                loaded by load_model_params into a flagship seeded otherwise:
                every parameter and the 5/1 sequential run bit-equal to
                phase 5's.
6. merge 5/1  — the same with the KV merge at pool 2 / stride 2: the global
                attention goes to K3 (1,474 keys), never K1.
7. slice 75/30— the flagship point-aligned and pose-aligned models over a
                synthetic 165-frame sequence at chunk 75 / overlap 30 (3
                chunks): global attention over 30,900 tokens through K2;
                point-aligned also through encode_batch=2; then one
                point-aligned chunk with the KV merge at pool 4 / stride 10
                (K2 with 30,900 queries over 5,641 keys).
8. global head — flagship(temporal_attention=False) over 9 frames at 5/1
                (2 chunks): the AlignmentHead's global attention (8 heads of
                128 over 2,065 and 2,891 tokens) through K3; one chunk's
                alignment stage held against the same stage on plain
                attention.
9. train       — Trainer.fit of the flagship AlignmentHead on the frozen
                backbone (the train keys of
                configs/train_featureAlignedVGGT_vkitti.yaml, seeded
                weights, a synthetic 40-frame 518x154 GT batch), 3 steps
                each: the shipped temporal head at bucket (10, 2), and the
                global head at bucket (20, 5), whose global attention over
                8,260 / 10,738 / 6,608 tokens runs K3 with lse forward (twice:
                the head's blocks are recomputed in the backward) and K4
                backward; then one step's head gradients through the kernels
                held against the same step on plain attention.
10. tail 5/1   — flagship(mlp_tail="both") over the 17-frame 5/1 sequence,
                sequential driver: every backbone block's two residual tails
                through K5 (144 launches a chunk); it and the slice 5/1
                sequential run (same seed, tails off) each held against an
                fp32 run of its own math with the same weights.
    tail 75/30 — flagship_point_aligned(mlp_tail="both") over the 165-frame
                sequence (3 chunks of 75 / 30): K5 at 30,900 rows, 144
                launches a chunk, finite outputs of the slice's shapes, its
                rate beside the tails-off point run.
11. eval       — the test mode's Metrics (the keys of
                configs/test_featureAlignedVGGT_vkitti.yaml: scale_from_poses,
                chunk 5 / overlap 1, ATE, RPE, Chamfer after ICP, the ICP cap
                of 500,000 points) over a synthetic 17-frame 518x154 GT
                sequence served by a BaseDataset, the tail model on the card;
                then the same eval on the card and on the CPU over one set of
                predictions (registered onto the GT points, ICP cap 20,000)
                held to each other.
12. distributed — gloo gangs of processes sharing the card (NCCL refuses
                two ranks on one GPU), launched by vitslam_tpu_torch.parallel.
                spawn_gang as ``chip_smoke.py --dist-worker RANK PORT WORLD
                OUTDIR SCENARIOS``: 3 ranks run the sequence-parallel encode
                of one 75-frame point-aligned chunk (25 frames a rank, K2
                with 10,300 local queries over 30,900 gathered keys) and the
                chunk-parallel flagship 5/1 at encode_batch=3; 2 ranks (three
                do not fit in 80 GB) one data-parallel train step of the
                global-mode head at (20, 5), one sample a rank. Each is held
                against one process's run of the same work; the 5/1 also runs
                through a 1-rank NCCL group. Each rank prints its wall time
                and peak memory; these are not rates. This phase runs right
                after the build, while this process holds no model.
13. int8       — the int8 serving mode: one int8 projection at the 75/30 qkv
                shape (30,900 x 1,024 x 3,072) on the card against the CPU
                (integers and int32 product equal, output within 1 bf16
                ulp); the four projections of a 75/30 block timed as the
                whole int8_matmul, torch._int_mm alone and bf16 F.linear;
                the flagship 5/1 and the point-aligned 75/30 with int8=True
                and both fused tails asked for (K1 on both, K2 on 75/30, no
                K5), beside the bf16 runs of slices 5/1 and 75/30; the last
                tap of an int8 chunk held to the same model's bf16 one
                (``set_int8``; cosine > 0.995).
14. hooks      — on one 5/1 chunk: utils.profiling.trace holds the chunk's
                annotate ranges and its kernels; nan_check off adds no
                device launch, on it reports a planted NaN (and raises when
                asked); ChunkTimer.
15. track      — the flagship with enable_track=True: one 5-frame chunk's
                taps, decode_track of 1,024 query points at the full VGGT-1B
                track width; the head in fp32 on the card (TF32 off) held to
                the same head on the CPU; the model's bf16 head against
                fp32, its time, device launches and peak memory.
16. tp         — tensor parallelism, right after the distributed phase and
                the same way: a gloo gang of 4 processes on the card, two
                nodes of 2 (LOCAL_WORLD_SIZE), as a (data 2, model 2) mesh,
                takes one global-mode (20, 5) train step of the full-width
                flagship through the Trainer with num_model_shards 2 (every
                split parameter held as its half, gathered where it is
                read), one batch row a data rank, held against the DP
                phase's one-process step (objective 1e-3, gradient norm
                1e-2, gradients GRAD_RTOL); its sharded save
                (io/sharded_ckpt.py, the orbax backend) is loaded here at
                model 1, bit-equal. Then one int8 projection's gradients on
                the card against the CPU, native_available(), and the pod
                dry run (vitslam_tpu_torch.parallel.dryrun) of 4 ranks on
                the card. Prints the rank peaks, the bytes each rank's
                parameter gathers receive and the phase's seconds.

The kernel phase also holds K3's lse output and K4 against their plain
versions at the global head's shapes (and K4's outputs from two runs to
each other: bit-identical), and K5 at the mlp and proj
tails of the 5/1 and 75/30 chunks, beside torch.mm of the same operands.
Every path runs with the kernels' launch counts set to 0 just before it
and reads them just after. The line before the last
is a JSON summary of the kernels; the last line is {"ok": true, "device":
{...}}.
"""
from __future__ import annotations

import collections
import gc
import io
import json
import re
import statistics
import struct
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
KERNELS = {  # name -> (route, source, the TPU kernel it replaces)
    "fused_qkv_attention": ("cuda", "vitslam_tpu_torch/csrc/fused_attention.cu",
                            "vitslam_tpu/ops/fused_attention.py:75"),
    # K1's LayerNorm + RoPE + scale fold, once per token and head: the TPU
    # kernel's _prep_tile, which it runs on every tile inside _fused_kernel
    "qk_prep": ("cuda", "vitslam_tpu_torch/csrc/fused_attention.cu",
                "vitslam_tpu/ops/fused_attention.py:56"),
    "flat_flash_attention": ("cuda", "vitslam_tpu_torch/csrc/flash_attention.cu",
                             "vitslam_tpu/ops/fused_attention.py:483"),
    "flash_attention": ("cuda", "vitslam_tpu_torch/csrc/flash_attention.cu",
                        "vitslam_tpu/ops/flash_attention.py:116"),
    "flash_attention_lse": ("cuda", "vitslam_tpu_torch/csrc/flash_attention.cu",
                            "vitslam_tpu/ops/flash_attention.py:116"),
    "flash_attention_backward": ("cuda", "vitslam_tpu_torch/csrc/flash_attention_bwd.cu",
                                 "vitslam_tpu/ops/flash_attention.py:384"),
    "mlp_tail": ("cuda", "vitslam_tpu_torch/csrc/mlp_tail.cu", "vitslam_tpu/ops/mlp_tail.py:54"),
}
# K4 is two TPU kernels, dq (:384) and dk/dv (:421); the port's one backward
# kernel (with its prep and dq passes) replaces both
ALSO_REPLACES = {"flash_attention_backward": "vitslam_tpu/ops/flash_attention.py:421"}
# head gradients of one train step through the kernels (bf16: K3 with lse,
# K4) against the same step on plain attention (the plain K3 and K4): both
# run the head in bf16, and the kernels round P and dS to bf16 where the
# plain versions keep fp32, so per-tensor relative L2 error up to 3e-2
GRAD_RTOL = 3e-2
# the eval on the card against the same eval on the CPU over one set of
# predictions: fp32 on both, distances summed in another order, so per
# metric relative error
EVAL_RTOL = 1e-3
# NVIDIA H100 SXM data sheet: dense bf16 tensor-core peak, dense int8 peak
# and HBM3 rate
PEAK_FLOPS = 989e12
PEAK_INT8_OPS = 1979e12
PEAK_BYTES = 3.35e12

# Kernel vs its plain version, bf16 on the card, elementwise
# |got - want| <= ATOL + RTOL * |want|: both outputs are bf16 (they may
# differ by an ulp, 2^-8 relative), the kernels round q to bf16 after
# folding scale*log2(e) into it while the plain versions of K1 and K3 round
# before scaling (logits differ by ~2^-8 relative, which moves the largest
# probabilities by a few percent when logits are large), P is rounded to
# bf16 before P V, and sums run in another order. The logit rounding error
# grows with the logits, whose size the qk-norm bound caps, so for a bound
# above 24 ATOL scales by bound / 24. The outputs of attention over
# thousands of keys are small, so the relative L2 error of the whole
# output is held too: a bf16 output rounding alone gives ~3e-3.
ATOL = 2e-2
RTOL = 2e-2
REL_L2_TOL = 1e-2
# whole pipeline, GPU bf16 vs GPU bf16 (sequential vs two-stage driver, the
# same math at other batch shapes, so cuBLAS/cuDNN may pick other
# algorithms): relative L2 error per output
DRIVER_RTOL = 3e-2
# small model, GPU (bf16, K1) against the CPU in fp32 (plain math: the path
# the CPU tests hold to the JAX package). bf16 compute through a random-
# weight model has a noise floor of several percent on poses and points,
# so the GPU's error is held to the CPU's own bf16 error against the same
# fp32 run: at most REFERENCE_FACTOR times it, plus 1e-3. A wrong kernel
# (mask, LayerNorm, RoPE, shift) moves outputs by O(1).
REFERENCE_FACTOR = 3.0


def run(cmd: list[str]) -> str:
    return subprocess.run(cmd, capture_output=True, text=True, check=True).stdout.strip()


def rel_l2(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-12))


def output_errors(got: dict, want: dict, keys=None) -> dict:
    """Relative L2 error per output. q and -q are one rotation, and with
    random weights a pose can sit where the w >= 0 canonical sign flips, so
    the quaternion slots of pose_enc are compared up to sign."""
    errs = {}
    for k in keys or ("pose_enc", "depth", "world_points", "chunk_sim3_enc", "memory_tokens"):
        a = np.asarray(got[k], np.float64)
        b = np.asarray(want[k], np.float64)
        if k == "pose_enc":
            q, qw = a[..., 3:7], b[..., 3:7]
            flip = (q * qw).sum(-1, keepdims=True) < 0
            a = np.concatenate([a[..., :3], np.where(flip, -q, q), a[..., 7:]], -1)
        errs[k] = rel_l2(a, b)
    return errs


def counters():
    from vitslam_tpu_torch.ops.flash_attention import (
        flash_attention,
        flash_attention_backward,
        flash_attention_lse,
    )
    from vitslam_tpu_torch.ops.fused_attention import (
        flat_flash_attention,
        fused_qkv_attention,
        qk_prep,
    )
    from vitslam_tpu_torch.ops.mlp_tail import mlp_tail

    return {"fused_qkv_attention": fused_qkv_attention, "qk_prep": qk_prep,
            "flat_flash_attention": flat_flash_attention, "flash_attention": flash_attention,
            "flash_attention_lse": flash_attention_lse,
            "flash_attention_backward": flash_attention_backward, "mlp_tail": mlp_tail}


def reset_launches() -> None:
    for fn in counters().values():
        fn.launches = 0


def read_launches() -> dict:
    return {name: fn.launches for name, fn in counters().items()}


def phase_device():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script runs only on a CUDA GPU")
    from vitslam_tpu_torch.ops.cuda_build import find_nvcc

    nvcc = run([find_nvcc(), "--version"]).splitlines()[-1]
    smi = run(["nvidia-smi", "--query-gpu=name,power.limit",
               "--format=csv,noheader"]).splitlines()[0]
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
          f"nvcc '{nvcc}' devices {torch.cuda.device_count()}")
    print(smi)
    return smi


def _cuobjdump():
    """cuobjdump from the CUDA toolkit, else Triton's bundled copy, else None."""
    import shutil

    from vitslam_tpu_torch.ops.cuda_build import find_nvcc

    found = shutil.which("cuobjdump")
    cands = [found] if found else []
    cands.append(str(Path(find_nvcc()).parent / "cuobjdump"))
    try:
        import triton

        cands.append(str(Path(triton.__file__).parent / "backends" / "nvidia" / "bin" / "cuobjdump"))
    except ImportError:
        pass
    return next((c for c in cands if c and Path(c).exists()), None)


def phase_build():
    """Build every kernel library; per library print ptxas' registers and
    spills per kernel and, from the SASS, the counts of HGMMA (wgmma) and
    UTMALDG (TMA tile loads) instructions."""
    from vitslam_tpu_torch.ops import cuda_build

    t0 = time.perf_counter()
    paths = cuda_build.build_all()
    print(f"[build] {len(cuda_build.ENTRY_POINTS)} kernel libraries in "
          f"{time.perf_counter() - t0:.1f} s (one nvcc per source, in parallel)")
    tool = _cuobjdump()
    sass = {}
    for name, info in cuda_build.build_info.items():
        ptxas = " | ".join(line.strip() for line in info.get("log", "").splitlines()
                           if "registers" in line or "spill" in line)
        if tool is None:
            counts = "SASS: not available (no cuobjdump in the toolkit or Triton)"
        else:
            text = run([tool, "-sass", str(paths[name])])
            sass[name] = {op: text.count(op) for op in ("HGMMA", "UTMALDG", "HMMA")}
            counts = "SASS: " + ", ".join(f"{op} {n}" for op, n in sass[name].items())
        print(f"[build] {name}: {info['seconds']:.1f} s (cached={info['cached']}); {counts}; "
              f"ptxas: {ptxas[:1500]}")
    for name, counts in sass.items():
        if not (counts["HGMMA"] and counts["UTMALDG"]) or counts["HMMA"]:
            raise AssertionError(f"{name}: every kernel library must be wgmma + TMA and no "
                                 f"mma.sync, SASS counts {counts}")
    return sass


def _time_ms(fn, target_ms: float = 40.0) -> float:
    """Device time per call: CUDA events around a run of back-to-back calls
    after a warm-up, divided by their count. The calls are replays of a
    CUDA graph that captured them (20 calls a graph for calls under 1 ms,
    else one), so the run has no host enqueue in it and small kernels are
    not hidden behind their wrappers' Python; a call that cannot be
    captured runs eagerly instead (then a call shorter than its enqueue is
    measured at the enqueue rate). ``_call_ms`` is the single-call view."""
    import torch

    def timed(run, n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            run()
        end.record()
        end.synchronize()
        return start.elapsed_time(end)

    fn()
    per_run, run = 1, fn
    eager_one = timed(fn, 1)
    try:
        graph = torch.cuda.CUDAGraph()
        per_run = 20 if eager_one < 1.0 else 1
        with torch.cuda.graph(graph):
            for _ in range(per_run):
                fn()
        run = graph.replay
        run()
    except RuntimeError:
        torch.cuda.synchronize()
        per_run, run = 1, fn
    one = timed(run, 1)
    n = int(min(200, max(3, target_ms / max(one, 1e-3))))
    return timed(run, n) / (n * per_run)


def _call_ms(fn, iters: int = 20) -> float:
    """Median of single-call times from CUDA events around one wrapper call
    each, after a warm-up (host enqueue included: what a host-bound path
    pays per call); calls longer than 50 ms are timed 3 times."""
    import torch

    def once():
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end)

    first = once()
    times = [once() for _ in range(iters if first < 50 else 3)]
    return statistics.median(times)


def _bound(flop: float, nbytes: float):
    """The least time the card could take: the larger of the operations
    over the bf16 tensor-core peak and the bytes over the memory rate."""
    t_op, t_b = flop / PEAK_FLOPS, nbytes / PEAK_BYTES
    return max(t_op, t_b) * 1e3, ("operations" if t_op >= t_b else "bytes")


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def _check(name: str, case: str, got, want, atol: float) -> tuple[float, float]:
    import torch

    torch.cuda.synchronize()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name} {case}: non-finite output")
    g, w = got.float(), want.float()
    diff = (g - w).abs()
    err = diff.max().item()
    rl2 = (torch.linalg.vector_norm(g - w) / torch.linalg.vector_norm(w).clamp_min(1e-12)).item()
    if not (diff <= atol + RTOL * w.abs()).all() or not rl2 <= REL_L2_TOL:
        raise AssertionError(f"{name} {case}: max abs err {err} beyond {atol} + {RTOL} * "
                             f"|plain|, or rel-L2 {rl2} > {REL_L2_TOL}")
    return err, rl2


def _sdpa_ms(q, k, v) -> float:
    """torch's SDPA (flash backend) on the same (B, H, N, 64) q/k/v: the
    library yardstick; the port never calls it."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    q, k, v = (t.contiguous() for t in (q, k, v))
    with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
        return _time_ms(lambda: F.scaled_dot_product_attention(q, k, v))


def _sdpa_bwd_ms(q, k, v, dout) -> float:
    """The backward of torch's SDPA (flash backend) through autograd on the
    same q/k/v and output gradient: the yardstick of K4."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    q, k, v = (t.detach().contiguous().requires_grad_() for t in (q, k, v))
    with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
        o = F.scaled_dot_product_attention(q, k, v)
    dout = dout.contiguous()
    return _time_ms(lambda: torch.autograd.grad(o, (q, k, v), dout, retain_graph=True))


def _report(results: dict, name: str, case: str, main: bool, err: float, rl2: float,
            fn, plain_ms: float, library_ms, flop: float, nbytes: int, **extra):
    """Time the kernel's wrapper call ``fn`` (device time per call of a
    back-to-back run, and the single-call time), print and keep one case.
    ``library_ms``: one torch call computing the same function (SDPA), or
    None where there is none; ``extra`` carries other yardsticks (K1: SDPA
    without the prep; K5: the unfused tail)."""
    ms, call_ms = _time_ms(fn), _call_ms(fn)
    bound_ms, bound_by = _bound(flop, nbytes)
    lib = "none" if library_ms is None else f"{library_ms:.4f} ms"
    more = "".join(f" {k} {v:.4f}" + (" ms" if k.endswith("_ms") else "")
                   for k, v in extra.items())
    rate = f"{flop / ms / 1e9:.1f} TFLOP/s" if flop else f"{nbytes / ms / 1e6:.0f} GB/s"
    print(f"[kernels] {name} {case}: max_abs_err {err:.3e} rel-L2 {rl2:.2e} kernel {ms:.4f} ms "
          f"per call back to back ({rate}, {bound_ms / ms:.1%} of bound {bound_ms:.4f} ms, "
          f"{bound_by}), single call {call_ms:.4f} ms, plain {plain_ms:.4f} ms, library {lib}"
          f"{more}")
    results.setdefault(name, []).append(dict(
        case=case, main=main, max_abs_err=err, rel_l2=rl2, ms=ms, call_ms=call_ms,
        plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by,
        tflops=flop / ms / 1e9, share_of_bound=bound_ms / ms, **extra))


def _flat_prep_sdpa(qkv, heads, ln, cos, sin, nsplit):
    """K1's yardstick with LayerNorm + RoPE: the port's own flat-route prep
    (HeadLayerNorm(flat=True) + apply_rope_flat on q and k, as
    nn.layers.Attention runs it for K2) followed by SDPA's flash backend on
    the (B, H, N, 64) views; a zero-argument callable. Never on the port's
    path."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from vitslam_tpu_torch.nn.layers import HeadLayerNorm
    from vitslam_tpu_torch.nn.rope import apply_rope_flat
    from vitslam_tpu_torch.ops.fused_attention import _heads

    C = qkv.shape[-1] // 3
    norms = []
    for scale, bias in ln:
        m = HeadLayerNorm(heads, C // heads, dtype=torch.bfloat16, device=qkv.device)
        with torch.no_grad():
            m.weight.copy_(scale)
            m.bias.copy_(bias)
        norms.append(m)

    def run():
        with torch.no_grad(), sdpa_kernel(SDPBackend.FLASH_ATTENTION):
            q = apply_rope_flat(norms[0](qkv[..., :C], flat=True), cos, sin, heads, nsplit)
            k = apply_rope_flat(norms[1](qkv[..., C:2 * C], flat=True), cos, sin, heads, nsplit)
            return F.scaled_dot_product_attention(_heads(q, heads), _heads(k, heads),
                                                  _heads(qkv[..., 2 * C:], heads))
    return run


def kernels_k1(results: dict, g, dev):
    """K1 (prep kernel + attention kernel, one wrapper call) and its prep
    kernel alone (``qk_prep``) at the main paths' shapes."""
    import torch

    from vitslam_tpu_torch.nn.layers import qk_shift_from
    from vitslam_tpu_torch.nn.rope import patch_grid_positions, rope_cache_2d
    from vitslam_tpu_torch.ops.flash_attention import q_fold
    from vitslam_tpu_torch.ops.fused_attention import (
        fused_qkv_attention,
        fused_qkv_attention_plain,
        qk_prep,
        qk_prep_plain,
    )

    heads, dh = 16, 64
    C = heads * dh
    # (name, B, N, LN+RoPE, LN gain, main-path case); N = frames * 412
    cases = [
        ("patch_embed 5/1 B=5 N=412 online-max", 5, 412, False, None, False),
        ("frame 5/1 B=5 N=412 LN+RoPE bounded", 5, 412, True, 1.0, False),
        ("global 5/1 B=1 N=2060 LN+RoPE bounded", 1, 2060, True, 1.0, False),
        ("patch_embed 75/30 B=75 N=412 online-max", 75, 412, False, None, False),
        ("frame 75/30 B=75 N=412 LN+RoPE bounded", 75, 412, True, 1.0, True),
        ("ragged B=2 N=1000 LN+RoPE bounded", 2, 1000, True, 1.0, False),
        # qk-norm gains of 2 put the logit bound near 54 > 24; the fixed
        # shift stays exact while bound - row max < ~87 nats (exp2 in fp32
        # stays normal), as in the reference kernel
        ("large-gain B=1 N=600 LN bounded (bound > 24)", 1, 600, "ln", 2.0, False),
    ]
    for case, B, N, prep, gain, main in cases:
        qkv = torch.randn((B, N, 3 * C), generator=g, device=dev).to(torch.bfloat16)
        kw = dict(num_heads=heads)
        tables = []
        if prep:
            ln = [(gain * (1 + 0.1 * torch.randn(dh, generator=g, device=dev)),
                   0.1 * torch.randn(dh, generator=g, device=dev)) for _ in range(2)]
            kw.update(q_ln=ln[0], k_ln=ln[1], static_max=qk_shift_from(ln[0], ln[1], dh))
            tables += [t for pair in ln for t in pair]
            if prep is True:
                # the main path's 2-D RoPE cache, fp32 as the model passes it:
                # 5 specials + an 11 x 37 grid per frame
                pos = patch_grid_positions(B, 11, 37, 5, dev).repeat(1, -(-N // 412), 1)
                cos, sin, nsplit = rope_cache_2d(pos[:, :N], dh)
                kw.update(cos=cos, sin=sin, nsplit=nsplit)
                tables += [cos, sin]
        if gain and gain > 1 and not float(kw["static_max"]) > 24.0:
            raise AssertionError(f"K1 {case}: the bound {float(kw['static_max'])} is not > 24")
        got = fused_qkv_attention(qkv, **kw)
        want = fused_qkv_attention_plain(qkv, **kw)
        atol = ATOL * max(1.0, float(kw.get("static_max", 0.0)) / 24.0)
        err, rl2 = _check("K1", case, got, want, atol)
        plain_ms = _time_ms(lambda: fused_qkv_attention_plain(qkv, **kw))
        q, k, v = (qkv[..., i * C:(i + 1) * C].reshape(B, N, heads, dh).transpose(1, 2)
                   for i in range(3))
        sdpa_ms = _sdpa_ms(q, k, v)  # SDPA on the same q/k/v, without K1's prep
        library_ms = sdpa_ms
        if prep is True:
            library_ms = _time_ms(_flat_prep_sdpa(qkv, heads, ln, cos, sin, nsplit))
        _report(results, "fused_qkv_attention", case, main, err, rl2,
                lambda: fused_qkv_attention(qkv, **kw), plain_ms, library_ms,
                4.0 * B * heads * N * N * dh, _nbytes(qkv, got, *tables), sdpa_ms=sdpa_ms)

        if not prep:
            del qkv, got, want
            continue
        # the prep kernel alone on the same inputs: bf16 outputs equal to
        # the plain version's or one ulp from them (the LayerNorm sums run in
        # another order), or within 1e-6 where RoPE cancels O(1) operands to
        # near zero; at least 99.9% bit-identical
        pkw = {k_: v_ for k_, v_ in kw.items() if k_ not in ("static_max",)}
        pkw["fold"] = q_fold(dh)
        got_p = qk_prep(qkv, **pkw)
        want_p = qk_prep_plain(qkv, **pkw)
        torch.cuda.synchronize()
        errs, same = [], []
        for a, b in zip(got_p, want_p):
            a, b = a.float(), b.float()
            same.append((a == b).float().mean().item())
            if not ((a - b).abs() <= 1e-6 + 2.0 ** -7 * b.abs()).all() or same[-1] < 0.999:
                raise AssertionError(f"qk_prep {case}: beyond one bf16 ulp of the plain version, "
                                     f"or only {same[-1]:.5f} bit-identical")
            errs.append((a - b).abs().max().item())
        nb = _nbytes(qkv[..., :2 * C], *got_p, *tables)
        _report(results, "qk_prep", case, main, max(errs), 0.0, lambda: qk_prep(qkv, **pkw),
                _time_ms(lambda: qk_prep_plain(qkv, **pkw)), None, 0.0, nb,
                bit_identical=min(same))
        del qkv, got, want, got_p, want_p
        torch.cuda.empty_cache()


def kernels_k2(results: dict, g, dev):
    import torch

    from vitslam_tpu_torch.ops.flash_attention import q_fold
    from vitslam_tpu_torch.ops.fused_attention import (
        _heads,
        flat_flash_attention,
        flat_flash_attention_plain,
    )

    heads, dh = 16, 64
    C = heads * dh
    smax = torch.tensor(24.0, device=dev)  # the model's bound is a device scalar
    cases = [  # (name, B, Nq, Nk, main-path case)
        ("global 75/30 B=1 Nq=Nk=30900", 1, 30900, 30900, True),
        ("merged 75/30 p4s10 B=1 Nq=30900 Nk=5641", 1, 30900, 5641, False),
        ("ragged B=2 Nq=4200 Nk=5000", 2, 4200, 5000, False),
        # sequence-parallel global attention, 75/30 over 3 ranks: 25 frames'
        # queries against the 75 frames' gathered keys
        ("SP 75/30 3 ranks B=1 Nq=10300 Nk=30900", 1, 10300, 30900, False),
    ]
    for case, B, nq, nk, main in cases:
        # q scaled by 2: logits ~N(0, 4), a sharper softmax than unit inputs
        q = (2 * torch.randn((B, nq, C), generator=g, device=dev)).to(torch.bfloat16)
        k = torch.randn((B, nk, C), generator=g, device=dev).to(torch.bfloat16)
        # v is a strided slice of a packed projection, as the model passes it
        v = torch.randn((B, nk, 3 * C), generator=g, device=dev).to(torch.bfloat16)[..., 2 * C:]
        got = flat_flash_attention(q, k, v, num_heads=heads, static_max=smax)
        qs = (q.float() * q_fold(dh)).to(torch.bfloat16)  # the kernel's scale fold
        want = flat_flash_attention_plain(qs, k, v, num_heads=heads)
        err, rl2 = _check("K2", case, got, want, ATOL)
        del want
        plain_ms = _time_ms(lambda: flat_flash_attention_plain(qs, k, v, num_heads=heads))
        library_ms = _sdpa_ms(_heads(q, heads), _heads(k, heads), _heads(v, heads))
        _report(results, "flat_flash_attention", case, main, err, rl2,
                lambda: flat_flash_attention(q, k, v, num_heads=heads, static_max=smax),
                plain_ms, library_ms, 4.0 * B * heads * nq * nk * dh, _nbytes(q, k, v, got))
        del q, k, v, qs, got
        torch.cuda.empty_cache()


def _check_q_fold(dev):
    """The kernel folds scale * log2(e) into q in shared memory; K4's
    wrapper rebuilds P from (q.float() * q_fold(D)).to(bf16). Read the
    kernel's q back exactly: head j attends to the one key e_j with an
    online max, so its lse is q^[:, j] (one product, exact in fp32) + log2(1).
    Raises unless every element equals the torch fold bit for bit."""
    import torch

    from vitslam_tpu_torch.ops.flash_attention import flash_attention_lse, q_fold

    g = torch.Generator(device=dev).manual_seed(5)
    for dh in (64, 128):
        q1 = (3 * torch.randn((2060, dh), generator=g, device=dev)).to(torch.bfloat16)
        q = q1.expand(1, dh, 2060, dh).contiguous()
        k = torch.eye(dh, device=dev, dtype=torch.bfloat16).reshape(1, dh, 1, dh)
        v = torch.zeros((1, dh, 1, dh), device=dev, dtype=torch.bfloat16)
        _, lse = flash_attention_lse(q, k, v)
        want = (q1.float() * q_fold(dh)).to(torch.bfloat16).float()
        bad = (lse[0].t() != want).sum().item()
        print(f"[kernels] in-kernel q fold at D {dh}: {want.numel() - bad} of {want.numel()} "
              "elements bit-identical to the torch fold")
        if bad:
            raise AssertionError(f"the kernel's q fold differs from torch's at D {dh}")


def kernels_k3(results: dict, g, dev):
    import torch

    from vitslam_tpu_torch.ops.flash_attention import flash_attention, flash_attention_plain

    _check_q_fold(dev)
    cases = [  # (name, B, H, Nq, Nk, bounded, main-path case)
        ("merged 5/1 p2s2 B=1 H=16 Nq=2060 Nk=1474 bounded", 1, 16, 2060, 1474, True, True),
        ("cross online-max B=1 H=16 Nq=1000 Nk=3000", 1, 16, 1000, 3000, False, False),
        ("ragged B=2 H=4 Nq=300 Nk=337 bounded", 2, 4, 300, 337, True, False),
    ]
    for case, B, H, nq, nk, bounded, main in cases:
        q = (2 * torch.randn((B, H, nq, 64), generator=g, device=dev)).to(torch.bfloat16)
        k = torch.randn((B, H, nk, 64), generator=g, device=dev).to(torch.bfloat16)
        v = torch.randn((B, H, nk, 64), generator=g, device=dev).to(torch.bfloat16)
        smax = torch.tensor(24.0, device=dev) if bounded else None
        got = flash_attention(q, k, v, static_max=smax)
        want = flash_attention_plain(q, k, v)
        err, rl2 = _check("K3", case, got, want, ATOL)
        plain_ms = _time_ms(lambda: flash_attention_plain(q, k, v))
        _report(results, "flash_attention", case, main, err, rl2,
                lambda: flash_attention(q, k, v, static_max=smax), plain_ms, _sdpa_ms(q, k, v),
                4.0 * B * H * nq * nk * 64, _nbytes(q, k, v, got))


def _rerun_difference(case: str, first, second) -> float:
    """K4 twice on the same inputs: its key blocks add into dq's fp32
    accumulator in key order, so dq, dk and dv are bit-identical. Returns
    the largest dq difference (0)."""
    import torch

    torch.cuda.synchronize()
    for a, b, name in zip(first, second, ("dq", "dk", "dv")):
        if not torch.equal(a, b):
            raise AssertionError(f"K4 {case}: {name} differs between two runs by "
                                 f"{(a.float() - b.float()).abs().max().item()}")
    print(f"[kernels] K4 {case}: dq, dk and dv of two runs bit-identical")
    return 0.0


def kernels_k3_lse_k4(results: dict, g, dev):
    """K3 with its lse output and K4 against their plain versions in fp32 on
    the query the kernels see (q * scale * log2(e) rounded to bf16, scaled
    back), on the same bf16 k, v, output and output gradient."""
    import torch

    from vitslam_tpu_torch.ops.flash_attention import (
        flash_attention_backward,
        flash_attention_backward_plain,
        flash_attention_lse,
        flash_attention_plain,
        q_fold,
    )

    cases = [  # (name, B, H, Nq, Nk, D, bounded, main-path case)
        ("head global (20,5) first chunk B=1 H=8 N=8260 D=128 bounded",
         1, 8, 8260, 8260, 128, True, False),
        ("head global (20,5) later chunks B=1 H=8 N=10738 D=128 bounded",
         1, 8, 10738, 10738, 128, True, True),
        ("head global (20,5) remainder B=1 H=8 N=6608 D=128 bounded",
         1, 8, 6608, 6608, 128, True, False),
        ("cross B=1 H=16 Nq=2060 Nk=1474 D=64 online-max", 1, 16, 2060, 1474, 64, False, False),
    ]
    for case, B, H, nq, nk, D, bounded, main in cases:
        q = (2 * torch.randn((B, H, nq, D), generator=g, device=dev)).to(torch.bfloat16)
        k = torch.randn((B, H, nk, D), generator=g, device=dev).to(torch.bfloat16)
        v = torch.randn((B, H, nk, D), generator=g, device=dev).to(torch.bfloat16)
        dout = torch.randn((B, H, nq, D), generator=g, device=dev).to(torch.bfloat16)
        smax = torch.tensor(24.0, device=dev) if bounded else None
        fold = q_fold(D)
        q_eff = (q.float() * fold).to(torch.bfloat16).float() / fold
        out, lse = flash_attention_lse(q, k, v, static_max=smax)
        want_out, want_lse = flash_attention_plain(q_eff, k, v, with_lse=True)
        errs = [_check("K3-lse", case + " out", out, want_out, ATOL),
                _check("K3-lse", case + " lse", lse, want_lse, ATOL)]
        del want_out, want_lse
        plain_ms = _time_ms(lambda: flash_attention_plain(q_eff, k, v, with_lse=True))
        _report(results, "flash_attention_lse", case, main, max(e[0] for e in errs),
                max(e[1] for e in errs), lambda: flash_attention_lse(q, k, v, static_max=smax),
                plain_ms, _sdpa_ms(q, k, v),
                4.0 * B * H * nq * nk * D, _nbytes(q, k, v, out, lse))

        got = flash_attention_backward(q, k, v, out, lse, dout)
        want = flash_attention_backward_plain(q_eff, k, v, out, lse, dout)
        errs = [_check("K4", f"{case} {name}", a, b, ATOL)
                for a, b, name in zip(got, want, ("dq", "dk", "dv"))]
        del want
        again = flash_attention_backward(q, k, v, out, lse, dout)
        rerun = _rerun_difference(case, got, again)
        del again
        plain_ms = _time_ms(lambda: flash_attention_backward_plain(q_eff, k, v, out, lse, dout))
        # five Nq x Nk x D products (S, dP, dv, dk, dq), each done once
        _report(results, "flash_attention_backward", case, main, max(e[0] for e in errs),
                max(e[1] for e in errs),
                lambda: flash_attention_backward(q, k, v, out, lse, dout), plain_ms,
                _sdpa_bwd_ms(q, k, v, dout),
                10.0 * B * H * nq * nk * D, _nbytes(q, k, v, out, lse, dout, *got),
                dq_rerun_max_abs=rerun)
        del q, k, v, dout, q_eff, out, lse, got
        torch.cuda.empty_cache()


def kernels_k5(results: dict, g, dev):
    """K5 at the backbone's two tail sites of a 5/1 chunk (M = 5 x 412 rows)
    and of a 75/30 chunk (M = 75 x 412), C 1,024: the mlp site (gelu, F
    4,096, no LayerNorm) and the proj site (F 1,024, LayerNorm). No torch
    call computes K5's function, so library_ms is None; the yardstick is
    the port's unfused tail on the same inputs (F.linear + gelu +
    LayerScale + residual add + ln_apply, the fp32 weight cast per call),
    which the main path runs with the tails off; tail_route_ms is K5 as a
    block calls it (nn.layers.dense_tail: LayerScale folded into the fp32
    weight, cast, then K5); gemm_ms is torch.mm of the same bf16 h and W,
    the product alone, timed as a floor and never called by the port."""
    import torch
    import torch.nn.functional as F

    from vitslam_tpu_torch.nn.layers import Dense, dense_tail, ln_apply
    from vitslam_tpu_torch.ops.mlp_tail import mlp_tail, mlp_tail_plain

    C = 1024
    cases = [  # (name, M, F, gelu, LayerNorm, main-path case)
        ("mlp 5/1 M=2060 F=4096 C=1024 gelu", 2060, 4096, True, False, True),
        ("proj 5/1 M=2060 F=1024 C=1024 LN", 2060, 1024, False, True, False),
        ("mlp 75/30 M=30900 F=4096 C=1024 gelu", 30900, 4096, True, False, False),
        ("proj 75/30 M=30900 F=1024 C=1024 LN", 30900, 1024, False, True, False),
        # not on a path: the mlp site's GEMM without its gelu prologue, which
        # shows what the in-kernel gelu costs
        ("probe 5/1 M=2060 F=4096 C=1024 no gelu", 2060, 4096, False, False, False),
    ]
    for case, M, Fd, gelu, ln, main in cases:
        randn = lambda *shape: torch.randn(shape, generator=g, device=dev)  # noqa: E731
        h = randn(M, Fd).to(torch.bfloat16)
        res = randn(M, C).to(torch.bfloat16)
        dense = Dense(Fd, C, dtype=torch.bfloat16, device=dev)
        with torch.no_grad():
            dense.weight.copy_(randn(C, Fd) / Fd ** 0.5)
            dense.bias.copy_(0.1 * randn(C))
        ls = 1.0 + 0.1 * randn(C)
        gamma, beta = 1.0 + 0.1 * randn(C), 0.1 * randn(C)
        w = (dense.weight * ls[:, None]).to(torch.bfloat16)  # LayerScale folded, as dense_tail
        b = dense.bias * ls
        kw = dict(gelu=gelu, ln=ln)
        args = (h, w, b, res) + ((gamma, beta) if ln else ())
        with torch.no_grad():
            got = mlp_tail(*args, **kw)
            want = mlp_tail_plain(*args, **kw)
            got, want = (got, want) if ln else ((got,), (want,))
            errs = [_check("K5", f"{case} {n}", a, c, ATOL)
                    for a, c, n in zip(got, want, ("x", "y"))]
            plain_ms = _time_ms(lambda: mlp_tail_plain(*args, **kw))
            tail_ln = (gamma, beta) if ln else None
            route_ms = _time_ms(lambda: dense_tail(dense, h, res, ls, tail_ln, gelu=gelu))

            def unfused():
                x = res + dense(F.gelu(h) if gelu else h) * ls.to(torch.bfloat16)
                return (x, ln_apply(x, gamma, beta, torch.bfloat16)) if ln else x
            unfused_ms = _time_ms(unfused)
            # the product alone, as a floor: cuBLAS on the same bf16 h and W
            gemm_ms = _time_ms(lambda: torch.mm(h, w.t()))
            _report(results, "mlp_tail", case, main, max(e[0] for e in errs),
                    max(e[1] for e in errs), lambda: mlp_tail(*args, **kw), plain_ms, None,
                    2.0 * M * Fd * C, _nbytes(*args, *got), unfused_ms=unfused_ms,
                    tail_route_ms=route_ms, gemm_ms=gemm_ms)
        del h, res, dense, w, got, want
        torch.cuda.empty_cache()


def phase_kernels() -> dict:
    import torch

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    results: dict = {}
    kernels_k1(results, g, dev)
    kernels_k2(results, g, dev)
    kernels_k3(results, g, dev)
    kernels_k3_lse_k4(results, g, dev)
    kernels_k5(results, g, dev)
    return results


def _synthetic_sequence(n_frames: int, H: int, W: int, seed: int) -> dict:
    """A smooth random scene panned across the frames, in [0, 1]."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(0.0, 1.0, size=(3, H // 7 + 1, (W + 4 * n_frames) // 7 + 1))
    big = np.kron(base, np.ones((1, 7, 7)))
    frames = [big[:, :H, 4 * s:4 * s + W] for s in range(n_frames)]
    return {"images": np.stack(frames)[None].astype(np.float32)}


def phase_reference():
    import torch

    from vitslam_tpu_torch.models import small_feature_aligned
    from vitslam_tpu_torch.ops import ROUTE_COUNTS
    from vitslam_tpu_torch.slam import ChunkedPipeline

    kw = dict(embed_dim=128, num_heads=2, depth=2, patch_embed_depth=1,
              intermediate_layers=(0, 1, 1, 1), align_embed_dim=64,
              align_dec_dim=32, num_memory_tokens=4)
    gpu = small_feature_aligned(device="cuda", seed=1, **kw)
    cpu16 = small_feature_aligned(device="cpu", seed=1, **kw)
    cpu32 = small_feature_aligned(device="cpu", seed=1, dtype=torch.float32, **kw)
    cpu16.load_state_dict(gpu.state_dict())
    cpu32.load_state_dict(gpu.state_dict())
    batch = _synthetic_sequence(10, 98, 182, seed=1)  # 96 tokens/frame, global 384
    ROUTE_COUNTS.clear()
    reset_launches()
    out_gpu, _ = ChunkedPipeline(gpu).run_sequence(batch, chunk_width=4, num_overlap=1)
    torch.cuda.synchronize()
    launched = read_launches()["fused_qkv_attention"]
    routes = dict(ROUTE_COUNTS)
    out16, _ = ChunkedPipeline(cpu16).run_sequence(batch, chunk_width=4, num_overlap=1)
    out32, _ = ChunkedPipeline(cpu32).run_sequence(batch, chunk_width=4, num_overlap=1)
    e_gpu = output_errors(out_gpu, out32)
    e_cpu = output_errors(out16, out32)
    print(f"[reference] small model dh 64, 3 chunks, rel-L2 against CPU fp32: "
          f"GPU bf16 (K1) {json.dumps({k: round(v, 5) for k, v in e_gpu.items()})}, "
          f"CPU bf16 {json.dumps({k: round(v, 5) for k, v in e_cpu.items()})} "
          f"(tol {REFERENCE_FACTOR} x CPU bf16 + 1e-3); K1 launches {launched}, routes {routes}")
    want = kw["depth"] * 3  # the global attentions (384 tokens) of 3 chunks
    if launched != want:
        raise AssertionError(f"reference: expected {want} K1 launches, got {launched}")
    bad = {k: v for k, v in e_gpu.items() if not v <= REFERENCE_FACTOR * e_cpu[k] + 1e-3}
    if bad:
        raise AssertionError(f"reference: GPU further from fp32 than bf16 allows: {bad}")


def _drive(model, batch, label: str, smi: str, width: int, overlap: int,
           encode_batch: int = 1, reps: int = 2):
    """Run one path `reps` times (the first warms up cuBLAS/cuDNN, the last
    is timed) with the launch counts set to 0 just before the timed run and
    read just after; returns (predictions, stats)."""
    import torch

    from vitslam_tpu_torch.ops import ROUTE_COUNTS
    from vitslam_tpu_torch.slam import ChunkedPipeline

    pipe = ChunkedPipeline(model, encode_batch=encode_batch)
    embed_launches = []
    embed = model.embed_frames

    def counted_embed(images):
        before = read_launches()["fused_qkv_attention"]
        out = embed(images)
        embed_launches.append(read_launches()["fused_qkv_attention"] - before)
        return out

    model.embed_frames = counted_embed
    try:
        for _ in range(reps):
            embed_launches.clear()
            ROUTE_COUNTS.clear()
            torch.cuda.synchronize()
            reset_launches()
            t = time.perf_counter()
            pred, _ = pipe.run_sequence(batch, chunk_width=width, num_overlap=overlap)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t
            launches = read_launches()
    finally:
        del model.embed_frames
    n_frames = batch["images"].shape[1]
    stats = dict(seconds=secs, fps=n_frames / secs, launches=launches,
                 embed=list(embed_launches), routes=dict(ROUTE_COUNTS))
    print(f"[{label}] {n_frames} frames in {secs:.3f} s = {n_frames / secs:.2f} new-frames/s "
          f"on {smi}; launches {launches} (K1 in embed_frames {embed_launches}); "
          f"routes {stats['routes']}")
    return pred, stats


def _check_outputs(label: str, outs: dict, shapes: dict):
    import torch

    for name, o in outs.items():
        for k, shape in shapes.items():
            if tuple(o[k].shape) != shape:
                raise AssertionError(f"{label} {name} {k}: shape {tuple(o[k].shape)} != {shape}")
        for k, v in o.items():
            if not torch.isfinite(v).all():
                raise AssertionError(f"{label} {name} {k}: non-finite values")


def _expect(label: str, got: dict, want: dict):
    """Launch counts of a path. K1 launches its prep kernel in the frame and
    global attentions (LayerNorm + RoPE), not in the patch embed."""
    if any(got[k] != v for k, v in want.items()):
        raise AssertionError(f"{label}: kernel launches {got} != {want}")


def _release():
    """Return the memory of the models and outputs the caller just dropped."""
    import torch

    gc.collect()
    torch.cuda.empty_cache()


def phase_slice(smi: str) -> tuple[dict, dict]:
    """The flagship 5/1 through both drivers; returns the runs' stats and
    the sequential run's predictions (the tail phase's reference)."""
    import torch

    from vitslam_tpu_torch.models import flagship

    t0 = time.perf_counter()
    model = flagship(device="cuda", seed=0)
    n_params = sum(p.numel() for p in model.parameters())
    torch.cuda.synchronize()
    print(f"[slice 5/1] flagship built on cuda: {n_params / 1e9:.3f}B params in "
          f"{time.perf_counter() - t0:.1f} s")
    n_frames, H, W = 17, 154, 518
    batch = _synthetic_sequence(n_frames, H, W, seed=0)
    outs, stats = {}, {}
    for label, eb in (("sequential", 1), ("encode_batch=4", 4)):
        outs[label], stats[label] = _drive(model, batch, f"slice 5/1 {label}", smi, 5, 1, eb)
    _check_outputs("slice 5/1", outs, {"pose_enc": (1, n_frames, 9),
                                       "depth": (1, n_frames, H, W, 1),
                                       "world_points": (1, n_frames, H, W, 3)})
    n_chunks = outs["sequential"]["chunk_sim3_enc"].shape[1]
    if n_chunks != 4:
        raise AssertionError(f"expected 4 chunks, got {n_chunks}")
    # 72 K1 launches per encode: 24 patch-embed + 24 frame + 24 global, the
    # last 48 with the prep
    none = {"flat_flash_attention": 0, "flash_attention": 0}
    _expect("slice 5/1 sequential", stats["sequential"]["launches"],
            dict(none, fused_qkv_attention=72 * n_chunks, qk_prep=48 * n_chunks))
    _expect("slice 5/1 encode_batch=4", stats["encode_batch=4"]["launches"],
            dict(none, fused_qkv_attention=72, qk_prep=48))
    if stats["encode_batch=4"]["embed"] != [24]:
        raise AssertionError(f"encode_batch=4: K1 in embed_frames {stats['encode_batch=4']} "
                             "!= [24] (24 in embed_frames + 48 in the encode)")
    errs = output_errors(outs["encode_batch=4"], outs["sequential"])
    print(f"[slice 5/1] drivers agree: rel-L2 "
          f"{json.dumps({k: round(v, 5) for k, v in errs.items()})} (tol {DRIVER_RTOL})")
    bad = {k: v for k, v in errs.items() if not v <= DRIVER_RTOL}
    if bad:
        raise AssertionError(f"slice 5/1: drivers disagree: {bad}")
    _check_async_fetch(model, batch, outs, stats, smi)
    sequential = outs["sequential"]
    del model, outs
    _release()
    return {f"slice 5/1 {label}": st for label, st in stats.items()}, sequential


def _blocking_fetch_run(model, batch: dict, width: int, overlap: int, encode_batch: int):
    """The driver's work with the fetch it had before: chunk by chunk,
    ChunkedPipeline.step (two-stage: the driver's stacked encode, then
    align_chunk), each chunk's outputs copied with .cpu() before the next
    chunk is queued; merged as run_sequence merges them."""
    import torch

    from vitslam_tpu_torch.slam import ChunkedPipeline
    from vitslam_tpu_torch.slam.chunking import chunk_batch, generate_chunks, merge_chunk_outputs

    pipe = ChunkedPipeline(model, encode_batch=encode_batch)
    indices = generate_chunks(batch["images"].shape[1], "chunk_overlap", width, overlap)
    chunks = chunk_batch(batch, indices)
    outs, state = [], None
    with torch.inference_mode():
        raws = pipe._encode_all(chunks, indices, batch["images"]) if encode_batch > 1 else None
        for i, chunk in enumerate(chunks):
            if raws is None:
                out, state = pipe.step(chunk["images"], overlap, state)
            else:
                out, state = model.align_chunk(raws[i], tuple(chunk["images"].shape), overlap,
                                               state)
            outs.append({k: v.cpu() for k, v in out.items()})
    return merge_chunk_outputs(outs, overlap)


def _host_syncs(fn) -> collections.Counter:
    """The host-device synchronisations ``fn()`` makes, by the port's
    call sites (innermost first), as torch's sync debug mode reports them."""
    import traceback
    import warnings

    import torch

    sites = collections.Counter()

    def show(message, category, filename, lineno, file=None, line=None):
        if "synchroniz" not in str(message):
            return
        stack = traceback.extract_stack()[:-1]
        ours = [f for f in stack if "vitslam_tpu_torch" in f.filename]
        frames = ours[-4:] if ours else stack[-3:]
        sites[" <- ".join(f"{Path(f.filename).name}:{f.lineno}" for f in reversed(frames))] += 1

    # the hook goes in after the mode is set: setting it may warn that the
    # mode is experimental, which is no sync
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings():  # restores showwarning on exit
            warnings.simplefilter("always")
            warnings.showwarning = show
            fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return sites


def _check_async_fetch(model, batch: dict, outs: dict, stats: dict, smi: str):
    """Both drivers, which fetch each chunk's outputs one chunk behind on a
    side stream, bit-equal to the same work with a blocking .cpu() after
    every chunk; one torch.profiler window of each for the device's idle
    share; and the host syncs left inside the sequential driver's chunks."""
    import shutil
    import tempfile

    from vitslam_tpu_torch.profile_slice import profile_run
    from vitslam_tpu_torch.slam import ChunkedPipeline

    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_profile_"))
    try:
        for label, eb in (("sequential", 1), ("encode_batch=4", 4)):
            ref = _blocking_fetch_run(model, batch, 5, 1, eb)
            equal = {k: _same_tensor(outs[label][k], ref[k]) for k in ref}
            if not all(equal.values()) or set(ref) != set(outs[label]):
                raise AssertionError(f"slice 5/1 {label}: the one-behind fetch differs from the "
                                     f"blocking fetch: {equal}")
            pipe = ChunkedPipeline(model, encode_batch=eb)
            prof = profile_run(lambda: pipe.run_sequence(batch, chunk_width=5, num_overlap=1),
                               tmp, label.replace("=", ""))
            unprofiled = stats[label]["seconds"]
            idle = 1.0 - prof["busy_s"] / unprofiled
            stats[label].update(idle_share=idle, profiled=prof)
            print(f"[slice 5/1 {label}] one-behind fetch bit-equal to step + .cpu() per chunk "
                  f"({len(ref)} outputs); {stats[label]['fps']:.2f} new-frames/s; profiler "
                  f"window: {prof['kernels']} kernels, device busy {prof['busy_s'] * 1e3:.1f} ms "
                  f"of {prof['wall_s'] * 1e3:.1f} ms profiled wall (idle "
                  f"{prof['idle_share']:.1%}), of the unprofiled run's {unprofiled * 1e3:.1f} ms: "
                  f"idle share {idle:.1%}; on {smi}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    pipe = ChunkedPipeline(model)
    sites = _host_syncs(lambda: pipe.run_sequence(batch, chunk_width=5, num_overlap=1))
    n_chunks = outs["sequential"]["chunk_sim3_enc"].shape[1]
    stats["sequential"]["host_syncs"] = dict(sites)
    print(f"[slice 5/1 sequential] host syncs in a {n_chunks}-chunk run (torch sync debug "
          f"mode): {sum(sites.values())}" + "".join(f"\n    {n:4d}  {site}"
                                                   for site, n in sites.most_common()))


def _same_tensor(a, b) -> bool:
    import torch

    return a.shape == b.shape and a.dtype == b.dtype and bool(torch.equal(a, b))


# The reference's checkpoint format, written here because the machine with
# the card has neither flax nor msgpack: the inverse of the port's reader
# (io/flax_msgpack.py) and of its layout half (io/from_jax.py). A port
# parameter name goes back to the flax variable path: a leading "params",
# "kernel" (Dense (in, out), Conv (kh, kw, in, out)) or LayerNorm "scale"
# for "weight", the patch embed's scanned "blocks.<i>." as
# "blocks/block", and per-layer entries of a "layers" / "blocks" scan
# stacked on a leading depth axis.
_SCAN = re.compile(r"^(.*\.(?:layers|blocks))\.(\d+)\.(.*)$")
MAX_LEAF_BYTES = 2 ** 30  # flax's MAX_CHUNK_SIZE: larger leaves it splits


def flax_tree(model) -> dict:
    """The reference's variable tree ({"params": ...}, numpy leaves on the
    host) holding ``model``'s parameters."""
    stacks, flat = {}, {}
    for name, p in model.named_parameters():
        x = p.detach().cpu().numpy()
        head, _, leaf = name.rpartition(".")
        if leaf == "weight":
            leaf = "kernel" if x.ndim in (2, 4) else "scale"
            x = x.T if x.ndim == 2 else (np.transpose(x, (2, 3, 1, 0)) if x.ndim == 4 else x)
        path = f"params.{head}.{leaf}" if head else f"params.{leaf}"
        m = _SCAN.match(path)
        if m:
            prefix, i, rest = m.groups()
            if prefix.endswith(".blocks"):
                rest = f"block.{rest}"
            stacks.setdefault(f"{prefix}.{rest}", {})[int(i)] = x
        else:
            flat[path] = x
    for key, layers in stacks.items():
        flat[key] = np.stack([layers[i] for i in range(len(layers))])
    tree: dict = {}
    for key, x in flat.items():
        *parents, leaf = key.split(".")
        node = tree
        for k in parents:
            node = node.setdefault(k, {})
        # (np.ascontiguousarray would make a 0-d leaf 1-d)
        node[leaf] = x if x.flags.c_contiguous else x.copy(order="C")
    return tree


def _pack_len(f, n: int, small: int, codes) -> None:
    """A msgpack header: the fix form below ``small`` or the 8/16/32-bit one."""
    if small and n < small:
        f.write(bytes([codes[0] | n]))
        return
    for code, fmt, limit in zip(codes[1:], (">B", ">H", ">I"), (2 ** 8, 2 ** 16, 2 ** 32)):
        if code is not None and n < limit:
            f.write(bytes([code]) + struct.pack(fmt, n))
            return
    raise ValueError(f"msgpack length {n} too large")


def _pack_str(f, text: str) -> None:
    data = text.encode()
    _pack_len(f, len(data), 32, (0xa0, 0xd9, 0xda, 0xdb))
    f.write(data)


def _pack_uint(n: int) -> bytes:
    if n < 128:
        return bytes([n])
    for code, fmt, limit in ((0xcc, ">B", 2 ** 8), (0xcd, ">H", 2 ** 16),
                             (0xce, ">I", 2 ** 32), (0xcf, ">Q", 2 ** 64)):
        if n < limit:
            return bytes([code]) + struct.pack(fmt, n)
    raise ValueError(n)


def _pack_tree(f, node) -> None:
    if isinstance(node, dict):
        _pack_len(f, len(node), 16, (0x80, None, 0xde, 0xdf))
        for key, value in node.items():
            _pack_str(f, key)
            _pack_tree(f, value)
        return
    x = node
    if x.nbytes > MAX_LEAF_BYTES:
        raise ValueError(f"a leaf of {x.nbytes} bytes: flax would write it in chunks")
    # ext 1: msgpack (shape, dtype name, C-order bytes)
    shape = bytes([0x90 | x.ndim]) if x.ndim < 16 else bytes([0xdc]) + struct.pack(">H", x.ndim)
    shape += b"".join(_pack_uint(d) for d in x.shape)
    name = x.dtype.name.encode()
    inner = bytearray(b"\x93" + shape + bytes([0xa0 | len(name)]) + name)
    with io.BytesIO() as b:
        _pack_len(b, x.nbytes, 0, (None, 0xc4, 0xc5, 0xc6))
        inner += b.getvalue()
    n = len(inner) + x.nbytes
    fixext = {1: 0xd4, 2: 0xd5, 4: 0xd6, 8: 0xd7, 16: 0xd8}
    if n in fixext:
        f.write(bytes([fixext[n], 1]))
    else:
        _pack_len(f, n, 0, (None, 0xc7, 0xc8, 0xc9))
        f.write(b"\x01")
    f.write(inner)
    f.write(x.reshape(-1).view(np.uint8).data)


def write_flax_checkpoint(path: str, tree: dict) -> int:
    """Write ``tree`` (nested dicts of numpy arrays) as the reference's
    ``save_checkpoint`` does (``flax.serialization.to_bytes``); returns
    the file's size."""
    with open(path, "wb") as f:
        _pack_tree(f, tree)
        return f.tell()


def phase_checkpoints(smi: str, seeded_run: dict) -> dict:
    """The reference's checkpoint format on the card: the flagship's
    AlignmentHead (model_checkpoint_path) and the whole flagship under
    "model" (from_pretrained), written in flax's format from phase 5's
    seeded weights, loaded through load_model_params into a flagship seeded
    otherwise: every parameter bit-equal, and its 5/1 sequential run
    bit-equal to phase 5's."""
    import shutil
    import tempfile

    import torch

    from vitslam_tpu_torch.io.checkpoint import load_model_params
    from vitslam_tpu_torch.models import flagship

    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_ckpt_"))
    head_path, base_path = str(tmp / "head.ckpt"), str(tmp / "base.ckpt")
    try:
        model = flagship(device="cuda", seed=0)
        t = time.perf_counter()
        tree = flax_tree(model)
        sizes = (write_flax_checkpoint(head_path, {"params": {
            "alignment_head": tree["params"]["alignment_head"]}}),
                 write_flax_checkpoint(base_path, {"model": tree}))
        write_s = time.perf_counter() - t
        del tree
        target = flagship(device="cuda", seed=1)
        torch.cuda.synchronize()
        t = time.perf_counter()
        missing = load_model_params(head_path, target, fallback_path=base_path)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    want = dict(model.named_parameters())
    differ = [n for n, p in target.named_parameters() if not _same_tensor(p, want[n])]
    n_params = sum(p.numel() for p in want.values())
    print(f"[checkpoints] reference-format files: head {sizes[0] / 2**20:.1f} MiB, whole "
          f"flagship {sizes[1] / 2**30:.3f} GiB ({n_params / 1e9:.3f}B fp32 params), "
          f"written in {write_s:.1f} s (host tree + msgpack); load_model_params "
          f"(head over the whole-model fallback) onto the card in {load_s:.1f} s; "
          f"{len(want) - len(differ)} of {len(want)} parameters bit-equal to the seeded ones, "
          f"unfilled {missing}")
    if missing or differ:
        raise AssertionError(f"checkpoints: unfilled {missing[:5]}, differing {differ[:5]}")
    del model, want
    _release()
    n_frames, H, W = 17, 154, 518
    pred, stats = _drive(target, _synthetic_sequence(n_frames, H, W, seed=0),
                         "checkpoints 5/1 sequential", smi, 5, 1)
    equal = {k: _same_tensor(pred[k], seeded_run[k]) for k in seeded_run}
    print(f"[checkpoints] 5/1 sequential run of the loaded flagship vs phase 5's seeded one: "
          f"bit-equal {equal}")
    if not all(equal.values()) or set(pred) != set(seeded_run):
        raise AssertionError(f"checkpoints: the loaded model's run differs: {equal}")
    del target, pred
    _release()
    stats.update(write_s=write_s, load_s=load_s, file_bytes=list(sizes))
    return {"checkpoints 5/1 sequential": stats}


def phase_merge(smi: str) -> dict:
    """The flagship 5/1 with the KV merge at pool 2 / stride 2: 1,474 keys,
    so every global attention goes to K3 (fixed shift) and none to K1."""
    from vitslam_tpu_torch.models import flagship

    model = flagship(device="cuda", seed=0, global_merge_pool=2, global_merge_stride=2)
    n_frames, H, W = 17, 154, 518
    batch = _synthetic_sequence(n_frames, H, W, seed=0)
    pred, stats = _drive(model, batch, "merge 5/1 p2s2 sequential", smi, 5, 1)
    _check_outputs("merge 5/1", {"sequential": pred}, {"pose_enc": (1, n_frames, 9),
                                                       "world_points": (1, n_frames, H, W, 3)})
    n_chunks = pred["chunk_sim3_enc"].shape[1]
    _expect("merge 5/1", stats["launches"], {"fused_qkv_attention": 48 * n_chunks,
                                             "qk_prep": 24 * n_chunks,
                                             "flash_attention": 24 * n_chunks,
                                             "flat_flash_attention": 0})
    del model, pred
    _release()
    return {"merge 5/1 p2s2 sequential": stats}


def phase_large_chunk(smi: str) -> tuple[dict, dict]:
    """Point- and pose-aligned flagship presets at chunk 75 / overlap 30 over
    165 synthetic frames (3 chunks), then one merged chunk at p4s10.
    Returns the runs' stats and the point-aligned sequential predictions
    (the int8 phase's reference)."""
    import torch

    import vitslam_tpu_torch.nn.layers as layers
    from vitslam_tpu_torch.models import flagship_point_aligned, flagship_pose_aligned

    n_frames, H, W, width, overlap = 165, 154, 518, 75, 30
    batch = _synthetic_sequence(n_frames, H, W, seed=2)
    stats = {}
    none = {"flash_attention": 0}

    model = flagship_point_aligned(device="cuda", seed=0)
    torch.cuda.reset_peak_memory_stats()
    seq, stats["point sequential"] = _drive(model, batch, "slice 75/30 point sequential",
                                            smi, width, overlap)
    peak = torch.cuda.max_memory_allocated() / 2**30
    bat, stats["point encode_batch=2"] = _drive(model, batch, "slice 75/30 point encode_batch=2",
                                                smi, width, overlap, encode_batch=2)
    print(f"[slice 75/30] point sequential peak device memory {peak:.2f} GiB")
    shapes = {"pose_enc": (1, n_frames, 9), "world_points": (1, n_frames, H, W, 3),
              "world_points_conf": (1, n_frames, H, W)}
    _check_outputs("slice 75/30 point", {"sequential": seq, "encode_batch=2": bat}, shapes)
    # per chunk: K1 24 patch-embed + 24 frame (B=75, 412 tokens), K2 24 global
    _expect("slice 75/30 point sequential", stats["point sequential"]["launches"],
            dict(none, fused_qkv_attention=48 * 3, qk_prep=24 * 3, flat_flash_attention=24 * 3))
    # encode_batch=2: chunks 0+1 share 30 frames, so 120 unique frames are
    # embedded once (24 K1), then their frame attention (24 K1) and global
    # attention (24 K2, B=2); chunk 2 alone is encoded in full (48 K1, 24 K2)
    _expect("slice 75/30 point encode_batch=2", stats["point encode_batch=2"]["launches"],
            dict(none, fused_qkv_attention=24 + 24 + 48, qk_prep=24 + 24,
                 flat_flash_attention=48))
    if stats["point encode_batch=2"]["embed"] != [24]:
        raise AssertionError(f"point encode_batch=2: K1 in embed_frames "
                             f"{stats['point encode_batch=2']['embed']} != [24]")
    errs = output_errors(bat, seq, ("pose_enc", "world_points"))
    print(f"[slice 75/30] point drivers agree: rel-L2 "
          f"{json.dumps({k: round(v, 5) for k, v in errs.items()})} (tol {DRIVER_RTOL})")
    bad = {k: v for k, v in errs.items() if not v <= DRIVER_RTOL}
    if bad:
        raise AssertionError(f"slice 75/30 point: drivers disagree: {bad}")
    del model, bat
    _release()

    model = flagship_pose_aligned(device="cuda", seed=0)
    pred, stats["pose sequential"] = _drive(model, batch, "slice 75/30 pose sequential",
                                            smi, width, overlap)
    _check_outputs("slice 75/30 pose", {"sequential": pred},
                   {"pose_enc": (1, n_frames, 9), "depth": (1, n_frames, H, W, 1)})
    _expect("slice 75/30 pose sequential", stats["pose sequential"]["launches"],
            dict(none, fused_qkv_attention=48 * 3, qk_prep=24 * 3, flat_flash_attention=24 * 3))
    del model, pred
    _release()

    # one 75-frame chunk with the KV merge at pool 4 / stride 10: 8 anchor
    # frames x 412 + 67 frames x (5 specials + 3 x 10 pooled) = 5,641 keys
    model = flagship_point_aligned(device="cuda", seed=0, global_merge_pool=4,
                                   global_merge_stride=10)
    shapes_seen = []
    real_k2 = layers.flat_flash_attention

    def recorded(q, k, v, **kw):
        shapes_seen.append((q.shape[1], k.shape[1]))
        return real_k2(q, k, v, **kw)

    layers.flat_flash_attention = recorded
    try:
        one = {"images": batch["images"][:, :width]}
        pred, stats["point merged p4s10 one chunk"] = _drive(
            model, one, "merge 75/30 p4s10 one chunk", smi, width, overlap, reps=1)
    finally:
        layers.flat_flash_attention = real_k2
    _check_outputs("merge 75/30", {"one chunk": pred}, {"world_points": (1, width, H, W, 3)})
    _expect("merge 75/30", stats["point merged p4s10 one chunk"]["launches"],
            dict(none, fused_qkv_attention=48, qk_prep=24, flat_flash_attention=24))
    if set(shapes_seen) != {(30900, 5641)}:
        raise AssertionError(f"merge 75/30: K2 (Nq, Nk) {set(shapes_seen)} != {{(30900, 5641)}}")
    print("[merge 75/30] K2 ran 24 times with Nq=30900 over Nk=5641")
    del model, pred
    _release()
    return {f"slice 75/30 {label}": st for label, st in stats.items()}, seq


def phase_global_head(smi: str) -> dict:
    """flagship(temporal_attention=False): the AlignmentHead's global
    attention (8 heads of 128) runs K3 in inference; one chunk's alignment
    stage on K3 against the same stage on plain attention."""
    from vitslam_tpu_torch.models import flagship
    from vitslam_tpu_torch.ops import plain_attention_routes

    model = flagship(device="cuda", seed=0, temporal_attention=False)
    n_frames, H, W = 9, 154, 518
    batch = _synthetic_sequence(n_frames, H, W, seed=4)
    pred, stats = _drive(model, batch, "global head 5/1", smi, 5, 1, reps=1)
    _check_outputs("global head 5/1", {"sequential": pred},
                   {"pose_enc": (1, n_frames, 9), "chunk_sim3_enc": (1, 2, 8)})
    # per chunk: 72 K1 in the backbone, 4 K3 in the head's global blocks
    # (2,065 keys in chunk 1, (5 + 2) x 413 = 2,891 in chunk 2)
    _expect("global head 5/1", stats["launches"], {"fused_qkv_attention": 144, "qk_prep": 96,
                                                   "flash_attention": 8,
                                                   "flat_flash_attention": 0})
    import torch

    images = torch.as_tensor(batch["images"][:, :5], device=next(model.parameters()).device)
    with torch.inference_mode():
        raw = model.encode_chunks(images)
        got, _ = model.align_chunk(raw, images.shape, 1)
        with plain_attention_routes():
            want, _ = model.align_chunk(raw, images.shape, 1)
    keys = ("chunk_sim3_enc", "frame_se3_enc", "pose_enc", "memory_tokens")
    errs = output_errors({k: got[k].float().cpu() for k in keys},
                         {k: want[k].float().cpu() for k in keys}, keys)
    print(f"[global head 5/1] alignment stage, K3 (D 128) vs plain attention: rel-L2 "
          f"{json.dumps({k: round(v, 5) for k, v in errs.items()})} (tol {DRIVER_RTOL})")
    bad = {k: v for k, v in errs.items() if not v <= DRIVER_RTOL}
    if bad:
        raise AssertionError(f"global head: K3 path and plain path disagree: {bad}")
    del model, pred, raw
    _release()
    return {"global head 5/1 sequential": stats}


def _train(smi: str, label: str, temporal: bool, bucket, batch: dict, steps: int = 3):
    """Trainer.fit for `steps` steps at one (width, overlap) bucket; checks
    finite losses, moved trainable and bit-identical frozen tensors."""
    import shutil
    import tempfile

    import torch

    from vitslam_tpu_torch.head_grad_check import head_trainer
    from vitslam_tpu_torch.models import flagship
    from vitslam_tpu_torch.ops import ROUTE_COUNTS
    from vitslam_tpu_torch.train import partition_params

    # the training config (configs/train_featureAlignedVGGT_vkitti.yaml,
    # copied as VKITTI_TRAIN_CFG) runs the model without its point head
    model = flagship(device="cuda", seed=0, enable_point=False, temporal_attention=temporal)
    n_params = sum(p.numel() for p in model.parameters())
    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_")
    trainer = head_trainer(model, batch, bucket, steps, tmp)
    trainable, frozen = partition_params(model, trainer.cfg["optim"]["frozen_module_names"])
    before_t = {n: p.detach().clone() for n, p in trainable.items()}
    before_f = {n: p.detach().clone() for n, p in frozen.items()}
    steps_seen = []
    log = trainer.logger.log_metrics

    def logged(metrics, step):  # called once per step, after its float() readback
        steps_seen.append((time.perf_counter(), dict(metrics)))
        log(metrics, step)

    trainer.logger.log_metrics = logged
    try:
        ROUTE_COUNTS.clear()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.perf_counter()
        state = trainer.fit()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = read_launches()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    n_frames = batch["images"].shape[1]
    times = np.diff([t0] + [t for t, _ in steps_seen])
    print(f"[{label}] {n_params / 1e9:.3f}B params ({sum(p.numel() for p in trainable.values()) / 1e6:.1f}M "
          f"trainable), bucket {tuple(bucket)}, {steps} steps in {secs:.3f} s = "
          f"{steps / secs:.3f} steps/s, {steps * n_frames / secs:.2f} frames/s "
          f"({n_frames}-frame batch; step walls {[round(float(t), 3) for t in times]} s), "
          f"peak device memory {peak:.2f} GiB, on {smi}; launches {launches}; "
          f"routes {dict(ROUTE_COUNTS)}")
    keys = ("objective", "loss_camera", "loss_camera_rel", "loss_depth", "loss_per_frame_reg",
            "loss_per_chunk_reg", "grad_norm", "train/lr")
    for i, (_, m) in enumerate(steps_seen):
        print(f"[{label}] step {i}: " + " ".join(f"{k}={m[k]:.6g}" for k in keys))
    if len(steps_seen) != steps or state.step != steps:
        raise AssertionError(f"{label}: {len(steps_seen)} logged steps, state at {state.step}")
    bad = [k for _, m in steps_seen for k, v in m.items() if not np.isfinite(v)]
    if bad:
        raise AssertionError(f"{label}: non-finite metrics {sorted(set(bad))}")
    moved = sum(not torch.equal(p.detach(), before_t[n]) for n, p in trainable.items())
    changed = [n for n, p in frozen.items() if not torch.equal(p.detach(), before_f[n])]
    print(f"[{label}] {moved} of {len(trainable)} trainable tensors moved; "
          f"{len(frozen) - len(changed)} of {len(frozen)} frozen tensors bit-identical")
    if moved == 0 or changed:
        raise AssertionError(f"{label}: {moved} trainable tensors moved, frozen changed: "
                             f"{changed[:5]}")
    del before_t, before_f
    stats = dict(seconds=secs, steps_per_s=steps / secs, frames_per_s=steps * n_frames / secs,
                 step_seconds=[float(t) for t in times], peak_gib=peak, launches=launches,
                 routes=dict(ROUTE_COUNTS),
                 losses=[{k: m[k] for k in keys} for _, m in steps_seen])
    return model, trainer, stats


def phase_train(smi: str) -> dict:
    """The training slice at full flagship width: the shipped temporal head
    (no kernel in its backward: every head attention has < 512 keys), then
    the global head, whose global attention runs K3 with lse and K4."""
    from vitslam_tpu_torch.head_grad_check import head_grad_errors
    from vitslam_tpu_torch.utils import make_synthetic_batch

    batch = make_synthetic_batch(B=1, N=40, H=154, W=518, seed=3)
    runs = {}
    model, trainer, runs["train temporal (10, 2)"] = _train(
        smi, "train temporal (10, 2)", True, (10, 2), batch)
    _expect("train temporal (10, 2)", runs["train temporal (10, 2)"]["launches"],
            {"flash_attention_lse": 0, "flash_attention_backward": 0, "flash_attention": 0})
    del model, trainer
    _release()

    label = "train global (20, 5)"
    model, trainer, runs[label] = _train(smi, label, False, (20, 5), batch)
    # per step 3 chunks (20, 20, 10 frames) x 4 global blocks: K3 with lse
    # over 8,260 / 10,738 / 6,608 tokens, twice (the head's blocks are
    # recomputed in the backward: 24 a step), and 12 K4 calls
    _expect(label, runs[label]["launches"],
            {"flash_attention_lse": 3 * 24, "flash_attention_backward": 3 * 12})

    # one step's head gradients, kernels vs plain attention, same dropout
    # and large offset (vitslam_tpu_torch.head_grad_check, per seed)
    res = head_grad_errors(trainer, batch, (20, 5))
    if res["k4_calls"] != (12, 0):
        raise AssertionError(f"{label}: K4 calls kernel path, plain path {res['k4_calls']} "
                             "(12, 0)")
    worst = list(res["errs"].items())[:5]
    obj = res["objective"]
    print(f"[{label}] head gradients, kernels vs plain attention: {len(res['errs'])} tensors, "
          f"max rel-L2 {worst[0][1]:.3e} (tol {GRAD_RTOL}); worst {worst}; "
          f"objective {obj[0]:.6g} vs {obj[1]:.6g}")
    if not worst[0][1] <= GRAD_RTOL:
        raise AssertionError(f"{label}: head gradients disagree: {worst}")
    runs[label]["grad_rel_l2_max"] = worst[0][1]
    del model, trainer, res
    _release()
    return runs


def phase_tail(smi: str, tails_off: dict, off_stats: dict):
    """flagship(mlp_tail="both") over the 17-frame 5/1 sequence, sequential
    driver: all 72 backbone blocks of a chunk (2,060 rows each) take both
    fused tails, 144 K5 launches a chunk. The two bf16 runs of the same
    seed, tails on and off (slice 5/1 sequential), differ by bf16 rounding
    amplified through 72 random-weight blocks, and by the tails' own math
    (the LayerNorm's centered variance against ln_apply's E[x^2] - E[x]^2,
    LayerScale folded into the weight). So each is held against an fp32
    run of its own math with the same weights (plain attention; the tails
    through K5's plain version): the K5 path may be no further from its
    fp32 run than REFERENCE_FACTOR times the tails-off run's own bf16
    error, plus 1e-3, as the reference phase holds the GPU. Returns the
    model (the eval phase runs it) and the run's stats."""
    import torch

    import vitslam_tpu_torch.nn.layers as layers
    from vitslam_tpu_torch.models import flagship
    from vitslam_tpu_torch.ops import mlp_tail_plain, plain_attention_routes
    from vitslam_tpu_torch.slam import ChunkedPipeline

    model = flagship(device="cuda", seed=0, mlp_tail="both")
    n_frames, H, W = 17, 154, 518
    batch = _synthetic_sequence(n_frames, H, W, seed=0)
    pred, stats = _drive(model, batch, "tail 5/1 sequential", smi, 5, 1)
    _check_outputs("tail 5/1", {"sequential": pred}, {"pose_enc": (1, n_frames, 9),
                                                      "depth": (1, n_frames, H, W, 1),
                                                      "world_points": (1, n_frames, H, W, 3)})
    n_chunks = pred["chunk_sim3_enc"].shape[1]
    _expect("tail 5/1", stats["launches"], {"mlp_tail": 144 * n_chunks,
                                            "fused_qkv_attention": 72 * n_chunks,
                                            "qk_prep": 48 * n_chunks,
                                            "flat_flash_attention": 0, "flash_attention": 0})
    fp32 = {}
    real = layers.mlp_tail
    layers.mlp_tail = mlp_tail_plain  # fp32 CUDA tensors: K5's math without the kernel
    try:
        with plain_attention_routes():
            for tail in ("off", "both"):
                ref = flagship(device="cuda", seed=0, dtype=torch.float32, mlp_tail=tail)
                fp32[tail], _ = ChunkedPipeline(ref).run_sequence(batch, chunk_width=5,
                                                                  num_overlap=1)
                del ref
    finally:
        layers.mlp_tail = real
    e_on, e_off = output_errors(pred, fp32["both"]), output_errors(tails_off, fp32["off"])
    errs = output_errors(pred, tails_off)
    gap = output_errors(fp32["both"], fp32["off"])
    rnd = lambda e: json.dumps({k: round(v, 5) for k, v in e.items()})  # noqa: E731
    print(f"[tail 5/1] rel-L2 against fp32 of the same math: tails on {rnd(e_on)}, tails off "
          f"{rnd(e_off)} (tol {REFERENCE_FACTOR} x off + 1e-3); bf16 on vs off {rnd(errs)}; "
          f"fp32 on vs off {rnd(gap)}; {stats['fps']:.2f} (on) vs {off_stats['fps']:.2f} (off) "
          "new-frames/s")
    bad = {k: v for k, v in e_on.items() if not v <= REFERENCE_FACTOR * e_off[k] + 1e-3}
    if bad:
        raise AssertionError(f"tail 5/1: the K5 path is further from its fp32 math than bf16 "
                             f"allows: {bad}")
    stats.update(rel_l2_on_vs_off=errs, rel_l2_on_vs_fp32=e_on, rel_l2_off_vs_fp32=e_off,
                 rel_l2_fp32_on_vs_off=gap)
    del pred, fp32
    _release()
    return model, {"tail 5/1 sequential": stats}


def phase_tail_large(smi: str, off_stats: dict) -> dict:
    """flagship_point_aligned(mlp_tail="both") over the 165-frame sequence
    at chunk 75 / overlap 30, sequential driver: every backbone block's two
    residual tails through K5 at 30,900 rows, 144 launches a chunk. Checked
    for finite outputs of the slice's shapes and the launch counts; no
    numeric gate (the tails' bf16 spread is an open question, ROADMAP S1).
    Prints its rate beside the tails-off point run of slice 75/30."""
    from vitslam_tpu_torch.models import flagship_point_aligned

    n_frames, H, W, width, overlap = 165, 154, 518, 75, 30
    batch = _synthetic_sequence(n_frames, H, W, seed=2)
    model = flagship_point_aligned(device="cuda", seed=0, mlp_tail="both")
    pred, stats = _drive(model, batch, "tail 75/30 point sequential", smi, width, overlap)
    _check_outputs("tail 75/30", {"sequential": pred},
                   {"pose_enc": (1, n_frames, 9), "world_points": (1, n_frames, H, W, 3),
                    "world_points_conf": (1, n_frames, H, W)})
    _expect("tail 75/30", stats["launches"], {"mlp_tail": 144 * 3, "fused_qkv_attention": 48 * 3,
                                              "qk_prep": 24 * 3, "flat_flash_attention": 24 * 3,
                                              "flash_attention": 0})
    print(f"[tail 75/30] {stats['fps']:.2f} (tails on) vs {off_stats['fps']:.2f} (off) "
          "new-frames/s")
    del model, pred
    _release()
    return {"tail 75/30 point sequential": stats}


def _sequence_dataset(n_frames: int, H: int, W: int, seed: int):
    """A one-sequence BaseDataset serving the port's synthetic GT batch
    (images, cameras, depths, world points, masks) in the readers' per-frame
    layout: the machine with the card has no OpenCV to read files."""
    from vitslam_tpu_torch.data import BaseDataset, CommonConfig
    from vitslam_tpu_torch.utils import make_synthetic_batch

    class SyntheticSequence(BaseDataset):
        def __init__(self):
            super().__init__(CommonConfig(img_size=W, training=False))
            self.frames = {k: v[0] for k, v in make_synthetic_batch(
                B=1, N=n_frames, H=H, W=W, seed=seed).items()}
            self.frames["cam_points"] = np.zeros_like(self.frames["world_points"])
            self.sequence_list = ["synthetic"]
            self.sequence_list_len = 1
            self.seq_frame_num = [n_frames]

        def get_seq_name(self, seq_index):
            return self.sequence_list[seq_index]

        def get_data(self, seq_index=None, img_per_seq=None, seq_name=None, ids=None,
                     aspect_ratio=1.0, rng=None):
            ids = np.arange(n_frames) if ids is None else np.asarray(ids)
            out = {k: v[ids] for k, v in self.frames.items()}
            return dict(out, seq_name=self.get_seq_name(seq_index), ids=ids,
                        frame_num=len(ids))

    return SyntheticSequence()


def _metrics(**overrides):
    """The test mode's Metrics with the metric keys of
    configs/test_featureAlignedVGGT_vkitti.yaml (PyYAML is not on the
    machine with the card: the keys are copied)."""
    from vitslam_tpu_torch.config.loader import instantiate

    node = {"_target_": "vitslam_tpu.eval.orchestrator.Metrics", "mode": "test",
            "overlap": [1, 1], "chunk_width": [5, 5], "full_seq_sample_mode": "chunk_overlap",
            "gt_alignment_type": "scale_from_poses", "use_random_sequences": False,
            "trajectory_metrics": [
                {"_target_": "vitslam_tpu.eval.trajectory.AbsoluteTrajectoryError"},
                {"_target_": "vitslam_tpu.eval.trajectory.RelativePoseError"}],
            "reconstruction_metrics": [
                {"_target_": "vitslam_tpu.eval.reconstruction.ChamferDistanceMetrics"}],
            "visualize": False, "log_dir": None}
    return instantiate(dict(node, **overrides))


def phase_eval(smi: str, model) -> dict:
    """Metrics.compute_full_sequence_metrics with the tail model on the
    card: the chunk pipeline with scale_from_poses, then ATE, RPE and
    Chamfer after ICP at the shipped cap of 500,000 points, all on the
    card; the eval's time split into inference, kNN + ICP and the rest.
    Then one set of predictions, registered onto the GT points
    (sim3_from_points, so that ICP starts well posed), scored on the card
    and on the CPU at an ICP cap of 20,000 (the CPU's kNN would take
    minutes at the full cap), the two held to each other."""
    import torch

    from vitslam_tpu_torch.eval import get_sequence_data, icp, reconstruction
    from vitslam_tpu_torch.slam import ChunkedPipeline

    n_frames, H, W = 17, 154, 518
    ds = _sequence_dataset(n_frames, H, W, seed=5)
    metrics = _metrics()
    if metrics.max_points_for_icp_full_seq != 500000:
        raise AssertionError("eval: the shipped ICP cap of the full-sequence eval is 500,000")
    pipe = ChunkedPipeline(model)
    times = {"inference": 0.0, "knn_icp": 0.0}

    def timed(key, fn):
        def run(*a, **k):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            times[key] += time.perf_counter() - t
            return out
        return run

    real = (metrics.run_sequence, icp.nn_search, reconstruction.nn_dists)
    metrics.run_sequence = timed("inference", metrics.run_sequence)
    icp.nn_search = timed("knn_icp", icp.nn_search)
    reconstruction.nn_dists = timed("knn_icp", reconstruction.nn_dists)
    try:
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = metrics.compute_full_sequence_metrics([ds], pipe)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = read_launches()
    finally:
        metrics.run_sequence, icp.nn_search, reconstruction.nn_dists = real
    rest = secs - times["inference"] - times["knn_icp"]
    print(f"[eval] {json.dumps(res)}")
    print(f"[eval] compute_full_sequence_metrics {secs:.3f} s on {smi}: inference "
          f"{times['inference']:.3f} s, kNN + ICP {times['knn_icp']:.3f} s, rest {rest:.3f} s; "
          f"launches {launches}")
    keys = ("ate_rmse", "rpe_trans_rmse", "rpe_rot_rmse", "chamfer_distance_rmse",
            "accuracy_rmse", "completion_rmse")
    prefix = "SyntheticSequence_synthetic/"
    if not all(np.isfinite(res.get(prefix + k, np.nan)) for k in keys):
        raise AssertionError(f"eval: missing or non-finite metrics in {res}")
    _expect("eval", launches, {"mlp_tail": 144 * 4})

    check = _metrics(gt_alignment_type="sim3_from_points", max_points_for_icp_full_seq=20000)
    seq = get_sequence_data(ds, 0, "synthetic", n_frames)
    preds = check.run_sequence(seq, pipe)
    torch.cuda.synchronize()
    t = time.perf_counter()
    card = check.sequence_metrics(preds, seq, device=torch.device("cuda"))
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t
    t = time.perf_counter()
    cpu = check.sequence_metrics(preds, seq, device=torch.device("cpu"))
    cpu_s = time.perf_counter() - t
    errs = {k: abs(card[k] - cpu[k]) / max(abs(cpu[k]), 1e-12) for k in cpu}
    print(f"[eval] registered predictions, ICP cap 20,000: card {json.dumps(card)} in "
          f"{card_s:.3f} s, CPU {cpu_s:.3f} s; max rel difference {max(errs.values()):.2e} "
          f"(tol {EVAL_RTOL})")
    bad = {k: v for k, v in errs.items() if not v <= EVAL_RTOL or not np.isfinite(card[k])}
    if card.keys() != cpu.keys() or bad:
        raise AssertionError(f"eval: the card and the CPU disagree: {bad}")
    return {"eval": dict(seconds=secs, inference_s=times["inference"],
                         knn_icp_s=times["knn_icp"], rest_s=rest, launches=launches,
                         metrics=res, check_card=card, check_cpu=cpu,
                         check_max_rel=max(errs.values()))}


# the distributed phase: gloo gangs of processes sharing the one card (NCCL
# refuses two ranks on one GPU; every kernel still runs on it): DIST_RANKS
# for the sequence-parallel encode and chunk-parallel serving, and
# DP_RANKS for the data-parallel train step, whose ranks each take ~25 GiB
# (the frozen backbone's encode and the global-mode head at one sample a
# rank): three of them do not fit in the card's 80 GB
DIST_RANKS = 3
DP_RANKS = 2
# gang vs one process on the same card doing the same work at the ranks'
# per-chunk shapes (bf16 results depend on the batch shape: cuBLAS and
# cuDNN pick other algorithms): relative L2 error per output, and for the
# train step the objective to 1e-3 relative, the gradient norm to 1e-2 and
# each trainable tensor's gradient to GRAD_RTOL; where the reference stacks
# chunks (encode_batch=3), the drivers' DRIVER_RTOL
DIST_RTOL = 1e-2
DIST_OBJ_RTOL = 1e-3
DIST_NORM_RTOL = 1e-2
SP_FRAMES = 75
TRAIN_BUCKET = (20, 5)


def _dist_sp(rank: int, world: int, out: Path) -> None:
    """Sequence-parallel encode of one 75-frame chunk of the flagship
    point-aligned model, 25 frames a rank."""
    import torch

    from vitslam_tpu_torch import parallel
    from vitslam_tpu_torch.models import flagship_point_aligned

    group = parallel.make_mesh(n_data=1, n_model=world).group("model")
    model = flagship_point_aligned(device="cuda", seed=0, seq_group=group)
    images = torch.as_tensor(_synthetic_sequence(SP_FRAMES, 154, 518, seed=2)["images"],
                             device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t = time.perf_counter()
    with torch.inference_mode():
        raw = parallel.sequence_parallel_encode(model, images, group)
        full = parallel.gather_sequence(raw, group)
    torch.cuda.synchronize()
    secs, launches = time.perf_counter() - t, read_launches()
    print(f"[distributed rank {rank}] SP encode: {SP_FRAMES // world} of {SP_FRAMES} frames, "
          f"{secs:.3f} s wall, max_memory_allocated "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, launches {launches}", flush=True)
    saved = {"launches": launches}
    if rank == 0:
        saved["full"] = {k: v.cpu() for k, v in full.items()}
    torch.save(saved, out / f"sp_{rank}.pt")


def _serve_run(model, encode_batch: int, mesh=None):
    """The flagship 5/1 over 17 frames through ChunkedPipeline; returns
    (predictions, launches)."""
    import torch

    from vitslam_tpu_torch.slam import ChunkedPipeline

    batch = _synthetic_sequence(17, 154, 518, seed=0)
    torch.cuda.synchronize()
    reset_launches()
    pred, _ = ChunkedPipeline(model, encode_batch=encode_batch, mesh=mesh).run_sequence(
        batch, chunk_width=5, num_overlap=1)
    torch.cuda.synchronize()
    return pred, read_launches()


def _dist_serve(rank: int, world: int, out: Path) -> None:
    """Chunk-parallel serving: the flagship 5/1 over 17 frames (4 chunks),
    encode_batch = the rank count, the encode groups split over the ranks."""
    import torch

    from vitslam_tpu_torch import parallel
    from vitslam_tpu_torch.models import flagship

    mesh = parallel.make_mesh(n_data=world)
    model = flagship(device="cuda", seed=0)
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    pred, launches = _serve_run(model, world, mesh)
    print(f"[distributed rank {rank}] chunk-parallel 5/1: {time.perf_counter() - t:.3f} s wall, "
          f"max_memory_allocated {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, "
          f"launches {launches}", flush=True)
    torch.save({"pred": pred, "launches": launches}, out / f"serve_{rank}.pt")


def _whole_hash(trainer) -> str:
    """head_grad_check.state_hash over the whole trainable tensors (gathered
    over the model group under tensor parallelism: every rank calls it)."""
    import hashlib

    h = hashlib.sha256()
    for name, t in sorted(trainer.state.trainable.items()):
        h.update(name.encode())
        h.update(trainer.whole(name, t.detach()).float().cpu().numpy().tobytes())
    return h.hexdigest()[:12]


def _dp_step(trainer, batch: dict) -> dict:
    """One train step of ``trainer`` on ``batch`` at TRAIN_BUCKET, data-
    parallel when the trainer has a mesh (and tensor-parallel when it has
    model shards): the losses, the whole gradients, their global norm, then
    the AdamW update and a hash of the whole trainable tensors after it."""
    import torch

    from vitslam_tpu_torch.train import loss_and_grads

    width, overlap = TRAIN_BUCKET
    chunks, merged = trainer._prepare_chunks(batch, width, overlap)
    st = trainer.state
    losses, grads = loss_and_grads(
        trainer.model, trainer.loss, st.trainable, chunks, merged, st.step, overlap,
        trainer.gt_alignment_type, generator=torch.Generator().manual_seed(11),
        data_group=None if trainer.mesh is None else trainer.mesh.group("data"))
    norm = float(st.optimizer.grad_norm(grads))
    st.optimizer.step(grads)
    torch.cuda.synchronize()
    return dict(objective=float(losses["objective"]), grad_norm=norm,
                grads={n: trainer.whole(n, g).cpu() for n, g in grads.items()},
                state=_whole_hash(trainer), rows=chunks[0]["images"].shape[0])


def _train_case(batch_rows: int):
    """A Trainer of the shipped training config's global-mode model over a
    batch of ``batch_rows`` 40-frame samples (a data mesh in a gang)."""
    import tempfile

    from vitslam_tpu_torch.head_grad_check import head_trainer
    from vitslam_tpu_torch.models import flagship
    from vitslam_tpu_torch.utils import make_synthetic_batch

    model = flagship(device="cuda", seed=0, enable_point=False, temporal_attention=False)
    batch = make_synthetic_batch(B=batch_rows, N=40, H=154, W=518, seed=3)
    trainer = head_trainer(model, batch, TRAIN_BUCKET, 1, tempfile.mkdtemp(prefix="chip_dp_"))
    trainer.init_state()
    return trainer, batch


def _dist_train(rank: int, world: int, out: Path) -> None:
    """One data-parallel step of the global-mode head at (20, 5), one sample
    a rank."""
    import torch

    trainer, batch = _train_case(world)
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t = time.perf_counter()
    res = _dp_step(trainer, batch)
    res["launches"] = read_launches()
    print(f"[distributed rank {rank}] DP train step: {res['rows']} of {world} rows, "
          f"{time.perf_counter() - t:.3f} s wall, max_memory_allocated "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, objective "
          f"{res['objective']:.6g}, grad_norm {res['grad_norm']:.6g}, state {res['state']}, "
          f"launches {res['launches']}", flush=True)
    if rank != 0:
        del res["grads"]
    torch.save(res, out / f"train_{rank}.pt")


def _dist_worker(rank: int, port: int, world: int, outdir: str, scenarios: str) -> int:
    """One rank of a gang of the distributed phase (``chip_smoke.py
    --dist-worker RANK PORT WORLD OUTDIR SCENARIOS``): joins the gloo gang on
    the card, runs the comma-separated scenarios in order and saves its
    results."""
    import torch
    import torch.distributed as dist

    from vitslam_tpu_torch import parallel

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    torch.cuda.set_device(0)
    parallel.init_distributed("gloo", f"localhost:{port}", world, rank)
    try:
        t = time.perf_counter()
        for name in scenarios.split(","):
            DIST_SCENARIOS[name](rank, world, Path(outdir))
            _release()
        print(f"[distributed rank {rank}] wall {time.perf_counter() - t:.1f} s, "
              f"max_memory_allocated {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB",
              flush=True)
    finally:
        dist.destroy_process_group()
    return 0


def _gang(smi: str, world: int, scenarios: str, out: Path, per_node: int = 0) -> None:
    """Run ``scenarios`` in a gloo gang of ``world`` processes on the card
    (nodes of ``per_node`` ranks, LOCAL_WORLD_SIZE; one node by default)
    and print the ranks' lines."""
    from vitslam_tpu_torch import parallel

    t = time.perf_counter()
    outs, _ = parallel.spawn_gang(
        lambda r, port: [sys.executable, str(ROOT / "chip_smoke.py"), "--dist-worker", str(r),
                         str(port), str(world), str(out), scenarios],
        world, timeout=600, retries=1, cwd=str(ROOT),
        env=parallel.clean_env({"LOCAL_WORLD_SIZE": str(per_node or world)}))
    for o in outs:
        print("\n".join(line for line in o.splitlines() if line.startswith("[distributed")))
    print(f"[distributed] gloo gang of {world} processes on one card ({scenarios}): "
          f"{time.perf_counter() - t:.1f} s wall (start-up and model builds included; not a "
          f"rate of the distributed paths), on {smi}")


def phase_distributed(smi: str) -> tuple[dict, dict]:
    """The distributed paths on the card: a gloo gang of DIST_RANKS
    processes sharing it runs the sequence-parallel encode and chunk-
    parallel serving, a gang of DP_RANKS one data-parallel train step; this
    process then runs each on its own and holds the gangs to it, and runs
    the 5/1 serving through a 1-rank NCCL group. Returns the stats and this
    process's train step (the tensor-parallel phase's reference too)."""
    import shutil
    import tempfile

    import torch
    import torch.distributed as dist

    from vitslam_tpu_torch import parallel
    from vitslam_tpu_torch.models import flagship, flagship_point_aligned

    out = Path(tempfile.mkdtemp(prefix="chip_smoke_dist_"))
    _release()
    print(f"[distributed] this process holds {torch.cuda.memory_reserved() / 2**30:.2f} GiB of "
          f"the card before the gangs")
    try:
        _gang(smi, DIST_RANKS, "sp,serve", out)
        _gang(smi, DP_RANKS, "train", out)
        sp = [torch.load(out / f"sp_{r}.pt") for r in range(DIST_RANKS)]
        serve = [torch.load(out / f"serve_{r}.pt") for r in range(DIST_RANKS)]
        train = [torch.load(out / f"train_{r}.pt") for r in range(DP_RANKS)]
    finally:
        shutil.rmtree(out, ignore_errors=True)
    stats = {}

    # 1. SP encode against one process's encode of the same chunk. A rank's
    # DPT decodes its 25 frames in 5-frame groups (the largest divisor of 25
    # within dpt_frames_chunk=16), one process its 75 in 15-frame groups:
    # cuDNN's bf16 convolutions at another batch move points_raw by ~1.4e-2
    # rel-L2 (H100 80GB HBM3, 700 W) with the attention gather exact. The
    # gated reference decodes in 5-frame groups too, so the check reads the
    # sequence parallelism, not the conv batch size; the one with the
    # preset's own grouping is printed beside it.
    local = SP_FRAMES // DIST_RANKS
    group = max(d for d in range(1, 17) if local % d == 0)  # VGGTCore's rule
    model = flagship_point_aligned(device="cuda", seed=0)
    images = torch.as_tensor(_synthetic_sequence(SP_FRAMES, 154, 518, seed=2)["images"],
                             device="cuda")
    own_groups = model.core.dpt_frames_chunk
    with torch.inference_mode():
        own = {k: v.float().cpu() for k, v in model.encode_chunks(images).items()}
        model.core.dpt_frames_chunk = group
        ref = model.encode_chunks(images)
    errs = {k: rel_l2(sp[0]["full"][k].float(), ref[k].float().cpu()) for k in ref}
    errs_own = {k: rel_l2(sp[0]["full"][k].float(), own[k]) for k in own}
    print(f"[distributed] SP encode, {DIST_RANKS} ranks vs one process decoding its DPT in "
          f"{group}-frame groups as a rank does: rel-L2 {json.dumps(errs)} (tol {DIST_RTOL}); "
          f"vs one process with dpt_frames_chunk={own_groups} (not gated): "
          f"{json.dumps(errs_own)}")
    want = {"flat_flash_attention": 24, "fused_qkv_attention": 48, "qk_prep": 24}
    for r, res in enumerate(sp):
        _expect(f"distributed SP encode rank {r}", res["launches"], want)
        stats[f"distributed SP encode rank {r}"] = dict(launches=res["launches"])
    bad = {k: v for k, v in errs.items() if not v <= DIST_RTOL}
    if bad or set(errs) != set(sp[0]["full"]):
        raise AssertionError(f"distributed SP encode disagrees: {bad}")
    del model, images, ref, own
    _release()

    # 2. chunk-parallel serving: identical on every rank; against one
    # process's sequential driver, which encodes each chunk at B=1 as a rank
    # does (DIST_RTOL), and its encode_batch=3 driver, which stacks B=3 and
    # embeds the unique frames once (other GEMM and conv shapes: the drivers'
    # DRIVER_RTOL); then through a 1-rank NCCL group at encode_batch=1, each
    # chunk's encode gathered through NCCL, bit-equal to the sequential run
    model = flagship(device="cuda", seed=0)
    seq, _ = _serve_run(model, 1)
    stacked, _ = _serve_run(model, DIST_RANKS)
    for r, res in enumerate(serve):
        same = all(torch.equal(res["pred"][k], serve[0]["pred"][k]) for k in serve[0]["pred"])
        if not same:
            raise AssertionError(f"distributed serving: rank {r}'s predictions differ from rank 0's")
        # per rank 2 encodes (its chunk of group 0-2, and the padded tail group)
        _expect(f"distributed serving rank {r}", res["launches"],
                {"fused_qkv_attention": 144, "qk_prep": 96})
        stats[f"distributed serving rank {r}"] = dict(launches=res["launches"])
    pred = serve[0]["pred"]
    errs = output_errors(pred, seq)
    errs_stacked = output_errors(pred, stacked)
    print(f"[distributed] chunk-parallel 5/1 at encode_batch={DIST_RANKS}: identical on all "
          f"{DIST_RANKS} ranks; vs one process, sequential driver: bit-equal "
          f"{all(torch.equal(pred[k], seq[k]) for k in seq)}, rel-L2 {json.dumps(errs)} "
          f"(tol {DIST_RTOL}); encode_batch={DIST_RANKS} driver: rel-L2 "
          f"{json.dumps(errs_stacked)} (tol {DRIVER_RTOL})")
    bad = {k: v for k, v in errs.items() if not v <= DIST_RTOL}
    bad.update({f"{k} (encode_batch={DIST_RANKS})": v for k, v in errs_stacked.items()
                if not v <= DRIVER_RTOL})
    if bad:
        raise AssertionError(f"distributed serving disagrees with one process: {bad}")
    parallel.init_distributed("nccl", f"localhost:{parallel.free_port()}", 1, 0)
    try:
        pred, launches = _serve_run(model, 1, parallel.make_mesh())
    finally:
        dist.destroy_process_group()
    _expect("distributed NCCL world size 1", launches, {"fused_qkv_attention": 288})
    stats["distributed NCCL world size 1"] = dict(launches=launches)
    equal = {k: torch.equal(pred[k], seq[k]) for k in seq}
    print(f"[distributed] 5/1 through a 1-rank NCCL group (mesh, encode_batch=1) vs one "
          f"process's sequential driver: bit-equal {equal}; launches {launches}")
    if not all(equal.values()):
        raise AssertionError(f"distributed NCCL run differs from one process: {equal}")
    del model, seq, stacked, pred
    _release()

    # 3. one DP train step against one process's step on the global batch.
    # A rank encodes its row through the frozen backbone at B=1, one process
    # its rows at B=2; bf16 at another batch shape (cuBLAS / cuDNN choices:
    # the serving check above shows ~1e-2 on the outputs) moves the
    # gradients by ~1e-2 and the cancelling scalar `alpha` (ROADMAP S3) by
    # 3.03e-2 (H100 80GB HBM3, 700 W). So the gated reference runs its frozen
    # encode one row at a time, as the ranks do; the head and the loss run
    # on the whole batch. The reference with the stacked encode is printed
    # beside it.
    trainer, batch = _train_case(DP_RANKS)
    model = trainer.model
    encode = model.encode_chunks

    def per_row(images, patch_tokens=None):
        outs = [encode(images[i:i + 1]) for i in range(images.shape[0])]
        return {k: torch.cat([o[k] for o in outs]) for k in outs[0]}

    model.encode_chunks = per_row
    try:
        reset_launches()
        ref = _dp_step(trainer, batch)
        ref_launches = read_launches()
    finally:
        del model.encode_chunks
    trainer, batch = _train_case(DP_RANKS)
    stacked = _dp_step(trainer, batch)
    del trainer, model, encode
    _release()
    states = {res["state"] for res in train}
    text, obj_err, norm_err, worst = _compare_step(train, ref)
    print(f"[distributed] DP train step at {TRAIN_BUCKET}, {DP_RANKS} ranks x 1 sample vs one "
          f"process x {DP_RANKS} (frozen encode one row at a time): {text} (tol objective "
          f"{DIST_OBJ_RTOL}, grad_norm {DIST_NORM_RTOL}, gradients {GRAD_RTOL}); ranks' "
          f"trainable tensors after the step: hashes {sorted(states)}; one process's launches "
          f"{ref_launches}")
    print(f"[distributed] the same against one process with the stacked encode (not gated): "
          f"{_compare_step(train, stacked)[0]}")
    for r, res in enumerate(train):
        stats[f"distributed DP train rank {r}"] = dict(launches=res["launches"])
    if len(states) != 1:
        raise AssertionError(f"distributed DP train: trainable tensors differ across ranks: {states}")
    if not (obj_err <= DIST_OBJ_RTOL and norm_err <= DIST_NORM_RTOL and worst[0][1] <= GRAD_RTOL):
        raise AssertionError("distributed DP train step disagrees with one process")
    if train[0]["launches"]["flash_attention_backward"] == 0:
        raise AssertionError("distributed DP train: K4 was not launched")
    stats["distributed DP train rank 0"].update(
        objective=[res["objective"] for res in train],
        grad_norm=[res["grad_norm"] for res in train], grad_rel_l2_max=worst[0][1])
    return stats, ref


def _compare_step(ranks: list, want: dict):
    """The ranks' step (objective, gradient norm; rank 0's gradients)
    against one process's: (text, objective error, norm error, the five
    worst gradients by relative L2 error)."""
    from vitslam_tpu_torch.head_grad_check import _rel_l2

    obj = [res["objective"] for res in ranks]
    norm = [res["grad_norm"] for res in ranks]
    g = ranks[0]["grads"]
    errs = {n: _rel_l2(g[n], want["grads"][n]) for n in g if want["grads"][n].abs().max() > 0}
    worst = sorted(errs.items(), key=lambda kv: -kv[1])[:5]
    obj_err = max(abs(o - want["objective"]) for o in obj) / abs(want["objective"])
    norm_err = max(abs(n - want["grad_norm"]) for n in norm) / want["grad_norm"]
    return (f"objective {obj} vs {want['objective']:.6g} (rel {obj_err:.2e}); grad_norm "
            f"{norm} vs {want['grad_norm']:.6g} (rel {norm_err:.2e}); gradients of "
            f"{len(errs)} tensors, max rel-L2 {worst[0][1]:.3e}, worst {worst}; state after "
            f"the step {want['state']}"), obj_err, norm_err, worst



# the tensor-parallel phase: a gloo gang of TP_RANKS processes sharing the
# card, two nodes of TP_PER_NODE (LOCAL_WORLD_SIZE), as a (data 2, model 2)
# mesh: data across the nodes, model within, as the JAX package lays out a
# pod. Each rank holds half of every split parameter and the whole global-
# mode flagship step otherwise (one batch row a data rank), so it needs
# about what a DP rank does less half the parameters: ~10-12 GiB
TP_RANKS = 4
TP_PER_NODE = 2
TP_MODEL = 2
# one int8 projection's gradients on the card against the CPU (the 5/1
# global qkv shape): the same integers, scales and int32 product on both
# (phase int8), fp32 sums in another order, so the largest difference of
# each gradient within 1e-4 of its largest entry
INT8_GRAD_SHAPE = (2060, 1024, 3072)
INT8_GRAD_RTOL = 1e-4


def _tp_trainer(out: Path):
    """The DP phase's case (the shipped training config's global-mode
    flagship over a 2-sample 40-frame batch) with num_model_shards 2 and the
    sharded (orbax) checkpoint backend, saving under ``out``."""
    import torch

    from vitslam_tpu_torch.head_grad_check import head_trainer
    from vitslam_tpu_torch.models import flagship
    from vitslam_tpu_torch.utils import make_synthetic_batch

    model = flagship(device="cuda", seed=0, enable_point=False, temporal_attention=False)
    batch = make_synthetic_batch(B=TP_RANKS // TP_MODEL, N=40, H=154, W=518, seed=3)
    trainer = head_trainer(model, batch, TRAIN_BUCKET, 1, str(out / "tp"),
                           num_model_shards=TP_MODEL,
                           checkpoint={"save_dir": str(out / "tp_ckpt"), "save_freq": 10 ** 9,
                                       "resume_from_checkpoint": False, "backend": "orbax"})
    trainer.init_state()
    torch.cuda.empty_cache()  # the whole parameters, dropped for their slices
    return trainer, batch


def _dist_tp(rank: int, world: int, out: Path) -> None:
    """One tensor- and data-parallel step of the global-mode head at (20,
    5), then a sharded save of the train state; rank 0 also saves the whole
    tensors, which this process compares with the sharded save."""
    import torch

    from vitslam_tpu_torch.parallel.mesh import gather_param

    trainer, batch = _tp_trainer(out)
    local = sum(p.numel() * p.element_size() for p in trainer.model.parameters())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    gather_param.calls = gather_param.bytes = 0
    t = time.perf_counter()
    res = _dp_step(trainer, batch)
    res.update(launches=read_launches(), seconds=time.perf_counter() - t,
               gathers=gather_param.calls, gathered_bytes=gather_param.bytes,
               peak=torch.cuda.max_memory_allocated(), local_bytes=local,
               sharded=len(trainer.shards.dims), coords=dict(trainer.mesh.coords))
    t = time.perf_counter()
    res["ckpt"] = trainer.ckpt.save(1, trainer.sharded_state_dict())
    res["save_seconds"] = time.perf_counter() - t
    opt = trainer.state.optimizer
    whole = {"trainable": {n: trainer.whole(n, p.detach()).cpu()
                           for n, p in trainer.state.trainable.items()},
             "mu": {n: trainer.whole(n, m).cpu() for n, m in opt.mu.items()},
             "nu": {n: trainer.whole(n, v).cpu() for n, v in opt.nu.items()},
             "count": opt.count, "step": trainer.state.step}
    print(f"[distributed rank {rank}] TP train step: mesh {res['coords']} of "
          f"{dict(trainer.mesh.shape)}, {res['rows']} of {world // TP_MODEL} rows, "
          f"{res['seconds']:.3f} s wall, max_memory_allocated {res['peak'] / 2**30:.2f} GiB, "
          f"parameters held {local / 2**30:.2f} GiB ({res['sharded']} tensors sharded), "
          f"{res['gathers']} parameter gathers receiving {res['gathered_bytes'] / 2**30:.2f} "
          f"GiB, objective {res['objective']:.6g}, grad_norm {res['grad_norm']:.6g}, state "
          f"{res['state']}, launches {res['launches']}; sharded save "
          f"{res['save_seconds']:.2f} s", flush=True)
    if rank != 0:
        del res["grads"]
    else:
        torch.save(whole, out / "tp_whole.pt")
    torch.save(res, out / f"tp_{rank}.pt")


def _int8_gradients(smi: str) -> dict:
    """One int8 projection's gradients (d/dx, d/dw, d/db of a weighted sum
    of its output) on the card against the CPU, fp32 inputs."""
    import torch

    from vitslam_tpu_torch.ops.quant import int8_matmul

    M, K, N = INT8_GRAD_SHAPE
    g = torch.Generator().manual_seed(13)
    x, w = torch.randn(M, K, generator=g), torch.randn(K, N, generator=g) / K ** 0.5
    b, gy = torch.randn(N, generator=g) * 0.1, torch.randn(M, N, generator=g)
    grads = {}
    for dev in ("cuda", "cpu"):
        ins = [t.to(dev).requires_grad_() for t in (x, w, b)]
        (int8_matmul(*ins, out_dtype=torch.float32) * gy.to(dev)).sum().backward()
        grads[dev] = [t.grad.cpu() for t in ins]
    errs = {name: float((a - c).abs().max() / c.abs().max())
            for name, a, c in zip(("dx", "dw", "db"), grads["cuda"], grads["cpu"])}
    nonzero = {name: int((a != 0).sum()) for name, a in zip(("dx", "dw", "db"), grads["cuda"])}
    print(f"[tp] int8 projection M {M} K {K} N {N} gradients, card vs CPU: largest difference "
          f"over largest entry {json.dumps(errs)} (tol {INT8_GRAD_RTOL}); nonzero entries "
          f"{json.dumps(nonzero)} (d/dx at each row's largest |x|, d/dw at each column's); "
          f"on {smi}")
    if not all(e <= INT8_GRAD_RTOL for e in errs.values()):
        raise AssertionError(f"int8 gradients on the card differ from the CPU: {errs}")
    return dict(errors=errs, nonzero=nonzero)


DIST_SCENARIOS = {"sp": _dist_sp, "serve": _dist_serve, "train": _dist_train, "tp": _dist_tp}


def phase_tp(smi: str, ref: dict) -> dict:
    """Tensor parallelism on the card: a gloo gang of TP_RANKS processes
    (two nodes of TP_PER_NODE) takes one global-mode train step of the
    full-width flagship as a (data 2, model 2) mesh through the Trainer
    (num_model_shards 2), held against this process's step on the same
    global batch (``ref``, the DP phase's); its sharded save is loaded here
    at model 1, bit-equal to the gang's whole tensors. Then one int8
    projection's gradients card vs CPU, whether the native preprocessing
    route runs, and the pod-topology dry run (parallel/dryrun.py) on the
    card."""
    import shutil
    import tempfile

    import torch

    from vitslam_tpu_torch.io import load_sharded
    from vitslam_tpu_torch.native import native_available
    from vitslam_tpu_torch.parallel.dryrun import dryrun_multichip

    t0 = time.perf_counter()
    out = Path(tempfile.mkdtemp(prefix="chip_smoke_tp_"))
    _release()
    try:
        _gang(smi, TP_RANKS, "tp", out, per_node=TP_PER_NODE)
        ranks = [torch.load(out / f"tp_{r}.pt") for r in range(TP_RANKS)]
        whole = torch.load(out / "tp_whole.pt")
        template = {"trainable": {n: torch.zeros_like(t) for n, t in whole["trainable"].items()},
                    "optimizer": {"count": 0, "mu": {n: torch.zeros_like(t)
                                                     for n, t in whole["mu"].items()},
                                  "nu": {n: torch.zeros_like(t) for n, t in whole["nu"].items()},
                                  "mini_step": 0},
                    "step": 0}
        t = time.perf_counter()
        loaded = load_sharded(ranks[0]["ckpt"], template)
        load_s = time.perf_counter() - t
    finally:
        shutil.rmtree(out, ignore_errors=True)
    stats = {}
    states = {res["state"] for res in ranks}
    text, obj_err, norm_err, worst = _compare_step(ranks, ref)
    print(f"[tp] train step at {TRAIN_BUCKET}, {TP_RANKS} ranks as (data 2, model 2), two nodes "
          f"of {TP_PER_NODE}, vs one process x 2 rows (frozen encode one row at a time, the DP "
          f"phase's reference): {text} (tol objective {DIST_OBJ_RTOL}, grad_norm "
          f"{DIST_NORM_RTOL}, gradients {GRAD_RTOL}); whole trainable tensors after the step: "
          f"hashes {sorted(states)}")
    peaks = [res["peak"] / 2 ** 30 for res in ranks]
    print(f"[tp] rank peaks (max_memory_allocated) {[round(p, 2) for p in peaks]} GiB; "
          f"parameters held a rank {ranks[0]['local_bytes'] / 2**30:.2f} GiB; step walls "
          f"{[round(res['seconds'], 2) for res in ranks]} s; {ranks[0]['gathers']} parameter "
          f"gathers a rank receiving {ranks[0]['gathered_bytes'] / 2**30:.2f} GiB a step; on {smi}")
    if len(states) != 1:
        raise AssertionError(f"tp train: whole trainable tensors differ across ranks: {states}")
    if not (obj_err <= DIST_OBJ_RTOL and norm_err <= DIST_NORM_RTOL and worst[0][1] <= GRAD_RTOL):
        raise AssertionError("tp train step disagrees with one process")
    if ranks[0]["launches"]["flash_attention_backward"] == 0:
        raise AssertionError("tp train: K4 was not launched")
    same = (loaded["step"] == whole["step"] and loaded["optimizer"]["count"] == whole["count"]
            and all(torch.equal(loaded["trainable"][n], whole["trainable"][n])
                    for n in whole["trainable"])
            and all(torch.equal(loaded["optimizer"][k][n], whole[k][n])
                    for k in ("mu", "nu") for n in whole[k]))
    print(f"[tp] sharded save ({ranks[0]['save_seconds']:.2f} s in the gang) loaded here at "
          f"model 1 in {load_s:.2f} s: trainable tensors, mu, nu, count and step bit-equal "
          f"{same}")
    if not same:
        raise AssertionError("tp: the sharded checkpoint does not load back bit-equal")
    for r, res in enumerate(ranks):
        stats[f"tp train rank {r}"] = dict(launches=res["launches"], peak_gib=peaks[r],
                                           seconds=res["seconds"])
    stats["tp train rank 0"].update(objective=ranks[0]["objective"],
                                    grad_norm=ranks[0]["grad_norm"], grad_rel_l2_max=worst[0][1],
                                    gathered_bytes=ranks[0]["gathered_bytes"])
    stats["tp int8 gradients"] = dict(launches={}, **_int8_gradients(smi))
    print(f"[tp] native preprocessing route: native_available() = {native_available()}")
    dryrun_multichip(TP_RANKS, "cuda")
    print(f"[tp] phase: {time.perf_counter() - t0:.1f} s wall on {smi}")
    return stats

# the int8 phase: one int8 projection at the 75/30 qkv shape on the card
# against the same computation on the CPU: the integers and the int32
# product equal, the bf16 output within INT8_ULPS units in the last place
# (the fp32 rescale is the same IEEE arithmetic on both)
INT8_ULPS = 1
# the last tap of an int8 chunk against the bf16 run of the same weights:
# cosine above this (the bound of tests/test_nn.py's int8 test)
INT8_COSINE = 0.995
# the four projections of a 75/30 backbone block: (M, K, N)
INT8_SHAPES = {"qkv": (30900, 1024, 3072), "proj": (30900, 1024, 1024),
               "fc1": (30900, 1024, 4096), "fc2": (30900, 4096, 1024)}
# the track head in fp32, card (TF32 off) against the CPU on the same taps:
# relative L2 error per output (tracks, visibility, confidence)
TRACK_RTOL = 1e-3
TRACK_QUERIES = 1024


def _ulps_bf16(a, b) -> int:
    """Largest distance in bf16 units in the last place between two bf16
    tensors of the same signs (their bit patterns as integers)."""
    import torch

    ai, bi = a.view(torch.int16).int(), b.view(torch.int16).int()
    same = torch.sign(a.float()) == torch.sign(b.float())
    if not bool(same.all()):
        return 1 << 15
    return int((ai - bi).abs().max())


def _int8_projection(smi: str) -> dict:
    """One int8 projection at the 75/30 qkv shape, card against CPU; then
    device ms (CUDA-graph replays, ``_time_ms``) of the four projections of
    a 75/30 block three ways: the whole ``int8_matmul`` (quantise x and W,
    int8 GEMM, rescale, bias), ``torch._int_mm`` alone on quantised
    operands, and bf16 ``F.linear``."""
    import torch
    import torch.nn.functional as F

    from vitslam_tpu_torch.ops.quant import int8_matmul, int_mm, quantize_cols, quantize_rows

    g = torch.Generator(device="cuda").manual_seed(9)
    M, K, N = INT8_SHAPES["qkv"]
    x = torch.randn(M, K, device="cuda", generator=g).to(torch.bfloat16)
    w = torch.randn(N, K, device="cuda", generator=g) / K ** 0.5
    b = torch.randn(N, device="cuda", generator=g) * 0.1
    with torch.no_grad():
        xq, xs = quantize_rows(x)
        wq, ws = quantize_cols(w.t())
        yq = int_mm(xq, wq)
        out = int8_matmul(x, w.t(), b)
        torch.cuda.synchronize()
        xq_c, xs_c = quantize_rows(x.cpu())
        wq_c, ws_c = quantize_cols(w.cpu().t())
        yq_c = int_mm(xq_c, wq_c)
        out_c = int8_matmul(x.cpu(), w.cpu().t(), b.cpu())
    int_diffs = int((xq.cpu() != xq_c).sum()) + int((wq.cpu() != wq_c).sum())
    scales_equal = torch.equal(xs.cpu(), xs_c) and torch.equal(ws.cpu(), ws_c)
    product_equal = torch.equal(yq.cpu(), yq_c)
    ulps = _ulps_bf16(out.cpu(), out_c)
    print(f"[int8] projection M {M} K {K} N {N}, card vs CPU: quantised integers differing "
          f"{int_diffs}, scales equal {scales_equal}, int32 product equal {product_equal}, "
          f"bf16 output max {ulps} ulp (tol {INT8_ULPS})")
    if int_diffs or not scales_equal or not product_equal or ulps > INT8_ULPS:
        raise AssertionError("int8 projection on the card differs from the CPU")
    del xq_c, wq_c, yq_c, out_c, yq, out

    times = {}
    for name, (M, K, N) in INT8_SHAPES.items():
        x = torch.randn(M, K, device="cuda", generator=g).to(torch.bfloat16)
        w = torch.randn(N, K, device="cuda", generator=g) / K ** 0.5
        b = torch.randn(N, device="cuda", generator=g) * 0.1
        w16, b16 = w.to(torch.bfloat16), b.to(torch.bfloat16)
        with torch.no_grad():
            xq, _ = quantize_rows(x)
            wq, _ = quantize_cols(w.t())
            t = dict(int8_matmul_ms=_time_ms(lambda: int8_matmul(x, w.t(), b)),
                     int_mm_ms=_time_ms(lambda: torch._int_mm(xq, wq)),
                     bf16_linear_ms=_time_ms(lambda: F.linear(x, w16, b16)))
        flop = 2.0 * M * K * N
        t["bf16_bound_ms"], _ = _bound(flop, _nbytes(x, w16, b16) + M * N * 2)
        # the int8 GEMM alone: its operations, or its int8 inputs and int32 output
        t["int8_bound_ms"] = max(flop / PEAK_INT8_OPS,
                                 (M * K + K * N + 4 * M * N) / PEAK_BYTES) * 1e3
        times[name] = t
        print(f"[int8] {name} M {M} K {K} N {N}: int8_matmul {t['int8_matmul_ms']:.4f} ms, "
              f"_int_mm alone {t['int_mm_ms']:.4f} ms ({flop / t['int_mm_ms'] / 1e9:.0f} TOP/s; "
              f"int8 bound {t['int8_bound_ms']:.4f} ms), bf16 F.linear "
              f"{t['bf16_linear_ms']:.4f} ms ({flop / t['bf16_linear_ms'] / 1e9:.0f} TFLOP/s; "
              f"bf16 bound {t['bf16_bound_ms']:.4f} ms); on {smi}")
        del x, w, b, w16, b16, xq, wq
    _release()
    return times


def _last_tap(model, images):
    import torch

    with torch.inference_mode():
        taps, _ = model.core.encode(images)
    return taps[-1].float()


def _cosine(a, b) -> float:
    import torch

    a, b = a.double().flatten(), b.double().flatten()
    return float(torch.dot(a, b) / (torch.linalg.vector_norm(a) * torch.linalg.vector_norm(b)))


def _int8_path(smi: str, label: str, model, batch: dict, width: int, overlap: int,
               want: dict, reference: dict, ref_fps: float) -> dict:
    """One int8 path through the sequential driver, the model built with
    both fused tails asked for (int8 takes neither: the tail phases show
    the same shapes launching K5 in bf16); launches gated, outputs and the
    rate printed beside the bf16 run of the same seed (``reference``,
    tails off)."""
    pred, stats = _drive(model, batch, f"int8 {label} sequential", smi, width, overlap)
    _expect(f"int8 {label}", stats["launches"], dict(want, mlp_tail=0))
    keys = [k for k in ("pose_enc", "depth", "world_points") if k in pred]
    _check_outputs(f"int8 {label}", {"int8": pred}, {k: tuple(reference[k].shape) for k in keys})
    errs = output_errors(pred, reference, keys)
    print(f"[int8 {label}] rel-L2 int8 vs the bf16 run of the same seed: "
          f"{json.dumps({k: round(v, 5) for k, v in errs.items()})}; new-frames/s int8 "
          f"{stats['fps']:.2f}, bf16 {ref_fps:.2f}; on {smi}")
    stats.update(rel_l2_vs_bf16=errs, bf16_fps=ref_fps)
    return stats


def phase_int8(smi: str, ref_5_1: dict, fps_5_1: float, ref_75_30: dict, fps_75_30: float):
    """The int8 serving mode: the projection card vs CPU and its times, the
    flagship 5/1 and the point-aligned 75/30 with int8=True (K1 on both,
    K2 on 75/30, no K5), the last tap's cosine to bf16. Returns the runs'
    stats (the projection times under the 75/30 run's "projections") and
    the 5/1 model (switched to bf16) for the hooks phase."""
    import torch

    from vitslam_tpu_torch.models import flagship, flagship_point_aligned
    from vitslam_tpu_torch.nn.layers import set_int8

    times = _int8_projection(smi)
    runs = {}
    n_frames, H, W = 17, 154, 518
    batch = _synthetic_sequence(n_frames, H, W, seed=0)
    model = flagship(device="cuda", seed=0, int8=True, mlp_tail="both")
    runs["int8 5/1 sequential"] = _int8_path(
        smi, "5/1", model, batch, 5, 1,
        dict(fused_qkv_attention=72 * 4, qk_prep=48 * 4, flat_flash_attention=0,
             flash_attention=0), ref_5_1, fps_5_1)
    images = torch.as_tensor(batch["images"][:, :5], device="cuda")
    int8_tap = _last_tap(model, images)
    set_int8(model, False)
    cos = _cosine(int8_tap, _last_tap(model, images))
    print(f"[int8 5/1] last aggregator tap of one chunk, int8 vs bf16 (same model): cosine "
          f"{cos:.6f} (tol > {INT8_COSINE})")
    if not cos > INT8_COSINE:
        raise AssertionError(f"int8 5/1: last tap cosine {cos} <= {INT8_COSINE}")
    runs["int8 5/1 sequential"]["last_tap_cosine"] = cos

    n_frames, width, overlap = 165, 75, 30
    batch = _synthetic_sequence(n_frames, H, W, seed=2)
    large = flagship_point_aligned(device="cuda", seed=0, int8=True, mlp_tail="both")
    runs["int8 75/30 point sequential"] = _int8_path(
        smi, "75/30 point", large, batch, width, overlap,
        dict(fused_qkv_attention=48 * 3, qk_prep=24 * 3, flat_flash_attention=24 * 3,
             flash_attention=0), ref_75_30, fps_75_30)
    runs["int8 75/30 point sequential"]["projections"] = times
    del large
    _release()
    return runs, model


def phase_track(smi: str) -> dict:
    """The VGGT TrackHead at full width (features 128, hidden 384, updater
    depth 6, 4 iterations, 7 correlation levels, radius 4) on one 5-frame
    518x154 chunk of the flagship, 1,024 query points: the head in fp32 on
    the card (TF32 off) against the same head on the CPU on the same taps,
    gated: the feature maps, then the tracker on them with the reference's
    initialisation (its flow head is zero, so the tracks stay at the
    queries) and with the flow head drawn from a seed for one iteration;
    two iterations of the latter are printed, not gated (the flow
    embedding's frequencies reach 2^31: a 1e-7 difference in a track moves
    its high-frequency features by O(1)). Then the model's
    own head (bf16 feature extractor) against fp32, its device ms, its
    kernel launches and its peak memory."""
    import torch

    from vitslam_tpu_torch.models import TrackHead, flagship

    model = flagship(device="cuda", seed=0, enable_track=True)
    n_frames, H, W = 5, 154, 518
    images = torch.as_tensor(_synthetic_sequence(n_frames, H, W, seed=0)["images"],
                             device="cuda")
    rng = np.random.default_rng(7)
    query = torch.tensor(np.stack([rng.uniform(0, W - 1, TRACK_QUERIES),
                                   rng.uniform(0, H - 1, TRACK_QUERIES)], -1)[None],
                         dtype=torch.float32, device="cuda")
    with torch.inference_mode():
        taps, psi = model.core.encode(images)
    head = model.core.track_head
    kw = dict(dim_in=head.feature_extractor.dim_in, patch_size=head.feature_extractor.patch_size,
              dtype=torch.float32)
    fp32 = TrackHead(**kw, device=images.device)
    fp32.load_state_dict(head.state_dict())
    cpu = TrackHead(**kw, device="cpu")
    cpu.load_state_dict(head.state_dict())
    taps_cpu, images_cpu, query_cpu = [t.cpu() for t in taps], images.cpu(), query.cpu()
    tf32 = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    names = ("tracks", "visibility", "confidence")

    def compare(case: str, gated: bool, iters: int):
        """The trackers on the feature maps each side computed, as
        TrackHead.forward runs them (sigmoid on visibility, confidence)."""
        for m in (fp32, cpu):
            m.tracker.iters = iters
        with torch.inference_mode():
            got = [t.cpu() for t in fp32.tracker(fmaps, query)]
            want = cpu.tracker(fmaps_cpu, query_cpu)
        got[1:], want = [torch.sigmoid(t) for t in got[1:]], [want[0]] + [
            torch.sigmoid(t) for t in want[1:]]
        errs = {n: rel_l2(g.numpy(), w.numpy()) for n, g, w in zip(names, got, want)}
        moved = float((got[0] - query_cpu[:, None]).abs().max())
        print(f"[track] fp32 head, card (TF32 off) vs CPU, {case}: rel-L2 "
              f"{json.dumps({k: float(f'{v:.3e}') for k, v in errs.items()})} "
              f"({'tol ' + str(TRACK_RTOL) if gated else 'not gated'}); tracks moved up to "
              f"{moved:.3f} px from the queries")
        if gated and not all(np.isfinite(g.numpy()).all() for g in got):
            raise AssertionError(f"track {case}: non-finite outputs")
        if gated and not all(e <= TRACK_RTOL for e in errs.values()):
            raise AssertionError(f"track {case}: the card differs from the CPU: {errs}")
        return errs

    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.inference_mode():
            fmaps = fp32.feature_extractor(taps, images, psi).float()
            fmaps_cpu = cpu.feature_extractor(taps_cpu, images_cpu, psi).float()
        fm_err = rel_l2(fmaps.cpu().numpy(), fmaps_cpu.numpy())
        print(f"[track] fp32 feature extractor, card (TF32 off) vs CPU: feature maps "
              f"{tuple(fmaps.shape)}, rel-L2 {fm_err:.3e} (tol {TRACK_RTOL})")
        if not fm_err <= TRACK_RTOL:
            raise AssertionError(f"track: feature maps differ between card and CPU: {fm_err}")
        stats = {"feature maps": fm_err,
                 "reference init, 4 iterations": compare("reference init, 4 iterations", True, 4)}
        g = torch.Generator().manual_seed(11)
        flow = torch.randn(fp32.tracker.updateformer.flow_head.weight.shape, generator=g) * 0.02
        for m in (fp32, cpu):
            with torch.no_grad():
                m.tracker.updateformer.flow_head.weight.copy_(flow)
        stats["seeded flow head, 1 iteration"] = compare("seeded flow head, 1 iteration",
                                                         True, 1)
        stats["seeded flow head, 2 iterations"] = compare("seeded flow head, 2 iterations",
                                                          False, 2)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32
        for m in (fp32, cpu):
            m.tracker.iters = head.tracker.iters
    del cpu, taps_cpu, fmaps, fmaps_cpu

    fp32.load_state_dict(head.state_dict())  # the reference's zero flow head again
    with torch.inference_mode():
        ref = fp32(taps, images, psi, query)
        run = lambda: model.core.decode_track(taps, images, psi, query)  # noqa: E731
        got = run()
        torch.cuda.synchronize()
        errs = {n: rel_l2(a.float().cpu().numpy(), b.cpu().numpy())
                for n, a, b in zip(names, got, ref)}
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        run()
        torch.cuda.synchronize()
        launches = read_launches()
        peak = (torch.cuda.max_memory_allocated() - base) / 2**30
        ms, device_ms = _call_ms(run, iters=5), _time_ms(run)
        kernels = _device_launches(run)
    print(f"[track] the model's head (bf16 feature extractor, fp32 tracker) vs fp32: rel-L2 "
          f"{json.dumps({k: float(f'{v:.3e}') for k, v in errs.items()})}; decode_track of "
          f"{TRACK_QUERIES} queries over {n_frames} frames {ms:.2f} ms per call (host enqueue "
          f"included), {device_ms:.2f} ms device time (back to back), {kernels} "
          f"device launches (the port's kernels: {launches}), peak memory above the taps "
          f"{peak:.2f} GiB; on {smi}")
    if any(launches.values()):
        raise AssertionError(f"track: the head launched a port kernel: {launches}")
    stats.update(bf16_vs_fp32=errs, ms=ms, device_ms=device_ms, device_launches=kernels,
                 peak_gib=peak, launches=launches)
    del model, fp32, taps
    _release()
    return {"track 5 frames": stats}


def _device_launches(fn) -> int:
    """Kernels and device copies or fills one call of ``fn`` puts on the
    card (a torch.profiler window)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(1 for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA)


def phase_hooks(smi: str, model) -> dict:
    """The profiling and NaN-check hooks on one 5/1 chunk of the flagship:
    a trace (utils.profiling.trace) holds the chunk's annotate ranges and
    its kernels; nan_check switched off adds no device launch to a chunk
    and reads nothing back, switched on it reports a planted NaN (and
    raises when asked); ChunkTimer times the chunks."""
    import logging
    import shutil
    import tempfile

    import torch

    from vitslam_tpu_torch.utils import debug, profiling

    images = torch.as_tensor(_synthetic_sequence(5, 154, 518, seed=0)["images"], device="cuda")

    def chunk(check: bool):
        with torch.inference_mode():
            with profiling.annotate("encode_chunks"):
                raw = model.encode_chunks(images)
            if check:
                debug.nan_check(raw, "raw")
            with profiling.annotate("align_chunk"):
                out, _ = model.align_chunk(raw, images.shape, 1)
            if check:
                debug.nan_check(out, "outputs")
        return raw, out

    timer = profiling.ChunkTimer()
    with timer.chunk(5):
        chunk(False)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_trace_")
    try:
        with profiling.trace(tmp) as log_dir:
            with timer.chunk(5):
                chunk(False)
        trace_file = Path(log_dir) / "trace.json"
        events = json.loads(trace_file.read_text())["traceEvents"]
        size = trace_file.stat().st_size
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    ranges = {e["name"] for e in events if e.get("name") in ("encode_chunks", "align_chunk")}
    kernels = sum(1 for e in events if e.get("cat") == "kernel")
    print(f"[hooks] trace of one 5/1 chunk: {size / 2**20:.1f} MiB, annotate ranges "
          f"{sorted(ranges)}, {kernels} kernel events")
    if ranges != {"encode_chunks", "align_chunk"} or not kernels:
        raise AssertionError("hooks: the trace lacks the annotate ranges or the card's kernels")

    debug.enable_nan_checks(False)
    plain = _device_launches(lambda: chunk(False))
    with timer.chunk(5):
        off = _device_launches(lambda: chunk(True))
    syncs = [sum(_host_syncs(lambda: chunk(check)).values()) for check in (False, True)]
    debug.enable_nan_checks(True)
    on = _device_launches(lambda: chunk(True))
    syncs.append(sum(_host_syncs(lambda: chunk(True)).values()))
    # the gate: the checks of one chunk's outputs alone, off and on (a whole
    # chunk's count moves between two runs of the same code: 6,624 and 6,695
    # launches, H100 80GB HBM3, 700 W)
    raw, out = chunk(False)

    def checks():
        debug.nan_check(raw, "raw")
        debug.nan_check(out, "outputs")

    debug.enable_nan_checks(False)
    alone_off = (_device_launches(checks), sum(_host_syncs(checks).values()))
    debug.enable_nan_checks(True)
    alone_on = (_device_launches(checks), sum(_host_syncs(checks).values()))
    debug.enable_nan_checks(False)
    print(f"[hooks] a chunk's device launches / host syncs: {plain} / {syncs[0]} plain, {off} / "
          f"{syncs[1]} with nan_check off, {on} / {syncs[2]} with it on; the checks of a "
          f"chunk's outputs alone: {alone_off[0]} / {alone_off[1]} off, {alone_on[0]} / "
          f"{alone_on[1]} on")
    if alone_off != (0, 0) or syncs[1] != syncs[0] or alone_on[0] == 0:
        raise AssertionError(f"hooks: nan_check off launched {alone_off[0]} kernels or synced "
                             f"{alone_off[1]} times ({syncs[0]} -> {syncs[1]} syncs a chunk), "
                             f"or on launched none ({alone_on[0]})")

    planted = raw["depth_raw"].clone()
    planted.view(-1)[12345] = float("nan")
    records = []
    handler = logging.Handler()
    handler.emit = records.append
    debug.logger.addHandler(handler)
    try:
        debug.enable_nan_checks(True)
        debug.nan_check({"depth_raw": planted}, "planted")
        debug.enable_nan_checks(True, raise_on_nan=True)
        try:
            debug.nan_check(planted, "planted")
            raised = False
        except FloatingPointError:
            raised = True
    finally:
        debug.enable_nan_checks(False)
        debug.logger.removeHandler(handler)
    messages = [r.getMessage() for r in records]
    print(f"[hooks] planted NaN: reported {messages}, raised {raised}; ChunkTimer "
          f"{timer.summary()}")
    if messages != ["NaN/Inf detected in planted[0]: 1 bad elements"] or not raised:
        raise AssertionError("hooks: the planted NaN was not reported")
    return {"hooks 5/1 chunk": dict(launches_plain=plain, launches_check_off=off,
                                    launches_check_on=on, host_syncs=syncs,
                                    checks_alone_off=alone_off, checks_alone_on=alone_on,
                                    trace_mib=size / 2**20, timer=timer.summary())}


def main() -> int:
    sys.path.insert(0, str(ROOT))
    if sys.argv[1:2] == ["--dist-worker"]:
        return _dist_worker(int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]), sys.argv[5],
                            sys.argv[6])
    smi = phase_device()
    import torch

    sass = phase_build()
    # first, while this process holds no model: the gangs' ranks need ~25
    # GiB each on the shared card
    dist_runs, train_ref = phase_distributed(smi)
    dist_runs.update(phase_tp(smi, train_ref))
    del train_ref
    results = phase_kernels()
    phase_reference()
    runs, tails_off = phase_slice(smi)
    runs.update(phase_checkpoints(smi, tails_off))
    runs.update(phase_merge(smi))
    large_runs, point_seq = phase_large_chunk(smi)
    runs.update(large_runs)
    runs.update(phase_global_head(smi))
    runs.update(phase_train(smi))
    model, tail_run = phase_tail(smi, tails_off, runs["slice 5/1 sequential"])
    runs.update(tail_run)
    runs.update(phase_eval(smi, model))
    del model
    _release()
    runs.update(phase_tail_large(smi, runs["slice 75/30 point sequential"]))
    int8_runs, model = phase_int8(
        smi, tails_off, runs["slice 5/1 sequential"]["fps"], point_seq,
        runs["slice 75/30 point sequential"]["fps"])
    runs.update(int8_runs)
    del point_seq
    phase_hooks(smi, model)
    del model
    _release()
    runs.update(phase_track(smi))
    runs.update(dist_runs)
    # each kernel's headline numbers: its case at the shapes of the path
    # named here, and the launches of that path's run
    main_path = {"fused_qkv_attention": "slice 75/30 point sequential",
                 "qk_prep": "slice 75/30 point sequential",
                 "flat_flash_attention": "slice 75/30 point sequential",
                 "flash_attention": "merge 5/1 p2s2 sequential",
                 "flash_attention_lse": "train global (20, 5)",
                 "flash_attention_backward": "train global (20, 5)",
                 "mlp_tail": "tail 5/1 sequential"}
    kernels = []
    for name, (route, source, replaces) in KERNELS.items():
        cases = results[name]
        main_case = next(c for c in cases if c["main"])
        launches = runs[main_path[name]]["launches"][name]
        if launches == 0:
            raise AssertionError(f"{name} was not launched on {main_path[name]}")
        extra = {"also_replaces": ALSO_REPLACES[name]} if name in ALSO_REPLACES else {}
        lib = Path(source).stem
        if lib in sass:
            extra["sass"] = sass[lib]
        kernels.append(dict(
            name=name, route=route, source=source, replaces=replaces, **extra, launches=launches,
            max_abs_err=max(c["max_abs_err"] for c in cases), ms=main_case["ms"],
            plain_ms=main_case["plain_ms"], bound_ms=main_case["bound_ms"],
            bound_by=main_case["bound_by"], library_ms=main_case["library_ms"],
            call_ms=main_case["call_ms"],
            **{k: main_case[k] for k in ("unfused_ms", "tail_route_ms", "gemm_ms", "sdpa_ms")
               if k in main_case},
            main_path=main_path[name], main_case=main_case["case"],
            launches_by_path={label: st["launches"].get(name, 0) for label, st in runs.items()},
            cases=cases))
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
