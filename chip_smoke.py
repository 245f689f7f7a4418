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
                streaming attention) and K3 (flash attention forward)
                against their plain PyTorch versions in bf16 at the main
                paths' shapes (dh 64, 16 heads), and the K3 kernel's
                in-kernel q fold bit for bit against torch's; max error,
                device time per call (a back-to-back run), single-call time,
                plain and SDPA times, bound.
4. reference  — a small model with dh 64 through ChunkedPipeline on the GPU
                (bf16, K1) and on the CPU (fp32, plain math), same weights.
5. slice 5/1  — the flagship FeatureAlignedVGGT (seeded random weights) over
                a synthetic 17-frame 518x154 sequence, chunk 5 / overlap 1,
                sequential and two-stage (encode_batch=4) drivers.
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
                8,260 / 10,738 / 6,608 tokens runs K3 with lse forward and K4
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

import gc
import json
import statistics
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
# NVIDIA H100 SXM data sheet: dense bf16 tensor-core peak and HBM3 rate
PEAK_FLOPS = 989e12
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
    sequential = outs["sequential"]
    del model, outs
    _release()
    return {f"slice 5/1 {label}": st for label, st in stats.items()}, sequential


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


def phase_large_chunk(smi: str) -> dict:
    """Point- and pose-aligned flagship presets at chunk 75 / overlap 30 over
    165 synthetic frames (3 chunks), then one merged chunk at p4s10."""
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
    del model, seq, bat
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
    return {f"slice 75/30 {label}": st for label, st in stats.items()}


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
    # over 8,260 / 10,738 / 6,608 tokens, and as many K4 calls
    _expect(label, runs[label]["launches"],
            {"flash_attention_lse": 3 * 12, "flash_attention_backward": 3 * 12})

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


def main() -> int:
    sys.path.insert(0, str(ROOT))
    smi = phase_device()
    import torch

    sass = phase_build()
    results = phase_kernels()
    phase_reference()
    runs, tails_off = phase_slice(smi)
    runs.update(phase_merge(smi))
    runs.update(phase_large_chunk(smi))
    runs.update(phase_global_head(smi))
    runs.update(phase_train(smi))
    model, tail_run = phase_tail(smi, tails_off, runs["slice 5/1 sequential"])
    runs.update(tail_run)
    runs.update(phase_eval(smi, model))
    del model
    _release()
    runs.update(phase_tail_large(smi, runs["slice 75/30 point sequential"]))
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
