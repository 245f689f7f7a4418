"""The port's benchmark: chunked-inference throughput of the flagship models
and the flagship train step on one GPU, with the scenarios, knobs, shapes
and metric names of the JAX package's ``bench.py``.

    python -m vitslam_tpu_torch.bench                  # the whole SUITE
    BENCH_MODEL=point BENCH_WIDTH=75 BENCH_OVERLAP=30 python -m vitslam_tpu_torch.bench

A scenario times steady-state new frames per second of the chunk-and-align
pipeline at 518-wide frames (H from ``fix_aspect_ratio``, 0.3 -> 518x154;
``BENCH_ASPECT=1.0`` gives 518x518), counting width - overlap new frames a
chunk. With an encode batch above 1 it runs the two-stage path: the models'
``encode_chunks`` over ``encode_batch`` chunks stacked along B, then
``align_chunk`` chunk by chunk with the state carried; otherwise
``ChunkedPipeline.step``. Images are uniform in [0, 1) from a seeded
``torch.Generator``, weights random from seed 0. Every step is fenced with
``torch.cuda.synchronize()``; the kernels' nvcc build (``build_s``) and the
warm-up run before the timed window, and the line carries each kernel's
launches in the timed window (``launches``, with the int8 projections'
calls under ``int8_matmul``) and what the built model runs (``mlp_tail``,
``int8``, ``token_merge``: ``presets.model_switches``), as the train line
does.

Env knobs (as ``bench.py``): BENCH_MODEL (feature | point | pose |
pose_only), BENCH_WIDTH / BENCH_OVERLAP (5 / 1), BENCH_CHUNKS (timed chunks,
24), BENCH_ASPECT (0.3), BENCH_SMALL=1 (the small model at width 224),
BENCH_ENCODE_BATCH (default ``max(1, (16 if H <= 300 else 8) * 5 //
width)``), BENCH_TRAIN=1 (the train scenario, ``vitslam_tpu_torch.train_bench``
at bucket 20:5) and BENCH_TRAIN_STEPS (3). The model switches, read by
the presets when the model is built, in every scenario and the train one:
VITSLAM_TOKEN_MERGE ("<pool>,<stride>", the flagship models only) puts
the KV merge on the global attention, as the JAX bench's token-merge
sweep does (``scripts/tpu_batch_r4.sh``); VITSLAM_MLP_TAIL (1 | mlp |
proj) routes the backbone blocks' residual tails through K5;
VITSLAM_INT8=1 runs their projections int8 (and then no tail is fused).
Setting any of BENCH_MODEL, BENCH_ASPECT, BENCH_WIDTH, BENCH_OVERLAP,
BENCH_SMALL or BENCH_TRAIN runs that one scenario and prints one JSON line
``{"metric", "value", "unit", "vs_baseline", ...}``; with none set the SUITE runs, each scenario in a
subprocess, and after every scenario the cumulative line ``{"metric",
"value", "unit", "vs_baseline", "all_metrics"}`` is printed (the last line
holds everything finished so far). BENCH_BUDGET_S bounds the whole suite:
the scenarios it leaves no time for are skipped with a note, and the run
exits 0.

Inference ``vs_baseline`` is against the PyTorch reference's GPU rates from
its README (feature-aligned 19 FPS, point- and pose-aligned 15 FPS). The
reference publishes no train rate, so the train line's ``vs_baseline`` is
null. The run needs CUDA unless ``--device cpu`` is given (the tests' small
runs); without it the bench exits 2 and never falls back to the CPU.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

# the PyTorch reference's README: feature-aligned 19 FPS (~12 GB GPU);
# point- and pose-aligned 15 FPS (24 GB GPU, chunk 75 / overlap 30)
BASELINE_FPS = {"feature": 19.0, "point": 15.0, "pose": 15.0, "pose_only": 15.0}

# (tag, env overrides), as bench.py's SUITE
SUITE = [
    ("feature_5_1", {"BENCH_MODEL": "feature"}),
    ("point_75_30", {"BENCH_MODEL": "point", "BENCH_WIDTH": "75",
                     "BENCH_OVERLAP": "30", "BENCH_CHUNKS": "8"}),
    ("pose_75_30", {"BENCH_MODEL": "pose", "BENCH_WIDTH": "75",
                    "BENCH_OVERLAP": "30", "BENCH_CHUNKS": "8"}),
    ("square_stress", {"BENCH_MODEL": "feature", "BENCH_ASPECT": "1.0",
                       "BENCH_CHUNKS": "16"}),
    ("train_w20_o5", {"BENCH_TRAIN": "1"}),
]
SINGLE_KNOBS = ("BENCH_MODEL", "BENCH_ASPECT", "BENCH_WIDTH", "BENCH_OVERLAP", "BENCH_SMALL",
                "BENCH_TRAIN")
SCENARIO_TIMEOUT_S = 3600
TRAIN_METRIC = "feature_aligned_train_sec_per_step_w20_o5_518x154"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def metric_name(variant: str, width: int, overlap: int, W: int, H: int) -> str:
    return "%s_aligned_inference_fps_chunk%d_ovl%d_%dx%d" % (variant, width, overlap, W, H)


def settings(env=os.environ) -> dict:
    """One scenario's shape and knobs from the environment."""
    from .data.preprocess import get_target_shape

    small = env.get("BENCH_SMALL", "0") == "1"
    variant = env.get("BENCH_MODEL", "feature")
    width = int(env.get("BENCH_WIDTH", 5))
    overlap = int(env.get("BENCH_OVERLAP", 1))
    W = 224 if small else 518
    H = int(get_target_shape(float(env.get("BENCH_ASPECT", 0.3)), W, 14)[0])
    # 16 at the wide aspect, 8 at the square one (~3.3x the tokens a frame),
    # scaled down with the chunk width (bench.py:234)
    default_eb = max(1, (16 if H <= 300 else 8) * 5 // width)
    return dict(small=small, variant=variant, width=width, overlap=overlap, W=W, H=H,
                n_timed=int(env.get("BENCH_CHUNKS", 24)),
                encode_batch=int(env.get("BENCH_ENCODE_BATCH", default_eb)),
                metric=metric_name(variant, width, overlap, W, H))


def card() -> str:
    """The card's name and power limit (nvidia-smi), or why there is none."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "nvidia-smi failed"
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi not available"


def require_device(name: str):
    """The torch device to run on; exits 2 when CUDA is asked for and missing."""
    import torch

    if name == "cpu":
        return torch.device("cpu")
    if not name.startswith("cuda"):
        raise SystemExit(f"--device must be cuda or cpu, got {name!r}")
    if not torch.cuda.is_available():
        sys.stderr.write("vitslam_tpu_torch.bench: torch.cuda.is_available() is False; the "
                         "bench runs on the GPU (--device cpu only for small test runs)\n")
        sys.exit(2)
    return torch.device(name)


def build_kernels(device) -> float:
    """Seconds to build (or find built) the CUDA kernels; 0 on the CPU."""
    if device.type != "cuda":
        return 0.0
    from .ops import cuda_build

    t0 = time.perf_counter()
    cuda_build.build_all()
    return time.perf_counter() - t0


def _model(s: dict, device):
    from .models import presets

    if s["small"]:
        return presets.small_feature_aligned(device=device)
    build = {"point": presets.flagship_point_aligned, "pose": presets.flagship_pose_aligned,
             "pose_only": presets.flagship_pose_only}.get(s["variant"], presets.flagship)
    return build(device=device)


def run_inference(device, env=os.environ) -> dict:
    """Time one inference scenario; returns its metric line."""
    import torch

    from .models import presets
    from .slam import ChunkedPipeline

    s = settings(env)
    width, overlap, eb = s["width"], s["overlap"], s["encode_batch"]
    build_s = build_kernels(device)
    t0 = time.perf_counter()
    model = _model(s, device)
    g = torch.Generator(device=device).manual_seed(0)
    images = torch.rand((1, width, 3, s["H"], s["W"]), generator=g, device=device)
    group_images = torch.rand((eb, width, 3, s["H"], s["W"]), generator=g, device=device)
    pipe = ChunkedPipeline(model, encode_batch=eb)
    init_s = time.perf_counter() - t0

    def fence():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    pipelined = eb > 1 and hasattr(model, "encode_chunks")
    shape = tuple(images.shape)

    def run_group(state):
        """Encode ``eb`` chunks at once, then align them in order."""
        raw = model.encode_chunks(group_images)
        outputs = None
        for k in range(eb):
            outputs, state = model.align_chunk({key: v[k:k + 1] for key, v in raw.items()},
                                               shape, overlap, state)
        return outputs, state

    with torch.inference_mode():
        t0 = time.perf_counter()
        if pipelined:  # the first chunk's trace, then a continued group
            raw = model.encode_chunks(group_images)
            _, state = model.align_chunk({k: v[:1] for k, v in raw.items()}, shape, overlap,
                                         None)
            del raw
            fence()
            _, state = run_group(state)
            fence()
        else:
            state = None
            for _ in range(3):
                _, state = pipe.step(images, overlap, state)
                fence()
        warmup_s = time.perf_counter() - t0

        n_timed = s["n_timed"]
        counters = launch_counters()
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        if pipelined:
            n_groups = max(1, n_timed // eb)
            for _ in range(n_groups):
                _, state = run_group(state)
                fence()
            n_timed = n_groups * eb
        else:
            for _ in range(n_timed):
                _, state = pipe.step(images, overlap, state)
                fence()
        elapsed = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}

    fps = n_timed * (width - overlap) / elapsed
    return {"metric": s["metric"], "value": round(fps, 3), "unit": "frames/sec",
            "vs_baseline": round(fps / BASELINE_FPS.get(s["variant"], 19.0), 3),
            "chunks_per_s": round(n_timed / elapsed, 4), "timed_chunks": n_timed,
            "encode_batch": eb, "build_s": round(build_s, 2), "init_s": round(init_s, 2),
            "warmup_s": round(warmup_s, 2), "timed_s": round(elapsed, 3), "launches": launches,
            **presets.model_switches(model),
            "device": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"}


def launch_counters() -> dict:
    """The kernels' wrappers and the int8 projection by name; each counts
    its launches in ``.launches``."""
    from .ops.flash_attention import flash_attention, flash_attention_backward, flash_attention_lse
    from .ops.fused_attention import flat_flash_attention, fused_qkv_attention, qk_prep
    from .ops.mlp_tail import mlp_tail
    from .ops.quant import int8_matmul

    fns = (fused_qkv_attention, qk_prep, flat_flash_attention, flash_attention,
           flash_attention_lse, flash_attention_backward, mlp_tail, int8_matmul)
    return {fn.__name__: fn for fn in fns}


def _json_lines(text: str):
    for ln in text.splitlines():
        ln = ln.strip()
        if ln.startswith("{"):
            try:
                yield json.loads(ln)
            except json.JSONDecodeError:
                pass


def run_train(device, env=os.environ) -> dict:
    """The train scenario: ``train_bench`` at bucket 20:5 in a subprocess."""
    steps = env.get("BENCH_TRAIN_STEPS", "3")
    cmd = [sys.executable, "-m", "vitslam_tpu_torch.train_bench", "--steps", steps,
           "--buckets", "20:5", "--descent-steps", "0", "--device", str(device)]
    r = subprocess.run(cmd, capture_output=True, text=True, timeout=SCENARIO_TIMEOUT_S,
                       env=_child_env(env), cwd=REPO)
    row = next((ln for ln in _json_lines(r.stdout) if "sec_per_step" in ln), None)
    if row is None:
        sys.stderr.write(f"vitslam_tpu_torch.bench[train]: train_bench failed "
                         f"(rc={r.returncode}):\n" + r.stderr[-1500:] + "\n")
        sys.exit(1)
    sys.stderr.write(f"# train_bench: {json.dumps(row)}\n")
    return {"metric": TRAIN_METRIC, "value": row["sec_per_step"], "unit": "sec/step",
            "vs_baseline": None, **{k: row[k] for k in ("frames_per_sec", "compile_s", "build_s",
                                                          "objective", "mlp_tail", "int8",
                                                          "token_merge") if k in row}}


def _child_env(env) -> dict:
    path = env.get("PYTHONPATH", "")
    return dict(env, PYTHONPATH=REPO + (os.pathsep + path if path else ""))


def run_scenario_subprocess(tag: str, overrides: dict, device: str, timeout: float):
    """One SUITE scenario in its own process; (metric line or None, rc,
    stderr tail). Raises subprocess.TimeoutExpired past ``timeout``."""
    env = _child_env(dict(os.environ, **overrides))
    r = subprocess.run([sys.executable, "-m", "vitslam_tpu_torch.bench", "--device", device],
                       env=env, capture_output=True, text=True, timeout=timeout, cwd=REPO)
    line = None
    for line in _json_lines(r.stdout):
        pass
    return line, r.returncode, r.stderr[-1500:]


def combined(results: list) -> dict:
    """The cumulative line: the first finished scenario as the headline
    (feature 5/1 when it ran), every scenario's entry in all_metrics."""
    ok = [r for r in results if "error" not in r and "skipped" not in r]
    head = ok[0] if ok else {}
    return {"metric": head.get("metric"), "value": head.get("value"), "unit": head.get("unit"),
            "vs_baseline": head.get("vs_baseline"), "all_metrics": results}


def run_suite(device: str, suite=SUITE, budget_s: float = 0.0, runner=run_scenario_subprocess,
              out=sys.stdout) -> int:
    """Every scenario in turn; the cumulative line after each. ``budget_s``
    > 0 bounds the whole run: a scenario that would start past it, or that
    it cuts short, is recorded as skipped. Returns the exit code: 2 when no
    scenario produced its metric, else 0."""
    t_start = time.time()
    results = []
    for tag, overrides in suite:
        timeout = SCENARIO_TIMEOUT_S
        if budget_s > 0:
            left = budget_s - (time.time() - t_start)
            if left <= 0:
                results.append({"scenario": tag, "skipped": f"budget: {budget_s:g} s spent "
                                f"before it started"})
                print(json.dumps(combined(results)), file=out, flush=True)
                continue
            timeout = min(timeout, left)
        t0 = time.time()
        try:
            line, rc, err = runner(tag, overrides, device, timeout)
        except subprocess.TimeoutExpired:
            if timeout < SCENARIO_TIMEOUT_S:
                entry = {"scenario": tag, "skipped": f"budget: cut after {time.time() - t0:.1f} "
                         f"s, {budget_s:g} s spent"}
            else:
                entry = {"scenario": tag, "error": "timeout"}
            sys.stderr.write(f"vitslam_tpu_torch.bench[suite]: scenario {tag}: {entry}\n")
            results.append(entry)
            print(json.dumps(combined(results)), file=out, flush=True)
            continue
        if line is None or "metric" not in line:
            sys.stderr.write(f"vitslam_tpu_torch.bench[suite]: scenario {tag} failed "
                             f"(rc={rc}):\n{err}\n")
            results.append({"scenario": tag, "error": f"rc={rc}"})
        else:
            line = dict(line, scenario=tag, wall_s=round(time.time() - t0, 1))
            results.append(line)
            sys.stderr.write(f"# suite {tag}: {json.dumps(line)}\n")
        print(json.dumps(combined(results)), file=out, flush=True)
    if not any("error" not in r and "skipped" not in r for r in results):
        sys.stderr.write("vitslam_tpu_torch.bench[suite]: no scenario produced its metric\n")
        return 2
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (small test runs only)")
    args = ap.parse_args(argv)
    device = require_device(args.device)
    if device.type == "cuda":
        sys.stderr.write(f"# card: {card()}\n")
    if not any(os.environ.get(k) for k in SINGLE_KNOBS):
        return run_suite(args.device, budget_s=float(os.environ.get("BENCH_BUDGET_S", 0) or 0))
    if os.environ.get("BENCH_TRAIN"):
        result = run_train(device)
    else:
        result = run_inference(device)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
