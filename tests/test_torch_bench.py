"""The port's benchmark (vitslam_tpu_torch/bench.py, train_bench.py) against
the JAX package's bench.py, on the CPU:

* the SUITE, and each scenario's H, encode batch and metric name, equal
  what bench.py gives (its module-level names imported, its encode-batch
  expression and metric format read from its source; bench.py imports no
  JAX at module level), and the baselines are bench.py's inference ones
  (the train line carries none);
* a ``BENCH_SMALL=1 --device cpu`` run with 2 timed chunks, and a small
  ``train_bench --device cpu`` run, print their JSON lines with the right
  keys (the small preset at test widths, ``tiny_small_preset``);
* the model switches VITSLAM_MLP_TAIL / VITSLAM_INT8 reach the bench's and
  train_bench's models, and the bench line names what the built model ran
  (tails and int8 projections counted in the timed window);
* the suite prints the cumulative line after every scenario, records a
  failure, a timeout and the scenarios a budget cuts or skips, exits 0 when
  one scenario ran and 2 when none did;
* without CUDA the bench and train_bench exit 2 unless ``--device cpu``."""
import io
import json
import os
import re
import subprocess
import sys
import time

import pytest
import torch

from vitslam_tpu.data.preprocess import get_target_shape as jax_target_shape
from vitslam_tpu_torch import bench, train_bench
from vitslam_tpu_torch import train as port_train
from vitslam_tpu_torch.models import presets
from vitslam_tpu_torch.nn import layers as tl

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import bench as jbench  # noqa: E402  (the JAX package's bench.py; no JAX at import)
from torch_weights import shared_jax_cache  # noqa: E402,F401

SRC = open(os.path.join(ROOT, "bench.py")).read()
EB_EXPR = re.search(r"default_eb = (.+)\n", SRC).group(1)
METRIC_FMT = eval(re.search(r'"metric": ("%s_aligned[^"]+")', SRC).group(1))
TRAIN_METRIC = re.search(r'"metric": "(feature_aligned_train[^"]+)"', SRC).group(1)
TINY = dict(embed_dim=64, depth=2, num_heads=4, patch_embed_depth=1,
            intermediate_layers=(0, 1, 1, 1), align_embed_dim=64, align_dec_dim=32,
            num_memory_tokens=4, enable_point=False)


def test_suite_and_knobs_equal_bench_py():
    assert bench.SUITE == jbench.SUITE
    assert bench.BASELINE_FPS == jbench.BASELINE_FPS
    assert bench.TRAIN_METRIC == TRAIN_METRIC
    assert "TRAIN_BASELINE_SEC_PER_STEP" not in vars(bench)
    for tag, overrides in bench.SUITE:
        if "BENCH_TRAIN" in overrides:
            continue
        got = bench.settings(overrides)
        width = int(overrides.get("BENCH_WIDTH", 5))
        H = int(jax_target_shape(float(overrides.get("BENCH_ASPECT", 0.3)), 518, 14)[0])
        assert got["H"] == H and got["W"] == 518, tag
        assert got["encode_batch"] == eval(EB_EXPR, {"H": H, "width": width}), tag
        assert got["n_timed"] == int(overrides.get("BENCH_CHUNKS", 24)), tag
        assert got["metric"] == METRIC_FMT % (overrides["BENCH_MODEL"], width,
                                              int(overrides.get("BENCH_OVERLAP", 1)), 518, H)
    assert [bench.settings(o)["encode_batch"] for _, o in bench.SUITE[:4]] == [16, 1, 1, 8]
    assert bench.settings(bench.SUITE[3][1])["H"] == 518  # square_stress


@pytest.fixture
def tiny_small_preset(monkeypatch):
    """The small preset at test widths: its 243M parameters take ~10 s to
    initialise on the CPU and ~4 cores for ~25 s to run; the bench's and
    train_bench's logic is the same at any width."""
    real = presets.small_feature_aligned

    def tiny(device="cuda", seed=0, **kw):
        return real(device=device, seed=seed, **dict(TINY, **kw))

    monkeypatch.setattr(presets, "small_feature_aligned", tiny)


def test_small_cpu_scenario_prints_its_line(monkeypatch, capsys, tiny_small_preset):
    for k, v in dict(BENCH_SMALL="1", BENCH_CHUNKS="2", BENCH_ENCODE_BATCH="2").items():
        monkeypatch.setenv(k, v)
    assert bench.main(["--device", "cpu"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["metric"] == METRIC_FMT % ("feature", 5, 1, 224, 70)
    assert line["unit"] == "frames/sec" and line["value"] > 0
    assert line["vs_baseline"] == round(line["value"] / 19.0, 3)
    assert line["timed_chunks"] == 2 and line["encode_batch"] == 2
    assert line["build_s"] == 0.0 and line["device"] == "cpu"
    assert (line["mlp_tail"], line["int8"], line["token_merge"]) == ("off", False, "off")
    assert line["launches"]["int8_matmul"] == 0


def test_small_cpu_train_bench_prints_its_lines(capsys, tiny_small_preset):
    assert train_bench.main(["--device", "cpu", "--small", "--steps", "1", "--buckets", "3:1",
                             "--descent-steps", "1"]) == 0
    rows = [json.loads(ln) for ln in capsys.readouterr().out.strip().splitlines()]
    assert set(rows[0]) == {"bucket", "sec_per_step", "steps_per_sec", "frames_per_step",
                            "frames_per_sec", "compile_s", "build_s", "objective", "mlp_tail",
                            "int8", "token_merge"}
    assert (rows[0]["mlp_tail"], rows[0]["int8"], rows[0]["token_merge"]) == ("off", False, "off")
    assert rows[0]["bucket"] == "w3_o1" and rows[0]["frames_per_step"] == 5
    assert len(rows[1]["descent_objectives"]) == 2
    assert all(v == v and abs(v) < 1e9 for v in rows[1]["descent_objectives"])


# the tiny small preset's fused-tail blocks: 1 patch-embed + 2 frame/global pairs
TINY_BLOCKS = 1 + 2 * 2


@pytest.mark.parametrize("env,switches,k5,int8", [
    ({"VITSLAM_MLP_TAIL": "1"}, ("both", False), 2 * TINY_BLOCKS, 0),
    ({"VITSLAM_MLP_TAIL": "1", "VITSLAM_INT8": "1"}, ("off", True), 0, 4 * TINY_BLOCKS),
], ids=["tails", "int8"])
def test_small_cpu_scenario_names_its_switches(monkeypatch, capsys, tiny_small_preset, env,
                                               switches, k5, int8):
    """Under the switches the small scenario's line names what its model
    ran, read from the model (int8 beats the tails), and its timed window
    (one encode of 3 chunks: 1,275 rows a block, past the 1,024-row gate)
    counts 2 tail sites a block, or 4 int8 projections a block and no tail.
    The CPU runs the tail's plain version, so its calls are counted here
    where the card's wrapper counts its launches."""
    for k, v in dict(BENCH_SMALL="1", BENCH_CHUNKS="3", BENCH_ENCODE_BATCH="3", **env).items():
        monkeypatch.setenv(k, v)
    real = tl.mlp_tail

    def counted(*a, **k):
        real.launches += 1
        return real(*a, **k)

    monkeypatch.setattr(tl, "mlp_tail", counted)
    assert bench.main(["--device", "cpu"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert (line["mlp_tail"], line["int8"], line["token_merge"]) == (*switches, "off")
    assert line["timed_chunks"] == 3 and line["value"] > 0
    assert line["launches"]["mlp_tail"] == k5 and line["launches"]["int8_matmul"] == int8


@pytest.mark.parametrize("variant", ["feature", "point", "pose", "pose_only", "small"])
@pytest.mark.parametrize("env,want", [({"VITSLAM_MLP_TAIL": "proj"}, ("proj", False)),
                                      ({"VITSLAM_INT8": "1"}, ("off", True))],
                         ids=["proj", "int8"])
def test_bench_models_follow_the_switches(monkeypatch, variant, env, want):
    """bench._model builds every scenario's preset (at its own widths, on
    meta here) under the switches."""
    knobs = {"BENCH_SMALL": "1"} if variant == "small" else {"BENCH_MODEL": variant}
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    got = presets.model_switches(bench._model(bench.settings(knobs), "meta"))
    assert (got["mlp_tail"], got["int8"], got["token_merge"]) == (*want, "off")


class _Built(Exception):
    pass


def test_train_bench_model_follows_the_switches(monkeypatch, tiny_small_preset):
    """train_bench's model is built under both switches: its blocks carry
    the mlp tail site and run their projections int8 (stopped before its
    first step; test_small_cpu_train_bench_prints_its_lines holds the
    line's keys)."""
    monkeypatch.setenv("VITSLAM_MLP_TAIL", "mlp")
    monkeypatch.setenv("VITSLAM_INT8", "1")
    built = []

    def stop(model, patterns):
        built.append(model)
        raise _Built

    monkeypatch.setattr(port_train, "freeze_params", stop)
    with pytest.raises(_Built):
        train_bench.main(["--device", "cpu", "--small"])
    blocks = [m for m in built[0].modules() if isinstance(m, tl.Block)
              and m.tail_sites == {"mlp"}]
    assert len(blocks) == TINY_BLOCKS and all(b.attn.qkv.int8 for b in blocks)
    assert presets.model_switches(built[0]) == dict(mlp_tail="off", int8=True, token_merge="off")


def _runner(script: dict):
    """A scenario runner that replays ``script[tag]``: a metric line, an
    exception to raise, or None (a failed run)."""
    def run(tag, overrides, device, timeout):
        got = script[tag]
        if isinstance(got, BaseException):
            raise got
        return got, (0 if got else 1), "stderr tail"
    return run


def _lines(buf: io.StringIO):
    return [json.loads(ln) for ln in buf.getvalue().strip().splitlines()]


def test_suite_prints_the_cumulative_line_after_every_scenario():
    suite = [("a", {}), ("b", {}), ("c", {}), ("d", {})]
    line = {"metric": "m_a", "value": 1.5, "unit": "frames/sec", "vs_baseline": 0.1}
    script = {"a": None, "b": line, "c": subprocess.TimeoutExpired("x", 3600),
              "d": dict(line, metric="m_d")}
    buf = io.StringIO()
    assert bench.run_suite("cpu", suite, runner=_runner(script), out=buf) == 0
    lines = _lines(buf)
    assert len(lines) == 4
    for n, ln in enumerate(lines, 1):
        assert set(ln) == {"metric", "value", "unit", "vs_baseline", "all_metrics"}
        assert [e["scenario"] for e in ln["all_metrics"]] == ["a", "b", "c", "d"][:n]
    assert lines[0]["metric"] is None and lines[0]["all_metrics"][0]["error"] == "rc=1"
    assert lines[-1]["metric"] == "m_a" and lines[-1]["value"] == 1.5
    assert lines[-1]["all_metrics"][2] == {"scenario": "c", "error": "timeout"}


def test_suite_budget_cuts_and_skips_with_a_note():
    suite = [("a", {}), ("b", {}), ("c", {})]
    line = {"metric": "m_a", "value": 2.0, "unit": "frames/sec", "vs_baseline": 0.1}
    seen = []

    def runner(tag, overrides, device, timeout):
        seen.append((tag, timeout))
        if tag == "a":
            return line, 0, ""
        time.sleep(timeout)  # b runs into the budget
        raise subprocess.TimeoutExpired("x", timeout)

    buf = io.StringIO()
    assert bench.run_suite("cpu", suite, budget_s=0.5, runner=runner, out=buf) == 0
    lines = _lines(buf)
    last = lines[-1]["all_metrics"]
    assert len(lines) == 3 and [e["scenario"] for e in last] == ["a", "b", "c"]
    assert "budget: cut after" in last[1]["skipped"] and "error" not in last[1]
    assert "before it started" in last[2]["skipped"]
    assert [t for t, _ in seen] == ["a", "b"] and all(0 < t <= 0.5 for _, t in seen)
    assert lines[-1]["metric"] == "m_a"


def test_suite_with_no_metric_exits_2():
    buf = io.StringIO()
    assert bench.run_suite("cpu", [("a", {})], runner=_runner({"a": None}), out=buf) == 2


@pytest.mark.parametrize("main", [lambda: bench.main([]),
                                  lambda: train_bench.main(["--small"])],
                         ids=["bench", "train_bench"])
def test_no_cuda_exits_2(main, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setenv("BENCH_SMALL", "1")
    with pytest.raises(SystemExit) as exit_:
        main()
    out = capsys.readouterr()
    assert exit_.value.code == 2 and "torch.cuda.is_available() is False" in out.err
    assert out.out == ""
