"""Port parity for the hooks: the opt-in NaN/Inf checks (utils/debug.py),
the profiling hooks (utils/profiling.py) and the viser viewer's host-side
preparation (viz/viser_viz.py), against the JAX package's on the same
inputs (tests/test_utils.py's and tests/test_viz.py's cases)."""
import json
import logging
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from vitslam_tpu.utils import debug as jdebug  # noqa: E402
from vitslam_tpu.utils import profiling as jprof  # noqa: E402
from vitslam_tpu.viz import viser_viz as jviz  # noqa: E402
from vitslam_tpu_torch.eval import Metrics  # noqa: E402
from vitslam_tpu_torch.utils import debug, profiling  # noqa: E402
from vitslam_tpu_torch.viz import viser_viz as tviz  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the point cloud is fp32 unprojection on both sides (K^-1 by another
# solver): elementwise relative 1e-5, tests/test_viz.py's tolerance
VIZ_RTOL = 1e-5


@pytest.fixture
def nan_checks():
    yield
    debug.enable_nan_checks(False)
    jdebug.enable_nan_checks(False)


def _messages(caplog):
    return [r.getMessage() for r in caplog.records if "NaN/Inf" in r.getMessage()]


def test_nan_check_reports_what_jax_reports(caplog, nan_checks):
    x = np.asarray([1.0, np.nan, 2.0, np.inf], np.float32)
    tree = {"a": x, "b": [np.ones(3, np.float32), np.asarray([np.nan], np.float32)]}
    debug.enable_nan_checks(True)
    jdebug.enable_nan_checks(True)
    with caplog.at_level(logging.WARNING):
        got = debug.nan_check(jax.tree.map(torch.tensor, tree), "probe")
        assert torch.isnan(got["a"][1])
        port = _messages(caplog)
        caplog.clear()
        jax.block_until_ready(jax.jit(lambda t: jdebug.nan_check(t, "probe"))(
            jax.tree.map(jnp.asarray, tree)))
        ref = _messages(caplog)
    assert port == ref == ["NaN/Inf detected in probe[0]: 2 bad elements",
                           "NaN/Inf detected in probe[2]: 1 bad elements"]


def test_nan_check_raises_when_asked(nan_checks):
    debug.enable_nan_checks(True, raise_on_nan=True)
    assert debug.nan_checks_enabled()
    with pytest.raises(FloatingPointError, match="probe"):
        debug.nan_check(torch.tensor([0.0, float("nan")]), "probe")
    ints = torch.tensor([1, 2])  # non-floating leaves are not checked
    assert debug.nan_check(ints) is ints


def test_nan_check_off_does_no_work(monkeypatch):
    """Off (the default), the check returns its argument and touches no
    tensor: no launch, no host sync."""
    assert not debug.nan_checks_enabled()
    monkeypatch.setattr(torch, "isfinite", lambda t: pytest.fail("checked while off"))
    x = torch.tensor([float("nan")])
    assert debug.nan_check(x, "quiet") is x


def test_nan_switches_are_read_at_import():
    code = ("from vitslam_tpu_torch.utils import debug\n"
            "assert debug.nan_checks_enabled() and debug._RAISE\n")
    env = dict(os.environ, PYTHONPATH=ROOT, VITSLAM_DEBUG_NANS="1",
               VITSLAM_DEBUG_NANS_RAISE="1")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_chunk_timer_summary_matches_jax():
    fences = []
    port = profiling.ChunkTimer(fence=lambda: fences.append(1))
    ref = jprof.ChunkTimer()
    for t in (port, ref):
        for _ in range(3):
            with t.chunk(new_frames=4):
                pass
    got, want = port.summary(), ref.summary()
    assert list(got) == list(want)
    assert got["chunks"] == want["chunks"] == 3 and got["frames"] == want["frames"] == 12
    assert got["frames_per_sec"] > 0 and fences == [1, 1, 1]
    # the default fence waits for the card, and a CPU timer has none
    assert profiling.ChunkTimer().fence is torch.cuda.synchronize
    assert profiling.ChunkTimer(device="cpu").fence is None
    port.reset()
    assert port.summary()["chunks"] == 0 and port.frames_per_sec == 0.0


def test_trace_holds_the_annotated_ranges(tmp_path):
    with profiling.trace(str(tmp_path / "t")) as log_dir:
        with profiling.annotate("encode"):
            torch.ones(64, 64) @ torch.ones(64, 64)
        with profiling.annotate("align"):
            torch.ones(8).sum()
    assert log_dir == str(tmp_path / "t")
    with open(os.path.join(log_dir, "trace.json")) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"encode", "align"} <= names


def _fake_scene(S=3, H=8, W=10):
    """tests/test_viz.py's scene."""
    rng = np.random.default_rng(0)
    f = 0.9 * W
    intr = np.stack([np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1]])] * S)
    extr = np.stack([np.eye(4)[:3] for _ in range(S)])
    for i in range(S):
        extr[i, 0, 3] = 0.1 * i
    return {
        "images": rng.uniform(0, 1, (S, 3, H, W)).astype(np.float32),
        "extrinsic": extr.astype(np.float32),
        "intrinsic": intr.astype(np.float32),
        "depth": rng.uniform(2, 20, (S, H, W, 1)).astype(np.float32),
        "depth_conf": rng.uniform(0, 5, (S, H, W)).astype(np.float32),
        "world_points": rng.normal(0, 5, (S, H, W, 3)).astype(np.float32),
        "world_points_conf": rng.uniform(0, 5, (S, H, W)).astype(np.float32),
    }


@pytest.mark.parametrize("source", ["depth", "world_points"])
def test_build_point_cloud_matches_jax(source):
    d = _fake_scene()
    if source == "world_points":
        del d["depth"], d["depth_conf"]
    got = tviz.build_point_cloud(d)
    want = jviz.build_point_cloud(d)
    n = 3 * 8 * 10
    for g, w in zip(got, want):
        assert g.shape == np.asarray(w).shape and g.shape[0] == n
        np.testing.assert_allclose(g, w, rtol=VIZ_RTOL, atol=1e-6)
    if source == "depth":  # identity-rotation camera: unprojected z == depth
        np.testing.assert_allclose(got[0][:80, 2], d["depth"][0, ..., 0].reshape(-1), rtol=1e-5)


def test_sky_mask_multiplies_confidences():
    conf = np.arange(2 * 2 * 3, dtype=np.float32) + 1
    masks = [np.asarray([[0, 40, 31], [32, 255, 10]]), np.full((2, 3), 100)]
    got = tviz.sky_mask_confidence(conf, masks)
    want = conf.reshape(2, 2, 3) * np.stack([(m >= 32) for m in masks])
    np.testing.assert_array_equal(got, want.reshape(-1))
    assert got.shape == conf.shape and conf[0] == 1  # the input stays as it was


def test_viewer_and_visualize_sequence_raise_without_viser(monkeypatch):
    monkeypatch.setitem(sys.modules, "viser", None)
    monkeypatch.setitem(sys.modules, "onnxruntime", None)
    with pytest.raises(ImportError, match="viser is not installed"):
        tviz.viser_wrapper(_fake_scene())
    with pytest.raises(ImportError, match="viser is not installed"):
        Metrics(visualize=True).visualize_sequence(None, None)
    with pytest.raises(ImportError, match="onnxruntime"):
        tviz.run_sky_segmentation(np.zeros((1, 3, 4, 4)), np.zeros(16))


def test_viz_dict_feeds_the_point_cloud():
    """The orchestrator's marshalling (pose encoding -> extrinsic,
    intrinsic) into build_point_cloud, as visualize_sequence runs it."""
    scene = _fake_scene()
    rng = np.random.default_rng(1)
    preds = {"pose_enc": rng.normal(0, 0.1, (1, 3, 9)).astype(np.float32),
             "images": scene["images"][None], "depth": scene["depth"][None],
             "depth_conf": scene["depth_conf"][None]}
    seq = {"images": scene["images"][None]}
    vd = Metrics._viz_dict(preds, seq)
    assert vd["extrinsic"].shape == (3, 3, 4) and vd["intrinsic"].shape == (3, 3, 3)
    pts, colors, conf, idx = tviz.build_point_cloud(vd)
    assert pts.shape == (240, 3) and np.isfinite(pts).all() and idx.max() == 2
