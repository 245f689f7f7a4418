"""The port's learning-loop demo (vitslam_tpu_torch/learning_loop_demo.py,
port of scripts/learning_loop_demo.py) and its fixture writer
(vitslam_tpu_torch/utils/fixtures.py, numpy only): ``graft_backbone``
grafts what the script's grafts, the writer's files are the reference's
byte for byte, and a 2-step run on the CPU writes a report of finite
metrics outside docs/."""
import hashlib
import importlib.util
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from vitslam_tpu.utils import fixtures as jfixtures  # noqa: E402
from vitslam_tpu_torch import learning_loop_demo as demo  # noqa: E402
from vitslam_tpu_torch.io.checkpoint import CheckpointManager  # noqa: E402
from vitslam_tpu_torch.models import FeatureAlignedVGGT, PointAlignedVGGT  # noqa: E402
from vitslam_tpu_torch.utils import fixtures  # noqa: E402
from torch_weights import shared_jax_cache  # noqa: E402,F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(img_size=28, embed_dim=64, depth=2, num_heads=2, patch_embed_depth=1,
            intermediate_layers=(0, 1, 1, 1), enable_point=True)


def _script():
    spec = importlib.util.spec_from_file_location(
        "learning_loop_demo_script", os.path.join(ROOT, "scripts", "learning_loop_demo.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _shapes(model, mark: int) -> dict:
    """name -> a read-only array of the parameter's shape, filled with
    ``mark`` (no memory: the models live on the meta device)."""
    return {n: np.broadcast_to(np.float32(mark), tuple(p.shape))
            for n, p in model.named_parameters()}


def _nest(flat: dict) -> dict:
    tree: dict = {}
    for name, v in flat.items():
        *path, leaf = name.split(".")
        node = tree
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = v
    return tree


def _flat(tree: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def test_graft_backbone_matches_the_script():
    """On the demo's feature-aligned (source) and point-aligned
    (destination) models, the port's graft copies what the script's
    recursive graft copies and reports the same shared modules."""
    src = _shapes(FeatureAlignedVGGT(**TINY, num_memory_tokens=4, device="meta"), 1)
    dst = _shapes(PointAlignedVGGT(**TINY, device="meta"), 2)
    dst["core.extra.weight"] = np.zeros(3)  # a module only the destination has keeps its init
    want, want_shared = _script().graft_backbone({"params": _nest(dst)}, {"params": _nest(src)})
    got, shared = demo.graft_backbone(dst, src)
    want = _flat(want["params"])
    assert shared == want_shared == ["core"] and sorted(got) == sorted(want) == sorted(dst)
    assert all(got[n] is want[n] for n in got)
    assert sum(got[n] is src.get(n) for n in got) == len(dst) - 1
    assert got["core.extra.weight"] is dst["core.extra.weight"]
    with pytest.raises(ValueError, match="shape differs"):
        demo.graft_backbone({"core.w": np.zeros(2)}, {"core.w": np.zeros(3)})


@pytest.mark.parametrize("hw,frames", [((56, 84), 3), ((29, 43), 2)],
                         ids=["demo-size", "odd-size"])
def test_fixture_writer_files_equal_the_reference(hw, frames, tmp_path):
    """The numpy writer's JPEGs, PNGs and text files are the bytes the
    reference writes through OpenCV."""
    pytest.importorskip("cv2")
    kw = dict(scene="02", n_frames=frames, hw=hw, seed=3)
    jfixtures.write_vkitti_fixture(str(tmp_path / "ref"), **kw)
    fixtures.write_vkitti_fixture(str(tmp_path / "port"), **kw)
    files = sorted(os.path.relpath(os.path.join(d, f), tmp_path / "ref")
                   for d, _, fs in os.walk(tmp_path / "ref") for f in fs)
    assert len(files) == 2 * frames + 2
    for f in files:
        assert (tmp_path / "port" / f).read_bytes() == (tmp_path / "ref" / f).read_bytes(), f


def test_two_step_cpu_run_writes_a_report(tmp_path, monkeypatch):
    """Two training steps and the four evaluations on the CPU (a shorter
    fixture, no checkpoint written, matplotlib blocked, so no plots): every
    ATE, RPE and Chamfer of the four rows finite, the report under the
    workdir with the JAX report's deltas beside the port's,
    docs/LEARNING_LOOP_DEMO.md untouched (and refused as the report's
    path)."""
    jax_report = os.path.join(ROOT, "docs", "LEARNING_LOOP_DEMO.md")
    before = hashlib.sha256(open(jax_report, "rb").read()).hexdigest()
    with pytest.raises(SystemExit, match="JAX package's report"):
        demo.main(["--device", "cpu", "--report", jax_report, "--workdir", str(tmp_path / "x")])
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    monkeypatch.setattr(demo, "SCENE_FRAMES", (12, 14))  # the train and val batches' sizes
    # the train state the demo saves at its last step (1.4 GB: the AlignmentHead
    # at its full width with AdamW's moments) is not written here
    monkeypatch.setattr(CheckpointManager, "maybe_save", lambda self, step, tree: None)
    out = demo.main(["--steps", "2", "--device", "cpu", "--workdir", str(tmp_path / "run")])
    assert out["report"] == str(tmp_path / "run" / "LEARNING_LOOP_DEMO.md")
    text = open(out["report"]).read()
    for row in ("feature_init", "feature_trained", "point", "pose"):
        for tag in demo.METRIC_TAGS:
            vals = [v for k, v in out["results"][row].items() if k.endswith("/" + tag)]
            assert len(vals) == 2 and np.isfinite(vals).all(), (row, tag)
    assert "| mean rpe_rot_rmse |" in text and "-42.1%" in text  # the JAX report's delta
    assert hashlib.sha256(open(jax_report, "rb").read()).hexdigest() == before
