"""Port parity for slice 13: ``VITSLAM_TOKEN_MERGE`` in the presets, the
KV-merge quality sweep (vitslam_tpu_torch/kv_merge_quality.py against the
calls scripts/kv_merge_quality.py makes into the JAX package) and the
trained sweep's guard and report splice (vitslam_tpu_torch/kv_merge_trained.py).
Same numpy fixture and the port's seeded weights moved into the JAX tree,
fp32 on the CPU, where every kernel wrapper runs its plain version."""
import hashlib
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from vitslam_tpu import models as jm  # noqa: E402
from vitslam_tpu.data.base import CommonConfig as JaxCommonConfig  # noqa: E402
from vitslam_tpu.data.vkitti import VKittiDataset as JaxVKitti  # noqa: E402
from vitslam_tpu.eval.orchestrator import get_sequence_data as jax_sequence  # noqa: E402
from vitslam_tpu.eval.prepare import prepare_data_for_metrics as jax_prepare  # noqa: E402
from vitslam_tpu.eval.trajectory import AbsoluteTrajectoryError as JaxATE  # noqa: E402
from vitslam_tpu.eval.trajectory import RelativePoseError as JaxRPE  # noqa: E402
from vitslam_tpu.models.presets import _token_merge_overrides  # noqa: E402
from vitslam_tpu.slam.pipeline import ChunkedPipeline as JaxPipeline  # noqa: E402
from vitslam_tpu_torch import kv_merge_quality as kvq  # noqa: E402
from vitslam_tpu_torch import kv_merge_trained as kvt  # noqa: E402
from vitslam_tpu_torch.models import presets  # noqa: E402
from vitslam_tpu_torch.utils.fixtures import write_vkitti_fixture  # noqa: E402

from torch_weights import jax_variables, shared_jax_cache  # noqa: E402,F401

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# a short sequence with the merge really on: 2 chunks of 12 frames, stride
# 5 under the chunk width
FRAMES, CHUNK, OVERLAP = 20, 12, 4
# fp32 on both sides through backbone, heads, chunk merge and GT alignment:
# the predictions within 1e-4 relative L2 (measured ~4e-6: summation
# order); ATE and RPE within 1e-3 relative (the IRLS scale and the Sim(3)
# chain in another order; measured ~1e-6). The Chamfer terms after the
# script's 30 ICP iterations are held within 5e-2 relative between the
# port's metrics of the port's and of the JAX package's predictions: the
# random-weight cloud lies far from its GT (Chamfer ~300), where ICP's
# nearest-neighbour matches flip on differences of ~1e-6 and turn them
# into percent-level changes (measured up to 0.9%; tests/test_torch_cli.py
# notes the same). The JAX package's Chamfer and ICP are held to the
# port's on well-posed clouds in tests/test_torch_eval.py; running them
# here would add a JAX ICP compile per case.
# (The file keeps to 9 cases: pytest-xdist's --dist loadfile starts the
# files with the most cases first, so this one starts after the long
# tests/test_train.py, which has 11, and does not delay it.)
PRED_RTOL = 1e-4
TRAJ_RTOL = 1e-3
CHAMFER_RTOL = 5e-2
TRAJ_KEYS = ("ate_rmse", "rpe_trans_rmse", "rpe_rot_rmse")
CHAMFER_KEYS = ("chamfer_distance_rmse", "accuracy_rmse", "completion_rmse")


# ---- (a) VITSLAM_TOKEN_MERGE -------------------------------------------------

def test_token_merge_env_parses_as_the_jax_presets(monkeypatch):
    for value in ("", "2", "2,5", "4,10"):
        monkeypatch.setenv("VITSLAM_TOKEN_MERGE", value)
        want = _token_merge_overrides()
        assert presets.token_merge_overrides() == want, value
        assert presets.token_merge_overrides({"VITSLAM_TOKEN_MERGE": value}) == want, value


def test_token_merge_env_reaches_the_presets_and_keywords_win(monkeypatch):
    """A tiny flagship_point_aligned built under the variable carries the
    merge. Every flagship preset takes it and an explicit keyword wins;
    small_feature_aligned ignores it, as in the JAX package (the presets'
    keywords read through a stand-in for the model build)."""
    monkeypatch.setenv("VITSLAM_TOKEN_MERGE", "4,10")
    tiny = dict(img_size=28, embed_dim=32, depth=1, num_heads=1, patch_embed_depth=1,
                intermediate_layers=(0, 0, 0, 0), dtype=torch.float32)
    agg = presets.flagship_point_aligned(device="cpu", **tiny).core.aggregator
    assert (agg.merge_pool, agg.merge_stride) == (4, 10)
    monkeypatch.setattr(presets, "_build", lambda cls, base, kw, device, seed: {**base, **kw})
    flagships = (presets.flagship, presets.flagship_point_aligned,
                 presets.flagship_pose_aligned, presets.flagship_pose_only)
    for build in flagships:
        kw = build(device="cpu")
        assert (kw["global_merge_pool"], kw["global_merge_stride"]) == (4, 10), build
        kw = build(device="cpu", global_merge_stride=3)
        assert (kw["global_merge_pool"], kw["global_merge_stride"]) == (4, 3), build
    assert "global_merge_pool" not in presets.small_feature_aligned(device="cpu")
    monkeypatch.setenv("VITSLAM_TOKEN_MERGE", "")
    assert all("global_merge_pool" not in build(device="cpu") for build in flagships)


# ---- (b) one sweep row against the JAX package's pieces ----------------------

@pytest.fixture(scope="module")
def fixture_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("kvq") / "vkitti")
    write_vkitti_fixture(root, scene="01", setting="clone", n_frames=FRAMES,
                         hw=kvq.FIXTURE_HW, seed=kvq.FIXTURE_SEED)
    return root


def _jax_row(family, setting, root, weights_model):
    """The row's predictions and trajectory metrics as
    scripts/kv_merge_quality.py computes them, in fp32, with the port's
    weights: (predictions, JAX sequence, ATE and RPE)."""
    kw = dict(img_size=28, patch_size=14, embed_dim=64, depth=4, num_heads=2,
              patch_embed_depth=2, intermediate_layers=(0, 1, 2, 3), dtype=jnp.float32,
              enable_camera=True)
    if family == "point":
        cls, kw = jm.PointAlignedVGGT, dict(kw, enable_depth=False, enable_point=True)
    else:
        cls, kw = jm.PoseAlignedVGGT, dict(kw, enable_depth=True, enable_point=False)
    if setting:
        kw.update(global_merge_pool=setting[0], global_merge_stride=setting[1])
    model = cls(**kw)
    params = jax_variables(lambda rng: model.init(
        rng, jnp.zeros((1, CHUNK, 3, 28, 28), jnp.float32), OVERLAP), weights_model)
    cc = JaxCommonConfig(img_size=28, patch_size=14, fix_aspect_ratio=1.0, training=False)
    ds = JaxVKitti(cc, split="test", VKitti_DIR=root, sequence_ids=["01"], settings=["clone"])
    seq = jax_sequence(ds, 0, ds.get_seq_name(0), FRAMES)
    # the two-stage driver compiles the backbone once (the sequential one
    # twice: the first chunk without state, then with); the same outputs
    preds, _ = JaxPipeline(model, params, encode_batch=2).run_sequence(
        seq, sample_mode="chunk_overlap", chunk_width=CHUNK, num_overlap=OVERLAP,
        gt_alignment_type="scale_from_poses")
    pred_poses, gt_poses = jax_prepare(preds, seq, max_points_icp=2000, want_points=False,
                                       want_poses=True)[:2]
    vals = {}
    vals.update(JaxATE().plot(pred_poses[0], gt_poses[0], "t", None)[0])
    vals.update(JaxRPE().plot(pred_poses[0], gt_poses[0], "t", None)[0])
    return preds, seq, {k: float(v) for k, v in vals.items()}


def _rel_l2(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-12))


@pytest.mark.parametrize("setting", [None, (2, 5)], ids=["exact", "p2s5"])
@pytest.mark.parametrize("family", kvq.FAMILIES)
def test_sweep_row_matches_the_jax_script(family, setting, fixture_root):
    """One (family, setting) row of the port's sweep (predict, then
    sequence_metrics, as run_setting does) against the JAX package's
    pipeline and trajectory metrics on the same fixture and weights, in
    fp32 (tolerances above)."""
    weights = kvq.family_weights(family, "cpu", torch.float32)
    seq = kvq.load_sequence(fixture_root, FRAMES)
    preds, secs, routes, launches = kvq.predict(family, setting, seq, weights, CHUNK, OVERLAP,
                                                "cpu", torch.float32)
    assert secs > 0 and not any(launches.values()) and set(routes) == {"plain"}
    got = kvq.sequence_metrics(preds, seq)
    assert set(got) == set(TRAJ_KEYS + CHAMFER_KEYS) and all(np.isfinite(list(got.values())))
    model = kvq.family_model(family, setting, "cpu", torch.float32)
    model.load_state_dict(weights)
    jpreds, jseq, want = _jax_row(family, setting, fixture_root, model)
    for k in ("images", "extrinsics", "world_points", "point_masks"):
        np.testing.assert_array_equal(np.asarray(seq[k]), np.asarray(jseq[k]), err_msg=k)
    keys = ("pose_enc", "world_points", "world_points_conf") if family == "point" else \
        ("pose_enc", "depth", "depth_conf")
    for k in keys:
        assert _rel_l2(preds[k], jpreds[k]) <= PRED_RTOL, k
    assert set(want) == set(TRAJ_KEYS)
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=TRAJ_RTOL, err_msg=k)
    theirs = kvq.sequence_metrics({k: torch.tensor(np.array(v)) for k, v in jpreds.items()
                                   if np.asarray(v).dtype.kind == "f"}, seq)
    for k in CHAMFER_KEYS:
        np.testing.assert_allclose(got[k], theirs[k], rtol=CHAMFER_RTOL, err_msg=k)


# ---- (c) the report ---------------------------------------------------------------

def test_report_columns_and_refusal_of_the_jax_report(tmp_path):
    vals = {"ate_rmse": 2.0, "rpe_trans_rmse": 1.0, "rpe_rot_rmse": 4.0,
            "chamfer_distance_rmse": 8.0}
    rows = [("point", "exact", vals, 1.0, {}, {}),
            ("point", "p2s5", {k: 1.1 * v for k, v in vals.items()}, 1.0, {}, {}),
            ("pose", "exact", dict(vals, chamfer_distance_rmse=0.0), 1.0, {}, {}),
            ("pose", "p4s10", {k: 0.5 for k in vals}, 1.0, {}, {})]
    text = kvq.report(rows, 90, 75, 30, "cpu").splitlines()
    assert text[0] == "# KV-merge quality sweep (synthetic weights, 75/30 fixture)"
    head = text.index("| variant | setting | ATE (Δ%) | RPE_trans (Δ%) | RPE_rot (Δ%) | "
                      "chamfer_distance (Δ%) |")
    assert text[head + 1] == "|---|---|---|---|---|---|"
    assert text[head + 2] == "| point | exact | 2.0000 | 1.0000 | 4.0000 | 8.0000 |"
    assert text[head + 3] == ("| point | p2s5 | 2.2000 (+10.0%) | 1.1000 (+10.0%) | "
                              "4.4000 (+10.0%) | 8.8000 (+10.0%) |")
    # a zero exact value gets no delta
    assert text[head + 5] == ("| pose | p4s10 | 0.5000 (-75.0%) | 0.5000 (-50.0%) | "
                              "0.5000 (-87.5%) | 0.5000 |")
    jax_report = os.path.join(ROOT, "docs", "KV_MERGE_QUALITY.md")
    before = hashlib.sha256(open(jax_report, "rb").read()).hexdigest()
    for main in (kvq.main, kvt.main):
        with pytest.raises(SystemExit, match="JAX package's report"):
            main(["--device", "cpu", "--report", jax_report, "--workdir" if main is kvq.main
                  else "--demo-dir", str(tmp_path)])
    assert kvq.report_path(None, str(tmp_path)) == str(tmp_path / "KV_MERGE_QUALITY.md")
    assert hashlib.sha256(open(jax_report, "rb").read()).hexdigest() == before


# ---- (d) the trained sweep's guard and splice -----------------------------------

def test_trained_sweep_guard_raises():
    """A stride at or above the 5-frame chunk, or a pool of 1, would run
    exact silently."""
    for setting in ((2, 5), (2, 7), (1, 2)):
        with pytest.raises(ValueError, match="silently disable merging"):
            kvt.check_setting(setting)
    for ok in kvt.SETTINGS:
        kvt.check_setting(ok)


def test_trained_sweep_splices_between_the_markers():
    block = f"{kvt.BEGIN}\nnew table\n{kvt.END}\n"
    doc = f"# head\n\nabove\n{kvt.BEGIN}\nold table\n{kvt.END}\n\nbelow\n"
    want = f"# head\n\nabove\n{kvt.BEGIN}\nnew table\n{kvt.END}\n\nbelow\n"
    assert kvt.splice(doc, block) == want
    assert kvt.splice("# head\n", block) == f"# head\n\n{block}"
