"""Port parity for the eval slice (ops/knn.py, eval/*.py): each case of
tests/test_eval.py, plus random inputs, through the JAX function and its
port on the CPU with the same numpy inputs, in fp32."""
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from vitslam_tpu import eval as jeval  # noqa: E402
from vitslam_tpu.eval import orchestrator as jorch  # noqa: E402
from vitslam_tpu.eval import prepare as jprep  # noqa: E402
from vitslam_tpu.geometry import extri_intri_to_pose_encoding  # noqa: E402
from vitslam_tpu.ops.knn import nn_search as jax_nn_search  # noqa: E402
from vitslam_tpu.utils.testing import make_synthetic_batch  # noqa: E402
from vitslam_tpu_torch import eval as teval  # noqa: E402
from vitslam_tpu_torch.eval import orchestrator as torch_orch  # noqa: E402
from vitslam_tpu_torch.eval import prepare as tprep  # noqa: E402
from vitslam_tpu_torch.ops.knn import nn_search  # noqa: E402

torch.set_num_threads(2)

# fp32 on both sides: metric values agree to rel 1e-5 (sums of a few
# hundred terms in another order; 1e-6 absolute where a value is the
# cancellation noise of an exact match); transforms and aligned points to
# 1e-4 (30 ICP iterations of 3x3 SVDs in fp32)
REL = 1e-5
ATOL = 1e-4


def _t(x):
    return torch.tensor(np.asarray(x))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("norm", [1, 2])
@pytest.mark.parametrize("tiles", [(64, 64), (1024, 65536), (50, 100)])
def test_knn_matches_jax_and_bruteforce(norm, tiles):
    """Exact indices and distances on distinct random points, ragged p and
    q tiles (137 and 251 points), norm 1 and squared norm 2."""
    rng = np.random.default_rng(0)
    p = rng.normal(size=(137, 3)).astype(np.float32)
    q = rng.normal(size=(251, 3)).astype(np.float32)
    d, i = nn_search(_t(p), _t(q), tile_p=tiles[0], tile_q=tiles[1], norm=norm)
    jd, ji = jax_nn_search(jnp.asarray(p), jnp.asarray(q), tile_p=tiles[0], tile_q=tiles[1],
                           norm=norm)
    diff = p[:, None] - q[None]
    full = (diff ** 2).sum(-1) if norm == 2 else np.abs(diff).sum(-1)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(i.numpy(), full.argmin(axis=1))
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(d.numpy(), full.min(axis=1), atol=1e-4)
    assert d.dtype == torch.float32 and (d >= 0).all()


def test_knn_l1_known_and_nonfinite_points():
    d, i = nn_search(_t([[0.0, 0, 0]]), _t([[1.0, 1, 1], [0.1, 0, 0]]), norm=1)
    assert int(i[0]) == 1
    np.testing.assert_allclose(float(d[0]), 0.1, atol=1e-6)
    # a NaN point in q is never the nearest (its distance reads +inf)
    d, i = nn_search(_t([[0.0, 0, 0]]), _t([[np.nan, 0, 0], [2.0, 0, 0]]))
    assert int(i[0]) == 1 and float(d[0]) == pytest.approx(4.0)


def _rot_z(a):
    return np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0], [0, 0, 1]],
                    np.float32)


def _icp_case(name):
    rng = np.random.default_rng(1)
    if name == "rigid":
        src = rng.normal(size=(400, 3)).astype(np.float32)
        R, t = _rot_z(0.15), np.array([0.05, -0.03, 0.04], np.float32)
        return src, src @ R.T + t, None, dict(iterations=20), (R, t, 1.0)
    if name == "scale":
        g = np.arange(6, dtype=np.float32)
        src = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)
        return src, 1.05 * src, None, dict(iterations=10, estimate_scale=True), \
            (np.eye(3), np.zeros(3), 1.05)
    src = np.random.default_rng(3).normal(size=(100, 3)).astype(np.float32)
    src_p = np.concatenate([src, np.zeros((20, 3), np.float32) + 100.0])
    w = np.concatenate([np.ones(100), np.zeros(20)]).astype(np.float32)
    return src_p, src + np.array([1.0, 0, 0], np.float32), w, dict(iterations=10), \
        (np.eye(3), np.array([1.0, 0, 0]), 1.0)


@pytest.mark.parametrize("name", ["rigid", "scale", "padding_mask"])
def test_icp_matches_jax(name):
    """ICP recovers the rigid transform, the scale, and ignores masked
    padding, with R, t, s and the aligned points within 1e-4 of JAX."""
    src, dst, w, kw, (R, t, s) = _icp_case(name)
    got = teval.iterative_closest_point(_t(src), _t(dst), None if w is None else _t(w), **kw)
    want = jeval.iterative_closest_point(jnp.asarray(src), jnp.asarray(dst),
                                         None if w is None else jnp.asarray(w), **kw)
    for a, b in zip(got[:4], want[:4]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=ATOL)
    # the final RMSE of a converged fit is the fp32 cancellation noise of
    # |p|^2 + |q|^2 - 2 p.q (~1e-6 squared distances), whose rounding
    # depends on the summation order: equal to JAX within that noise
    np.testing.assert_allclose(float(got.rmse), float(want.rmse), atol=1e-3)
    np.testing.assert_allclose(got.R.numpy(), R, atol=1e-3)
    np.testing.assert_allclose(got.t.numpy(), t, atol=1e-3)
    np.testing.assert_allclose(float(got.s), s, atol=1e-3)
    if name == "rigid":
        np.testing.assert_allclose(got.transformed.numpy(), dst, atol=1e-3)
        assert float(got.rmse) < 1e-3


def _traj(n, rng=None, noise=0.0, rot=0.0):
    poses = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    for i in range(n):
        poses[i, :3, :3] = _rot_z(rot * i)
        poses[i, :3, 3] = [i * 1.0, 0, 0]
        if noise:
            poses[i, :3, 3] += rng.normal(size=3) * noise
    return poses


def _metric_pair(cls, **kw):
    return getattr(teval, cls)(**kw), getattr(jeval, cls)(**kw)


def _check_metric(cls, preds, gts, **kw):
    port, ref = _metric_pair(cls, **kw)
    for p, g in zip(preds, gts):
        port.update(_t(p), _t(g))
        ref.update(jnp.asarray(p), jnp.asarray(g))
    got, want = port.compute(), ref.compute()
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=REL, atol=1e-6, err_msg=k)
    return got


@pytest.mark.parametrize("cls,kw", [("AbsoluteTrajectoryError", dict(detailed=True)),
                                    ("RelativePoseError", dict(detailed=True)),
                                    ("RelativePoseError", dict(delta=2)),
                                    ("ScaleConsistency", {})])
def test_trajectory_metrics_match_jax(cls, kw):
    """Random noisy, rotating trajectories (two sequences), every key of the
    detailed ATE and RPE and the scale variance, within rel 1e-5."""
    rng = np.random.default_rng(4)
    gts = [_traj(9, rng, 0.1, 0.05), _traj(6, rng, 0.2, -0.1)]
    preds = [g.copy() for g in gts]
    for p in preds:
        p[:, :3, 3] = p[:, :3, 3] * 0.9 + rng.normal(size=(len(p), 3)) * 0.05
        p[:, :3, :3] = p[:, :3, :3] @ _rot_z(0.02)
    _check_metric(cls, preds, gts, **kw)


def test_trajectory_known_values():
    gt = _traj(5)
    pred = gt.copy()
    pred[:, 0, 3] += 0.5
    res = _check_metric("AbsoluteTrajectoryError", [pred], [gt], detailed=True)
    np.testing.assert_allclose(res["ate_rmse"], 0.5, atol=1e-6)
    np.testing.assert_allclose(res["ate_rmse_per_dim"][0], 0.5, atol=1e-6)
    pred = _traj(4)
    pred[:, 0, 3] *= 2.0  # relative steps of 2 m against 1 m
    res = _check_metric("RelativePoseError", [pred], [_traj(4)])
    np.testing.assert_allclose(res["rpe_trans_rmse"], 1.0, atol=1e-5)
    res = _check_metric("RelativePoseError", [gt], [gt], detailed=True)
    assert res["rpe_trans_rmse"] < 1e-5 and res["rpe_rot_rmse"] < 0.1
    pred = gt.copy()
    pred[:, :3, 3] *= 0.5
    assert _check_metric("ScaleConsistency", [pred], [gt])["scale_var"] < 1e-8


@pytest.mark.parametrize("kw", [dict(), dict(rmse=False), dict(max_dist=0.05),
                                dict(norm=1, rmse=False)])
def test_chamfer_matches_jax(kw):
    rng = np.random.default_rng(5)
    a = rng.normal(size=(300, 3)).astype(np.float32)
    b = (a[:250] + rng.normal(size=(250, 3)) * 0.05).astype(np.float32)
    _check_metric("ChamferDistanceMetrics", [a, b], [b, a], **kw)


def test_chamfer_known_values():
    pts = np.random.default_rng(5).normal(size=(200, 3)).astype(np.float32)
    assert _check_metric("ChamferDistanceMetrics", [pts], [pts])["chamfer_distance_rmse"] < 1e-4
    a = np.stack([np.arange(10), np.zeros(10), np.zeros(10)], -1).astype(np.float32)
    b = a.copy()
    b[:, 1] = 0.2  # squared distance 0.04 on both sides
    res = _check_metric("ChamferDistanceMetrics", [a], [b])
    np.testing.assert_allclose(res["chamfer_distance_rmse"], 0.04, atol=1e-5)
    res = _check_metric("ChamferDistanceMetrics", [np.zeros((1, 3), np.float32)],
                        [np.full((1, 3), 100.0, np.float32)], max_dist=1.0)
    np.testing.assert_allclose(res["chamfer_distance_rmse"], 1.0, atol=1e-5)


@pytest.mark.parametrize("shape,max_points,density", [
    ((1, 2, 64, 64), 512, 1.0), ((1, 3, 77, 258), 5000, 0.7), ((2, 2, 154, 518), 30000, 0.9),
    ((1, 1, 30, 40), 2000, 0.5)])
def test_find_subsample_factor_and_resize_match_jax(shape, max_points, density):
    mask = np.random.default_rng(6).uniform(size=shape) < density
    f = tprep.find_subsample_factor(_t(mask), max_points)
    assert f == jprep.find_subsample_factor(mask, max_points)
    B, S, H, W = shape
    x = np.random.default_rng(7).normal(size=(B, S, H, W, 3)).astype(np.float32)
    for h, w in ((max(1, H // f), max(1, W // f)), (max(1, H // 3), max(1, W // 2))):
        np.testing.assert_allclose(tprep._resize_bshw(_t(x), h, w).numpy(),
                                   jprep._resize_bshw(x, h, w), atol=1e-5)


def _pred_and_batch():
    batch = make_synthetic_batch(B=1, N=3, H=28, W=42)
    pe = extri_intri_to_pose_encoding(jnp.asarray(batch["extrinsics"]),
                                      jnp.asarray(batch["intrinsics"]), (28, 42))
    rng = np.random.default_rng(7)
    pred = {"pose_enc": np.asarray(pe),
            "depth": (batch["depths"][..., None]
                      * rng.uniform(0.95, 1.05, batch["depths"].shape + (1,))).astype(np.float32),
            "depth_conf": rng.uniform(1, 2, batch["depths"].shape).astype(np.float32),
            "world_points": batch["world_points"],
            "world_points_conf": rng.uniform(1, 2, batch["depths"].shape).astype(np.float32)}
    return pred, batch


@pytest.mark.parametrize("use_depth", [True, False])
@pytest.mark.parametrize("max_points", [None, 500])
def test_prepare_data_for_metrics_matches_jax(use_depth, max_points):
    """Poses, the conf-quantile masks, the subsampled clouds and the ICP
    alignment end to end: the same point lists and poses within 1e-4 (the
    unprojected depths are preferred over the point maps when present)."""
    pred, batch = _pred_and_batch()
    if not use_depth:
        del pred["depth"], pred["depth_conf"]
    kw = dict(max_points_icp=max_points, icp_iterations=5)
    got = teval.prepare_data_for_metrics({k: _t(v) for k, v in pred.items()}, batch, **kw)
    want = jeval.prepare_data_for_metrics(pred, batch, **kw)
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL)
    for gl, wl in zip(got[2:], want[2:]):
        assert len(gl) == len(wl) == 1
        assert tuple(gl[0].shape) == tuple(np.asarray(wl[0]).shape)
        np.testing.assert_allclose(gl[0].numpy(), np.asarray(wl[0]), atol=ATOL)
    if max_points:
        assert got[3][0].shape[0] <= max_points


def test_nearest_quantile_is_jax_nearest():
    x = np.random.default_rng(8).uniform(size=(2, 5, 7, 3)).astype(np.float32)
    for q in (0.0, 0.25, 0.5, 0.9, 1.0):
        assert float(tprep._nearest_quantile(_t(x), q)) == \
            float(jnp.quantile(jnp.asarray(x), q, method="nearest"))


def test_log_additional_data_and_gather_match_jax():
    rng = np.random.default_rng(9)
    pred = {"alignment_scales": rng.uniform(0.5, 2, (1,)).astype(np.float32),
            "frame_se3_enc": rng.normal(size=(1, 7, 7)).astype(np.float32),
            "chunk_sim3_enc": rng.normal(size=(1, 3, 8)).astype(np.float32),
            "memory_tokens": rng.normal(size=(1, 4, 16)).astype(np.float32)}
    got, want = {}, {}
    torch_orch.log_additional_data({k: _t(v) for k, v in pred.items()}, got)
    jorch.log_additional_data(pred, want)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=REL, err_msg=k)

    class DS:
        sequence_list_len = 3
        seq_frame_num = [5, 6, 7]

        def get_seq_name(self, j):
            return f"s{j}"

    dss = [DS(), DS()]
    for rand in (True, False):
        a = torch_orch.gather_sequences(dss, rand, np.random.default_rng(3))
        b = jorch.gather_sequences(dss, rand, np.random.default_rng(3))
        assert [x[1:] for x in a] == [x[1:] for x in b]
        assert [dss.index(x[0]) for x in a] == [dss.index(x[0]) for x in b]


def test_metrics_refuse_what_is_not_ported(monkeypatch):
    """The viser viewer is ported; without viser (absent here and on the
    machine with the card) it raises ImportError before the sequence runs."""
    monkeypatch.setitem(sys.modules, "viser", None)
    m = teval.Metrics(visualize=True)
    with pytest.raises(ImportError, match="viser is not installed"):
        m.visualize_sequence(None, None)


def test_plots_write_files(tmp_path):
    gt = _traj(5)
    pred = gt.copy()
    pred[:, 0, 3] += 0.1
    out = str(tmp_path) + "/"
    for cls in ("AbsoluteTrajectoryError", "RelativePoseError", "ScaleConsistency"):
        res, png = getattr(teval, cls)().plot(_t(pred), _t(gt), title="t", outpath=out)
        assert os.path.exists(png) and os.path.exists(png[:-4] + ".npy")
        assert getattr(teval, cls)().plot(_t(pred), _t(gt))[1] is None
    pts = np.random.default_rng(0).normal(size=(50, 3)).astype(np.float32)
    res, png = teval.ChamferDistanceMetrics().plot(_t(pts), _t(pts + 0.01), outpath=out)
    assert os.path.exists(png)
