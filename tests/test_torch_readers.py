"""Port parity for the KITTI Odometry and Waymo readers
(vitslam_tpu_torch/data/{kitti_odometry,waymo}.py) against vitslam_tpu's on
the JAX package's byte-level fixtures: every key of ``get_data`` for a
whole sequence and a sampled window. The port reads K from P2 by scipy's
RQ decomposition (the reference by OpenCV's). Both packages take their C++
splat and back-projection first when the library loads; both native paths
are switched off for the comparison (numpy against numpy), and the
reference's native splat, where it loads, is held to the port's numpy one
separately."""
import numpy as np
import pytest

pytest.importorskip("torch")
cv2 = pytest.importorskip("cv2")

import vitslam_tpu.native as jnative  # noqa: E402
import vitslam_tpu_torch.native as tnative  # noqa: E402
from vitslam_tpu.data.base import CommonConfig as JCommon  # noqa: E402
from vitslam_tpu.data.kitti_odometry import KITTIOdometryDataset as JKitti  # noqa: E402
from vitslam_tpu.data.waymo import WaymoDataset as JWaymo  # noqa: E402
from vitslam_tpu.utils.fixtures import (  # noqa: E402
    write_kitti_odometry_fixture,
    write_waymo_fixture,
)
from vitslam_tpu_torch.data import CommonConfig, KITTIOdometryDataset, WaymoDataset  # noqa: E402
from vitslam_tpu_torch.data.kitti_odometry import decompose_projection  # noqa: E402
from vitslam_tpu_torch.data.waymo import lidar_to_depth  # noqa: E402

# poses and intrinsics: K from scipy's RQ against OpenCV's, in float64
POSE_ATOL = 1e-6
# the reference's C++ splat against the port's numpy splat: float32 sums
# over a pixel's contributions in another order, relative per pixel
NATIVE_RTOL = 1e-5
KW = dict(img_size=56, patch_size=14, fix_aspect_ratio=0.7, training=True,
          inside_random=False, chunk_subsampling=(1, 2))


@pytest.fixture
def numpy_reference(monkeypatch):
    """The reference's readers and the port's on their numpy paths (the
    native ones against each other: tests/test_torch_native.py)."""
    monkeypatch.setattr(jnative, "lidar_splat_depth_native", lambda *a, **k: None)
    monkeypatch.setattr(jnative, "depth_to_points_native", lambda *a, **k: None)
    _port_on_numpy(monkeypatch)


def _port_on_numpy(monkeypatch):
    """The port's readers on their numpy paths (its native route returning
    None, as with VITSLAM_NATIVE=0; the environment is left alone, which
    the reference reads once, at its first load)."""
    monkeypatch.setattr(tnative, "lidar_splat_depth_native", lambda *a, **k: None)
    monkeypatch.setattr(tnative, "depth_to_points_native", lambda *a, **k: None)


def _same(got: dict, want: dict):
    assert got.keys() == want.keys()
    for k, w in want.items():
        g = got[k]
        if k in ("extrinsics", "intrinsics"):
            np.testing.assert_allclose(g, w, rtol=0, atol=POSE_ATOL, err_msg=k)
        elif isinstance(w, np.ndarray):
            assert g.dtype == w.dtype and g.shape == w.shape, k
            if k not in ("cam_points", "world_points"):
                np.testing.assert_array_equal(g, w, err_msg=k)
            else:  # back-projected through the intrinsics above
                np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6, err_msg=k)
        else:
            assert g == w, k


def _both(ds, jds):
    """(port, reference) get_data of the whole first sequence and of a
    sampled 3-frame window, each side drawing from its own seeded rng."""
    n = jds.seq_frame_num[0]
    whole = dict(seq_index=0, img_per_seq=-1, ids=np.arange(n), aspect_ratio=0.7)
    yield ds.get_data(**whole), jds.get_data(**whole)
    yield (ds.get_data(0, 3, rng=np.random.default_rng(2)),
           jds.get_data(0, 3, rng=np.random.default_rng(2)))


def test_decompose_projection_matches_opencv():
    """K of KITTI's real P2 (R = I, t != 0) and of projections K R [I | c]
    with random rotations, positive scale and skew, against
    cv2.decomposeProjectionMatrix."""
    from scipy.spatial.transform import Rotation

    P2 = np.array([7.215377e+02, 0.0, 6.095593e+02, 4.485728e+01, 0.0, 7.215377e+02,
                   1.728540e+02, 2.163791e-01, 0.0, 0.0, 1.0, 2.745884e-03]).reshape(3, 4)
    rng = np.random.default_rng(0)
    cases = [P2]
    for i in range(20):
        K = np.array([[rng.uniform(300, 900), rng.uniform(-2, 2), rng.uniform(100, 700)],
                      [0, rng.uniform(300, 900), rng.uniform(100, 400)], [0, 0, 1]])
        R = Rotation.random(random_state=i).as_matrix()
        cases.append(np.concatenate([K @ R, K @ rng.normal(size=(3, 1))], 1)
                     * rng.uniform(0.5, 2.0))
    for P in cases:
        want = cv2.decomposeProjectionMatrix(P)[0]
        np.testing.assert_allclose(decompose_projection(P), want / want[2, 2],
                                   rtol=1e-9, atol=1e-9)


def test_kitti_odometry_matches_jax(tmp_path, numpy_reference):
    root = str(tmp_path / "kitti")
    write_kitti_odometry_fixture(root, seq="00", n_frames=8, hw=(56, 84))
    ds = KITTIOdometryDataset(CommonConfig(**KW), split="train", KITTIOD_DIR=root,
                              sequence_ids=["00", "05"])
    jds = JKitti(JCommon(**KW), split="train", KITTIOD_DIR=root, sequence_ids=["00", "05"])
    assert ds.sequence_list == jds.sequence_list and ds.seq_frame_num == jds.seq_frame_num
    assert ds.get_seq_name(0) == jds.get_seq_name(0) == "00"
    for got, want in _both(ds, jds):
        _same(got, want)


def test_waymo_matches_jax(tmp_path, numpy_reference):
    root = str(tmp_path / "waymo")
    write_waymo_fixture(root, split="validation", n_frames=6, hw=(56, 84), n_lidar=2000)
    write_waymo_fixture(root, seq="seq0001", split="validation", n_frames=6, hw=(56, 84),
                        seed=1)
    kw = dict(split="val", Waymo_DIR=root, sequence_ids=["seq0001"], cameras=["cam_01"])
    ds = WaymoDataset(CommonConfig(**KW), **kw)
    jds = JWaymo(JCommon(**KW), **kw)
    assert ds.sequence_list == jds.sequence_list == ["validation/seq0000/frames/cam_01"]
    assert ds.seq_frame_num == jds.seq_frame_num and ds.get_seq_name(0) == jds.get_seq_name(0)
    for got, want in _both(ds, jds):
        assert want["point_masks"].sum() > 0  # the splat gave depth
        _same(got, want)


def test_lidar_splat_against_the_native_one(monkeypatch):
    """The port's numpy splat against the reference's C++ one, where that
    library loads here (the reference's default path)."""
    from vitslam_tpu.native.bindings import lidar_splat_depth_native

    _port_on_numpy(monkeypatch)

    rng = np.random.default_rng(0)
    pts = np.concatenate([rng.uniform(-3, 3, (5000, 2)), rng.uniform(3, 30, (5000, 1))], 1)
    K = np.array([[60.0, 0, 42], [0, 60.0, 28], [0, 0, 1]])
    extr = np.eye(4)[:3]
    want = lidar_splat_depth_native(pts, K, extr, (56, 84), 0.05)
    if want is None:
        pytest.skip("the reference's native splat library does not load here")
    got = lidar_to_depth(np.concatenate([pts, np.ones((5000, 1))], 1).T, K, extr, (56, 84))
    assert (got > 0).sum() > 1000
    np.testing.assert_array_equal(got > 0, want > 0)
    np.testing.assert_allclose(got, want, rtol=NATIVE_RTOL, atol=0)
