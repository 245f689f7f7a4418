"""The port's native preprocessing (vitslam_tpu_torch/native: its copy of
preprocess.cpp, built by g++ at first use, and the ctypes bindings) against
its own numpy paths and the JAX package's native path, and the readers'
choice of route (``VITSLAM_NATIVE``).

The C++ kernels compute in float64 and write float32, the numpy paths too,
in another order: every output within 1e-5 (absolute; depths and points of
a few metres)."""
import os

import numpy as np
import pytest

from vitslam_tpu import native as jnative
from vitslam_tpu_torch import native
from vitslam_tpu_torch.data import preprocess as tpp
from vitslam_tpu_torch.data import waymo as twaymo
from torch_weights import shared_jax_cache  # noqa: E402,F401

ATOL = 1e-5


@pytest.fixture
def numpy_route(monkeypatch):
    """The numpy route: the native one switched off."""
    monkeypatch.setenv("VITSLAM_NATIVE", "0")
    assert not native.native_available()


def _depth_case():
    rng = np.random.default_rng(0)
    H, W = 16, 24
    depth = rng.uniform(1, 10, (H, W)).astype(np.float32)
    depth[0, 0] = 0.0
    depth[3, 5] = np.inf
    K = np.array([[30.0, 0, W / 2], [0, 31.0, H / 2], [0, 0, 1]])
    a = 0.2
    extr = np.array([[np.cos(a), 0, np.sin(a), 0.5], [0, 1, 0, -0.2],
                     [-np.sin(a), 0, np.cos(a), 1.0]], np.float64)
    return depth, extr, K


def _lidar_case():
    rng = np.random.default_rng(1)
    K = np.array([[50.0, 0, 16], [0, 50.0, 12], [0, 0, 1]])
    extr = np.eye(4)[:3]
    pts = rng.uniform(-2, 2, size=(500, 3)).astype(np.float32)
    pts[:, 2] = rng.uniform(2, 20, 500)
    pts_h = np.concatenate([pts, np.ones((500, 1), np.float32)], -1).T
    return pts, pts_h, K, extr


def test_native_builds_into_the_build_directory():
    """g++ is here, so the route is on; the library lands in the package's
    gitignored _build/, never beside the source."""
    assert native.native_available()
    from vitslam_tpu_torch.native import bindings

    path = bindings._lib_path()
    assert path.exists() and path.parent.name == "_build"
    assert not any(p.suffix == ".so" for p in bindings.SOURCE.parent.iterdir())


def test_depth_to_points_native_matches_numpy_and_reference(monkeypatch):
    depth, extr, K = _depth_case()
    got = native.depth_to_points_native(depth, extr, K)
    assert native.native_available() and got is not None
    ref = jnative.depth_to_points_native(depth, extr, K)
    monkeypatch.setenv("VITSLAM_NATIVE", "0")
    assert native.depth_to_points_native(depth, extr, K) is None
    numpy = tpp.depth_to_points(depth, extr, K)
    for a, b in zip(got[:2], numpy[:2]):
        finite = np.isfinite(b)
        assert np.array_equal(finite, np.isfinite(a))
        np.testing.assert_allclose(a[finite], b[finite], atol=ATOL, rtol=0)
    np.testing.assert_array_equal(got[2], numpy[2])
    assert not got[2][0, 0] and not got[2][3, 5] and got[2].sum() == got[2].size - 2
    if ref is not None:
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(a, b)


def test_readers_take_the_native_route_first(numpy_route, monkeypatch):
    """depth_to_points and lidar_to_depth: with the route off, numpy; with
    it on, the native kernels, within 1e-5 of it."""
    depth, extr, K = _depth_case()
    pts, pts_h, Kl, extr_l = _lidar_case()
    off = (tpp.depth_to_points(depth, extr, K), twaymo.lidar_to_depth(pts_h, Kl, extr_l, (24, 32)))
    monkeypatch.setenv("VITSLAM_NATIVE", "1")
    calls = []
    for name in ("depth_to_points_native", "lidar_splat_depth_native"):
        real = getattr(native, name)
        monkeypatch.setattr(native, name, lambda *a, _real=real, **k: calls.append(1)
                            or _real(*a, **k))
    on = (tpp.depth_to_points(depth, extr, K), twaymo.lidar_to_depth(pts_h, Kl, extr_l, (24, 32)))
    assert len(calls) == 2
    np.testing.assert_allclose(on[1], off[1], atol=ATOL, rtol=0)
    a, b = on[0][0], off[0][0]
    finite = np.isfinite(b)
    np.testing.assert_allclose(a[finite], b[finite], atol=ATOL, rtol=0)


def test_lidar_splat_native_matches_numpy_and_reference(monkeypatch):
    pts, pts_h, K, extr = _lidar_case()
    got = native.lidar_splat_depth_native(pts, K, extr, (24, 32))
    assert got is not None and (got > 0).sum() > 50
    ref = jnative.lidar_splat_depth_native(pts, K, extr, (24, 32))
    monkeypatch.setenv("VITSLAM_NATIVE", "0")
    numpy = twaymo.lidar_to_depth(pts_h, K, extr, (24, 32))
    np.testing.assert_allclose(got, numpy, atol=ATOL, rtol=0)
    if ref is not None:
        np.testing.assert_array_equal(got, ref)


def test_native_checks_shapes():
    with pytest.raises(ValueError, match=r"\(N, 3\)"):
        native.lidar_splat_depth_native(np.zeros((4, 2), np.float32), np.eye(3), np.eye(4),
                                        (4, 4))
    with pytest.raises(ValueError, match="K must be"):
        native.depth_to_points_native(np.ones((4, 4), np.float32), np.eye(4), np.eye(2))
    assert os.environ.get("VITSLAM_NATIVE", "1") != "0"
