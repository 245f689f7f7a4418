"""Port parity for geometry/solvers.py: tests/test_geometry.py's solver cases
through the JAX functions and their ports on the same numpy inputs, in
fp32. Tolerance 1e-4 unless stated: both sides are fp32, with 3x3 SVDs
from different LAPACK routines and sums in another order (measured ~1e-6)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from vitslam_tpu import geometry as G  # noqa: E402
from vitslam_tpu_torch.geometry import solvers as S  # noqa: E402
from torch_weights import shared_jax_cache  # noqa: E402,F401

torch.set_num_threads(2)
ATOL = 1e-4


def _rotation(rng):
    q = rng.normal(size=4)
    return np.asarray(G.quat_to_mat(jnp.asarray(q / np.linalg.norm(q), jnp.float32)))


def _t(x):
    return torch.tensor(np.asarray(x))


def _close(got, want, atol=ATOL):
    got = [g.numpy() for g in got] if isinstance(got, tuple) else [got.numpy()]
    want = want if isinstance(want, tuple) else (want,)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(w), atol=atol, rtol=0)


def test_fp32_matmuls_never_run_in_tf32():
    """The covariance sums over millions of points (30 overlap frames x
    79,772 pixels at 75/30) must stay fp32: importing the port turns TF32
    off for CUDA matmuls and convolutions."""
    import vitslam_tpu_torch  # noqa: F401

    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


@pytest.mark.parametrize("case", ["known", "planar", "weighted"])
def test_umeyama_matches_jax(case):
    rng = np.random.default_rng({"known": 7, "planar": 8, "weighted": 9}[case])
    x = rng.normal(size=(100, 3)).astype(np.float32)
    if case == "planar":  # degenerate: the Kabsch sign fix must keep det(R) = +1
        x[:, 2] = 0
    R_true = _rotation(rng)
    y = (1.7 * x @ R_true.T + rng.normal(size=3)).astype(np.float32)
    w = None
    if case == "weighted":
        y[:10] += 100.0
        w = np.ones(100, np.float32)
        w[:10] = 0.0
    want = G.umeyama(jnp.asarray(x), jnp.asarray(y), None if w is None else jnp.asarray(w))
    got = S.umeyama(_t(x), _t(y), None if w is None else _t(w))
    _close(got, want)
    assert torch.linalg.det(got[0]) > 0.99


def test_umeyama_batched_matches_per_element():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(4, 50, 3)).astype(np.float32)
    y = np.stack([(0.5 + i) * x[i] @ _rotation(rng).T + i for i in range(4)]).astype(np.float32)
    w = rng.uniform(size=(4, 50)).astype(np.float32)
    R, t, s = S.umeyama(_t(x), _t(y), _t(w))
    for i in range(4):
        _close((R[i], t[i], s[i]), G.umeyama(jnp.asarray(x[i]), jnp.asarray(y[i]),
                                             jnp.asarray(w[i])))


@pytest.mark.parametrize("n", [199, 200])
def test_median_takes_the_mean_of_the_middle_pair(n):
    """jnp.median averages the two middle values of an even count;
    torch.median returns the lower one. The IRLS threshold uses the former."""
    x = np.random.default_rng(n).uniform(size=(2, n)).astype(np.float32)
    np.testing.assert_allclose(S.median(_t(x)).numpy(), np.median(x, axis=-1), rtol=1e-7)
    np.testing.assert_allclose(S.median(_t(x)).numpy(),
                               np.asarray(jnp.median(jnp.asarray(x), axis=-1)), rtol=1e-7)
    if n % 2 == 0:
        assert not torch.equal(S.median(_t(x)), torch.median(_t(x), dim=-1).values)


@pytest.mark.parametrize("conf", ["ones", "even-count"])
def test_irls_matches_jax(conf):
    """Robust Sim(3) with 10% outliers; with random confidences over an even
    number of points the median threshold is the mean of the middle pair
    (a lower-median threshold would drop or keep other points)."""
    rng = np.random.default_rng(10)
    x = rng.normal(size=(200, 3)).astype(np.float32)
    R_true = _rotation(rng)
    y = (1.5 * x @ R_true.T + np.array([1, 2, 3], np.float32)).astype(np.float32)
    y[:20] += (rng.normal(size=(20, 3)) * 5.0).astype(np.float32)
    if conf == "ones":
        c1 = c2 = np.ones(200, np.float32)
    else:
        c1 = rng.uniform(0.5, 3.0, size=200).astype(np.float32)
        c2 = rng.uniform(0.5, 3.0, size=200).astype(np.float32)
    want = G.irls_sim3_umeyama(jnp.asarray(x), jnp.asarray(y), jnp.asarray(c1), jnp.asarray(c2))
    got = S.irls_sim3_umeyama(_t(x), _t(y), _t(c1), _t(c2))
    _close(got, want)
    assert abs(float(got[2]) - 1.5) < 0.05
    np.testing.assert_allclose(got[0].numpy(), R_true, atol=0.05)


def test_irls_batched_matches_jax_per_element():
    """The point-aligned model's batched form (each element frozen on its
    own) equals one solve per element; point maps (B, S, H, W, 3)."""
    rng = np.random.default_rng(11)
    src = rng.normal(size=(2, 2, 4, 5, 3)).astype(np.float32)
    dst = np.stack([(1.0 + b) * src[b] @ _rotation(rng).T + 0.3 for b in range(2)])
    dst = (dst + 0.01 * rng.normal(size=dst.shape)).astype(np.float32)
    cs = rng.uniform(1, 2, size=(2, 2, 4, 5)).astype(np.float32)
    cd = rng.uniform(1, 2, size=(2, 2, 4, 5)).astype(np.float32)
    R, t, s = S.irls_sim3_umeyama_batched(_t(src), _t(dst), _t(cs), _t(cd))
    for b in range(2):
        _close((R[b], t[b], s[b]), G.irls_sim3_umeyama(
            jnp.asarray(src[b]), jnp.asarray(dst[b]), jnp.asarray(cs[b]), jnp.asarray(cd[b])))


def test_horn_lse_weighted_median_and_depth_weights_match_jax():
    rng = np.random.default_rng(12)
    x = rng.normal(size=(40, 3)).astype(np.float32)
    y = (0.5 * x @ _rotation(rng).T + np.array([0.1, -0.2, 0.3], np.float32)).astype(np.float32)
    for scale in (True, False):
        _close(S.method_of_horn(_t(x), _t(y), scale),
               G.method_of_horn(jnp.asarray(x), jnp.asarray(y), scale))
    v = rng.normal(size=(30,)).astype(np.float32)
    _close(S.scale_lse_solver(_t(v), _t(-3.0 * v)), G.scale_lse_solver(jnp.asarray(v),
                                                                       jnp.asarray(-3.0 * v)))
    d = (np.abs(rng.normal(size=(2, 200))) + 0.1).astype(np.float32)
    gt = (2.3 * d).astype(np.float32)
    gt[:, :20] *= 10
    w = rng.uniform(size=(2, 200)).astype(np.float32)
    _close(S.weighted_median_scale(_t(d), _t(gt), _t(w)),
           G.weighted_median_scale(jnp.asarray(d), jnp.asarray(gt), jnp.asarray(w)), atol=1e-6)
    dg = jnp.asarray([[1.0, 2.0, 100.0, 0.001]], jnp.float32)
    m = jnp.asarray([[1.0, 1.0, 0.0, 1.0]], jnp.float32)
    c = jnp.asarray([[0.5, 1.0, 2.0, 3.0]], jnp.float32)
    _close(S.depth_scale_weights(_t(dg), _t(m), _t(c)), G.depth_scale_weights(dg, m, c),
           atol=1e-6)
    r = np.array([0.05, 0.1, 0.3, 2.0], np.float32)
    # XLA may divide by a reciprocal multiply: one fp32 ulp
    _close(S.huber_weights(_t(r), 0.1), G.huber_weights(jnp.asarray(r), 0.1), atol=1e-7)
