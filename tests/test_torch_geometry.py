"""Port parity: vitslam_tpu_torch.geometry vs vitslam_tpu.geometry on the
same numpy inputs (fp32 on both sides)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from vitslam_tpu import geometry as jg  # noqa: E402
from vitslam_tpu_torch import geometry as tg  # noqa: E402

torch.set_num_threads(2)

# fp32 on both sides, the same formulas in another op order: a few ulps
ATOL = 1e-5


def _rand_quats(rng, n):
    q = rng.normal(size=(n, 4)).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def _rand_extr(rng, shape):
    R = np.asarray(jg.quat_to_mat(jnp.asarray(_rand_quats(rng, int(np.prod(shape))))))
    t = rng.normal(size=(int(np.prod(shape)), 3, 1)).astype(np.float32)
    return np.concatenate([R, t], axis=-1).reshape(shape + (3, 4))


def _t(x):
    return torch.tensor(np.array(x))


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol, rtol=0)


def test_quat_mat_roundtrip_matches_jax():
    rng = np.random.default_rng(0)
    q = _rand_quats(rng, 64)
    _close(tg.quat_to_mat(_t(q)), jg.quat_to_mat(jnp.asarray(q)))
    R = np.asarray(jg.quat_to_mat(jnp.asarray(q)))
    # mat_to_quat canonicalises w >= 0 on both sides
    _close(tg.mat_to_quat(_t(R)), jg.mat_to_quat(jnp.asarray(R)))
    _close(tg.normalize_quat(_t(3 * q)), jg.normalize_quat(jnp.asarray(3 * q)))
    _close(tg.rotation_angle(_t(R)), jg.rotation_angle(jnp.asarray(R)), atol=1e-3)


def test_average_quaternions_matches_jax_up_to_sign():
    """Markley mean via eigh: the eigenvector's global sign is arbitrary on
    both sides, so compare up to sign."""
    rng = np.random.default_rng(1)
    base = _rand_quats(rng, 3)
    q = base[:, None] + 0.05 * rng.normal(size=(3, 5, 4)).astype(np.float32)
    w = rng.uniform(0.5, 1.5, size=(3, 5)).astype(np.float32)
    for weights in (None, w):
        got = tg.average_quaternions(_t(q), None if weights is None else _t(weights)).numpy()
        want = np.asarray(jg.average_quaternions(
            jnp.asarray(q), None if weights is None else jnp.asarray(weights)))
        sign = np.sign((got * want).sum(-1, keepdims=True))
        _close(got * sign, want)


def test_se3_ops_match_jax():
    rng = np.random.default_rng(2)
    e = _rand_extr(rng, (2, 4))
    scale = rng.uniform(0.5, 2.0, size=(2,)).astype(np.float32)
    T = np.asarray(jg.pad_to_4x4(jnp.asarray(_rand_extr(rng, (2,)))))
    pts = rng.normal(size=(2, 4, 3, 5, 3)).astype(np.float32)
    _close(tg.pad_to_4x4(_t(e)), jg.pad_to_4x4(jnp.asarray(e)))
    _close(tg.closed_form_inverse_se3(_t(e)), jg.closed_form_inverse_se3(jnp.asarray(e)))
    _close(tg.se3_compose(_t(e), _t(e)), jg.se3_compose(jnp.asarray(e), jnp.asarray(e)))
    for to_next in (True, False):
        _close(tg.compute_relative_poses(_t(e), 1, to_next),
               jg.compute_relative_poses(jnp.asarray(e), 1, to_next))
    _close(tg.apply_sim3_on_w2c(_t(e), _t(T), _t(scale)),
           jg.apply_sim3_on_w2c(jnp.asarray(e), jnp.asarray(T), jnp.asarray(scale)))
    _close(tg.apply_sim3_on_point_maps(_t(pts), _t(T), _t(scale)),
           jg.apply_sim3_on_point_maps(jnp.asarray(pts), jnp.asarray(T), jnp.asarray(scale)))


def test_pose_encodings_match_jax():
    rng = np.random.default_rng(3)
    e = _rand_extr(rng, (2, 5))
    K = np.zeros((2, 5, 3, 3), np.float32)
    K[..., 0, 0], K[..., 1, 1], K[..., 2, 2] = 300.0, 280.0, 1.0
    hw = (154, 518)
    _close(tg.extri_to_pose_encoding(_t(e)), jg.extri_to_pose_encoding(jnp.asarray(e)))
    enc9 = np.asarray(jg.extri_intri_to_pose_encoding(jnp.asarray(e), jnp.asarray(K), hw))
    _close(tg.extri_intri_to_pose_encoding(_t(e), _t(K), hw), enc9)
    _close(tg.extri_intri_to_pose_encoding(_t(e), None),
           jg.extri_intri_to_pose_encoding(jnp.asarray(e), None))
    ge, gk = tg.pose_encoding_to_extri_intri(_t(enc9), hw)
    we, wk = jg.pose_encoding_to_extri_intri(jnp.asarray(enc9), hw)
    _close(ge, we)
    _close(gk, wk, atol=1e-3)  # focal lengths ~300: fp32 tan/divide ulps
    enc7 = np.asarray(jg.extri_to_pose_encoding(jnp.asarray(e)))
    _close(tg.pose_encoding_to_extri(_t(enc7)), jg.pose_encoding_to_extri(jnp.asarray(enc7)))


def test_average_pose_encodings_matches_jax_up_to_sign():
    rng = np.random.default_rng(4)
    e = _rand_extr(rng, (2, 3))
    enc = np.asarray(jg.extri_to_pose_encoding(jnp.asarray(e)))
    got = tg.average_pose_encodings(_t(enc)).numpy()
    want = np.asarray(jg.average_pose_encodings(jnp.asarray(enc)))
    _close(got[..., :3], want[..., :3])
    sign = np.sign((got[..., 3:] * want[..., 3:]).sum(-1, keepdims=True))
    _close(got[..., 3:] * sign, want[..., 3:])
