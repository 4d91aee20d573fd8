"""Port geometry (pdc_tpu_torch.geom) against pdc_tpu.geom and the numpy
oracle: camera intrinsics, (un)projection, flat indices and SE(3) helpers on
the same numpy inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pdc_tpu.geom import camera as jcam
from pdc_tpu.geom import transforms as jtf
from pdc_tpu_torch.geom import camera as tcam
from pdc_tpu_torch.geom import transforms as ttf
from tests.oracle import oracle_project, oracle_unproject

torch.set_num_threads(2)

K = np.array([[533.6, 0.0, 319.4], [0.0, 534.8, 236.4], [0.0, 0.0, 1.0]])


def _rand_pose(rng):
    q = rng.standard_normal(4)
    return jtf.se3_from_quat_trans(q / np.linalg.norm(q), rng.standard_normal(3))


def test_camera_intrinsics_match():
    info = {"camera_matrix": {"data": [533.6, 0, 319.4, 0, 534.8, 236.4, 0, 0, 1]},
            "image_width": 640, "image_height": 480}
    a, b = jcam.CameraIntrinsics.from_dict(info), tcam.CameraIntrinsics.from_dict(info)
    assert dataclasses_equal(a, b)
    np.testing.assert_array_equal(a.K, b.K)
    c, d = jcam.CameraIntrinsics.from_K(K, 640, 480), tcam.CameraIntrinsics.from_K(K, 640, 480)
    assert dataclasses_equal(c, d)


def dataclasses_equal(a, b):
    return all(getattr(a, f) == getattr(b, f) for f in ("cx", "cy", "fx", "fy", "width", "height"))


def test_unproject_project_match_jax_and_oracle():
    rng = np.random.default_rng(0)
    uv = np.stack([rng.integers(0, 640, 500), rng.integers(0, 480, 500)], -1)
    z = rng.uniform(0.3, 2.0, 500).astype(np.float32)
    p_t = tcam.unproject_to_camera(torch.as_tensor(uv), torch.as_tensor(z), K)
    p_j = np.asarray(jcam.unproject_to_camera(uv, z, K))
    # same float32 ops, matrix products summed in another order: a few ulps
    np.testing.assert_allclose(p_t.numpy(), p_j, rtol=1e-6, atol=1e-7)
    for i in range(0, 500, 50):
        np.testing.assert_allclose(p_t[i].numpy(), oracle_unproject(uv[i, 0], uv[i, 1], z[i], K),
                                   rtol=1e-5)
    uv_t, z_t = tcam.project_to_image(p_t, K)
    uv_j, z_j = jcam.project_to_image(p_j, K)
    np.testing.assert_allclose(uv_t.numpy(), np.asarray(uv_j), rtol=1e-6, atol=1e-4)
    np.testing.assert_array_equal(z_t.numpy(), np.asarray(z_j))
    for i in range(0, 500, 50):
        o_uv, o_z = oracle_project(p_t[i].double().numpy(), K)
        np.testing.assert_allclose(uv_t[i].numpy(), o_uv, atol=1e-3)
    np.testing.assert_allclose(uv_t.numpy(), uv, atol=1e-3)  # the round trip


def test_flat_indices_match():
    rng = np.random.default_rng(1)
    uv = np.stack([rng.uniform(0, 640, 300), rng.uniform(0, 480, 300)], -1).astype(np.float32)
    flat_t = tcam.uv_to_flat(torch.as_tensor(uv), 640)
    np.testing.assert_array_equal(flat_t.numpy(), np.asarray(jcam.uv_to_flat(uv, 640)))
    np.testing.assert_array_equal(tcam.flat_to_uv(flat_t, 640).numpy(),
                                  np.asarray(jcam.flat_to_uv(np.asarray(flat_t), 640)))


def test_host_transforms_exact():
    rng = np.random.default_rng(2)
    for _ in range(5):
        q = rng.standard_normal(4)
        np.testing.assert_array_equal(ttf.quaternion_matrix(q), jtf.quaternion_matrix(q))
        t = rng.standard_normal(3)
        np.testing.assert_array_equal(ttf.se3_from_quat_trans(q, t), jtf.se3_from_quat_trans(q, t))
        A, B = _rand_pose(rng), _rand_pose(rng)
        assert ttf.pose_distance(A, B) == jtf.pose_distance(A, B)
        assert ttf.pose_angle(A, B) == jtf.pose_angle(A, B)
        np.testing.assert_array_equal(ttf.invert_se3(A), jtf.invert_se3(A))
    np.testing.assert_array_equal(ttf.quaternion_matrix(np.zeros(4)), np.eye(3))


@pytest.mark.parametrize("batch", [(), (3,)])
def test_invert_and_transform_match_jax(batch):
    rng = np.random.default_rng(3)
    T = np.stack([_rand_pose(rng) for _ in range(int(np.prod(batch)))]).astype(np.float32)
    T = T.reshape(batch + (4, 4))
    pts = rng.standard_normal(batch + (200, 3)).astype(np.float32)
    inv_t = ttf.invert_se3(torch.as_tensor(T))
    out_t = ttf.transform_points(inv_t, torch.as_tensor(pts))
    flat_T, flat_p = T.reshape(-1, 4, 4), pts.reshape(-1, 200, 3)
    for i in range(flat_T.shape[0]):
        inv_j = np.asarray(jtf.invert_se3(jnp.asarray(flat_T[i])))
        np.testing.assert_allclose(inv_t.reshape(-1, 4, 4)[i].numpy(), inv_j, rtol=1e-6, atol=1e-7)
        out_j = np.asarray(jtf.transform_points(inv_j, flat_p[i]))
        np.testing.assert_allclose(out_t.reshape(-1, 200, 3)[i].numpy(), out_j,
                                   rtol=1e-6, atol=1e-6)
        # applying T after its inverse gives the points back
        back = ttf.transform_points(torch.as_tensor(flat_T[i]), out_t.reshape(-1, 200, 3)[i])
        np.testing.assert_allclose(back.numpy(), flat_p[i], atol=1e-5)


def test_default_K_matrix_equals_jax():
    got, want = tcam.default_K_matrix(), jcam.default_K_matrix()
    assert got.dtype == want.dtype == np.float64 and got.shape == (3, 3)
    np.testing.assert_array_equal(got, want)
    got[0, 0] = 0.0  # a new array each call, as in pdc_tpu
    assert tcam.default_K_matrix()[0, 0] == want[0, 0]
