"""The port's geometry (`ops/pose.py`'s VO family and angular errors,
`ops/camera.py`, `ops/align.py`, `ops/pgo.py`) against the JAX package's
functions on the CPU, on the same seeded numpy inputs.

Tolerances, stated once:
  * float32 closed forms: rtol 1e-5, with atol 1e-6 for entries near 0
    (CLOSED);
  * PGO, 10 Gauss-Newton steps in float32 (chained and fully connected,
    N = 8-16, both VO conventions): atol 1e-4 (PGO_ATOL); the measured
    gap is ~1e-7 (6e-8 chained and 9e-8 fully connected at N = 12);
  * `mat2quat` in float32: bit for bit (the port rounds its square roots
    and sums the norm's squares as XLA's CPU code does).
Alignment inputs have distinct singular values, so the rotation does not
depend on the SVD's sign choices.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from relpose_gnn_tpu.ops import align as jax_align
from relpose_gnn_tpu.ops import camera as jax_camera
from relpose_gnn_tpu.ops import pgo as jax_pgo
from relpose_gnn_tpu.ops import pose as jax_pose
from relpose_gnn_tpu_torch.ops import align, camera, pgo
from relpose_gnn_tpu_torch.ops import pose

CLOSED = dict(rtol=1e-5, atol=1e-6)
PGO_ATOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _close(got, want, **tol):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), **(tol or CLOSED))


def _jit(fn, **static):
    """`fn` jitted with its keyword arguments fixed: one compile a call
    site, where eager JAX compiles every primitive it meets."""
    return jax.jit(functools.partial(fn, **static))


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _pose6(rng, *shape):
    t = rng.normal(size=shape + (3,))
    w = rng.normal(scale=0.6, size=shape + (3,))
    return np.concatenate([t, w], -1).astype(np.float32)


def _pose7(rng, n):
    t = np.cumsum(rng.normal(scale=0.3, size=(n, 3)), axis=0)
    q = Rotation.random(n, rng=rng).as_quat()[:, [3, 0, 1, 2]]
    q *= np.where(q[:, :1] >= 0, 1, -1)
    return np.concatenate([t, q], 1).astype(np.float32)


def _K(fx=500.0, fy=480.0, cx=320.0, cy=240.0):
    return np.asarray([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], np.float32)


def _Tcw(rng, n):
    R = Rotation.random(n, rng=rng).as_matrix()
    t = rng.normal(size=(n, 3, 1))
    return np.concatenate([R, t], -1).astype(np.float32)


# -- ops/pose.py: the VO family and the angular errors -----------------------

@pytest.mark.parametrize("name", ["calc_vo_logq", "calc_vo_relative_logq"])
def test_pose6_pair_functions(name):
    rng = np.random.default_rng(0)
    p0, p1 = _pose6(rng, 2, 5), _pose6(rng, 2, 5)
    _close(getattr(pose, name)(_t(p0), _t(p1)),
           _jit(getattr(jax_pose, name))(jnp.asarray(p0),
                                         jnp.asarray(p1)))


def test_calc_vo_relative():
    rng = np.random.default_rng(1)
    p0, p1 = _pose7(rng, 9), _pose7(rng, 9)
    _close(pose.calc_vo_relative(_t(p0), _t(p1)),
           _jit(jax_pose.calc_vo_relative)(jnp.asarray(p0),
                                           jnp.asarray(p1)))


@pytest.mark.parametrize("name", ["calc_vos", "calc_vos_fc",
                                  "calc_vos_simple"])
def test_sequence_vos(name):
    rng = np.random.default_rng(2)
    p = _pose6(rng, 3, 6)
    got, want = (getattr(pose, name)(_t(p)),
                 _jit(getattr(jax_pose, name))(jnp.asarray(p)))
    assert tuple(got.shape) == want.shape
    _close(got, want)


def test_angular_errors():
    rng = np.random.default_rng(3)
    q1 = Rotation.random(50, rng=rng).as_quat()[:, [3, 0, 1, 2]]
    q2 = Rotation.random(50, rng=rng).as_quat()[:, [3, 0, 1, 2]]
    q2[:5] = q1[:5]                       # zero angle: arccos at the clip
    _close(pose.quaternion_angular_error(_t(q1), _t(q2)),
           _jit(jax_pose.quaternion_angular_error)(
               jnp.asarray(q1, jnp.float32), jnp.asarray(q2, jnp.float32)),
           rtol=1e-5, atol=2e-2)
    w1, w2 = _pose6(rng, 40)[:, 3:], _pose6(rng, 40)[:, 3:]
    _close(pose.log_quaternion_angular_error(_t(w1), _t(w2)),
           _jit(jax_pose.log_quaternion_angular_error)(jnp.asarray(w1),
                                                       jnp.asarray(w2)))


def test_mat2quat_is_jax_bit_for_bit():
    rng = np.random.default_rng(4)
    R = np.concatenate([Rotation.random(5000, rng=rng).as_matrix(),
                        np.stack([np.eye(3), np.diag([1, -1, -1]),
                                  np.diag([-1, 1, -1]),
                                  np.diag([-1, -1, 1])])]).astype(np.float32)
    np.testing.assert_array_equal(pose.mat2quat(_t(R)).numpy(),
                                  np.asarray(_jit(jax_pose.mat2quat)(
                                      jnp.asarray(R))))


# -- ops/camera.py ---------------------------------------------------------

def test_x_2d_coords():
    _close(camera.x_2d_coords(5, 7, "cpu"), jax_camera.x_2d_coords(5, 7),
           rtol=0, atol=0)


def test_pi_and_pi_inv():
    rng = np.random.default_rng(5)
    K = np.stack([_K(), _K(600, 600, 100, 80)])
    x2d = rng.uniform(0, 600, size=(2, 50, 2)).astype(np.float32)
    d = rng.uniform(0.5, 5.0, size=(2, 50, 1)).astype(np.float32)
    X = camera.pi_inv(_t(K), _t(x2d), _t(d))
    _close(X, _jit(jax_camera.pi_inv)(jnp.asarray(K), jnp.asarray(x2d),
                                      jnp.asarray(d)))
    X[0, 0, 2] = 0.0                          # the |z| < 1e-12 guard
    got = camera.pi(_t(K), X)
    want = _jit(jax_camera.pi)(jnp.asarray(K), jnp.asarray(X.numpy()))
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("name", ["inv_pose", "camera_pose_inv"])
def test_pose_inverses(name):
    rng = np.random.default_rng(6)
    T = _Tcw(rng, 4)
    got = getattr(camera, name)(_t(T[:, :, :3]), _t(T[:, :, 3]))
    want = _jit(getattr(jax_camera, name))(jnp.asarray(T[:, :, :3]),
                                           jnp.asarray(T[:, :, 3]))
    for g, w in zip(got, want):
        _close(g, w)


def test_transform_points_and_camera_center():
    rng = np.random.default_rng(7)
    T = _Tcw(rng, 3)
    X = rng.normal(size=(3, 20, 3)).astype(np.float32)
    R, t = T[:, :, :3], T[:, :, 3]
    _close(camera.transform_points(_t(R), _t(t), _t(X)),
           _jit(jax_camera.transform_points)(jnp.asarray(R),
                                             jnp.asarray(t), jnp.asarray(X)))
    _close(camera.camera_center_from_Tcw(_t(R), _t(t)),
           _jit(jax_camera.camera_center_from_Tcw)(jnp.asarray(R),
                                                   jnp.asarray(t)))


def test_decode_depth_mm():
    d = np.random.default_rng(8).integers(0, 65536, (6, 9)).astype(np.uint16)
    d[0, :3] = 65535
    got = camera.decode_depth_mm(torch.from_numpy(d.astype(np.int32)))
    # eager, as the JAX package calls it (under jit XLA multiplies by
    # 0.001 in place of the division)
    _close(got, jax_camera.decode_depth_mm(jnp.asarray(d)), rtol=0, atol=0)


def test_preprocess_scene():
    rng = np.random.default_rng(9)
    L, H, W = 2, 12, 16
    rgb = rng.random((L, H, W, 3)).astype(np.float32)
    depth = rng.uniform(0.5, 4.0, (L, H, W)).astype(np.float32)
    depth[0, :2] = 0.0
    K = np.stack([_K(20, 21, W / 2, H / 2)] * L)
    T = _Tcw(rng, L)
    got = camera.preprocess_scene(_t(rgb), _t(depth), _t(K), _t(T))
    want = _jit(jax_camera.preprocess_scene)(
        jnp.asarray(rgb), jnp.asarray(depth), jnp.asarray(K), jnp.asarray(T))
    assert sorted(got) == sorted(want)
    for k in want:
        # X_world is centred: its small entries take an absolute bound
        _close(got[k], want[k], rtol=1e-5, atol=1e-5)


def test_preprocess_query():
    rng = np.random.default_rng(10)
    T = _Tcw(rng, 3)
    K = np.stack([_K()] * 3)
    c = rng.normal(size=3).astype(np.float32)
    got = camera.preprocess_query(_t(T), _t(K), _t(c), (256, 341),
                                  (480, 640))
    want = _jit(jax_camera.preprocess_query, out_hw=(256, 341),
                in_hw=(480, 640))(jnp.asarray(T), jnp.asarray(K),
                                  jnp.asarray(c))
    for k in want:
        _close(got[k], want[k])


@pytest.mark.parametrize("name", ["rel_distance", "rel_rot_angle"])
def test_pose_metrics(name):
    rng = np.random.default_rng(11)
    T1, T2 = _Tcw(rng, 30), _Tcw(rng, 30)
    _close(getattr(camera, name)(_t(T1), _t(T2)),
           _jit(getattr(jax_camera, name))(jnp.asarray(T1), jnp.asarray(T2)))


def test_solve_pnp_ransac_matches_jax():
    pytest.importorskip("cv2", reason="OpenCV is not installed here: PnP "
                        "is a host call into it in both packages")
    rng = np.random.default_rng(12)
    R_true = Rotation.from_euler("xyz", [0.2, -0.1, 0.3]).as_matrix()
    t_true = np.array([0.5, -0.2, 2.0])
    K = np.array([[500.0, 0, 320], [0, 500.0, 240], [0, 0, 1]])
    X_world = rng.uniform(-1, 1, size=(60, 3)) + [0, 0, 4]
    X_cam = X_world @ R_true.T + t_true
    x_2d = np.stack([X_cam[:, 0] / X_cam[:, 2] * 500 + 320,
                     X_cam[:, 1] / X_cam[:, 2] * 500 + 240], axis=1)
    x_2d[:5] += 40.0                            # outliers
    got = camera.solve_pnp_ransac(x_2d, X_world, K)
    want = jax_camera.solve_pnp_ransac(x_2d, X_world, K)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)     # the same OpenCV call
    np.testing.assert_allclose(got[0], R_true, atol=1e-3)
    assert not got[2][:5].any() and got[2][5:].all()


# -- ops/align.py ----------------------------------------------------------

def _points(rng, batch, n, d):
    x = rng.normal(size=batch + (n, d)) * np.arange(1, d + 1)  # distinct
    R = Rotation.random(rng=rng).as_matrix()[:d, :d]
    if d == 2:
        th = rng.uniform(0, 2 * np.pi)
        R = np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]])
    y = 1.7 * x @ R.T + rng.normal(size=d) + rng.normal(scale=0.05,
                                                        size=x.shape)
    return x.astype(np.float32), y.astype(np.float32)


@pytest.mark.parametrize("name,d,batch", [
    ("align_3d_pts", 3, ()), ("align_3d_pts", 3, (4,)),
    ("align_3d_pts_noscale", 3, ()), ("align_2d_pts", 2, ()),
    ("align_pts", 3, (2, 3))])
def test_align_points(name, d, batch):
    rng = np.random.default_rng(13)
    x, y = _points(rng, batch, 20, d)
    got = getattr(align, name)(_t(x), _t(y))
    want = _jit(getattr(jax_align, name))(jnp.asarray(x), jnp.asarray(y))
    for g, w in zip(got, want):
        _close(g, w, rtol=1e-5, atol=1e-5)
    _close(align.apply_similarity(*got, _t(x)),
           _jit(jax_align.apply_similarity)(*want, jnp.asarray(x)),
           rtol=1e-5, atol=1e-5)


def test_reflection_guard():
    rng = np.random.default_rng(14)
    x = (rng.normal(size=(10, 3)) * [1, 2, 3]).astype(np.float32)
    y = x.copy()
    y[:, 0] = -y[:, 0]
    _, R, _ = align.align_3d_pts(_t(x), _t(y))
    _, Rj, _ = _jit(jax_align.align_3d_pts)(jnp.asarray(x), jnp.asarray(y))
    assert torch.linalg.det(R) > 0.99
    _close(R, Rj, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("constraint", [True, False])
@pytest.mark.parametrize("with_scale", [True, False])
def test_align_camera_poses(constraint, with_scale):
    rng = np.random.default_rng(15)
    gt = _pose7(rng, 25)
    gt[:, :3] *= [1.0, 2.0, 3.0]
    pred = gt.copy()
    pred[:, :3] = 0.8 * pred[:, :3] @ Rotation.random(
        rng=rng).as_matrix().T.astype(np.float32) + [1, 0, -1]
    pred[:, :3] += rng.normal(scale=0.05, size=(25, 3))
    q = pred[:, 3:] + rng.normal(scale=0.02, size=(25, 4))
    pred[:, 3:] = q / np.linalg.norm(q, axis=1, keepdims=True)
    args = [pred[:, :3], pred[:, 3:], gt[:, :3], gt[:, 3:]]
    got = align.align_camera_poses(*map(_t, args), with_scale=with_scale,
                                   use_rotation_constraint=constraint)
    want = _jit(jax_align.align_camera_poses, with_scale=with_scale,
                use_rotation_constraint=constraint)(*map(jnp.asarray, args))
    _close(got[0], want[0], rtol=1e-5, atol=1e-5)
    _close(got[1], want[1], rtol=1e-5, atol=1e-5)
    for g, w in zip(got[2], want[2]):
        _close(g, w, rtol=1e-5, atol=1e-5)


# -- ops/pgo.py ------------------------------------------------------------

def _pgo_inputs(n, seed):
    rng = np.random.default_rng(seed)
    targ = _pose7(rng, n)
    pred = targ.copy()
    pred[:, :3] += rng.normal(scale=0.2, size=(n, 3))
    q = pred[:, 3:] + rng.normal(scale=0.05, size=(n, 4))
    pred[:, 3:] = q / np.linalg.norm(q, axis=1, keepdims=True)
    return pred, targ


def test_edges():
    for n in (1, 2, 7):
        for a, b in zip(pgo.chain_edges(n) + pgo.fc_edges(n),
                        jax_pgo.chain_edges(n) + jax_pgo.fc_edges(n)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("rotate_frame", [False, True])
def test_vos_from_target_poses(rotate_frame):
    _, targ = _pgo_inputs(10, 16)
    got = pgo.vos_from_target_poses(targ.astype(np.float64), rotate_frame,
                                    device="cpu")
    want = jax_pgo.vos_from_target_poses(targ.astype(np.float64),
                                         rotate_frame)
    assert got.dtype == want.dtype == np.float32
    _close(got, want)


@pytest.mark.parametrize("rotate_frame", [False, True])
@pytest.mark.parametrize("n,fc", [(8, False), (16, False), (8, True),
                                  (12, True)])
def test_optimize_pose_graph(n, fc, rotate_frame):
    pred, targ = _pgo_inputs(n, 17 + n)
    if fc:
        src, dst = pgo.fc_edges(n)
        rel = (pose.calc_vo_relative if not rotate_frame else pose.calc_vo)
        vos = rel(_t(targ[src]), _t(targ[dst])).numpy()
    else:
        vos = pgo.vos_from_target_poses(targ, rotate_frame, device="cpu")
    kw = dict(fc=fc, sax=0.5, saq=2.0, srx=1.5, srq=0.7)
    got = pgo.optimize_pose_graph(pred, vos, device="cpu", **kw)
    want = jax_pgo.optimize_pose_graph(pred, vos, **kw)
    assert got.shape == (n, 7) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=PGO_ATOL)
    np.testing.assert_allclose(np.linalg.norm(got[:, 3:], axis=1), 1.0,
                               atol=1e-5)


def test_optimize_poses_driver():
    pred, targ = _pgo_inputs(8, 30)
    got = pgo.optimize_poses(pred, target_poses=targ, device="cpu")
    want = jax_pgo.optimize_poses(pred, target_poses=targ)
    np.testing.assert_allclose(got, want, rtol=0, atol=PGO_ATOL)
    assert pgo.optimize_poses(pred, device="cpu") is None
    with pytest.raises(ValueError, match="VO measurements"):
        pgo.optimize_poses(pred, vos=np.zeros((3, 7)), device="cpu")


def test_float64_reference_evaluation():
    """`dtype=torch.float64` (the smoke run's reference) agrees with the
    float32 optimisation to its rounding."""
    pred, targ = _pgo_inputs(10, 31)
    vos = pgo.vos_from_target_poses(targ, device="cpu")
    f32 = pgo.optimize_pose_graph(pred, vos, device="cpu")
    f64 = pgo.optimize_pose_graph(pred, vos, device="cpu",
                                  dtype=torch.float64)
    assert f64.dtype == np.float64
    np.testing.assert_allclose(f32, f64, rtol=0, atol=1e-5)
