"""``topiaxl_torch.render.geom`` against ``topiaxl.render.geom`` on the
CPU, f32, inputs from numpy seeds. Bar: 1e-5 (the same formulas, summed
in other orders); the UV index images and their inpaint exactly."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_models import torch_threads  # noqa: F401
from topiaxl.render import geom as jgeom
from topiaxl_torch.render import geom

TOL = 1e-5


def _close(got, ref, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), atol=tol,
                               rtol=0)


def _mesh():
    """A bumpy 6 x 6 grid of vertices, two triangles a cell, UVs = xy."""
    rng = np.random.default_rng(0)
    n = 6
    ys, xs = np.meshgrid(np.linspace(0, 1, n), np.linspace(0, 1, n),
                         indexing="ij")
    v = np.stack([xs, ys, 0.1 * rng.standard_normal(xs.shape)], -1)
    v = v.reshape(-1, 3).astype(np.float32)
    f = []
    for i in range(n - 1):
        for j in range(n - 1):
            a = i * n + j
            f += [[a, a + 1, a + n + 1], [a, a + n + 1, a + n]]
    return v, np.array(f, np.int64), v[:, :2].copy()


def test_normals_tbn_and_view_cos_match_jax():
    v, f, vt = _mesh()
    tv, tf, tvt = map(torch.from_numpy, (v, f, vt))
    jv, jf, jvt = map(jnp.asarray, (v, f, vt))
    _close(geom.face_normals(tv[None], tf), jgeom.face_normals(jv[None], jf))
    _close(geom.vert_normals(tv, tf), jgeom.vert_normals(jv, jf))
    _close(geom.vert_normals(tv[None].repeat(2, 1, 1), tf),
           jgeom.vert_normals(jnp.stack([jv, jv]), jf))
    for a, b in zip(geom.compute_tbn(tv, tvt, tf, tf),
                    jgeom.compute_tbn(jv, jvt, jf, jf)):
        _close(a, b)
    cam = np.array([0.3, 0.2, 4.0], np.float32)
    _close(geom.compute_view_cos(tv, tf, torch.from_numpy(cam)),
           jgeom.compute_view_cos(jv, jf, jnp.asarray(cam)))


def test_rotations_match_jax():
    rng = np.random.default_rng(1)
    rvec = rng.standard_normal((8, 3)).astype(np.float32)
    rvec *= (rng.uniform(0.1, 3.0, (8, 1))
             / np.linalg.norm(rvec, axis=1, keepdims=True)).astype(np.float32)
    R = geom.axisangle_to_matrix(torch.from_numpy(rvec))
    _close(R, jgeom.axisangle_to_matrix(jnp.asarray(rvec)))
    for a, b in zip(geom.matrix_to_axisangle(R),
                    jgeom.matrix_to_axisangle(jnp.asarray(R.numpy()))):
        _close(a, b, 1e-4)
    for alpha in (0.0, 0.3, 1.0):
        _close(geom.rotation_interp(R[0], R[1], alpha),
               jgeom.rotation_interp(jnp.asarray(R[0].numpy()),
                                     jnp.asarray(R[1].numpy()), alpha), 1e-4)


@pytest.mark.parametrize("size", [16, 32])
def test_uv_maps_match_jax(size):
    v, f, vt = _mesh()
    idx, bary = geom.make_uv_barys(vt, f, size)
    jidx, jbary = jgeom.make_uv_barys(vt, f, size)
    np.testing.assert_array_equal(idx, jidx)
    _close(bary, jbary)
    idx[:2] = -1                                   # holes to fill
    for a, b in zip(geom.index_image_impaint(idx, bary),
                    jgeom.index_image_impaint(idx, bary)):
        np.testing.assert_array_equal(a, b)
    got = geom.values_to_uv(torch.from_numpy(v), idx, bary, torch.from_numpy(f))
    _close(got, jgeom.values_to_uv(jnp.asarray(v), idx, bary, jnp.asarray(f)))
    _close(geom.make_postex(v, idx, bary, f),
           jgeom.make_postex(v, idx, bary, f))
    uv = np.random.default_rng(2).uniform(0, 1, (50, 2)).astype(np.float32)
    _close(geom.sample_uv(got, torch.from_numpy(uv)),
           jgeom.sample_uv(jnp.asarray(got.numpy()), jnp.asarray(uv)))


@pytest.mark.parametrize("normalize", [False, True])
def test_project_points_multi_matches_jax(normalize):
    rng = np.random.default_rng(3)
    Rt = np.zeros((2, 3, 4), np.float32)
    Rt[:, :3, :3] = np.diag([1.0, -1.0, -1.0])
    Rt[1, :3, :3] = Rt[1, :3, :3] @ np.array(
        [[0.8, -0.6, 0], [0.6, 0.8, 0], [0, 0, 1]], np.float32)
    Rt[:, :, 3] = [[0.1, 0.0, 5.0], [-0.2, 0.1, 4.0]]
    K = np.tile(np.array([[100.0, 0, 32], [0, 90.0, 30], [0, 0, 1]],
                         np.float32), (2, 1, 1))
    p = rng.uniform(-0.5, 0.5, (3, 7, 3)).astype(np.float32)
    kw = dict(normalize=normalize, size=(60, 64))
    got = geom.project_points_multi(*map(torch.from_numpy, (p, Rt, K)), **kw)
    ref = jgeom.project_points_multi(*map(jnp.asarray, (p, Rt, K)), **kw)
    for a, b in zip(got, ref):
        _close(a, b, 1e-4)
