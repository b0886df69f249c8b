"""The port's mesh SDF (``topiaxl_torch/extract/mesh_sdf.py``) against the
JAX package's on the CPU: a marching-tetrahedra sphere and a cube (both
convex, so every face of an argmin tie gives the same sign). Bars:
distance 1e-5, signs exact, ``sample_surface`` the same faces and points
(1e-6)."""

import numpy as np
import pytest
import torch

from test_torch_models import torch_threads  # noqa: F401
from topiaxl.extract.mesh_sdf import MeshSDF as JaxMeshSDF
from topiaxl.extract.mesh_sdf import _closest_point_on_tri as jax_closest
from topiaxl_torch.extract.isosurface import extract_isosurface
from topiaxl_torch.extract.mesh_sdf import MeshSDF, _closest_point_on_tri

CUBE_V = np.array([[x, y, z] for x in (-0.5, 0.5) for y in (-0.5, 0.5)
                   for z in (-0.5, 0.5)], np.float32)
CUBE_F = np.array([[0, 1, 3], [0, 3, 2], [4, 6, 7], [4, 7, 5],
                   [0, 4, 5], [0, 5, 1], [2, 3, 7], [2, 7, 6],
                   [0, 2, 6], [0, 6, 4], [1, 5, 7], [1, 7, 3]], np.int64)


def sphere_mesh(r=20, radius=0.5):
    lin = np.linspace(-1, 1, r, dtype=np.float32)
    z, y, x = np.meshgrid(lin, lin, lin, indexing="ij")
    return extract_isosurface(np.sqrt(x**2 + y**2 + z**2) - radius)


MESHES = {"sphere": sphere_mesh, "cube": lambda: (CUBE_V, CUBE_F)}


@pytest.mark.parametrize("name", sorted(MESHES))
def test_mesh_sdf_matches_jax(name):
    v, f = MESHES[name]()
    pts = np.random.default_rng(0).uniform(-0.9, 0.9, (700, 3)).astype("f")
    # on the surface and on the cube's vertices and edge midpoints too
    pts = np.concatenate([pts, v[:40], 0.5 * (v[f[:20, 0]] + v[f[:20, 1]])])
    ref = JaxMeshSDF(v, f, chunk=256)(pts)
    got = MeshSDF(v, f, chunk=300, device="cpu")(pts)
    assert got.dtype == np.float32 and got.shape == ref.shape
    np.testing.assert_allclose(np.abs(got), np.abs(ref), atol=1e-5, rtol=0)
    np.testing.assert_array_equal(np.sign(got), np.sign(ref))
    # a sanity read of the field: inside negative, outside positive
    inside = np.abs(pts).max(1) < 0.3 if name == "cube" else \
        np.linalg.norm(pts, axis=1) < 0.4
    assert (got[inside] < 0).all() and (got[np.abs(pts).max(1) > 0.8] > 0).all()


@pytest.mark.parametrize("name", sorted(MESHES))
def test_sample_surface_matches_jax(name):
    v, f = MESHES[name]()
    for seed in (0, 3):
        ref = JaxMeshSDF(v, f).sample_surface(512, seed=seed)
        got = MeshSDF(v, f, device="cpu").sample_surface(512, seed=seed)
        np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)


def test_closest_point_on_tri_matches_jax():
    """Every region of the cascade (face, three edges, three vertices)."""
    rng = np.random.default_rng(4)
    p = rng.uniform(-2, 2, (400, 1, 3)).astype(np.float32)
    tri = rng.uniform(-1, 1, (3, 1, 8, 3)).astype(np.float32)
    ref = np.asarray(jax_closest(p, *tri))
    got = _closest_point_on_tri(torch.from_numpy(p),
                                *map(torch.from_numpy, tri)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)
