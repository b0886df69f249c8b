"""The port's copies of the JAX package's JAX-free host stages
(``topiaxl_torch.extract``, ``topiaxl_torch.native``,
``topiaxl_torch.core.config``) against the originals on the same numpy
inputs. The code is the same, so the results must be equal, bit for bit.

The port's cases run through its own C++ library, built from
``topiaxl_torch/native/`` into its build directory: each case calls the
native backend where the stage names one (which raises rather than
falling back) and then checks that the port's library is the one loaded.
"""

import os

import numpy as np
import pytest

from topiaxl import extract as jx
from topiaxl_torch import extract as tx
from topiaxl_torch import native as tnative

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _sphere_grid(n=28, r=0.37):
    ax = np.linspace(-0.5, 0.5, n, dtype=np.float32)
    x, y, z = np.meshgrid(ax, ax, ax, indexing="ij")
    # an off-centre sphere, so the mesh has no symmetry to hide an error
    return (np.sqrt((x - 0.03) ** 2 + y ** 2 + (z + 0.02) ** 2) - r).astype(
        np.float32)


def _mesh(ex):
    v, f = ex.extract_isosurface(_sphere_grid(), 0.0, backend="mc")
    return ex.clean_mesh(v, f)


def _isosurface(ex, _tmp):
    return ex.extract_isosurface(_sphere_grid(), 0.0, backend="mc")


def _clean_decimate(ex, _tmp):
    v, f = _mesh(ex)
    return (v, f) + tuple(ex.decimate_mesh(v, f, target=len(f) // 3,
                                           backend="native"))


def _box_unwrap(ex, _tmp):
    v, f = _mesh(ex)
    vn = ex.compute_vertex_normal(v, f)
    return (vn,) + tuple(ex.box_projection_uv_unwrap(v, vn, f))


def _quality_unwrap(ex, _tmp):
    v, f = _mesh(ex)
    return ex.quality_uv_unwrap(v, ex.compute_vertex_normal(v, f), f,
                                pack_grid=128)


def _rasterize(ex, _tmp):
    v, f = _mesh(ex)
    uv, ft = ex.box_projection_uv_unwrap(v, ex.compute_vertex_normal(v, f), f)
    return ex.rasterize_uv_atlas(uv[ft], v[f], 96, 96, backend="native")


def _inpaint(ex, _tmp):
    rng = np.random.default_rng(0)
    feats = rng.uniform(0, 1, (80, 72, 3)).astype(np.float32)
    mask = np.zeros((80, 72), bool)
    mask[20:40, 10:30] = True
    mask[55:60, 50:70] = True
    info = {}
    out = ex.nearest_inpaint(feats, mask, pad_width=6, info_out=info)
    assert info["branch"] == "native", info
    return out, np.array(info["pixels"])


def _glb(ex, tmp):
    v, f = _mesh(ex)
    vn = ex.compute_vertex_normal(v, f)
    vt, ft = ex.box_projection_uv_unwrap(v, vn, f)
    rng = np.random.default_rng(1)
    albedo = rng.uniform(0, 1, (32, 32, 3)).astype(np.float32)
    mr = rng.uniform(0, 1, (32, 32, 3)).astype(np.float32)
    path = os.path.join(tmp, f"{ex.__name__}.glb")
    ex.write_glb(path, v, f, vt, ft, albedo, mr, vn=vn)
    with open(path, "rb") as fh:
        blob = fh.read()
    return np.frombuffer(blob, np.uint8), path


CASES = {"isosurface": _isosurface, "clean_decimate": _clean_decimate,
         "box_unwrap": _box_unwrap, "quality_unwrap": _quality_unwrap,
         "rasterize": _rasterize, "inpaint": _inpaint, "glb": _glb}


@pytest.mark.parametrize("case", sorted(CASES))
def test_extract_stage_matches_jax_package(case, tmp_path):
    ours = CASES[case](tx, str(tmp_path))
    theirs = CASES[case](jx, str(tmp_path))
    if case == "glb":
        # the same bytes, and the port's reader takes them back
        np.testing.assert_array_equal(ours[0], theirs[0])
        from topiaxl.extract.glb import read_glb as jax_read
        from topiaxl_torch.extract.glb import read_glb

        gltf, blob = read_glb(ours[1])
        assert (gltf, blob) == jax_read(theirs[1])
        prim = gltf["meshes"][0]["primitives"][0]
        assert gltf["accessors"][prim["indices"]]["count"] > 0
        assert len(blob) > 0
    else:
        assert len(ours) == len(theirs)
        for a, b in zip(ours, theirs):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    lib = tnative.loaded_path()
    assert lib is not None and lib.name == tnative.LIB_NAME
    assert lib.parent.parent == tnative.build_root()
    assert lib.parent == tnative.build_dir()


def test_native_build_lands_in_build_dir_not_beside_sources():
    """The library is built into the ignored build tree, keyed by the
    sources, and nothing is written next to them."""
    tnative.marching_cubes(_sphere_grid(8))
    assert str(tnative.build_root()) == os.path.join(
        ROOT, "build", "topiaxl_torch_native")
    assert (tnative.build_dir() / tnative.LIB_NAME).is_file()
    here = os.path.dirname(tnative.__file__)
    assert not [n for n in os.listdir(here) if n.endswith(".so")]


def test_load_config_matches_jax_package():
    """configs/inference_dit.yml with dotlist overrides gives the same
    nested dict through the port's copy of the loader."""
    from topiaxl.core.config import load_config as jax_load
    from topiaxl_torch.core.config import load_config

    path = os.path.join(ROOT, "configs", "inference_dit.yml")
    overrides = ["inference.ddim=4", "model.generator.depth=2",
                 "train.batch_size=3", "inference.device=cpu",
                 "root_data_dir=/data/elsewhere"]
    ours, theirs = load_config(path, overrides), jax_load(path, overrides)
    assert ours.to_dict() == theirs.to_dict()
    assert ours.inference.ddim == 4 and ours.model.generator.depth == 2
    assert load_config(path).to_dict() == jax_load(path).to_dict()
