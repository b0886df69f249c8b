"""The port's GLB against the JAX package's, by the fidelity metrics of
``bench.py:bench_fidelity`` on the same textured sphere, on the CPU.

The two stage-2 chains differ by design (the port bakes with an exact
top-24 query per texel in an f32 band; JAX bakes by cells in an int8
band), so their GLBs are not byte-equal; each is scored against its own
PrimX field. Bars: the port's albedo PSNR at least the JAX package's less
1 dB and both above 30 dB; the port's 99th-percentile distance of the
vertices to the sphere at most the JAX package's plus half a cell
(1 / (mc - 1)), and both below one cell (2 / (mc - 1)), the bar of
``tests/test_fidelity.py``. Tier 1 runs mc 48 with a 128² texture; the
slow tier ``bench.py``'s own size (mc 128, texture 512). The JAX side is
``bench.py:bench_fidelity``'s method written out at a given size
(``jax_fidelity``): that function's sizes are fixed, and its comparison
with the reference implementation skips the test where the reference is
absent.
"""

import os
import tempfile

import numpy as np
import pytest
import torch

from test_torch_models import torch_threads  # noqa: F401 (autouse)
from topiaxl_torch.bench import bench_fidelity


def jax_fidelity(mc_resolution: int, decimate: int, texture_size: int):
    """``bench.py:bench_fidelity``'s albedo PSNR and geometry deviation for
    the JAX package, at a size given here (its sizes are fixed)."""
    import cv2
    import jax.numpy as jnp
    from test_fidelity import _psnr, _textured_sphere
    from topiaxl.extract.glb import read_glb
    from topiaxl.extract.rasterize import rasterize_uv_atlas
    from topiaxl.models import primx as primx_lib
    from topiaxl.pipelines import infer as P

    params = _textured_sphere()
    with tempfile.TemporaryDirectory() as td:
        glb = P.extract_glb(params, td, mc_resolution=mc_resolution,
                            decimate=decimate, texture_size=texture_size,
                            batch_size=32768, pos_scale=1.0)
        gltf, blob = read_glb(glb)
        prim = gltf["meshes"][0]["primitives"][0]

        def load(name, dtype, ncomp):
            acc = gltf["accessors"][name]
            view = gltf["bufferViews"][acc["bufferView"]]
            return np.frombuffer(blob, dtype, acc["count"] * ncomp,
                                 view.get("byteOffset", 0)).reshape(-1, ncomp)

        verts = load(prim["attributes"]["POSITION"], np.float32, 3)
        uv = load(prim["attributes"]["TEXCOORD_0"], np.float32, 2)
        faces = load(prim["indices"], np.uint32, 1).reshape(-1, 3)
        xyz_map, mask = rasterize_uv_atlas(uv[faces], verts[faces],
                                           texture_size, texture_size)
        tex = cv2.imread(os.path.join(td, "texture.jpg"))[..., ::-1] / 255.0
    dev = np.abs(np.linalg.norm(verts, axis=1) - 0.55)
    ys, xs = np.nonzero(mask)
    sub = slice(0, len(ys), max(len(ys) // 8192, 1))
    pts = jnp.asarray(xyz_map[ys[sub], xs[sub]], jnp.float32)
    out = primx_lib.query(params, pts, top_k=32, with_fallback=False,
                          outputs=("tex",))
    return {"albedo_psnr_db": round(_psnr(tex[ys[sub], xs[sub]],
                                          np.asarray(out["tex"])), 1),
            "geometry_p99_dev": round(float(np.percentile(dev, 99)), 5)}


def check_bars(port: dict, ref: dict, mc: int) -> None:
    half_cell, cell = 1.0 / (mc - 1), 2.0 / (mc - 1)
    print(f"fidelity at mc {mc}: port {port}, JAX {ref}")
    assert port["albedo_psnr_db"] >= ref["albedo_psnr_db"] - 1.0, (port, ref)
    assert port["albedo_psnr_db"] > 30 and ref["albedo_psnr_db"] > 30
    assert port["geometry_p99_dev"] <= ref["geometry_p99_dev"] + half_cell
    assert port["geometry_p99_dev"] < cell and ref["geometry_p99_dev"] < cell


def test_glb_fidelity_matches_jax():
    kw = dict(mc_resolution=48, decimate=3000, texture_size=128)
    port = bench_fidelity(torch.device("cpu"), **kw)
    check_bars(port, jax_fidelity(**kw), kw["mc_resolution"])
    # the port's UV metrics are those of its own copies of the JAX
    # package's unwraps on a watertight sphere
    assert port["uv_charts_box"] >= 1 and port["uv_charts_lscm"] >= 1
    assert 0.3 < port["uv_coverage_box"] <= 1.0


@pytest.mark.slow
def test_glb_fidelity_matches_jax_at_bench_size():
    kw = dict(mc_resolution=128, decimate=60000, texture_size=512)
    port = bench_fidelity(torch.device("cpu"), **kw)
    check_bars(port, jax_fidelity(**kw), kw["mc_resolution"])
