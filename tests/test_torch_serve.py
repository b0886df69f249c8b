"""Multi-asset serving in the port (``pipelines/infer.py:serve_assets``)
on the CPU: the pipelined and batched loops against serial calls from
the same generator state (their GLBs byte for byte), the ``dpm`` chain,
``load_primx`` across the two packages' files, and ``extract_glb``'s
``inpaint_pad``.

The tiny DiT and VAE are randomised, and the latent statistics put the
primitives' scales at ~0.35 and their positions inside the unit cube, so
every asset has a surface (asserted, never skipped)."""

import os

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_models import tiny_dit, tiny_vae, torch_threads  # noqa: F401
from test_torch_pipeline import sphere_shell
from topiaxl_torch.extract.glb import read_glb
from topiaxl_torch.models.primx import PrimXParams

EXTRACT = dict(mc_resolution=16, decimate=2000, texture_size=64,
               batch_size=4096)


def _models():
    from topiaxl_torch.diffusion import create_diffusion

    dit, _ = tiny_dit(seed=20, depth=1, hidden=32, heads=2, seq=8, cond=6)
    vae, _ = tiny_vae(seed=21)
    diffusion = create_diffusion("ddim3", noise_schedule="squaredcos_cap_v2",
                                 parameterization="v", diffusion_steps=50)
    mean = np.zeros(68, np.float32)
    std = np.ones(68, np.float32)
    mean[0], std[0] = 0.35, 0.02          # scale
    std[1:4] = 0.25                       # position
    rng = np.random.default_rng(22)
    ys = [torch.from_numpy(rng.standard_normal((1, 3, 6)).astype(np.float32))
          for _ in range(3)]
    return dit, vae, diffusion, ys, mean, std


def _faces(glb: str) -> int:
    gltf, _ = read_glb(glb)
    prim = gltf["meshes"][0]["primitives"][0]
    return gltf["accessors"][prim["indices"]]["count"] // 3


def _bytes(path: str) -> bytes:
    with open(path, "rb") as f:
        return f.read()


def test_serve_assets_pipelined_equals_serial(tmp_path):
    from topiaxl_torch.pipelines import infer as P

    dit, vae, diffusion, ys, mean, std = _models()
    dirs = [str(tmp_path / f"a{i}") for i in range(3)]
    glbs = P.serve_assets(dit, vae, diffusion, ys, dirs, mean, std,
                          cfg_scale=2.0, generator=torch.Generator().manual_seed(7),
                          **EXTRACT)
    assert glbs == [os.path.join(d, "pbr_mesh.glb") for d in dirs]

    gen = torch.Generator().manual_seed(7)
    for i, y in enumerate(ys):
        p = P.generate_primx(dit, vae, diffusion, y, mean, std, cfg_scale=2.0,
                             generator=gen)
        g = P.extract_glb(p, str(tmp_path / f"s{i}"), **EXTRACT)
        assert _faces(g) > 0
        assert _bytes(g) == _bytes(glbs[i]), i
    assert len({_bytes(g) for g in glbs}) == 3     # three different assets


def test_serve_assets_stage1_batched(tmp_path):
    """``stage1_batch=2``: assets {0, 1} share one chain at batch 2, asset
    2 runs alone; each equals the direct batched call."""
    from topiaxl_torch.pipelines import infer as P

    dit, vae, diffusion, ys, mean, std = _models()
    dirs = [str(tmp_path / f"b{i}") for i in range(3)]
    glbs = P.serve_assets(dit, vae, diffusion, ys, dirs, mean, std,
                          cfg_scale=2.0, stage1_batch=2,
                          generator=torch.Generator().manual_seed(8),
                          **EXTRACT)
    gen = torch.Generator().manual_seed(8)
    direct = P.generate_primx(dit, vae, diffusion, torch.cat(ys[:2]), mean,
                              std, cfg_scale=2.0, generator=gen)
    direct.append(P.generate_primx(dit, vae, diffusion, ys[2], mean, std,
                                   cfg_scale=2.0, generator=gen))
    for i, p in enumerate(direct):
        g = P.extract_glb(p, str(tmp_path / f"d{i}"), **EXTRACT)
        assert _faces(g) > 0
        assert _bytes(g) == _bytes(glbs[i]), i


def test_serve_assets_dpm_sampler(tmp_path):
    from topiaxl_torch.pipelines import infer as P

    dit, vae, diffusion, ys, mean, std = _models()
    glbs = P.serve_assets(dit, vae, diffusion, ys[:1], [str(tmp_path / "a")],
                          mean, std, cfg_scale=2.0, sampler="dpm",
                          generator=torch.Generator().manual_seed(9),
                          **EXTRACT)
    p = P.generate_primx(dit, vae, diffusion, ys[0], mean, std, cfg_scale=2.0,
                         sampler="dpm",
                         generator=torch.Generator().manual_seed(9))
    assert torch.isfinite(p.srt).all() and torch.isfinite(p.feat).all()
    g = P.extract_glb(p, str(tmp_path / "s"), **EXTRACT)
    assert _faces(g) > 0 and _bytes(g) == _bytes(glbs[0])
    with pytest.raises(ValueError, match="sampler="):
        P.serve_assets(dit, vae, diffusion, ys[:1], [str(tmp_path / "x")],
                       mean, std, sampler="ddpm")
    with pytest.raises(ValueError, match="output directories"):
        P.serve_assets(dit, vae, diffusion, ys, [str(tmp_path / "x")], mean,
                       std)


def test_load_primx_reads_both_packages_files(tmp_path):
    from topiaxl.models.primx import PrimXParams as JaxParams
    from topiaxl.pipelines import infer as JP
    from topiaxl_torch.pipelines import infer as P

    srt, feat = sphere_shell(16, 0.2, seed=4)
    JP.save_primx(str(tmp_path / "jax.npz"),
                  JaxParams(jnp.asarray(srt), jnp.asarray(feat)))
    got = P.load_primx(str(tmp_path / "jax.npz"), device="cpu")
    assert got.srt.device.type == "cpu"
    np.testing.assert_array_equal(got.srt.numpy(), srt)
    np.testing.assert_array_equal(got.feat.numpy(), feat)

    P.save_primx(str(tmp_path / "port.npz"),
                 PrimXParams(torch.from_numpy(srt), torch.from_numpy(feat)))
    back = JP.load_primx(str(tmp_path / "port.npz"))
    np.testing.assert_array_equal(np.asarray(back.srt), srt)
    np.testing.assert_array_equal(np.asarray(back.feat), feat)


def test_extract_glb_inpaint_pad(tmp_path):
    """``inpaint_pad`` is the width of the band filled beyond the charts:
    2 and 16 texels give the same charts and other texels around them."""
    from topiaxl_torch.pipelines import infer as P

    srt, feat = sphere_shell(64, 0.3, seed=5)
    params = PrimXParams(torch.from_numpy(srt), torch.from_numpy(feat))
    tex = {}
    for pad in (2, 16):
        P.extract_glb(params, str(tmp_path / f"p{pad}"), inpaint_pad=pad,
                      **EXTRACT)
        tex[pad] = cv2.imread(str(tmp_path / f"p{pad}" / "texture.jpg"))
    narrow, wide = tex[2].astype(int), tex[16].astype(int)
    black_narrow = narrow.max(-1) <= 8
    black_wide = wide.max(-1) <= 8
    # the wide band fills texels the narrow one leaves empty, and no more
    assert (black_narrow & ~black_wide).sum() > 50
    assert not (black_wide & ~black_narrow).any()
