"""The topiaxl_torch slice as a whole against the JAX package on the CPU:
the DDIM chain with CFG from identical numpy noise, the VAE decode, the
coarse-to-fine SDF grid, the texel bake and the port's CLI writing a
GLB. f32 on both sides, every parameter randomised."""

import os
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import torch

import reference_runtime as rr
from test_torch_models import tiny_dit, tiny_vae, torch_threads  # noqa: F401
from topiaxl.models import primx as jprimx
from topiaxl.models.latent_stats import get_latent_stats
from topiaxl_torch.models.primx import PrimXParams


def test_ddim_cfg_chain_and_decode_match_jax():
    from topiaxl.diffusion import create_diffusion as jax_diffusion
    from topiaxl.diffusion import gaussian as jax_gaussian
    from topiaxl.models import DiT as JaxDiT
    from topiaxl.models import VAE3D as JaxVAE
    from topiaxl.pipelines import infer as JP
    from topiaxl_torch.diffusion import create_diffusion
    from topiaxl_torch.pipelines import infer as P

    dit, dparams = tiny_dit(seed=10)
    vae, vparams = tiny_vae(seed=11)
    rng = np.random.default_rng(12)
    noise = rng.standard_normal((1, 64, 68)).astype(np.float32)
    y = rng.standard_normal((1, 10, 32)).astype(np.float32)
    mean, std = get_latent_stats("primx_v1")
    kw = dict(timestep_respacing="ddim5", noise_schedule="squaredcos_cap_v2",
              parameterization="v")

    jd = JaxDiT(seq_length=64, in_channels=68, condition_channels=32,
                hidden_size=144, depth=2, num_heads=2, attn_proj_bias=True,
                dtype=jnp.float32)
    kvs = jd.apply(dparams, jnp.asarray(y), method=JaxDiT.precompute_kv)
    nulls = jd.apply(dparams, method=JaxDiT.precompute_null_out)

    def model_fn(x, t):
        return jd.apply(dparams, x, t, kvs, nulls, 6.0,
                        method=JaxDiT.forward_with_cfg_fast)

    ref = jax_gaussian.ddim_sample_loop(jax_diffusion(**kw), model_fn,
                                        jnp.asarray(noise),
                                        jax.random.PRNGKey(0))
    tokens_ref = np.asarray(ref.sample)
    srt_ref, feat_ref = JP.decode_primx(
        JaxVAE(down_channels=(8, 16), up_channels=(16, 8), dtype=jnp.float32),
        vparams, JP.denormalize_tokens(ref.sample, jnp.asarray(mean),
                                       jnp.asarray(std), 0.9),
        num_prims=64)

    out = P.sample_tokens(dit, create_diffusion(**kw), torch.from_numpy(y),
                          cfg_scale=6.0, noise=torch.from_numpy(noise))
    assert np.abs(tokens_ref - noise).max() > 0.1   # the model did move x
    np.testing.assert_allclose(out.sample.numpy(), tokens_ref, atol=5e-5,
                               rtol=1e-3)
    srt, feat = P.decode_primx(vae, P.denormalize_tokens(
        torch.from_numpy(tokens_ref.copy()), torch.from_numpy(mean),
        torch.from_numpy(std), 0.9))
    np.testing.assert_allclose(srt.numpy(), np.asarray(srt_ref), atol=2e-4)
    np.testing.assert_allclose(feat.numpy(), np.asarray(feat_ref), atol=2e-4)


def test_chain_matches_reference_fixture():
    """The reference's own state_dicts (loaded strictly) through the port's
    CFG fast path reproduce the reference chain's committed outputs, at
    the bars tests/test_reference_parity.py holds the JAX package to."""
    from topiaxl_torch.diffusion import create_diffusion
    from topiaxl_torch.models import primx
    from topiaxl_torch.models.dit import DiT
    from topiaxl_torch.models.vae3d import VAE3D
    from topiaxl_torch.pipelines import infer as P

    fx = np.load(os.path.join(os.path.dirname(__file__), "goldens",
                              "reference_chain_v1.npz"))

    def sd(which):
        pre = f"sd.{which}."
        return {k[len(pre):]: torch.from_numpy(fx[k]) for k in fx.files
                if k.startswith(pre)}

    T = rr.TINY
    dit = DiT(seq_length=T["num_prims"], in_channels=T["in_channels"],
              condition_channels=T["cond_channels"], hidden_size=T["hidden"],
              depth=T["depth"], num_heads=T["heads"], dtype=torch.float32)
    dit.load_state_dict(sd("dit"))
    vae = VAE3D(down_channels=(32, 64), up_channels=(64, 32),
                dtype=torch.float32)
    vae.load_state_dict(sd("vae"))
    params = P.generate_primx(
        dit, vae, create_diffusion(T["ddim"], "squaredcos_cap_v2",
                                   parameterization="v"),
        torch.from_numpy(fx["y"]), fx["latent_mean"], fx["latent_std"],
        latent_nf=T["latent_nf"], cfg_scale=T["cfg"],
        noise=torch.from_numpy(fx["noise"]))
    np.testing.assert_allclose(params.srt.numpy(), fx["out.srt"][0], atol=5e-5)
    np.testing.assert_allclose(params.feat.numpy(), fx["out.feat"][0],
                               atol=2e-4)
    got = primx.query(params, torch.from_numpy(rr.grid_points(T["grid_res"])),
                      top_k=T["num_prims"])
    for k in ("sdf", "tex", "mat"):
        np.testing.assert_allclose(got[k].numpy(), fx[f"out.{k}"], atol=5e-4,
                                   err_msg=k)


def sphere_shell(n: int, scale: float, seed: int = 0, S: int = 8):
    """PrimX shell on the r = 0.55 sphere: SDF |p| - 0.55, RGB from position,
    roughness 0.8, metallic 0.2 (numpy)."""
    v = np.random.default_rng(seed).standard_normal((n, 3))
    pos = (v / np.linalg.norm(v, axis=1, keepdims=True) * 0.55).astype(
        np.float32)
    world = pos[:, None, :] + scale * jprimx.local_grid(S)[None]
    sdf = np.linalg.norm(world, axis=2) - 0.55
    rgb = np.clip(0.5 + 0.5 * world.transpose(0, 2, 1), 0.0, 1.0)
    mat = np.concatenate([np.full((n, 1, S**3), 0.8), np.full((n, 1, S**3), 0.2)],
                         axis=1)
    feat = np.concatenate([sdf[:, None], rgb, mat], 1).reshape(n, -1)
    srt = np.concatenate([np.full((n, 1), scale), pos], 1)
    return srt.astype(np.float32), feat.astype(np.float32)


def test_synthetic_inputs(tmp_path):
    """The smoke and profiling runs' sphere asset is the numpy shell above
    at scale 0.07; the synthetic photo is a 512² image."""
    import cv2

    from topiaxl_torch.pipelines.synthetic import sphere_asset, write_bench_image

    srt, feat = sphere_shell(64, 0.07)
    got = sphere_asset(torch.device("cpu"), n=64)
    np.testing.assert_allclose(got.srt.numpy(), srt, atol=1e-6, rtol=0)
    np.testing.assert_allclose(got.feat.numpy(), feat, atol=1e-6, rtol=0)
    write_bench_image(str(tmp_path / "a.png"), shift=12)
    img = cv2.imread(str(tmp_path / "a.png"))
    assert img.shape == (512, 512, 3) and (img != 255).any()


def test_sdf_grid_matches_jax():
    from scipy import ndimage

    from topiaxl.pipelines import infer as JP
    from topiaxl_torch.pipelines import infer as P

    srt, feat = sphere_shell(64, 0.3)
    res, coarse, sigma = 32, 16, 2.0
    jparams = jprimx.PrimXParams(jnp.asarray(srt), jnp.asarray(feat))
    ref = JP.sdf_grid(jparams, res, top_k=64, coarse=coarse, band_sigma=sigma)
    tm: dict = {}
    got = P.sdf_grid(PrimXParams(torch.from_numpy(srt), torch.from_numpy(feat)),
                     res, top_k=64, coarse=coarse, band_sigma=sigma, timings=tm)

    # the JAX band: the Lipschitz-scaled test on its f16 coarse grid
    gc = np.asarray(JP._coarse_grid_f16(jparams, coarse, f=4, top_k=64)
                    ).astype(np.float32).reshape((coarse,) * 3)
    cell = 2.0 / (coarse - 1)
    lip = np.zeros_like(gc)
    for ax in range(3):
        d = np.abs(np.diff(gc, axis=ax)) / cell
        lo, hi = [slice(None)] * 3, [slice(None)] * 3
        lo[ax], hi[ax] = slice(0, -1), slice(1, None)
        lip[tuple(lo)] = np.maximum(lip[tuple(lo)], d)
        lip[tuple(hi)] = np.maximum(lip[tuple(hi)], d)
    lip = np.maximum(ndimage.maximum_filter(lip, size=3), 1.0)
    band = ndimage.minimum_filter(np.abs(gc), size=3) < sigma * cell * lip
    f = res // coarse
    band = band.repeat(f, 0).repeat(f, 1).repeat(f, 2)
    assert 0 < band.sum() < band.size
    assert tm["band_points"] == band.sum()

    # inside the band JAX keeps int8 steps of the clamped SDF
    r = sigma * cell
    step = r / 127
    np.testing.assert_allclose(np.clip(got[band], -r, r), ref[band],
                               atol=step / 2 + 1e-6, rtol=0)
    # outside it, the upsampled coarse grid, which JAX rounds to f16
    bound = np.abs(gc).max() * 2.0 ** -11 + 1e-6
    np.testing.assert_allclose(got[~band], ref[~band], atol=bound, rtol=0)


def test_bake_matches_jax():
    from topiaxl.pipelines import infer as JP
    from topiaxl_torch.pipelines import infer as P

    srt, feat = sphere_shell(64, 0.3, seed=1)
    v = np.random.default_rng(2).standard_normal((2000, 3))
    pts = (v / np.linalg.norm(v, axis=1, keepdims=True)
           * np.random.default_rng(3).uniform(0.53, 0.57, (2000, 1))
           ).astype(np.float32)
    ref = np.asarray(JP._bake_query_u8(
        jprimx.PrimXParams(jnp.asarray(srt), jnp.asarray(feat)),
        jnp.asarray(pts)))
    got = P.bake_query_u8(PrimXParams(torch.from_numpy(srt),
                                      torch.from_numpy(feat)),
                          torch.from_numpy(pts)).numpy()
    assert got.dtype == np.uint8 and got.shape == (2000, 5)
    assert np.abs(got.astype(int) - ref.astype(int)).max() <= 1


def _tiny_config(tmp_path, img_dir):
    cfg = tmp_path / "tiny.yml"
    cfg.write_text(textwrap.dedent(f"""
        root_data_dir: {tmp_path}/runs
        checkpoint_path: null
        global_seed: 0
        image_height: 32
        image_width: 32
        inference:
          device: cpu
          input_dir: {img_dir}
          ddim: 3
          cfg: 2.0
          seed: 0
          export_glb: true
          fast_unwrap: true
          decimate: 3000
          mc_resolution: 32
          batch_size: 4096
          remesh: false
        model:
          class_name: topiaxl.PrimX
          num_prims: 64
          dim_feat: 6
          prim_shape: 8
          vae:
            class_name: topiaxl.VAE3D
            in_channels: 6
            latent_channels: 1
            out_channels: 6
            down_channels: [8, 16]
            mid_attention: true
            up_channels: [16, 8]
            layers_per_block: 1
            dtype: fp32
          vae_checkpoint_path: null
          conditioner:
            class_name: topiaxl.ImageConditioner
            num_prims: ${{model.num_prims}}
            encoder_config:
              class_name: topiaxl.DinoV2Wrapper
              model_name: dinov2_tiny_test
              dtype: fp32
          generator:
            class_name: topiaxl.DiT
            seq_length: 64
            in_channels: 68
            condition_channels: 32
            hidden_size: 32
            depth: 1
            num_heads: 4
            attn_proj_bias: true
            dtype: fp32
          latent_nf: 1.0
          latent_stats: primx_v1
        diffusion:
          noise_schedule: squaredcos_cap_v2
          diffusion_steps: 50
          parameterization: v
        tag: tiny
        output_dir: {tmp_path}/runs/tiny
    """))
    return cfg


def test_cli_writes_glb(tmp_path):
    import cv2

    from topiaxl.extract.glb import read_glb
    from topiaxl_torch.cli.infer import main

    img_dir = tmp_path / "imgs"
    os.makedirs(img_dir)
    img = np.zeros((64, 64, 3), np.uint8)
    cv2.circle(img, (32, 32), 20, (200, 180, 160), -1)
    cv2.imwrite(str(img_dir / "blob.png"), img)
    timings: list = []
    assert main([str(_tiny_config(tmp_path, img_dir))], timings_out=timings) == 0
    out = tmp_path / "runs" / "tiny" / "inference_folder" / "blob"
    z = np.load(out / "denoised.npz")
    assert z["srt"].shape == (64, 4) and z["feat"].shape == (64, 3072)
    assert np.isfinite(z["srt"]).all() and np.isfinite(z["feat"]).all()
    gltf, _ = read_glb(str(out / "pbr_mesh.glb"))
    assert gltf["asset"]["version"] == "2.0"
    assert gltf["accessors"][gltf["meshes"][0]["primitives"][0]["indices"]][
        "count"] > 0
    assert os.path.exists(out / "texture.jpg")
    # the frontal rgb | prim-box snapshot at image_height x 2 image_width
    assert cv2.imread(str(out / "recon.jpg")).shape == (32, 64, 3)
    assert [sorted(r) for r in timings] == [
        ["encode_s", "image", "recon_s", "stage1_s", "stage2_s"]]


def test_cli_debug_writes_the_orbit_videos(tmp_path):
    """``debug=true``: beside recon.jpg, the 61-frame orbit of rgb, prim
    boxes and materials (mp4, or frame JPEGs where no mp4 writer is
    installed), at image_height x image_width."""
    import cv2

    from topiaxl_torch.cli.infer import main

    img_dir = tmp_path / "imgs"
    os.makedirs(img_dir)
    img = np.zeros((64, 64, 3), np.uint8)
    cv2.circle(img, (32, 32), 20, (200, 180, 160), -1)
    cv2.imwrite(str(img_dir / "blob.png"), img)
    assert main([str(_tiny_config(tmp_path, img_dir)), "debug=true",
                 "inference.export_glb=false"]) == 0
    out = tmp_path / "runs" / "tiny" / "inference_folder" / "blob"
    assert cv2.imread(str(out / "recon.jpg")).shape == (32, 64, 3)
    for name in ("rgb", "prim", "mat"):
        if (out / f"{name}.mp4").exists():
            continue
        frames = sorted(os.listdir(out / name))
        assert frames == [f"{i:04d}.jpg" for i in range(61)], name
        assert cv2.imread(str(out / name / frames[-1])).shape == (32, 32, 3)


def test_cli_without_config_prints_usage(capsys):
    from topiaxl_torch.cli.infer import main

    assert main([]) == 1
    assert "topiaxl_torch.cli.infer" in capsys.readouterr().out
