"""Dataset preparation (``topiaxl_torch/pipelines/data.py:encode_assets``,
``python -m topiaxl_torch.cli.prepare_data``) on the CPU: the encoding
against the JAX package's on the same VAE weights and inputs (bar 1e-4 of
max), and the CLI end to end, meshes -> shards -> the trainer."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_models import tiny_vae, torch_threads  # noqa: F401
from test_torch_pipeline import _tiny_config
from topiaxl.models import VAE3D as JaxVAE
from topiaxl.pipelines.data import encode_assets as jax_encode_assets
from topiaxl_torch.models.latent_stats import get_latent_stats
from topiaxl_torch.pipelines.data import encode_assets, normalize_payload

CUBE_V = np.array([[x, y, z] for x in (-0.5, 0.5) for y in (-0.5, 0.5)
                   for z in (-0.5, 0.5)], np.float32)
CUBE_F = np.array([[0, 1, 3], [0, 3, 2], [4, 6, 7], [4, 7, 5],
                   [0, 4, 5], [0, 5, 1], [2, 3, 7], [2, 7, 6],
                   [0, 2, 6], [0, 6, 4], [1, 5, 7], [1, 7, 3]], np.int64)


def _asset(seed, n=5):
    rng = np.random.default_rng(seed)
    srt = rng.uniform(0.1, 0.5, (n, 4)).astype("f")
    payload = rng.uniform(-0.2, 1.0, (n, 6 * 512)).astype("f")
    return srt, payload


def test_encode_assets_matches_jax():
    vae, params = tiny_vae(seed=40)
    srt, payload = _asset(41)
    mean, std = get_latent_stats("primx_v1")
    jv = JaxVAE(down_channels=(8, 16), up_channels=(16, 8), dtype=jnp.float32)
    ref = jax_encode_assets(jv, params, srt, payload, mean, std, 0.5)
    got = encode_assets(vae, torch.from_numpy(srt), torch.from_numpy(payload),
                        mean, std, 0.5)
    assert got.shape == (5, 68) and ref.shape == got.shape
    err = np.abs(got - ref).max() / np.abs(ref).max()
    assert err <= 1e-4, err
    # numpy inputs give the same; the srt channels invert exactly
    np.testing.assert_array_equal(
        encode_assets(vae, srt, payload, mean, std, 0.5), got)
    np.testing.assert_allclose(got[:, :4] / 0.5 * std[:4] + mean[:4], srt,
                               atol=1e-5)


def test_encode_assets_samples_from_the_generator():
    """With a generator the latent is mean + std * eps, eps drawn from it
    in the posterior's NCDHW shape."""
    vae, _ = tiny_vae(seed=42)
    srt, payload = _asset(43)
    mean, std = get_latent_stats("primx_v1")
    got = encode_assets(vae, srt, payload, mean, std,
                        generator=torch.Generator().manual_seed(9))
    with torch.no_grad():
        post = vae.encode(normalize_payload(torch.from_numpy(payload)))
    z = post.sample(torch.Generator().manual_seed(9)).reshape(5, -1).numpy()
    expect = (np.concatenate([srt, z], -1) - mean) / std
    np.testing.assert_allclose(got, expect, atol=1e-5, rtol=1e-5)
    mode = encode_assets(vae, srt, payload, mean, std)
    assert np.abs(got - mode).max() > 1e-3


def _data_config(tmp_path, cpu=True):
    """The tiny serving config (64 prims, VAE (8, 16), tiny DINOv2), with
    the trainer's keys and, with ``cpu``, ``data.device=cpu``."""
    path = _tiny_config(tmp_path, tmp_path)
    with open(path, "a") as fh:
        fh.write("optimizer: {lr: 0.001, weight_decay: 0}\n"
                 "scheduler: {warmup_iters: 2, max_iters: 100}\n"
                 "train: {device: cpu, batch_size: 2, max_steps: 1, "
                 "log_every_n_steps: 1, ckpt_every_n_steps: 100, "
                 "keep_ckpts: 1}\n"
                 + ("data: {device: cpu}\n" if cpu else ""))
    return str(path)


def test_cli_prepare_data_to_train_step(tmp_path, monkeypatch):
    """Two cube OBJs -> fitted PrimX -> one shard -> a TokenShardDataset
    batch -> one ``cli.train`` step on it. The conditioner renders at 64²
    here (both packages' registries build it at 518², which takes a
    minute an asset on two CPU threads)."""
    from topiaxl_torch import registry
    from topiaxl_torch.cli.prepare_data import main
    from topiaxl_torch.cli.train import main as train_main
    from topiaxl_torch.extract.objio import save_obj
    from topiaxl_torch.pipelines.data import TokenShardDataset

    renderer_kwargs = registry._renderer_kwargs
    monkeypatch.setattr(registry, "_renderer_kwargs", lambda kw: dict(
        renderer_kwargs(kw), image_height=64, image_width=64))
    mesh_dir = tmp_path / "meshes"
    os.makedirs(mesh_dir)
    for i in range(2):
        save_obj(str(mesh_dir / f"cube{i}.obj"), CUBE_V * (1 + 0.2 * i),
                 CUBE_F)
    cfg = _data_config(tmp_path)
    out = tmp_path / "shards"
    recs = []
    rc = main([cfg, f"data.input_glob={mesh_dir}/*.obj",
               f"data.output_dir={out}", "data.assets_per_shard=2",
               "data.shape_opt_steps=8", "data.tex_opt_steps=10"],
              records_out=recs)
    assert rc == 0 and sorted(os.listdir(out)) == ["shard_00000.npz"]
    assert [os.path.basename(r["path"]) for r in recs] == ["cube0.obj",
                                                           "cube1.obj"]
    for r in recs:
        assert r["fit_steps"] == 10 and r["fit_s"] > 0 and r["mesh_sdf_s"] > 0
        # the fit moved the payload off zero
        assert r["params"].feat.abs().max() > 1e-3

    ds = TokenShardDataset(str(out / "*.npz"), batch_size=2)
    batch = next(ds.epoch(0))
    assert batch["x"].shape == (2, 64, 68) and np.isfinite(batch["x"]).all()
    assert batch["y"].shape[0] == 2 and batch["y"].shape[2] == 32
    assert np.isfinite(batch["y"]).all()

    metrics = []
    assert train_main([cfg, f"train.data_glob={out}/*.npz"],
                      metrics_out=metrics) == 0
    assert len(metrics) == 1 and np.isfinite(metrics[0]["loss"])


def test_cli_prepare_data_refuses_and_defaults(tmp_path, capsys):
    """No arguments print the usage; no mesh raises; ``data.device``
    defaults to ``cuda`` with no fallback to the CPU."""
    from topiaxl_torch.cli.prepare_data import main
    from topiaxl_torch.extract.objio import save_obj

    assert main([]) == 1 and "prepare_data" in capsys.readouterr().out
    cfg = _data_config(tmp_path)
    with pytest.raises(FileNotFoundError, match="no meshes"):
        main([cfg, f"data.input_glob={tmp_path}/none/*.obj"])
    save_obj(str(tmp_path / "cube.obj"), CUBE_V, CUBE_F)
    os.makedirs(tmp_path / "default")
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            main([_data_config(tmp_path / "default", cpu=False),
                  f"data.input_glob={tmp_path}/*.obj"])
