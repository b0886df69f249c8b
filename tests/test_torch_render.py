"""The port's renderer (``topiaxl_torch.render``) against the JAX
package's (``topiaxl.render``) on the CPU, f32 on both sides, scenes from
numpy seeds.

Bars: cameras equal; rays within 1e-5 (their t ranges ~4-6 within 1e-5
relative); raymarch and render_primx rgb within 1e-3 of max |JAX rgb|
and alpha within 1e-4 (the two sum their trilinear corners, rays and
cumsums in other orders, ~1e-6 apart); payloads within 1e-5 of max
|JAX|, the coloured boxes exactly; the files written have the same names
and their decoded JPEGs agree to a mean of 0.5 levels."""

import os

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_models import torch_threads  # noqa: F401
from test_torch_pipeline import sphere_shell
from topiaxl import render as jrender
from topiaxl.render import visualize as jvis
from topiaxl_torch import render
from topiaxl_torch.render import visualize as vis

CPU = torch.device("cpu")
RGB_REL = 1e-3
ALPHA_ABS = 1e-4


def _cameras():
    rt = np.array([[0.0, 0.0, 1.0, 0.2], [0.0, -1.0, 0.0, 0.1],
                   [1.0, 0.0, 0.0, 4.5]], np.float32)
    k = np.array([[60.0, 0, 15.5], [0, 58.0, 11.5], [0, 0, 1]], np.float32)
    return {
        "frontal": (lambda m, **kw: m.frontal_camera(24, 32, **kw)),
        # the port takes the angle as a 0-d tensor too (an f32 value here)
        "orbit": (lambda m, **kw: m.orbit_camera(
            torch.tensor(1.7) if kw else float(np.float32(1.7)), 20, 20,
            **kw)),
        "rt_k": (lambda m, **kw: m.camera_from_rt_k(rt, k, 24, 32, **kw)),
    }


@pytest.mark.parametrize("name", ["frontal", "orbit", "rt_k"])
def test_camera_and_rays_match_jax(name):
    make = _cameras()[name]
    ref, got = make(jrender), make(render, device=CPU)
    for a, b in zip(got[:4], ref[:4]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert got[4:] == ref[4:]
    for a, b in zip(render.compute_rays(got), jrender.compute_rays(ref)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5,
                                   rtol=1e-5)


def test_subsample_rays_matches_jax():
    from topiaxl.render.raymarch import subsample_rays as jax_sub
    from topiaxl_torch.render.raymarch import subsample_rays

    cam = render.frontal_camera(32, 32, device=CPU)
    for a, b in zip(subsample_rays(cam, 4),
                    jax_sub(jrender.frontal_camera(32, 32), 4)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)
    # the random phase: a strided grid at an offset in [0, factor - 2]
    _, rd_full, _ = render.compute_rays(cam)
    seen = set()
    for seed in range(12):
        _, rd, tm = subsample_rays(cam, 4, torch.Generator().manual_seed(seed))
        assert rd.shape == (8, 8, 3) and tm.shape == (8, 8, 2)
        hits = [(y, x) for y in range(3) for x in range(3)
                if torch.equal(rd, rd_full[y::4, x::4][:8, :8])]
        assert len(hits) == 1
        seen.add(hits[0])
    assert len(seen) > 1


def _scene(rng, K=6, S=4, alpha=40.0):
    pos = rng.uniform(-0.5, 0.5, (K, 3)).astype(np.float32)
    scale = rng.uniform(0.25, 0.45, (K,)).astype(np.float32)
    payload = rng.uniform(0, 1, (K, S, S, S, 4)).astype(np.float32)
    payload[..., :3] *= 255.0
    payload[..., 3] *= alpha
    return payload, pos, 1.0 / scale


def _frontal_rays(size=24):
    rp, rd, tm = jrender.compute_rays(jrender.frontal_camera(size, size))
    return [np.asarray(a).reshape(-1, a.shape[-1]) for a in (rp, rd, tm)]


def _rot(rng):
    a, b, c = rng.uniform(0, 2 * np.pi, 3)
    rz = lambda t: np.array([[np.cos(t), -np.sin(t), 0],  # noqa: E731
                             [np.sin(t), np.cos(t), 0], [0, 0, 1]])
    rx = lambda t: np.array([[1, 0, 0], [0, np.cos(t), -np.sin(t)],  # noqa: E731
                             [0, np.sin(t), np.cos(t)]])
    return (rz(a) @ rx(b) @ rz(c)).astype(np.float32)


def _case(name):
    """(payload, pos, scale_inv, rays, kwargs) of each raymarch case."""
    rng = np.random.default_rng(["axis", "rot", "warp", "few_hits",
                                 "deep"].index(name))
    if name == "deep":
        # 48 prims stacked along z, one ray down the stack (max_hits >= depth)
        K, S = 48, 4
        pos = np.zeros((K, 3), np.float32)
        pos[:, 2] = np.linspace(-0.8, 0.8, K)
        payload = rng.uniform(0, 1, (K, S, S, S, 4)).astype(np.float32)
        payload[..., :3] *= 255.0
        payload[..., 3] *= 25.0
        rays = [np.array([[0, 0, -2.0], [0.02, 0.01, -2.0], [0.3, 0.3, -2.0]],
                         np.float32),
                np.array([[0, 0, 1.0]] * 3, np.float32),
                np.array([[0.0, 4.0]] * 3, np.float32)]
        return payload, pos, np.full((K,), 1 / 0.06, np.float32), rays, dict(
            num_steps=48 * 24, max_hits=64)
    if name == "few_hits":
        # twelve small prims: most rays meet fewer than max_hits of them
        payload, pos, sinv = _scene(rng, K=12, alpha=60.0)
        return payload, pos, sinv * 2.5, _frontal_rays(), dict(
            num_steps=64, max_hits=8)
    payload, pos, sinv = _scene(rng, K=2, S=8, alpha=30.0)
    kw = dict(num_steps=64, max_hits=2)
    if name == "rot":
        kw["prim_rot"] = np.stack([_rot(rng), _rot(rng)])
    elif name == "warp":
        lin = np.linspace(-1, 1, 8, dtype=np.float32)
        zz, yy, xx = np.meshgrid(lin, lin, lin, indexing="ij")
        warp = np.broadcast_to(np.stack([xx, yy, zz], -1)[None],
                               (2, 8, 8, 8, 3)).copy()
        warp[..., 0] += 0.25
        warp[..., 1] *= 0.8
        kw["warp"] = warp
    return payload, pos, sinv, _frontal_rays(), kw


def assert_rgba_close(got, ref):
    assert ref[..., 3].max() > 0.1      # something is seen
    rgb_scale = np.abs(ref[..., :3]).max()
    np.testing.assert_allclose(got[..., :3], ref[..., :3],
                               atol=RGB_REL * rgb_scale, rtol=0)
    np.testing.assert_allclose(got[..., 3], ref[..., 3], atol=ALPHA_ABS,
                               rtol=0)


@pytest.mark.parametrize("name", ["axis", "rot", "warp", "few_hits", "deep"])
def test_raymarch_matches_jax(name):
    payload, pos, sinv, rays, kw = _case(name)
    arrays = {k: v for k, v in kw.items() if isinstance(v, np.ndarray)}
    static = {k: v for k, v in kw.items() if k not in arrays}
    ref = np.asarray(jrender.raymarch(
        jnp.asarray(payload), jnp.asarray(pos), jnp.asarray(sinv),
        *map(jnp.asarray, rays), **static,
        **{k: jnp.asarray(v) for k, v in arrays.items()}))
    got = render.raymarch(
        torch.from_numpy(payload), torch.from_numpy(pos),
        torch.from_numpy(sinv), *map(torch.from_numpy, rays), **static,
        **{k: torch.from_numpy(v) for k, v in arrays.items()}).numpy()
    assert_rgba_close(got, ref)
    if name == "few_hits":
        # rays that met fewer prims than max_hits, and rays that met none
        from topiaxl_torch.render.raymarch import _slab

        pos_t, ext = torch.from_numpy(pos), torch.from_numpy(1.0 / sinv)
        rp, rd, tm = map(torch.from_numpy, rays)
        rd = torch.where(rd.abs() < 1e-12, 1e-12, rd)
        tin, tout = _slab(pos_t - ext[:, None], pos_t + ext[:, None], rp,
                          1.0 / rd)
        hits = ((tout >= torch.maximum(tin, tm[:, :1])) & (tin <= tm[:, 1:])
                & (tout >= 0)).sum(1)
        assert ((hits > 0) & (hits < 8)).sum() > 20 and (hits == 0).any()
    if name == "deep":
        assert got[0, 3] > 0.95          # the stacked ray saturates


def test_render_primx_matches_jax():
    """A 64-prim sphere shell through ``render_primx``, its chunks of rays
    (the port's 300, JAX's 1024) changing nothing."""
    srt, feat = sphere_shell(64, 0.3)
    feat[:, :512] = np.maximum(feat[:, :512], 0.0)   # a solid interior
    ref = np.asarray(jrender.render_primx(
        jnp.asarray(srt), jnp.asarray(feat), jrender.frontal_camera(32, 32),
        num_steps=64, max_hits=8, chunk=1024))
    got = render.render_primx(
        torch.from_numpy(srt), torch.from_numpy(feat),
        render.frontal_camera(32, 32, device=CPU), num_steps=64, max_hits=8,
        chunk=300).numpy()
    assert got.shape == (32, 32, 4)
    assert_rgba_close(got, ref)
    assert got[16, 16, 3] > 0.8 and got[1, 1, 3] == 0.0


@pytest.mark.parametrize("channels", ["tex", "mat"])
def test_payload_matches_jax(channels):
    from topiaxl.models.primx import sdf2alpha as jax_sdf2alpha
    from topiaxl_torch.models.primx import sdf2alpha

    srt, feat = sphere_shell(16, 0.3, seed=2)
    feat += np.random.default_rng(3).normal(0, 0.01, feat.shape).astype(
        np.float32)
    ref = np.asarray(jvis.primx_to_payload(jnp.asarray(srt), jnp.asarray(feat),
                                           8, channels=channels))
    got = vis.primx_to_payload(torch.from_numpy(srt), torch.from_numpy(feat),
                               8, channels=channels).numpy()
    assert got.shape == (16, 8, 8, 8, 4) and ref[..., 3].max() > 100
    np.testing.assert_allclose(got, ref, atol=1e-5 * np.abs(ref).max(), rtol=0)
    sdf = feat[:, :512]
    np.testing.assert_allclose(sdf2alpha(torch.from_numpy(sdf)).numpy(),
                               np.asarray(jax_sdf2alpha(jnp.asarray(sdf))),
                               atol=1e-6, rtol=0)


def test_colored_box_payload_equals_jax():
    got = vis.colored_box_payload(8, 4, device=CPU).numpy()
    np.testing.assert_array_equal(got, np.asarray(jvis.colored_box_payload(8, 4)))


def _tiny_recon(n=8, s=4):
    rng = np.random.default_rng(0)
    srt = np.zeros((n, 4), np.float32)
    srt[:, 0] = 0.3
    srt[:, 1:4] = rng.uniform(-0.4, 0.4, (n, 3))
    feat = rng.uniform(-0.05, 0.05, (n, 6 * s**3)).astype(np.float32)
    feat[:, s**3:] += 0.5
    return np.concatenate([srt, feat], -1)[None]


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def _assert_jpegs_agree(port_dir, jax_dir):
    names = _files(jax_dir)
    assert names and _files(port_dir) == names
    for name in names:
        a = cv2.imread(os.path.join(port_dir, name)).astype(np.float32)
        b = cv2.imread(os.path.join(jax_dir, name)).astype(np.float32)
        assert a.shape == b.shape and b.max() > 50, name
        assert np.abs(a - b).mean() < 0.5, name


def test_visualize_files_match_jax(tmp_path, monkeypatch):
    """recon.jpg (frontal rgb | boxes), the multi-view grid and the orbit
    videos: the same files, the same pictures; the videos as frame JPEGs
    where no mp4 writer is installed, as on the JAX side. (The JAX side
    marches 576 rays a chunk, not its default 32768: the same images.)"""
    import functools

    monkeypatch.setattr(jvis, "render_primx", functools.partial(
        jrender.render_primx, chunk=24 * 24))
    recon = _tiny_recon()
    kw = dict(prim_shape=4, num_steps=32, max_hits=4)
    out = {}
    for side, mod, arr in (("port", vis, torch.from_numpy(recon)),
                           ("jax", jvis, jnp.asarray(recon))):
        d = tmp_path / side
        os.makedirs(d / "video")
        out[side] = mod.visualize_primvolume(str(d / "recon.jpg"), arr, 24, 24,
                                             **kw)
        mod.visualize_multiview_primvolume(str(d / "mv.jpg"), arr, views=2,
                                           height=24, width=24, **kw)
        out[side + "_video"] = mod.visualize_video_primvolume(
            str(d / "video"), arr, view_counts=2, height=24, width=24, **kw)
    _assert_jpegs_agree(tmp_path / "port", tmp_path / "jax")
    assert cv2.imread(str(tmp_path / "port" / "recon.jpg")).shape == (24, 48, 3)
    branches = out["port_video"]
    assert sorted(branches) == ["mat", "prim", "rgb"]
    for name, branch in branches.items():
        want = [f"{name}.mp4"] if branch == "mp4" else [
            f"{name}/{i:04d}.jpg" for i in range(3)]
        assert set(want) <= set(_files(tmp_path / "port" / "video"))
    rgb, boxes = out["port"]
    assert rgb.shape == boxes.shape == (24, 24, 4)
