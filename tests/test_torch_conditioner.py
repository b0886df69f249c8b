"""The render-then-encode conditioners (``ImageConditioner.render_batch``,
``condition_from_primx``, ``ImageMultiViewConditioner``) against the JAX
package's on the CPU, f32, on one random tiny DINOv2 (a state_dict that
both load) and a small PrimX batch, rendered at 32².

Bars: the rendered images within 1e-3 of 255 (``test_torch_render.py``'s
rgb bar on the 0..255 scale; they read ~5e-4 apart); the tokens within
1e-4 (they read ~4e-6 apart, max |token| ~2.6)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_models import randomize_, torch_threads  # noqa: F401
from test_torch_pipeline import sphere_shell
from topiaxl.core import convert

IMG_ABS = 1e-3 * 255
TOK_ABS = 1e-4
SIZE = 32


@pytest.fixture(autouse=True)
def _jax_chunk(monkeypatch):
    """The JAX conditioners call ``topiaxl.render.render_primx`` with its
    default chunk of 32768 rays, padding a 32² image 32-fold; a chunk of
    1024 gives the same image (rays are marched independently) for 1/32
    of the work."""
    import functools

    from topiaxl import render as jrender

    monkeypatch.setattr(jrender, "render_primx", functools.partial(
        jrender.render_primx, chunk=SIZE * SIZE))


@pytest.fixture(scope="module")
def encoders():
    """(JAX DINOv2 wrapper, the port's) on one randomised tiny DINOv2,
    built once: the JAX wrapper compiles its encoder per instance."""
    from topiaxl.models.conditioner import image as jimage
    from topiaxl_torch.models.conditioner import image

    port_enc = image.DinoV2Wrapper("dinov2_tiny_test", dtype=torch.float32)
    sd = randomize_(port_enc.vit, 30)
    jax_enc = jimage.DinoV2Wrapper("dinov2_tiny_test", dtype=jnp.float32)
    jax_enc.params = jax.tree.map(jnp.asarray, convert.convert_dinov2(
        sd, depth=len(port_enc.vit.blocks)))
    return jax_enc, port_enc


def _pair(encoders, multi_view: bool = False, views: int = 2):
    """(JAX conditioner, the port's) over the shared encoders."""
    from topiaxl.models.conditioner import image as jimage
    from topiaxl_torch.models.conditioner import image

    jax_enc, port_enc = encoders
    kw = dict(num_prims=24, prim_shape=8, image_height=SIZE, image_width=SIZE)
    if multi_view:
        return (jimage.ImageMultiViewConditioner(jax_enc, view_counts=views,
                                                 **kw),
                image.ImageMultiViewConditioner(port_enc, view_counts=views,
                                                **kw))
    return jimage.ImageConditioner(jax_enc, **kw), image.ImageConditioner(
        port_enc, **kw)


def _batch():
    """Two 24-prim assets [2, 24, 4], [2, 24, 6 * 8^3] with solid interiors."""
    assets = [sphere_shell(24, 0.35, seed=s) for s in (31, 32)]
    srt = np.stack([a[0] for a in assets])
    feat = np.stack([a[1] for a in assets])
    feat[:, :, :512] = np.maximum(feat[:, :, :512], 0.0)
    srt[1, :, 1] += 0.2                     # the second asset sits aside
    return srt, feat


def test_render_batch_matches_jax(encoders):
    from topiaxl import render as jrender
    from topiaxl_torch import render

    jc, tc = _pair(encoders)
    srt, feat = _batch()
    ref = np.asarray(jc.render_batch(jnp.asarray(srt), jnp.asarray(feat),
                                     jrender.frontal_camera(SIZE, SIZE)))
    with torch.no_grad():
        got = tc.render_batch(torch.from_numpy(srt), torch.from_numpy(feat),
                              render.frontal_camera(SIZE, SIZE, device="cpu"))
    assert got.shape == (2, SIZE, SIZE, 3)
    assert ref.min() < 100 and ref.max() >= 255.0 - 1e-3   # asset on white
    assert np.abs(ref[0] - ref[1]).max() > 10
    np.testing.assert_allclose(got.numpy(), ref, atol=IMG_ABS, rtol=0)


def test_condition_from_primx_matches_jax(encoders):
    jc, tc = _pair(encoders)
    srt, feat = _batch()
    ref = np.asarray(jc.condition_from_primx(jnp.asarray(srt),
                                             jnp.asarray(feat)))
    with torch.no_grad():
        got = tc.condition_from_primx(torch.from_numpy(srt),
                                      torch.from_numpy(feat)).numpy()
    assert got.shape == ref.shape == (2, 1 + 4 * 4, 32)
    assert np.abs(ref[0] - ref[1]).max() > 1e-2     # the two assets differ
    np.testing.assert_allclose(got, ref, atol=TOK_ABS, rtol=0)


def test_sampled_view_draws_its_angle_from_the_generator(encoders):
    """``sample_view``: the orbit angle is uniform in [0, 2 pi) from the
    generator, so the tokens are those of that orbit camera's render."""
    from topiaxl_torch import render

    _, tc = _pair(encoders)
    tc.sample_view = True
    srt, feat = map(torch.from_numpy, _batch())
    with torch.no_grad():
        got = tc.condition_from_primx(srt, feat,
                                      torch.Generator().manual_seed(33))
        angle = torch.rand((), generator=torch.Generator().manual_seed(33)) \
            * (2 * np.pi)
        cam = render.orbit_camera(angle, SIZE, SIZE, device="cpu")
        want = tc.encoder(tc.render_batch(srt, feat, cam))
        frontal = tc.condition_from_primx(srt, feat)   # no generator: frontal
    assert torch.equal(got, want)
    assert (got - frontal).abs().max() > 1e-3


def test_multi_view_tokens_are_the_views_in_order(encoders):
    from topiaxl_torch import render

    jc, tc = _pair(encoders, multi_view=True, views=2)
    srt, feat = _batch()
    ref = np.asarray(jc.condition_from_primx(jnp.asarray(srt),
                                             jnp.asarray(feat)))
    ts, tf = torch.from_numpy(srt), torch.from_numpy(feat)
    with torch.no_grad():
        got = tc.condition_from_primx(ts, tf)
        views = [tc.encoder(tc.render_batch(
            ts, tf, render.orbit_camera(2 * np.pi * v / 2, SIZE, SIZE,
                                        device="cpu"))) for v in range(2)]
    assert got.shape == (2, 2 * 17, 32)
    assert torch.equal(got, torch.cat(views, dim=1))
    assert (views[0] - views[1]).abs().max() > 1e-3
    np.testing.assert_allclose(got.numpy(), ref, atol=TOK_ABS, rtol=0)
