"""topiaxl_torch's VGG19 feature slices and masked perceptual loss against
the JAX package on the CPU, f32, on one randomised set of VGG19 weights
(a torchvision ``vgg19().features`` state_dict, which both load).

Bars: each of the five feature maps within 1e-5 of its largest entry
(16 f32 convs, NCHW here and NHWC in JAX, summed in another order); the
loss within 1e-5 relative; the weight carriers exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_models import randomize_, torch_threads  # noqa: F401

REL = 1e-5


@pytest.fixture(scope="module")
def vggs():
    """(port VGG19Features, JAX VGG19Features, JAX params, state_dict)."""
    from topiaxl.models import vgg as jvgg
    from topiaxl_torch.models.vgg import VGG19Features

    model = VGG19Features().eval()
    sd = randomize_(model, 21)
    params = jax.tree.map(jnp.asarray, jvgg.convert_vgg19(
        {k: v.numpy() for k, v in sd.items()}))
    return model, jvgg.VGG19Features(), params, sd


def _images(seed, n=2, size=32):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, (n, size, size, 3)).astype(np.float32)
    y = rng.uniform(0, 1, (n, size, size, 3)).astype(np.float32)
    mask = (rng.uniform(0, 1, (n, size, size, 1)) > 0.3).astype(np.float32)
    return x, y, mask


def test_vgg_features_match_jax(vggs):
    model, jmodel, params, _ = vggs
    x, _, _ = _images(0)
    refs = jmodel.apply(params, jnp.asarray(x))
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    assert len(got) == len(refs) == 5
    for i, (g, r) in enumerate(zip(got, refs)):
        r = np.asarray(r)
        g = g.permute(0, 2, 3, 1).numpy()
        assert g.shape == r.shape, (i, g.shape, r.shape)
        assert np.abs(r).max() > 0, i
        np.testing.assert_allclose(g, r, rtol=0, atol=REL * np.abs(r).max(),
                                   err_msg=f"slice {i}")


@pytest.mark.parametrize("weights_", [(1.0,) * 5, (1.0, 0.5, 0.25, 0.125,
                                                    0.0625)])
def test_vgg_loss_masked_matches_jax(vggs, weights_):
    from topiaxl.models import vgg as jvgg
    from topiaxl_torch.models.vgg import vgg_loss_masked

    model, jmodel, params, _ = vggs
    x, y, mask = _images(1)
    ref = jvgg.vgg_loss_masked(lambda a: jmodel.apply(params, a),
                               jnp.asarray(x), jnp.asarray(y),
                               jnp.asarray(mask), weights_)
    with torch.no_grad():
        got = vgg_loss_masked(model, *map(torch.from_numpy, (x, y, mask)),
                              weights=weights_)
    np.testing.assert_allclose(got.item(), float(ref), rtol=REL)


def test_vgg_weights_load_from_torchvision_layout_and_jax(vggs, tmp_path):
    """``load_vgg19`` takes a torchvision ``features`` state_dict (a dict
    or a saved file; keys of other layers ignored) and ``vgg_from_jax``
    inverts ``convert_vgg19``: both give the model's own weights."""
    from topiaxl_torch.models.vgg import load_vgg19, vgg_from_jax

    model, _, params, sd = vggs
    assert sorted(sd) == sorted(
        f"{i}.{w}" for i in (0, 2, 5, 7, 10, 12, 14, 16, 19, 21, 23, 25, 28,
                             30, 32, 34) for w in ("weight", "bias"))
    path = tmp_path / "vgg19_features.pth"
    torch.save(dict(sd, **{"36.unused": torch.zeros(1)}), path)
    back = vgg_from_jax(jax.tree.map(np.asarray, params))
    for loaded in (load_vgg19(str(path)).state_dict(), back):
        assert sorted(loaded) == sorted(sd)
        for k in sd:
            torch.testing.assert_close(loaded[k], sd[k], rtol=0, atol=0,
                                       msg=k)
