"""U^2-Net matting in the port (``models/matting_u2net.py``,
``ops/matting.py``, ``cli/infer.py:prepare_image``) against the JAX
package on the CPU, f32.

One randomised state_dict in the official layout (BatchNorm running
statistics included) feeds both: the port loads it with ``strict=True``,
the JAX side folds BatchNorm into each conv (``convert_u2net``). Bar: the
saliency maps within 1e-4 of max |JAX| (the folded and unfolded BatchNorm
round differently, ~1e-6 apart); the alphas within one level."""

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_models import torch_threads  # noqa: F401
from topiaxl.core.convert import convert_u2net
from topiaxl.models.matting_u2net import U2Net as JaxU2Net

REL = 1e-4


def randomized_u2net(arch: str, seed: int):
    """The port's U^2-Net with every parameter and BatchNorm statistic
    drawn from a numpy seed (weights N(0, 0.1), running variances in
    [0.5, 1.5]), in eval mode."""
    from topiaxl_torch.models.matting_u2net import U2Net

    model = U2Net(arch)
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for name, t in model.state_dict().items():
            if name.endswith("num_batches_tracked"):
                continue
            r = rng.standard_normal(tuple(t.shape)).astype(np.float32) * 0.1
            if name.endswith("running_var"):
                r = rng.uniform(0.5, 1.5, t.shape).astype(np.float32)
            t.copy_(torch.from_numpy(r))
    return model.eval()


def _jax_saliency(model, x):
    params = jax.tree.map(jnp.asarray, convert_u2net(model.state_dict()))
    out = JaxU2Net(arch=model.arch).apply(params,
                                          jnp.asarray(x.transpose(0, 2, 3, 1)))
    return np.asarray(out).transpose(0, 3, 1, 2)


def _holds(model, size, seed):
    x = np.random.default_rng(seed).standard_normal(
        (1, 3, size, size)).astype(np.float32)
    ref = _jax_saliency(model, x)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == (1, 1, size, size) and ref.std() > 1e-3
    np.testing.assert_allclose(got, ref, atol=REL * np.abs(ref).max(), rtol=0)


@pytest.mark.parametrize("size", [64, 96])   # 96: odd sizes at depth 5, 6
def test_u2netp_matches_jax(size):
    _holds(randomized_u2net("u2netp", seed=1), size, seed=2)


@pytest.mark.slow
def test_u2net_full_matches_jax():
    _holds(randomized_u2net("u2net", seed=3), 64, seed=4)


def test_load_u2net_detects_the_architecture(tmp_path):
    from topiaxl_torch.ops.matting import load_u2net

    for arch, seed in (("u2netp", 5), ("u2net", 6)):
        model = randomized_u2net(arch, seed)
        path = tmp_path / f"{arch}.pth"
        torch.save(model.state_dict(), path)
        matter = load_u2net(str(path), device="cpu")
        assert matter.model.arch == arch and not matter.model.training
        got = matter.model.state_dict()
        assert all(torch.equal(got[k], v) for k, v in model.state_dict().items())
    assert load_u2net("", device="cpu") is None
    assert load_u2net(str(tmp_path / "missing.pth"), device="cpu") is None
    with pytest.raises(ValueError, match="directory"):
        load_u2net(str(tmp_path), device="cpu")
    # strict: a state_dict that lacks a key is refused
    sd = randomized_u2net("u2netp", 7).state_dict()
    del sd["outconv.bias"]
    torch.save(sd, tmp_path / "broken.pth")
    with pytest.raises(RuntimeError, match="outconv.bias"):
        load_u2net(str(tmp_path / "broken.pth"), device="cpu")


def test_matting_wrapper_matches_jax(tmp_path):
    """rembg's pre- and post-processing around the network: the alpha of
    an 80 x 120 photo, min-max rescaled, within one level of JAX's (both
    at a network input of 64², not rembg's 320², to keep the CPU test
    short)."""
    from topiaxl.ops.matting import U2NetMatting as JaxMatting
    from topiaxl_torch.ops.matting import U2NetMatting, load_u2net

    model = randomized_u2net("u2netp", seed=8)
    torch.save(model.state_dict(), tmp_path / "u2netp.pth")
    loaded = load_u2net(str(tmp_path / "u2netp.pth"), device="cpu")
    assert loaded.input_size == 320
    matter = U2NetMatting(loaded.model, input_size=64)
    rgb = np.random.default_rng(9).integers(0, 255, (80, 120, 3), dtype=np.uint8)
    alpha = matter(rgb)
    assert alpha.shape == (80, 120) and alpha.dtype == np.uint8
    assert int(alpha.max()) - int(alpha.min()) > 128    # min-max rescaled
    ref = JaxMatting(jax.tree.map(jnp.asarray, convert_u2net(model.state_dict())),
                     arch="u2netp", input_size=64)(rgb)
    assert np.abs(alpha.astype(int) - ref.astype(int)).max() <= 1


class CenterMatter:
    """A matter whose alpha keeps the centre square only."""

    def __call__(self, rgb):
        a = np.zeros(rgb.shape[:2], np.uint8)
        a[16:48, 16:48] = 255
        return a


def _photo(tmp_path):
    img = np.full((64, 64, 3), 200, np.uint8)
    img[16:48, 16:48] = (255, 0, 0)
    cv2.circle(img, (40, 30), 6, (0, 90, 200), -1)
    path = str(tmp_path / "in.png")
    cv2.imwrite(path, img[..., ::-1])
    return path


@pytest.mark.parametrize("matting,matter", [
    ("u2net", CenterMatter()), ("auto", CenterMatter()), ("auto", None),
    ("grabcut", None), ("threshold", None)])
def test_prepare_image_matches_jax(tmp_path, matting, matter):
    from topiaxl.cli.infer import prepare_image as jax_prepare
    from topiaxl_torch.cli.infer import prepare_image

    path = _photo(tmp_path)
    got = prepare_image(path, matting=matting, matter=matter)
    np.testing.assert_array_equal(got, jax_prepare(path, matting=matting,
                                                   matter=matter))
    assert got.shape[0] == got.shape[1]
    if matter is not None:     # the red square is the kept foreground
        assert ((got[..., 0] > 128) & (got[..., 2] < 64)).any()


def test_prepare_image_u2net_errors(tmp_path):
    from topiaxl_torch.cli.infer import prepare_image

    path = _photo(tmp_path)
    with pytest.raises(ValueError, match="u2net"):
        prepare_image(path, matting="u2net", matter=None)

    class Empty:
        def __call__(self, rgb):
            return np.full(rgb.shape[:2], 32, np.uint8)   # all at the cut

    with pytest.raises(ValueError, match="u2net matting found nothing"):
        prepare_image(path, matting="u2net", matter=Empty())
    with pytest.raises(ValueError, match="expected auto, u2net"):
        prepare_image(path, matting="u2nte", matter=CenterMatter())
