"""The port's DiT and VAE decode held to the JAX package's pinned golden
values (``tests/goldens/golden_v1.npz``, ``["dit"]`` and ``["vae"]``), on
the JAX package's own fixed-seed weights and inputs (built as
``tests/test_goldens.py`` builds them, carried across by
``core/weights.py``), f32 on the CPU. Bars: the port's against JAX,
DiT 1e-4 and decode 2e-4 (``test_torch_models.py``,
``test_torch_pipeline.py``)."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from test_goldens import GOLDEN, _perturbed
from test_torch_models import torch_threads  # noqa: F401
from topiaxl_torch.core import weights


def test_dit_matches_golden():
    from topiaxl.models import DiT as JaxDiT
    from topiaxl_torch.models.dit import DiT

    kw = dict(seq_length=8, in_channels=4, condition_channels=6,
              hidden_size=16, depth=2, num_heads=2, cond_drop_prob=0.1)
    jd = JaxDiT(dtype=jnp.float32, **kw)
    params = _perturbed(jd.init(jax.random.PRNGKey(0), jnp.zeros((1, 8, 4)),
                                jnp.zeros((1,), jnp.int32),
                                jnp.zeros((1, 3, 6))))
    dit = DiT(dtype=torch.float32, **kw).eval()
    dit.load_state_dict(weights.dit_from_jax(jax.tree.map(np.asarray, params)))
    x = np.array(jax.random.normal(jax.random.PRNGKey(2), (2, 8, 4)))
    y = np.array(jax.random.normal(jax.random.PRNGKey(3), (2, 3, 6)))
    with torch.no_grad():
        got = dit(torch.from_numpy(x), torch.tensor([3, 7]),
                  torch.from_numpy(y)).numpy()
    want = np.load(GOLDEN)["dit"]
    assert got.shape == want.shape == (2, 8, 8) and np.abs(want).max() > 0.1
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def test_vae_decode_matches_golden():
    from topiaxl.models import VAE3D as JaxVAE
    from topiaxl_torch.models.vae3d import VAE3D

    kw = dict(in_channels=6, latent_channels=1, out_channels=6,
              down_channels=(8, 16), up_channels=(16, 8), layers_per_block=1)
    vp = JaxVAE(dtype=jnp.float32, **kw).init(
        jax.random.PRNGKey(4), jnp.zeros((1, 8, 8, 8, 6)),
        jax.random.PRNGKey(5))
    vae = VAE3D(dtype=torch.float32, **kw).eval()
    vae.load_state_dict(weights.vae_from_jax(jax.tree.map(np.asarray, vp)))
    z = np.array(jax.random.normal(jax.random.PRNGKey(6), (2, 4, 4, 4, 1)))
    with torch.no_grad():
        got = vae.decode(torch.from_numpy(z).permute(0, 4, 1, 2, 3))
    want = np.load(GOLDEN)["vae"]
    got = got.permute(0, 2, 3, 4, 1).numpy()
    assert got.shape == want.shape == (2, 8, 8, 8, 6) and np.abs(want).max() > 0.1
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=0)
