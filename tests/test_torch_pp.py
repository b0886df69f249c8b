"""topiaxl_torch's pipeline parallelism (``parallel/pipeline.py``) against
the JAX package on the CPU: four gloo ranks spawned by
``tests/torch_dist_workers.py`` (one spawn, with a time limit), JAX on
this process.

Bars (f32), JAX's own (``tests/test_pipeline_parallel.py:48-165``): the
pipelined forward over pp = 4 at ``n_micro`` 1, 2 and 4, and W8A8, within
atol and rtol 2e-5 of JAX's unpipelined forward on the same weights; the
dp = 2 x pp = 2 train step against JAX's single-device step with its
draws, loss rtol 2e-5, grad norm rtol 2e-4, the updated
``blocks.2.mlp.fc1.weight`` within 2e-6, with moments, EMA and parameters
held as ``test_torch_parallel.py`` holds the dp step; with remat the same.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dist_workers as W
from test_torch_models import randomize_, torch_threads  # noqa: F401
from test_torch_parallel import DIFFUSION, EMA, OPTIMIZER, _check_state
from topiaxl.core import convert

BAR = 2e-5
LOSS_REL, GNORM_REL, UPDATE_ABS = 2e-5, 2e-4, 2e-6
KW = dict(seq_length=8, in_channels=4, condition_channels=6, hidden_size=16,
          depth=4, num_heads=2, cond_drop_prob=0.1)
N_MICRO = (1, 2, 4)


def _weights(kw=KW):
    from topiaxl_torch.models.dit import DiT

    sd = randomize_(DiT(dtype=torch.float32, **kw), 21)
    return {k: v.numpy() for k, v in sd.items()}


def _jax(sd, quant=False):
    """JAX's DiT (W8A8 with ``quant``) and its params from the port's
    weights."""
    from topiaxl.models import DiT as JaxDiT
    from topiaxl.models import quantize_dit_params

    jd = JaxDiT(dtype=jnp.float32, attn_proj_bias=True, **KW)
    params = jax.tree.map(jnp.asarray, convert.convert_dit(
        {k: torch.from_numpy(v) for k, v in sd.items()}, depth=KW["depth"]))
    if quant:
        return jd.clone(quant=True), quantize_dit_params(jd, params)
    return jd, params


def _inputs():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((4, 8, 4)).astype(np.float32)
    t = rng.integers(0, 20, size=(4,))
    y = rng.standard_normal((4, 3, 6)).astype(np.float32)
    key = jax.random.PRNGKey(11)
    t_key, loss_key = jax.random.split(jax.random.fold_in(key, 0))
    drop_key, noise_key = jax.random.split(loss_key)
    t_draw = np.asarray(jax.random.randint(t_key, (4,), 0, 20))
    batch = dict(x=x, y=y, t=t_draw,
                 drop=np.asarray(jax.random.uniform(drop_key, (4,)) < 0.1),
                 noise=np.asarray(jax.random.normal(noise_key, x.shape)))
    return x, t, y, key, batch


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    x, t, y, _, batch = _inputs()
    job = {"pp": dict(kw=KW, sd=_weights(), x=x, t=t, y=y,
                      mesh={"pp": 4}, n_micro=N_MICRO,
                      train_mesh={"dp": 2, "pp": 2}, batch=batch,
                      diffusion=DIFFUSION, optimizer=OPTIMIZER,
                      ema_decay=EMA)}
    return W.spawn(4, job, str(tmp_path_factory.mktemp("pp")), timeout=150)


@pytest.mark.parametrize("n_micro", N_MICRO)
def test_pp_forward_matches_jax(ranks, n_micro):
    """pp = 4 (one block a stage), the batch of 4 in ``n_micro``
    microbatches: every rank's output is JAX's plain forward."""
    x, t, y, _, _ = _inputs()
    jd, params = _jax(_weights())
    ref = np.asarray(jd.apply(params, jnp.asarray(x), jnp.asarray(t),
                              jnp.asarray(y)))
    assert np.abs(ref).max() > 0.1
    for r in ranks:
        np.testing.assert_allclose(r["pp"]["forward"][n_micro].numpy(), ref,
                                   atol=BAR, rtol=BAR)


def test_pp_forward_int8_matches_jax(ranks):
    """A W8A8 DiT (``tests/test_pipeline_parallel.py:112``) pipelines: its
    output over pp = 4 is JAX's W8A8 forward."""
    x, t, y, _, _ = _inputs()
    jq, qparams = _jax(_weights(), quant=True)
    ref = np.asarray(jq.apply(qparams, jnp.asarray(x), jnp.asarray(t),
                              jnp.asarray(y)))
    for r in ranks:
        np.testing.assert_allclose(r["pp"]["int8"].numpy(), ref, atol=BAR,
                                   rtol=BAR)


def test_stage_state_dicts_gather_to_the_whole(ranks):
    """Each stage's state_dict (its blocks under their global names, the
    rest replicated) gathers over pp to the whole weights exactly."""
    assert all(r["pp"]["gathers"] for r in ranks)


@pytest.mark.parametrize("name", ["train", "train_remat"])
def test_pp_dp_train_step_matches_jax(ranks, name):
    """dp = 2 x pp = 2 (two blocks a stage, two microbatches of a rank's two
    rows), and the same with every block recomputed in the backward:
    against JAX's single-device step on the same weights and draws. The
    state's whole tensors (gathered over the stages) load back into a
    fresh stage's state unchanged, as a resume does."""
    from topiaxl.diffusion import create_diffusion as jax_diffusion
    from topiaxl.pipelines.train import (create_train_state as jax_state,
                                         make_optimizer as jax_optimizer,
                                         make_train_step as jax_step)
    from topiaxl_torch.core import weights

    x, _, y, key, _ = _inputs()
    jd, params = _jax(_weights())
    opt = jax_optimizer(**OPTIMIZER)
    s2, m2 = jax.jit(jax_step(jd, jax_diffusion(**DIFFUSION), opt,
                              ema_decay=EMA))(
        jax_state(params, opt), {"x": jnp.asarray(x), "y": jnp.asarray(y)},
        key)
    ref = {n: weights.dit_from_jax(jax.tree.map(np.asarray, t)) for n, t in (
        ("params", s2.params), ("ema", s2.ema_params),
        ("mu", s2.opt_state[1][0].mu), ("nu", s2.opt_state[1][0].nu))}
    fc1 = "blocks.2.mlp.fc1.weight"
    for r in ranks:
        got = r["pp"][name]
        assert got["resumes"]
        np.testing.assert_allclose(got["metrics"]["loss"], float(m2["loss"]),
                                   rtol=LOSS_REL)
        np.testing.assert_allclose(got["metrics"]["grad_norm"],
                                   float(m2["grad_norm"]), rtol=GNORM_REL)
        np.testing.assert_allclose(got["params"][fc1].numpy(),
                                   ref["params"][fc1].numpy(), rtol=0,
                                   atol=UPDATE_ABS)
        _check_state(got, ref, ref)


# both attentions on the flash path (>= 512 keys, head dim 72), so a
# policy's kept flash outputs enter the pipeline's recompute
WIDE_KW = dict(KW, seq_length=520, hidden_size=144, depth=2)


def _wide_inputs():
    rng = np.random.default_rng(4)
    return (rng.standard_normal((2, 520, 4)).astype(np.float32),
            np.array([3, 17]),
            rng.standard_normal((2, 530, 6)).astype(np.float32))


def _one_stage_vs_plain(kw=KW, inputs=None, remat=False, frozen=False):
    """pp = 1 in this process against the plain forward (no remat) on the
    same weights: output within 1e-6, then every gradient of
    ``out.square().sum()``. ``frozen`` sets every parameter outside the
    blocks to ``requires_grad_(False)`` on both sides. Returns the number
    of block parameters that got a gradient."""
    from topiaxl_torch.models.dit import DiT
    from topiaxl_torch.parallel import (make_mesh, make_pp_forward,
                                        shard_pp_params)

    sd = {k: torch.from_numpy(v) for k, v in _weights(kw).items()}
    x, t, y = (torch.from_numpy(np.asarray(a))
               for a in (inputs or _inputs()[:3]))
    plain = DiT(dtype=torch.float32, **kw)
    plain.load_state_dict(sd)
    stage = DiT(dtype=torch.float32, remat=remat, **kw)
    stage.load_state_dict(sd)
    if frozen:
        for model in (plain, stage):
            for n, p in model.named_parameters():
                p.requires_grad_(n.startswith("blocks."))
    mesh = make_mesh({"pp": 1}, world_size=1)
    fwd = make_pp_forward(shard_pp_params(stage, mesh), mesh, n_micro=2)
    out, ref = fwd(x, t, y), plain(x, t, y)
    torch.testing.assert_close(out, ref, atol=1e-6, rtol=1e-6)
    out.square().sum().backward()
    ref.square().sum().backward()
    grads = dict(plain.named_parameters())
    # each gradient within 1e-5 of its own largest entry, or of the largest
    # of all where it is zero in exact arithmetic (the key bias's)
    top = max(p.grad.abs().max() for p in plain.parameters()
              if p.grad is not None)
    for n, p in stage.named_parameters():
        g = grads[n].grad
        if g is None:
            assert p.grad is None or not p.grad.any(), n
            continue
        bar = 1e-5 * (top if n.endswith("to_k.bias") else g.abs().max())
        torch.testing.assert_close(p.grad, g, atol=bar, rtol=0, msg=n)
    return sum(p.grad is not None for n, p in stage.named_parameters()
               if n.startswith("blocks."))


def test_one_stage_pipeline_is_the_plain_forward():
    """pp = 1 in this process: the schedule runs every block as one stage
    in ``n_micro`` microbatches; output and gradients are the plain
    forward's."""
    _one_stage_vs_plain()


def test_one_stage_pipeline_trains_blocks_behind_frozen_embedders():
    """With every parameter outside the blocks frozen, no input of the
    pipeline needs a gradient, yet every block parameter gets the plain
    forward's (the stage's parameters are inputs of the pipeline's
    Function, as JAX's value_and_grad over the stacked blocks gives
    them theirs)."""
    n_blocks = sum(1 for n in _weights() if n.startswith("blocks."))
    assert _one_stage_vs_plain(frozen=True) == n_blocks == 72


@pytest.mark.parametrize("remat", ["dots", "flash", "flash_mlp"])
def test_one_stage_pipeline_under_each_policy_jax_takes(remat):
    """The remat policies JAX's pipeline takes, on a DiT whose attentions
    take the flash path: the plain forward's output and gradients."""
    _one_stage_vs_plain(WIDE_KW, _wide_inputs(), remat=remat)


def test_pp_refuses_what_jax_refuses():
    """depth % pp and B % n_micro raise as in JAX; ``remat="dots"`` builds,
    and ``make_pp_forward`` raises for ``dots_plus`` and an unknown name
    with JAX's message (``topiaxl/parallel/pipeline.py:stage``)."""
    from topiaxl_torch.models.dit import DiT
    from topiaxl_torch.parallel import (make_mesh, make_pp_forward,
                                        shard_pp_params)

    with pytest.raises(ValueError, match="not divisible by pp=3"):
        shard_pp_params(DiT(dtype=torch.float32, **KW),
                        make_mesh({"pp": 3}, world_size=3))
    assert DiT(dtype=torch.float32, remat="dots", **KW).remat == "dots"
    mesh = make_mesh({"pp": 1}, world_size=1)
    stage = shard_pp_params(DiT(dtype=torch.float32, **KW), mesh)
    x, t, y = (torch.from_numpy(np.asarray(a)) for a in _inputs()[:3])
    with pytest.raises(ValueError, match="not divisible by n_micro=3"):
        make_pp_forward(stage, mesh, n_micro=3)(x, t, y)
    for remat in ("dots_plus", "everything"):
        stage.remat = remat
        with pytest.raises(ValueError, match=(
                f"remat='{remat}': expected False, True, 'dots', 'flash', "
                "or 'flash_mlp'")):
            make_pp_forward(stage, mesh, n_micro=2)


def test_stack_unstack_roundtrip():
    """``stack_dit_params`` gives every block leaf a leading [depth] axis;
    ``unstack_dit_params`` gives the state_dict back exactly."""
    from topiaxl_torch.parallel import stack_dit_params, unstack_dit_params

    sd = {k: torch.from_numpy(v) for k, v in _weights().items()}
    pp = stack_dit_params(sd, KW["depth"])
    assert pp["stacked"]["attn.qkv.weight"].shape[0] == KW["depth"]
    back = unstack_dit_params(pp, KW["depth"])
    assert back.keys() == sd.keys()
    assert all(torch.equal(back[k], sd[k]) for k in sd)
