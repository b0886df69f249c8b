"""topiaxl_torch's named remat policies (``models/dit.py:REMAT_POLICIES``:
``dots``, ``dots_plus``, ``flash``, ``flash_mlp``) on the CPU, f32, on a
tiny randomised DiT whose attentions take the flash path (520 tokens, 530
condition tokens, head dim 72), against ``remat=True`` and the JAX
package.

Bars: one ``make_train_step`` step under each policy gives ``remat=True``'s
loss and updated parameters within 1e-6 (JAX's own bar between its remat
modes, ``tests/test_train.py:test_remat_modes_match_numerics``); the
step's loss and gradients against JAX's under the same policy at the
trainer's bars (``test_torch_train.py:_train_step_vs_jax``). The ops each
mode runs over one forward and backward are counted exactly, and they
are the kernel launches ``chip_smoke.py`` expects on the card
(``train_launches``).
"""

import collections
import importlib.util
import pathlib

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from test_torch_models import randomize_, torch_threads  # noqa: F401
from test_torch_train import _train_step_vs_jax

ROOT = pathlib.Path(__file__).resolve().parents[1]
POLICIES = ("dots", "dots_plus", "flash", "flash_mlp")
# both attentions on the flash path (>= 512 keys, head dim 72)
WIDE = dict(seq_length=520, in_channels=4, condition_channels=8,
            hidden_size=144, num_heads=2, cond_drop_prob=0.1)
# fc1 runs again in the backward unless the policy keeps its output
FC1_RUNS = {False: 1, True: 2, "dots": 1, "dots_plus": 1, "flash": 2,
            "flash_mlp": 1}


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _dit(remat, depth=2):
    from topiaxl_torch.models.dit import DiT

    dit = DiT(dtype=torch.float32, param_dtype=torch.float32, remat=remat,
              depth=depth, **WIDE)
    randomize_(dit, 5)
    return dit.train()


def _batch(n=2):
    rng = np.random.default_rng(6)
    return {"x": torch.from_numpy(rng.standard_normal(
                (n, 520, 4)).astype(np.float32)),
            "y": torch.from_numpy(rng.standard_normal(
                (n, 530, 8)).astype(np.float32))}


def _step(remat):
    """One ``make_train_step`` step: the loss and the updated parameters."""
    from topiaxl_torch.diffusion import create_diffusion
    from topiaxl_torch.pipelines.train import (create_train_state,
                                               make_optimizer, make_train_step)

    dit = _dit(remat)
    state = create_train_state(dit)
    step = make_train_step(
        dit, create_diffusion(timestep_respacing=None,
                              noise_schedule="squaredcos_cap_v2",
                              parameterization="v", diffusion_steps=50),
        make_optimizer(lr=1e-3, warmup_iters=0, max_iters=100),
        ema_decay=0.5)
    loss = float(step(state, _batch(), 0)["loss"])
    return loss, {n: p.detach().clone() for n, p in state.params().items()}


@pytest.fixture(scope="module")
def remat_step():
    return _step(True)


@pytest.mark.parametrize("policy", POLICIES)
def test_policy_train_step_is_remats(policy, remat_step):
    """The policies trade memory for recompute only: the step's loss and
    every updated parameter are ``remat=True``'s."""
    loss, params = _step(policy)
    loss0, params0 = remat_step
    np.testing.assert_allclose(loss, loss0, rtol=1e-6)
    assert params.keys() == params0.keys()
    for name, p in params.items():
        torch.testing.assert_close(p, params0[name], rtol=0, atol=1e-6,
                                   msg=name)


@pytest.mark.parametrize("policy", POLICIES)
def test_policy_step_matches_jax(policy):
    """The port's step under each policy against JAX's step under the same
    policy (``topiaxl/models/dit.py:_remat_policy``), the same weights,
    draws and bars as the plain and ``remat=True`` steps."""
    _train_step_vs_jax(1, remat=policy)


class _OpCounts(TorchDispatchMode):
    """Counts each ``topiaxl_torch`` op that runs (a policy's saved op
    returns its kept output in the recompute and runs no more)."""

    def __init__(self):
        super().__init__()
        self.counts = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.namespace == "topiaxl_torch":
            self.counts[func._opname] += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("remat", [False, True, *POLICIES])
def test_each_mode_runs_the_kernels_chip_smoke_counts(remat, monkeypatch):
    """One forward and backward at depth 3: the flash forward runs once a
    block and attention under every policy (twice with ``remat=True``),
    the LN ops once under ``dots_plus`` (and without remat), twice under
    the rest; the flash backward once an attention. These are
    ``chip_smoke.train_launches`` at that depth, the launches the card
    must show at depth 28."""
    from topiaxl_torch.ops import flash_attention as fa

    depth = 3
    dit = _dit(remat, depth)
    batch = _batch()
    backward = []
    real = fa.flash_attention_backward
    monkeypatch.setattr(fa, "flash_attention_backward",
                        lambda *a: backward.append(1) or real(*a))
    with _OpCounts() as ops:
        out = dit(batch["x"], torch.tensor([3, 7]), batch["y"])
        out.square().mean().backward()
    got = {"flash_attn_fwd": ops.counts["flash_fwd"],
           "flash_attn_bwd": len(backward),
           "ln_modulate": ops.counts["ln_modulate"],
           "ln_modulate_residual": ops.counts["ln_modulate_residual"]}
    expected = _chip_smoke().train_launches(remat, depth)
    assert got == {k: expected[k] for k in got}
    assert expected["flash_attn_bwd_dq"] == expected["flash_attn_bwd_dkv"] == 0
    assert ops.counts["mlp_fc1"] == FC1_RUNS[remat] * depth
    assert all(p.grad is not None for n, p in dit.named_parameters()
               if n.startswith("blocks."))
