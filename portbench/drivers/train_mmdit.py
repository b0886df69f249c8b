"""Hunyuan3D-2's shape DiT's training step, back to back.

Set-up builds the model as the port's trainer does (the registry's
``Hunyuan3DDiT`` from the configuration's ``generator``, f32 master
weights, bf16 blocks), loads weights drawn from the seed under
Hunyuan3D-2's checkpoint names (``load_state_dict(strict=True)`` through
the model's key map), and makes the step of
``pipelines/train.py:make_train_step`` with the rectified-flow objective
(``diffusion/flow.py``, here at sigma_min 0) and AdamW at a constant rate;
then it drives the first ``first_steps`` steps, records what the check
needs, and hands the same state to the window. Every step's batch is new,
drawn from the seed on the device: x0 [B, 3072, 64], y [B, 1370, 1536]
(DINOv2-giant's final-LN tokens stand in as a layer norm of a normal
draw), the flow times (logit-normal), the cond-drop mask (``p_uncond``: a
dropped row sees zeros) and the noise, all passed to the step, which takes
them in place of its own draws. The unit of work is one sample.

The state and its first steps are ``train_flow``'s (its ``load``), the
check ``train_dit``'s (its ``compare``, ``readings`` and ``check``), as
``train_flow`` runs it: the first three steps against the
plain reference (``reference/mmdit.py``, with ``reference/train.py``'s
AdamW) from the same weights and batches, the reference's gradients and
changes read under the program's names (``models/mmdit.py:from_hunyuan``).
``fault`` "half_batch" leaves out half of each batch.
"""

from __future__ import annotations

import torch

from .. import counts_mmdit, inputs
from ..reference import judge, ops
from ..reference import mmdit as rmm
from ..reference import train as rtrain
from . import train_flow


def centre_gates_(weights: dict) -> None:
    """Centre each modulation's gates on ``inputs.GATE_BIAS`` (its bias is
    drawn around 0): the third and sixth of a double block's six chunks,
    the third of a single block's three."""
    for k, w in weights.items():
        if k.endswith("_mod.lin.bias"):
            w.view(6, -1)[2::3] += inputs.GATE_BIAS
        elif k.startswith("single_blocks.") and k.endswith(
                ".modulation.lin.bias"):
            w.view(3, -1)[2] += inputs.GATE_BIAS


class Driver(train_flow.Driver):
    def batch(self, index: int) -> dict:
        g, tr = self.cfg["generator"], self.cfg["train"]
        sched = self.cfg["diffusion"]["t_schedule"]
        B, dev = int(tr["batch_size"]), self.run.device
        gen = torch.Generator(dev).manual_seed(
            inputs.stream_seed(self.seed, "batches", index))
        shape = (B, g["num_latents"], g["in_channels"])
        cc = g["context_in_dim"]
        x = torch.randn(shape, generator=gen, device=dev)
        y = torch.nn.functional.layer_norm(
            torch.randn((B, self.cfg["cond_tokens"], cc), generator=gen,
                        device=dev), (cc,), eps=1e-6)
        z = torch.randn((B,), generator=gen, device=dev)
        return {"x": x, "y": y,
                "t": torch.sigmoid(z * sched["std"] + sched["mean"]),
                "drop": torch.rand((B,), generator=gen, device=dev)
                < tr["p_uncond"],
                "noise": torch.randn(shape, generator=gen, device=dev)}

    def setup(self) -> None:
        from topiaxl_torch import registry  # noqa: F401  (the factories)
        from topiaxl_torch.core.config import build
        from topiaxl_torch.diffusion import flow
        from topiaxl_torch.models.mmdit import from_hunyuan, to_hunyuan
        from topiaxl_torch.pipelines import train as T

        c, g, dev = self.cfg, self.cfg["generator"], self.run.device
        self.dit = build(dict(g, class_name="Hunyuan3DDiT",
                              cond_drop_prob=c["train"]["p_uncond"]),
                         device=dev, param_dtype=torch.float32).train()
        self.diffusion = flow.from_config(c["diffusion"])
        o = c["optimizer"]
        self.opt = T.make_optimizer(lr=o["lr"], weight_decay=o["weight_decay"],
                                    grad_clip=o["grad_clip"],
                                    schedule="constant")
        self.T, self.from_names = T, from_hunyuan
        # the weights are drawn and loaded under Hunyuan3D-2's names
        self._template = {k: v.to("meta") for k, v
                          in to_hunyuan(self.dit.state_dict()).items()}
        B = int(c["train"]["batch_size"])
        n, m, C = g["num_latents"], c["cond_tokens"], g["hidden_size"]
        H, depth, single = g["num_heads"], g["depth"], g["depth_single_blocks"]
        hd, L = C // H, n + m
        self.run.work = {
            "flops": counts_mmdit.train_step_flops(
                B, depth, single, C, n, m, g["context_in_dim"],
                in_channels=g["in_channels"], mlp_ratio=g["mlp_ratio"]) / B,
            "attn_fwd": [((1, L, L, H, hd), depth + single)],
            "attn_bwd": [((1, L, L, H, hd), depth + single)],
            "qk_norm_bytes": counts_mmdit.step_qk_norm_bytes(
                B, depth, single, n, m, H, hd) / B,
        }
        self.load(self.run.seed)

    @torch.no_grad()
    def _weights(self, seed: int) -> dict:
        """Hunyuan3D-2-named weights from ``seed``
        (``inputs.seeded_weights``: the QK-norm gains, named ``scale``,
        drawn around one as norm gains), the modulations' gates centred."""
        out = inputs.seeded_weights(self._template, seed, self.run.device)
        centre_gates_(out)
        return out

    def reference_readings(self, precision: str = "f32") -> tuple:
        """(losses of the first steps and of the next, first clipped
        gradient, change norms, EMA move norms) of the reference, its
        products in ``precision``, under the program's names."""
        ops.no_tf32()
        heads = self.cfg["generator"]["num_heads"]
        o = self.cfg["optimizer"]
        decay = float(self.cfg["train"]["ema_decay"])
        P = {k: v.float() for k, v in self._weights(self.seed).items()}
        P0 = {k: v.clone() for k, v in P.items()}
        ema = {k: v.double() for k, v in P.items()}
        adam = rtrain.AdamW(o["lr"], 0, train_flow.CONSTANT_STEPS,
                            clip=o["grad_clip"])
        losses = []
        with ops.precision(precision):
            for step in range(self.first):
                loss, grads = rmm.gradient(P, self.batch(step), heads)
                clipped = adam.step(P, grads)
                for k in ema:
                    ema[k].mul_(decay).add_(P[k].double(), alpha=1.0 - decay)
                losses.append(loss)
                if step == 0:
                    g_first = self.from_names(clipped)
                del grads, clipped
            losses.append(rmm.loss(P, self.batch(self.first), heads))
        changes = judge.norms(self.from_names({k: P[k] - P0[k] for k in P}))
        moves = judge.norms(self.from_names({k: ema[k] - P0[k] for k in P}))
        return losses, g_first, changes, moves
