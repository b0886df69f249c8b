"""Hunyuan3D-2.1's shape DiT's training step, back to back.

Set-up builds the model as the port's trainer does (the registry's
``HunYuanDiTPlain`` from the configuration's ``generator``, f32 master
weights, bf16 blocks), loads weights drawn from the seed under the
release's checkpoint names (``load_state_dict(strict=True)`` through the
model's key map, which stacks each layer's experts), and makes the step of
``pipelines/train.py:make_train_step`` with the rectified-flow objective
(``diffusion/flow.py``, here at sigma_min 0) and AdamW at a constant rate;
then it drives the first ``first_steps`` steps, records what the check
needs, zeroes the program's counter of expert slots
(``models/moe.py:expert_tokens``) and hands the same state to the window.
Every step's batch is new, drawn from the seed on the device: x0 [B,
4096, 64], y [B, 1370, 1024] (DINOv2-L/14's final-LN tokens stand in as a
layer norm of a normal draw), the flow times (logit-normal), the cond-drop
mask (``p_uncond``: a dropped row sees zeros) and the noise, all passed to
the step, which takes them in place of its own draws. The unit of work is
one sample.

The state and its first steps are ``train_flow``'s (its ``load``), the
check ``train_dit``'s (its ``compare``, ``readings`` and ``check``): the
first three steps against the plain reference (``reference/hunyuandit.py``,
with ``reference/train.py``'s AdamW) from the same weights and batches. The
reference routes its own f32 activations: a token whose second and third
gate scores lie within the program's bf16 rounding of each other may take
another expert there, which the sound readings carry. The reference's
gradients and changes are read under the program's names
(``models/hunyuandit.py:from_h21``; a stacked expert tensor's norm is the
norm of its experts' norms). To fit beside the reference's own state, the
first gradient waits on the host and the EMA is kept as its move from the
start (``ema - p0`` follows the same recurrence). ``fault``: "half_batch"
leaves out half of each batch; "renorm_topk" divides each token's top-2
weights by their sum in the program (the release's ``norm_topk_prob``);
"no_aux" drops the auxiliary loss's gradient in the program (the gate
scores it reads leave the graph). Both wrap each MoE layer's ``route``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import counts_h21, inputs
from ..reference import hunyuandit as rh21
from ..reference import judge, ops
from ..reference import train as rtrain
from . import train_flow


def _renorm_topk(route):
    """``route`` with each token's top-k weights divided by their sum."""
    def routed(x):
        experts, weights, scores = route(x)
        return experts, weights / weights.sum(-1, keepdim=True), scores
    return routed


def _no_aux(route):
    """``route`` whose scores, which only the auxiliary loss reads, carry no
    gradient: the forward is the same, the aux gradient is gone."""
    def routed(x):
        experts, weights, scores = route(x)
        return experts, weights, scores.detach()
    return routed


FAULTS = {"renorm_topk": _renorm_topk, "no_aux": _no_aux}


class Driver(train_flow.Driver):
    def batch(self, index: int) -> dict:
        g, tr = self.cfg["generator"], self.cfg["train"]
        sched = self.cfg["diffusion"]["t_schedule"]
        B, dev = int(tr["batch_size"]), self.run.device
        gen = torch.Generator(dev).manual_seed(
            inputs.stream_seed(self.seed, "batches", index))
        shape = (B, g["input_size"], g["in_channels"])
        cc = g["context_dim"]
        x = torch.randn(shape, generator=gen, device=dev)
        y = F.layer_norm(torch.randn((B, self.cfg["cond_tokens"], cc),
                                     generator=gen, device=dev), (cc,),
                         eps=1e-6)
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
        from topiaxl_torch.models import moe
        from topiaxl_torch.models.hunyuandit import from_h21, to_h21
        from topiaxl_torch.pipelines import train as T

        c, g, dev = self.cfg, self.cfg["generator"], self.run.device
        self.dit = build(dict(g, class_name="HunYuanDiTPlain",
                              cond_drop_prob=c["train"]["p_uncond"]),
                         device=dev, param_dtype=torch.float32).train()
        if self.fault in FAULTS:
            for m in self.dit.modules():
                if isinstance(m, moe.MoEFFN):
                    m.route = FAULTS[self.fault](m.route)
        self.diffusion = flow.from_config(c["diffusion"])
        o = c["optimizer"]
        self.opt = T.make_optimizer(lr=o["lr"], weight_decay=o["weight_decay"],
                                    grad_clip=o["grad_clip"],
                                    schedule="constant")
        self.T, self.from_names = T, from_h21
        # the weights are drawn and loaded under the release's names
        self._template = {k: v.to("meta") for k, v
                          in to_h21(self.dit.state_dict()).items()}
        B = int(c["train"]["batch_size"])
        n, m, C = g["input_size"], c["cond_tokens"], g["hidden_size"]
        H, depth, moe_layers = g["num_heads"], g["depth"], g["num_moe_layers"]
        hd, L = C // H, n + 1
        self.run.work = {
            "flops": counts_h21.train_step_flops(
                B, depth, moe_layers, C, n, m, g["context_dim"],
                in_channels=g["in_channels"], experts=g["num_experts"],
                top_k=g["moe_top_k"]) / B,
            "attn_fwd": [((1, L, L, H, hd), depth), ((1, L, m, H, hd), depth)],
            "attn_bwd": [((1, L, L, H, hd), depth), ((1, L, m, H, hd), depth)],
            "qk_norm_bytes": counts_h21.step_qk_norm_bytes(
                B, depth, n, m, H, hd) / B,
            # a step's: the span h21.moe.experts is read a step
            "expert_flops_step": counts_h21.expert_flops(
                B, moe_layers, C, L, g["moe_top_k"]),
        }
        self.load(self.run.seed)
        moe.reset_expert_tokens()

    @torch.no_grad()
    def _weights(self, seed: int) -> dict:
        """Release-named weights from ``seed`` (``inputs.seeded_weights``:
        the LN and QK-norm gains drawn around one as norm gains)."""
        return inputs.seeded_weights(self._template, seed, self.run.device)

    def port_norms(self, norms: dict) -> dict:
        """Per-leaf norms under the release's names -> the program's: a
        stacked leaf's norm is the norm of its parts'."""
        out = self.from_names({k: torch.tensor(v, dtype=torch.float64)
                               for k, v in norms.items()})
        return {k: float(v.norm()) for k, v in out.items()}

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
        moved = {k: torch.zeros_like(v) for k, v in P.items()}   # ema - p0
        adam = rtrain.AdamW(o["lr"], 0, train_flow.CONSTANT_STEPS,
                            clip=o["grad_clip"])
        losses = []
        with ops.precision(precision):
            for step in range(self.first):
                loss, grads = rh21.gradient(P, self.batch(step), heads)
                clipped = adam.step(P, grads)
                del grads
                for k, e in moved.items():
                    e.mul_(decay).add_(P[k] - P0[k], alpha=1.0 - decay)
                losses.append(loss)
                if step == 0:
                    g_first = {k: v.cpu() for k, v in clipped.items()}
                del clipped
            losses.append(rh21.loss(P, self.batch(self.first), heads))
        changes = self.port_norms({k: float((P[k] - P0[k]).double().norm())
                                   for k in P})
        moves = self.port_norms(judge.norms(moved))
        del P, P0, moved, adam
        return losses, self.from_names(g_first), changes, moves
