"""TRELLIS's sparse-structure flow transformer's training step, back to
back.

Set-up builds the model as the port's trainer does (the registry's
``SparseStructureFlowModel`` from the configuration's ``generator``, f32
master weights, bf16 blocks), loads weights drawn from the seed under
TRELLIS's checkpoint names (``load_state_dict(strict=True)`` through the
model's TRELLIS key map), and makes the step of
``pipelines/train.py:make_train_step`` with the rectified-flow objective
(``diffusion/flow.py``) and AdamW at a constant rate; then it drives the
first ``first_steps`` steps, records what the check needs, and hands the
same state to the window. Every step's batch is new, drawn from the seed
on the device: x0 [B, 8, R, R, R], y [B, M, C] (DINOv2's final-LN tokens
stand in as a layer norm of a normal draw), the flow times (logit-normal),
the cond-drop mask (``p_uncond``: a dropped row sees zeros) and the
noise, all passed to the step, which takes them in place of its own
draws. The unit of work is one sample.

The check is ``train_dit``'s (its ``compare``, ``readings`` and
``check``): the first three steps against the plain reference
(``reference/ss_flow.py``, with ``reference/train.py``'s AdamW) from the
same weights and batches, the reference's gradients and changes read
under the program's names (``models/ss_flow.py:from_trellis``, which
splits each ``to_kv`` into ``to_k`` and ``to_v``), so that the
cross-attention's key bias, whose gradient softmax makes zero, is its own
leaf and is left out of the change as ``train_dit`` leaves out the DiT's.
``fault`` "half_batch" leaves out half of each batch.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import counts_flow, inputs
from ..reference import judge, ops
from ..reference import ss_flow as rflow
from ..reference import train as rtrain
from . import train_dit

# ``inputs.init_rule`` reads a ``gamma`` as DINOv2's LayerScale (mean
# 0.1); the QK-norm gains are drawn around one, as TRELLIS initialises them
GAMMA_SHIFT = 0.9
ADALN_BIAS = "adaLN_modulation.1.bias"
# the reference's AdamW schedule with no warm-up over 2^62 steps: its
# cosine reads 1 (in float64) at every step a check runs, a constant rate
CONSTANT_STEPS = 2 ** 62


class Driver(train_dit.Driver):
    def batch(self, index: int) -> dict:
        g, tr = self.cfg["generator"], self.cfg["train"]
        sched = self.cfg["diffusion"]["t_schedule"]
        B, dev = int(tr["batch_size"]), self.run.device
        gen = torch.Generator(dev).manual_seed(
            inputs.stream_seed(self.seed, "batches", index))
        shape = (B, g["in_channels"]) + (g["resolution"],) * 3
        cc = g["cond_channels"]
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
        from topiaxl_torch.models.ss_flow import from_trellis, to_trellis
        from topiaxl_torch.pipelines import train as T

        c, g, dev = self.cfg, self.cfg["generator"], self.run.device
        self.dit = build(dict(g, class_name="SparseStructureFlowModel",
                              cond_drop_prob=c["train"]["p_uncond"]),
                         device=dev, param_dtype=torch.float32).train()
        self.diffusion = flow.from_config(c["diffusion"])
        o = c["optimizer"]
        self.opt = T.make_optimizer(lr=o["lr"], weight_decay=o["weight_decay"],
                                    grad_clip=o["grad_clip"],
                                    schedule="constant")
        self.T, self.from_trellis = T, from_trellis
        # the weights are drawn and loaded under TRELLIS's names
        self._template = {k: v.to("meta") for k, v
                          in to_trellis(self.dit.state_dict()).items()}
        B = int(c["train"]["batch_size"])
        n, m, C = g["resolution"] ** 3, c["cond_tokens"], g["model_channels"]
        H, depth = g["num_heads"], g["num_blocks"]
        hd = C // H
        self.run.work = {
            "flops": counts_flow.train_step_flops(
                B, depth, C, n, m, g["cond_channels"],
                in_channels=g["in_channels"], out_channels=g["out_channels"],
                mlp_ratio=g["mlp_ratio"]) / B,
            "attn_fwd": [((1, n, n, H, hd), depth), ((1, n, m, H, hd), depth)],
            "attn_bwd": [((1, n, n, H, hd), depth), ((1, n, m, H, hd), depth)],
            # q and k in every block, forward and backward
            "qk_norm_bytes": 2 * depth * sum(
                counts_flow.qk_norm_bytes(B, n, H, hd)) / B,
        }
        self.load(self.run.seed)

    @torch.no_grad()
    def _weights(self, seed: int) -> dict:
        """TRELLIS-named weights from ``seed`` (``inputs.seeded_weights``,
        whose gate rule reads a nine-way adaLN: the six-way biases are
        drawn under a masked name and their two gates centred on
        ``inputs.GATE_BIAS`` here; the QK-norm gains around one)."""
        def mask(k):
            return "~" + k if k.endswith(ADALN_BIAS) else k

        drawn = inputs.seeded_weights(
            {mask(k): v for k, v in self._template.items()}, seed,
            self.run.device)
        out = {k: drawn[mask(k)] for k in self._template}
        for k, w in out.items():
            if k.endswith(ADALN_BIAS):
                w.view(6, -1)[2::3] += inputs.GATE_BIAS
            elif k.endswith("_rms_norm.gamma"):
                w += GAMMA_SHIFT
        return out

    def load(self, seed: int) -> None:
        """A new training state from ``seed``, driven through its first
        steps; the readings the check compares are taken on the way."""
        self.seed = seed
        self.dit.load_state_dict(self._weights(seed))
        self.state = self.T.create_train_state(self.dit)
        self.step = self.T.make_train_step(
            self.dit, self.diffusion, self.opt,
            ema_decay=self.cfg["train"]["ema_decay"])
        p0 = {k: v.detach().clone() for k, v in self.dit.named_parameters()}
        b1 = self.opt["b1"]
        self.losses, self.first = [], int(self.mix["first_steps"])
        for s in range(self.first):
            m = self.step(self.state, self._program_batch(s), self.seed)
            self.losses.append(float(m["loss"]))
            if s == 0:
                self.grad_first = {k: (v / (1 - b1)).cpu() for k, v
                                   in self.state.opt_state.mu.items()}
        self.change_norms = judge.norms(
            {k: v.detach() - p0[k] for k, v in self.dit.named_parameters()})
        self.ema_moves = judge.norms(
            {k: v - p0[k] for k, v in self.state.ema_params.items()})
        del p0

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
        adam = rtrain.AdamW(o["lr"], 0, CONSTANT_STEPS, clip=o["grad_clip"])
        losses = []
        with ops.precision(precision):
            for step in range(self.first):
                loss, grads = rflow.gradient(P, self.batch(step), heads)
                clipped = adam.step(P, grads)
                for k in ema:
                    ema[k].mul_(decay).add_(P[k].double(), alpha=1.0 - decay)
                losses.append(loss)
                if step == 0:
                    g_first = self.from_trellis(clipped)
                del grads, clipped
            losses.append(rflow.loss(P, self.batch(self.first), heads))
        changes = judge.norms(self.from_trellis({k: P[k] - P0[k] for k in P}))
        moves = judge.norms(self.from_trellis({k: ema[k] - P0[k] for k in P}))
        return losses, g_first, changes, moves
