"""The DiT's training step, back to back.

Set-up builds one training state (f32 master weights from the seed,
AdamW moments, EMA) and the step of ``pipelines/train.py:make_train_step``,
drives it through its first ``first_steps`` steps with the window's own
call and feed, records what the check needs, and hands the same state to
the window. Every step's batch is new, drawn from the seed on the device:
x [B, N, 68] tokens, y [B, M, C] conditioning tokens, the timesteps
(uniform over the 1000), the cond-drop mask and the noise, all passed to
the step, which takes them in place of its own draws. The unit of work is
one sample.

The check follows the first three steps with the reference
(``reference/train.py``), from the same weights and batches, and then
the loss of step 4, the window's first. The readings: each step's loss
(``loss_gap``, the worst relative gap of the four); the first gradient
as the optimizer got it, read back from its first moment after one step,
and each parameter's change over the three steps, each by the gap
between the two norms over the larger of the reference's norm of that
leaf and of the median leaf, at the worst leaf (``grad_gap``,
``update_gap``) and at the median one (``grad_median_gap``,
``update_median_gap``); the first gradient also by the norm of the
difference in its place (``grad_diff``, ``grad_median_diff``). The
change leaves out the leaves whose reference gradient is under a
thousandth of the median leaf's (a key's bias under softmax: Adam moves
them by round-off alone). The EMA's move over the three steps is read as
the change is (``ema_gap``): at the warm-up's learning rates it moves by
about 1e-4 of a change of about 1e-7, below what its float32 values
hold. The cell's ``limits`` name the readings compared; the others are
printed.

``fault`` plants a fault for the readings that set the limits:
"half_batch" (half of each batch left out, the mean over the rest).
"""

from __future__ import annotations

import sys

import torch

from .. import counts, inputs
from ..reference import judge, ops
from ..reference import train as rtrain


class Driver:
    def __init__(self, run, fault: str | None = None):
        self.run, self.fault = run, fault
        self.cfg, self.mix = run.config, run.traffic

    def batch(self, index: int) -> dict:
        g, t = self.cfg["generator"], self.cfg["train"]
        B, dev = int(t["batch_size"]), self.run.device
        gen = torch.Generator(dev).manual_seed(
            inputs.stream_seed(self.seed, "batches", index))
        shape = (B, g["seq_length"], g["in_channels"])
        out = {"x": torch.randn(shape, generator=gen, device=dev),
               "y": torch.randn((B, self.cfg["cond_tokens"],
                                 g["condition_channels"]),
                                generator=gen, device=dev),
               "t": torch.randint(0, self.cfg["diffusion"]["diffusion_steps"],
                                  (B,), generator=gen, device=dev),
               "drop": torch.rand((B,), generator=gen, device=dev)
               < g["cond_drop_prob"],
               "noise": torch.randn(shape, generator=gen, device=dev)}
        return out

    def _program_batch(self, index: int) -> dict:
        b = self.batch(index)
        if self.fault == "half_batch":
            b = {k: v[: v.shape[0] // 2] for k, v in b.items()}
        return b

    def setup(self) -> None:
        from topiaxl_torch.diffusion import create_diffusion
        from topiaxl_torch.models.dit import DiT
        from topiaxl_torch.pipelines import train as T

        c, g, dev = self.cfg, self.cfg["generator"], self.run.device
        self.dit = DiT(**g, dtype=torch.bfloat16, param_dtype=torch.float32,
                       device=dev).train()
        d = c["diffusion"]
        self.diffusion = create_diffusion(
            timestep_respacing=None, noise_schedule=d["noise_schedule"],
            parameterization=d["parameterization"],
            diffusion_steps=d["diffusion_steps"], device=dev)
        o, s = c["optimizer"], c["scheduler"]
        self.opt = T.make_optimizer(
            lr=o["lr"], weight_decay=o["weight_decay"],
            warmup_iters=s["warmup_iters"], max_iters=s["max_iters"],
            grad_clip=o["grad_clip"])
        self.T = T
        self._template = {k: v.to("meta") for k, v in self.dit.state_dict().items()}
        B, n, m = int(c["train"]["batch_size"]), g["seq_length"], c["cond_tokens"]
        hd = g["hidden_size"] // g["num_heads"]
        self.run.work = {
            "flops": counts.train_step_flops(
                B, g["depth"], g["hidden_size"], n, m,
                g["condition_channels"], in_channels=g["in_channels"]) / B,
            "attn_fwd": [((1, n, n, g["num_heads"], hd), g["depth"]),
                         ((1, n, m, g["num_heads"], hd), g["depth"])],
            "attn_bwd": [((1, n, n, g["num_heads"], hd), g["depth"]),
                         ((1, n, m, g["num_heads"], hd), g["depth"])],
        }
        self.load(self.run.seed)

    @torch.no_grad()
    def _weights(self, seed: int) -> dict:
        return inputs.seeded_weights(self._template, seed, self.run.device)

    def load(self, seed: int) -> None:
        """A new training state from ``seed``, driven through its first
        steps; the readings the check compares are taken on the way."""
        self.seed = seed
        self.dit.load_state_dict(self._weights(seed))
        self.state = self.T.create_train_state(self.dit)
        self.step = self.T.make_train_step(
            self.dit, self.diffusion, self.opt,
            ema_decay=self.cfg["train"]["ema_decay"],
            timestep_sampler=self.cfg["train"]["timestep_sampler"])
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

    def request(self, i: int) -> int:
        b = self._program_batch(self.first + i)
        m = self.step(self.state, b, self.seed)
        if i == 0:
            self.window_loss = m["loss"]
        return int(b["x"].shape[0])

    def finish(self) -> None:
        self.state = self.step = self.dit = None
        if self.run.device.type == "cuda":
            torch.cuda.empty_cache()

    # -- the check -------------------------------------------------------

    def reference_readings(self, precision: str = "f32") -> tuple:
        """(losses of the first steps and of the next, first clipped
        gradient, change norms, EMA move norms) of the reference, its
        products in ``precision``."""
        ops.no_tf32()
        heads = self.cfg["generator"]["num_heads"]
        c = self.cfg
        o, s = c["optimizer"], c["scheduler"]
        decay = float(c["train"]["ema_decay"])
        P = {k: v.float() for k, v in self._weights(self.seed).items()}
        P0 = {k: v.clone() for k, v in P.items()}
        ema = {k: v.double() for k, v in P.items()}
        adam = rtrain.AdamW(o["lr"], s["warmup_iters"], s["max_iters"],
                            clip=o["grad_clip"])
        losses = []
        with ops.precision(precision):
            for step in range(self.first):
                loss, grads = rtrain.gradient(P, self.batch(step), heads)
                clipped = adam.step(P, grads)
                for k in ema:
                    ema[k].mul_(decay).add_(P[k].double(), alpha=1.0 - decay)
                losses.append(loss)
                if step == 0:
                    g_first = clipped
                del grads, clipped
            losses.append(rtrain.loss(P, self.batch(self.first), heads))
        changes = judge.norms({k: P[k] - P0[k] for k in P})
        moves = judge.norms({k: ema[k] - P0[k] for k in P})
        return losses, g_first, changes, moves

    def compare(self, losses, g_first, changes, moves, ref) -> dict:
        r_losses, r_first, r_changes, r_moves = ref
        r_g = judge.norms(r_first)
        g_norms = judge.norms(g_first, next(iter(r_first.values())).device)
        med = sorted(r_g.values())[len(r_g) // 2]
        moved = {k for k, v in r_g.items() if v >= 1e-3 * med}
        grad, g_at, grad_med = judge.leaf_gaps(g_norms, r_g)
        diff, d_at, diff_med = judge.leaf_gaps(
            g_norms, r_g, gaps=judge.diff_norms(g_first, r_first))
        upd, u_at, upd_med = judge.leaf_gaps(changes, r_changes, keep=moved)
        ema, e_at, _ = judge.leaf_gaps(moves, r_moves, keep=moved)
        print(f"portbench: losses {losses!r} reference {r_losses!r}; worst "
              f"gradient leaf {g_at}, worst change leaf {u_at}; "
              f"{len(r_g) - len(moved)} leaves left out of the change; "
              f"worst EMA leaf {e_at}, EMA move of the median leaf "
              f"{sorted(moves.values())[len(moves) // 2]!r}, reference "
              f"{sorted(r_moves.values())[len(r_moves) // 2]!r}",
              file=sys.stderr)
        return {"loss_gap": max(judge.rel_gap(a, b)
                                for a, b in zip(losses, r_losses, strict=True)),
                "grad_gap": grad, "grad_median_gap": grad_med,
                "grad_diff": diff, "grad_median_diff": diff_med,
                "update_gap": upd, "update_median_gap": upd_med,
                "ema_gap": ema}

    def readings(self) -> dict:
        return self.compare(self.losses + [float(self.window_loss)],
                            self.grad_first, self.change_norms,
                            self.ema_moves, self.reference_readings())

    def check(self) -> dict:
        r = self.readings()
        lim = self.run.cell["limits"]
        print("portbench: not compared: "
              + ", ".join(f"{k} {v!r}" for k, v in r.items() if k not in lim),
              file=sys.stderr)
        return {k: (r[k], float(v)) for k, v in lim.items()}
