"""Image -> PrimX, one client in a closed loop.

Each request takes the next image of a pool made from the seed (already
matted, at the encoder's size), encodes it with DINOv2
(``models/conditioner/image.py:DinoV2Wrapper``) and runs
``pipelines/infer.py:generate_primx`` on its tokens with the request's
initial noise, drawn from the seed and passed as ``noise=``: the DDIM chain
with CFG (one CUDA graph on a card) and the VAE decode. The unit of work
is one PrimX.

The check: a sample of the window's requests, drawn from the seed, is
kept; once the window has closed the reference encodes each kept image,
runs the chain from the same noise in float32 and decodes. The readings,
each the worst over the sample: a request's relative RMS gap of the
encoder's tokens (``enc_gap``), of ``srt`` and of ``feat``
(``srt_gap``, ``feat_gap``); its worst prim, the prim's gap over the RMS
of the request's prims (``srt_row_gap``, ``feat_row_gap``); and, over the
whole sample, the gap of the mean over every prim (``*_mean_gap``): an
error all prims share. The cell's ``limits`` name the ones compared; the
others are printed.

Two controls, for the readings the limits are set from: the reference
itself with its products in float8 e4m3 put in the program's place
(``readings("fp8")``), and ``variant="w8a8"``, the program's own W8A8
path for the DiT's block products (``model.generator.quant``).
"""

from __future__ import annotations

import random
import sys

import numpy as np
import torch

from .. import counts, inputs
from ..reference import diffusion as rdiff
from ..reference import dinov2 as rdino
from ..reference import dit as rdit
from ..reference import judge, ops
from ..reference import vae as rvae

DTYPES = {"bf16": torch.bfloat16}
MODELS = ("encoder", "dit", "vae")


class Driver:
    def __init__(self, run, variant: str = "program"):
        self.run, self.variant = run, variant
        self.cfg, self.mix = run.config, run.traffic
        self.kept: list = []

    # -- the program -----------------------------------------------------

    def _build(self):
        from topiaxl_torch.diffusion import create_diffusion
        from topiaxl_torch.models.conditioner.image import DinoV2Wrapper
        from topiaxl_torch.models.dit import DiT
        from topiaxl_torch.models.vae3d import VAE3D

        c, dev = self.cfg, self.run.device
        dt = DTYPES[c["precision"]]
        enc = c["encoder"]
        self.encoder = DinoV2Wrapper(enc["model_name"], image_size=enc["image_size"],
                                     dtype=dt, device=dev).eval()
        self.dit = DiT(**c["generator"], dtype=dt, device=dev).eval()
        self.vae = VAE3D(**c["vae"], dtype=dt, device=dev).eval()
        if self.variant == "w8a8":
            self.float_dit = self.dit
            self.dit = DiT(**c["generator"], dtype=dt, quant=True,
                           device=dev).eval()
        d = c["diffusion"]
        self.diffusion = create_diffusion(
            timestep_respacing=f"ddim{c['inference']['ddim']}",
            noise_schedule=d["noise_schedule"],
            parameterization=d["parameterization"],
            diffusion_steps=d["diffusion_steps"], device=dev)
        float_dit = getattr(self, "float_dit", self.dit)
        self.templates = {
            name: {k: v.to("meta") for k, v in m.state_dict().items()}
            for name, m in zip(MODELS, (self.encoder, float_dit, self.vae))}

    def weights(self, seed: int) -> dict:
        """The seed's weights of each model, as the program holds them."""
        return {name: inputs.seeded_weights(
                    self.templates[name], seed * len(MODELS) + i,
                    self.run.device)
                for i, name in enumerate(MODELS)}

    @torch.no_grad()
    def load(self, seed: int) -> None:
        """Load the weights of ``seed`` in place (a captured chain graph
        reads them where they are) and start a new sample."""
        w = self.weights(seed)
        self.encoder.load_state_dict(w["encoder"])
        self.vae.load_state_dict(w["vae"])
        if self.variant == "w8a8":
            from topiaxl_torch.models.dit import quantize_dit_state_dict

            self.float_dit.load_state_dict(w["dit"])
            self.dit.load_state_dict(quantize_dit_state_dict(
                self.dit, w["dit"]))
        else:
            self.dit.load_state_dict(w["dit"])
        self.seed, self.kept = seed, []
        self.sampler = random.Random(inputs.stream_seed(seed, "sample"))
        size = self.cfg["encoder"]["image_size"]
        self.images = [inputs.object_image(seed, k, size)
                       for k in range(int(self.mix["image_pool"]))]

    def setup(self) -> None:
        from topiaxl_torch.pipelines import infer as P

        self.P = P
        self._build()
        c, g = self.cfg, self.cfg["generator"]
        self.mean = np.asarray(c["latent_stats"]["mean"], np.float32)
        self.std = np.asarray(c["latent_stats"]["std"], np.float32)
        self.load(self.run.seed)
        n, m = g["seq_length"], c["cond_tokens"]
        e = c["encoder"]
        steps = int(c["inference"]["ddim"])
        tokens = 1 + e["registers"] + (e["image_size"] // e["patch"]) ** 2
        self.run.work = {
            "flops": steps * counts.cfg_step_flops(
                g["depth"], g["hidden_size"], g["num_heads"], n, m,
                in_channels=g["in_channels"]),
            "attn_fwd": [
                ((2, n, n, g["num_heads"], g["hidden_size"] // g["num_heads"]),
                 steps * g["depth"]),
                ((1, n, m, g["num_heads"], g["hidden_size"] // g["num_heads"]),
                 steps * g["depth"]),
                ((1, tokens, tokens, e["heads"], e["width"] // e["heads"]),
                 e["depth"])],
        }
        # the chain graph's capture, then one request as the window runs it
        for i in (-2, -1):
            self.request(i)
        self.kept = []

    def noise(self, i: int) -> torch.Tensor:
        g = self.cfg["generator"]
        gen = torch.Generator(self.run.device).manual_seed(
            inputs.stream_seed(self.seed, "noise", i % 2 ** 20))
        return torch.randn((1, g["seq_length"], g["in_channels"]),
                           generator=gen, device=self.run.device)

    def request(self, i: int) -> int:
        run = self.run
        image = torch.from_numpy(self.images[i % len(self.images)]).to(
            run.device)[None]
        with run.span("encode"), torch.inference_mode():
            y = self.encoder(image)
        with run.span("stage1"):
            p = self.P.generate_primx(
                self.dit, self.vae, self.diffusion, y, self.mean, self.std,
                cfg_scale=float(self.cfg["inference"]["cfg"]),
                noise=self.noise(i))
        if i >= 0:
            self._keep(i, y, p)
        return 1

    def _keep(self, i: int, y, p) -> None:
        """A uniform sample of ``check_requests`` of the window's requests
        (reservoir sampling, from the seed)."""
        k = int(self.mix["check_requests"])
        item = (i, y.clone(), p.srt.clone(), p.feat.clone())
        if len(self.kept) < k:
            self.kept.append(item)
        else:
            j = self.sampler.randrange(i + 1)
            if j < k:
                self.kept[j] = item

    def finish(self) -> None:
        from topiaxl_torch.pipelines import chain_graph

        chain_graph.forget()
        self.encoder = self.dit = self.vae = self.float_dit = None
        if self.run.device.type == "cuda":
            torch.cuda.empty_cache()

    # -- the check -------------------------------------------------------

    @torch.no_grad()
    def reference(self, W: dict, i: int):
        """(tokens [1, M, C], srt, feat) of request ``i`` by the reference."""
        c, e = self.cfg, self.cfg["encoder"]
        heads = c["generator"]["num_heads"]
        image = torch.from_numpy(self.images[i % len(self.images)]).to(
            self.run.device)[None]
        y = rdino.encode(W["encoder"], image, size=e["image_size"],
                         heads=e["heads"], registers=e["registers"],
                         patch=e["patch"])
        cfg = float(c["inference"]["cfg"])
        tok = rdiff.ddim_chain(
            lambda x, t: rdit.cfg_forward(W["dit"], x, t, y, heads, cfg),
            self.noise(i), count=int(c["inference"]["ddim"]),
            steps=c["diffusion"]["diffusion_steps"])
        srt, feat = rvae.primx(W["vae"], tok[0], self.mean, self.std)
        return y, srt, feat

    def readings(self, precision: str | None = None) -> dict:
        """The gaps between the kept requests and the reference; with
        ``precision`` ("fp8"), between the reference in that precision,
        put in the program's place, and the reference."""
        ops.no_tf32()
        W = {name: {k: v.float() for k, v in w.items()}
             for name, w in self.weights(self.seed).items()}
        out = {k: 0.0 for k in ("enc_gap", "srt_gap", "feat_gap",
                                "srt_row_gap", "feat_row_gap")}
        pairs: dict = {"srt": [], "feat": []}
        for i, *got in self.kept:
            ref = self.reference(W, i)
            if precision is not None:
                with ops.precision(precision):
                    got = self.reference(W, i)
            for k, g, r in zip(("enc", "srt", "feat"), got, ref):
                out[k + "_gap"] = max(out[k + "_gap"], judge.rel_rms(g, r))
                if k in pairs:
                    out[k + "_row_gap"] = max(out[k + "_row_gap"],
                                              judge.row_gap(g, r))
                    pairs[k].append((g, r))
        for k, pr in pairs.items():
            out[k + "_mean_gap"] = judge.mean_gap([g for g, _ in pr],
                                                  [r for _, r in pr])
        return out

    def check(self) -> dict:
        r = self.readings()
        lim = self.run.cell["limits"]
        print(f"portbench: not compared, over {len(self.kept)} requests: "
              + ", ".join(f"{k} {v!r}" for k, v in r.items() if k not in lim),
              file=sys.stderr)
        return {k: (r[k], float(v)) for k, v in lim.items()}
