"""The demo app's staged pipeline (counterpart of ``topiaxl/app.py``).

The reference's Gradio demo runs three stages with state kept between
them: (1) matting and recentring of the input photo, (2) DiT sampling to
a PrimX with a reconstruction preview, (3) GLB export with quality knobs
(marching-cubes resolution, decimation, remesh, fast or LSCM unwrap).
``App`` runs those stages with the models built once (the reference
rebuilds them per session); stage outputs persist on the instance, so
``export`` re-runs with other knobs without sampling again; on a card
every ``generate`` with the same steps, CFG scale and sampler replays the
chain's CUDA graph, captured at the first (``pipelines/chain_graph.py``).
``launch_ui`` wraps the same object in a Gradio UI when ``gradio`` is
installed, and otherwise prints how to run headless: ``python -m
topiaxl_torch.app image.png [config.yml] [k=v ...]`` runs all three
stages (on ``cuda`` unless ``inference.device`` says otherwise) and
prints the GLB's path.
"""

from __future__ import annotations

import os
import sys

import torch


class App:
    """Staged image -> PrimX -> GLB pipeline over the port's models, built
    once from the config (``cli/infer.py:build_models``)."""

    def __init__(self, config_path: str = "configs/inference_dit.yml",
                 overrides=(), workdir: str = "runs/app"):
        from .cli.infer import build_models
        from .core.config import load_config
        from .models.latent_stats import resolve_latent_stats

        self.cfg = load_config(config_path, overrides=list(overrides))
        self.workdir = workdir
        os.makedirs(workdir, exist_ok=True)
        self.device = torch.device(self.cfg.inference.get("device", "cuda"))
        gen = torch.Generator(device=self.device).manual_seed(
            int(self.cfg.get("global_seed", 0)))
        self.dit, self.vae, self.conditioner = build_models(
            self.cfg, self.device, gen)
        self.latent_nf = float(self.cfg.model.get("latent_nf", 1.0))
        self.latent_mean, self.latent_std = resolve_latent_stats(
            self.cfg.model)
        self._matter = None
        self.prepared = None   # stage 1: the input image [H, W, 3], 0..255
        self.primx = None      # stage 2: PrimXParams

    # -- stage 1: preprocess -------------------------------------------------

    def preprocess(self, image_path: str, remove_bg: bool = True,
                   foreground_ratio: float = 0.85):
        """Matte and recentre the image: U^2-Net where
        ``inference.u2net_checkpoint`` names its weights, else GrabCut."""
        from .cli.infer import prepare_image
        from .ops.matting import load_u2net

        if self._matter is None:
            self._matter = load_u2net(
                self.cfg.inference.get("u2net_checkpoint", ""),
                device=self.device)
        self.prepared = prepare_image(
            image_path, foreground_ratio,
            matting="auto" if remove_bg else "threshold",
            matter=self._matter)
        return self.prepared

    # -- stage 2: generate ---------------------------------------------------

    def generate(self, steps: int = 25, cfg_scale: float = 6.0,
                 seed: int = 42, sampler: str = "ddim"):
        """Denoise to a PrimX (saved as ``denoised.npz``); ``sampler='dpm'``
        runs DPM-Solver++(2M) (about half the steps)."""
        from .diffusion.schedule import create_diffusion
        from .pipelines import infer as P

        if self.prepared is None:
            raise RuntimeError("call preprocess(image) first")
        diffusion = create_diffusion(
            timestep_respacing=f"ddim{int(steps)}",
            noise_schedule=self.cfg.diffusion.noise_schedule,
            parameterization=self.cfg.diffusion.parameterization,
            diffusion_steps=int(self.cfg.diffusion.diffusion_steps),
            device=self.device)
        with torch.inference_mode():
            y = self.conditioner.encode_image(
                torch.from_numpy(self.prepared[None]).to(self.device))
        self.primx = P.generate_primx(
            self.dit, self.vae, diffusion, y, self.latent_mean,
            self.latent_std, self.latent_nf, cfg_scale=float(cfg_scale),
            prim_shape=int(self.cfg.model.prim_shape),
            dim_feat=int(self.cfg.model.dim_feat),
            generator=torch.Generator(device=self.device).manual_seed(
                int(seed)), sampler=sampler)
        P.save_primx(os.path.join(self.workdir, "denoised.npz"), self.primx)
        return self.primx

    def preview(self, path: str | None = None) -> str:
        """The frontal rgb | prim-box snapshot of the current PrimX at the
        config's image size (the CLI's ``recon.jpg``)."""
        from .render.visualize import visualize_primvolume

        if self.primx is None:
            raise RuntimeError("call generate() first")
        path = path or os.path.join(self.workdir, "preview.jpg")
        visualize_primvolume(path, self.primx, int(self.cfg.image_height),
                             int(self.cfg.image_width),
                             int(self.cfg.model.prim_shape))
        return path

    # -- stage 3: export -----------------------------------------------------

    def export(self, mc_resolution: int = 256, decimate: int = 100000,
               texture_size: int = 1024, fast_unwrap: bool = True,
               remesh: bool = False, ssaa: int = 1) -> str:
        """PrimX -> ``pbr_mesh.glb`` in the work directory; returns its
        path."""
        from .pipelines import infer as P

        if self.primx is None:
            raise RuntimeError("call generate() first")
        return P.extract_glb(
            self.primx, self.workdir, mc_resolution=int(mc_resolution),
            decimate=int(decimate), texture_size=int(texture_size),
            batch_size=int(self.cfg.inference.get("batch_size", 32768)),
            prim_shape=int(self.cfg.model.prim_shape),
            dim_feat=int(self.cfg.model.dim_feat),
            fast_unwrap=bool(fast_unwrap), remesh=bool(remesh),
            ssaa=int(ssaa))

    def run(self, image_path: str, **kw) -> str:
        """All three stages; defaults from the config's inference block
        (the CLI's knobs), overridable per call."""
        inf = self.cfg.inference
        self.preprocess(image_path, remove_bg=kw.pop("remove_bg", True))
        self.generate(
            steps=kw.pop("steps", int(inf.get("ddim", 25)) or 25),
            cfg_scale=kw.pop("cfg_scale", float(inf.get("cfg", 6.0))),
            seed=kw.pop("seed", int(inf.get("seed", 42))),
            sampler=kw.pop("sampler", inf.get("sampler", "ddim")))
        kw.setdefault("mc_resolution", int(inf.get("mc_resolution", 256)))
        kw.setdefault("decimate", int(inf.get("decimate", 100000)))
        kw.setdefault("fast_unwrap", bool(inf.get("fast_unwrap", True)))
        kw.setdefault("remesh", bool(inf.get("remesh", False)))
        return self.export(**kw)


def launch_ui(config_path: str = "configs/inference_dit.yml", overrides=()):
    """A Gradio Blocks UI with the reference's knobs (its app.py:144-267)
    where ``gradio`` is installed; otherwise the headless usage, printed."""
    try:
        import gradio as gr
    except ImportError:
        print("gradio is not installed; falling back to headless mode.\n"
              "usage: python -m topiaxl_torch.app <image> [config.yml] "
              "[k=v ...]")
        return None

    app = App(config_path, overrides)
    with gr.Blocks(title="topiaxl_torch: 3DTopia-XL") as demo:
        gr.Markdown("# topiaxl_torch: single image to PBR 3D asset")
        with gr.Row():
            with gr.Column():
                inp = gr.Image(label="input image", type="filepath")
                remove_bg = gr.Checkbox(True, label="remove background")
                prep_view = gr.Image(label="preprocessed", interactive=False)
                prep_btn = gr.Button("1 — Preprocess")
            with gr.Column():
                steps = gr.Radio([25, 50, 100, 200], value=25,
                                 label="DDIM steps")
                cfg = gr.Slider(0, 10, value=6, step=0.5, label="CFG scale")
                seed = gr.Number(value=42, precision=0, label="seed")
                gen_btn = gr.Button("2 — Generate")
                preview = gr.Image(label="reconstruction preview",
                                   interactive=False)
            with gr.Column():
                mc = gr.Radio([128, 256], value=256, label="MC resolution")
                deci = gr.Number(value=100000, precision=0, label="max faces")
                unwrap = gr.Radio(["Faster", "Better"], value="Faster",
                                  label="UV unwrap")
                remesh = gr.Checkbox(False, label="isotropic remesh")
                exp_btn = gr.Button("3 — Export GLB")
                viewer = gr.Model3D(label="generated GLB")

        def _prep(image, rm):
            return app.preprocess(image, remove_bg=bool(rm)).astype("uint8")

        def _gen(s, c, sd):
            app.generate(int(s), float(c), int(sd))
            return app.preview()

        def _exp(m, d, uw, rm):
            return app.export(mc_resolution=int(m), decimate=int(d),
                              fast_unwrap=(uw == "Faster"), remesh=bool(rm))

        prep_btn.click(_prep, [inp, remove_bg], prep_view)
        gen_btn.click(_gen, [steps, cfg, seed], preview)
        exp_btn.click(_exp, [mc, deci, unwrap, remesh], viewer)
    demo.launch()
    return demo


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv:
        app = App(argv[1] if len(argv) > 1 else "configs/inference_dit.yml",
                  overrides=argv[2:])
        print(app.run(argv[0]))
        return 0
    launch_ui()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
