"""Where one image's time goes on a CUDA card, stage by stage.

    python -m topiaxl_torch.cli.profile configs/inference_dit.yml [k=v ...]

Builds the models the config names as ``topiaxl_torch.cli.infer`` does
(``build_models``; random weights unless the config names checkpoints)
and measures, on synthetic inputs (``pipelines/synthetic.py``):

- ``prepare``: host matting and recentring of a 512² image (wall);
- ``encode``: DINOv2 on that image;
- ``precompute``: the DiT's per-block cross K/V and null outputs;
- ``cfg_step``: one CFG'd DiT step (``forward_with_cfg_fast``);
- ``chain``: the whole DDIM chain (``sample_tokens``);
- ``vae_decode``: ``decode_primx`` of 2048 primitives;
- ``recon``: the CLI's ``recon.jpg`` pair (the frontal render of the
  2048-prim sphere shell and of its coloured prim boxes, 128 steps, 8
  hits) at the config's ``image_height`` x ``image_width``;
- ``stage2``: ``extract_glb`` on the 2048-prim sphere shell at the config's
  ``mc_resolution`` and ``decimate`` (texture 1024, ``pos_scale`` 1.0),
  with the box and the LSCM unwrap in turn, twice each, so that the
  second pair shows the warm times;
- ``train_step``: one training step of ``topiaxl_torch.cli.train`` (the
  config's ``model.generator`` with f32 master weights, a synthetic batch
  of ``train.batch_size``: forward, backward, fused AdamW + EMA).

For each device region: wall ms per call (perf_counter around
synchronised calls, no profiler attached), device ms per call (the sum
of kernel self times under ``torch.profiler``), the idle share
1 - device / wall, and the kernels that take the most device time. The
last line is one JSON object with every number printed.

With ``model.generator.quant=true`` the DiT regions run W8A8; while the
profiler traces, the three parts of each W8A8 layer run inside ranges
``int8.quantize_activations``, ``int8.int_mm`` and ``int8.rescale``,
whose device ms per call each region reports (``ranges_ms``). The
trainer refuses ``quant``, so ``train_step`` is then skipped.
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
import tempfile
import time

import torch

# kernel-name substrings -> the layer they belong to
_GROUPS = {"flash_attn_fwd": ("flash_fwd_kernel",),
           "flash_attn_bwd": ("flash_bwd_",),
           "ln_modulate": ("ln_modulate_kernel",),
           "optimizer": ("foreach", "multi_tensor"),
           "gemm": ("gemm", "cutlass", "nvjet", "xmma", "cublas"),
           "conv": ("conv", "cudnn", "implicit"),
           "norm": ("norm",),
           "sort": ("sort", "topk")}


def _group(name: str) -> str:
    low = name.lower()
    for group, keys in _GROUPS.items():
        if any(k in low for k in keys):
            return group
    return "other"


@contextlib.contextmanager
def _int8_ranges():
    """Runs the W8A8 layers' activation quant, int8 product and rescale
    (``ops/int8.py``) inside profiler ranges named after them."""
    from torch.profiler import record_function

    from ..ops import int8

    names = ("quantize_activations", "int_mm", "rescale")
    saved = {n: getattr(int8, n) for n in names}

    def ranged(name, fn):
        def call(*args):
            with record_function(f"int8.{name}"):
                return fn(*args)
        return call

    for n, fn in saved.items():
        setattr(int8, n, ranged(n, fn))
    try:
        yield
    finally:
        for n, fn in saved.items():
            setattr(int8, n, fn)


def profile_region(name: str, fn, repeats: int, top: int = 8) -> dict:
    """Time ``fn`` on the card: wall without the profiler, device time
    with it. Prints a summary and returns it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()                                    # warm-up: allocator, kernel build
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(repeats):
        fn()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / repeats

    with _int8_ranges(), profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(repeats):
            fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    # the ranges also appear on the device timeline, spanning their kernels
    # and the gaps between them: kernels only, and each range's own kernels
    kernels = [e for e in events
               if e.device_type != DeviceType.CPU and e.self_device_time_total > 0
               and not e.key.startswith("int8.")]
    ranges = {e.key: e.device_time_total / 1e3 / repeats for e in events
              if e.device_type == DeviceType.CPU and e.key.startswith("int8.")}
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / repeats
    groups: dict = {}
    for e in kernels:
        g = _group(e.key)
        groups[g] = groups.get(g, 0.0) + e.self_device_time_total / 1e3 / repeats
    out = {"wall_ms": wall_ms, "device_ms": device_ms,
           "idle_share": 1.0 - device_ms / wall_ms if device_ms else None,
           "groups_ms": groups, "ranges_ms": ranges, "repeats": repeats}
    idle = ("not measured (the profiler saw no device time)" if not device_ms
            else f"{out['idle_share']:.3f}")
    print(f"[{name}] wall {wall_ms:.3f} ms, device {device_ms:.3f} ms, idle "
          f"share {idle}, over {repeats} calls", flush=True)
    print("  by layer (device ms per call): " + ", ".join(
        f"{g} {ms:.3f}" for g, ms in sorted(groups.items(), key=lambda x: -x[1])))
    if ranges:
        print("  W8A8 ranges (device ms per call): " + ", ".join(
            f"{k} {ms:.3f}" for k, ms in sorted(ranges.items())))
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:top]:
        ms = e.self_device_time_total / 1e3 / repeats
        print(f"  {ms:8.3f} ms  x{e.count // repeats:<4d} {e.key[:100]}")
    return out


def profile_train_step(cfg, device) -> dict:
    """One step of the trainer on one synthetic batch, repeated."""
    from ..diffusion.schedule import create_diffusion
    from ..pipelines.data import synthetic_batches
    from ..pipelines.train import (
        create_train_state, make_optimizer, make_train_step)
    from .train import build_dit

    g = cfg.model.generator
    dit = build_dit(g, device, torch.Generator(device=device).manual_seed(0))
    diffusion = create_diffusion(
        timestep_respacing=None, noise_schedule=cfg.diffusion.noise_schedule,
        diffusion_steps=cfg.diffusion.diffusion_steps,
        parameterization=cfg.diffusion.parameterization, device=device)
    state = create_train_state(dit)
    step = make_train_step(dit, diffusion, make_optimizer(
        lr=float(cfg.optimizer.lr), warmup_iters=int(cfg.scheduler.warmup_iters),
        max_iters=int(cfg.scheduler.max_iters)))
    batch = next(synthetic_batches(
        int(cfg.train.batch_size), dit.seq_length, dit.in_channels,
        cond_seq=int(cfg.train.get("cond_seq", 1370)),
        cond_ch=dit.condition_channels))
    batch = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
    torch.cuda.reset_peak_memory_stats(device)
    out = profile_region("train_step", lambda: step(state, batch, 0), 3)
    out["peak_gib"] = torch.cuda.max_memory_allocated(device) / 2 ** 30
    print(f"  peak device memory {out['peak_gib']:.2f} GiB "
          f"(torch.cuda.max_memory_allocated)")
    return out


def main(argv=None) -> int:
    from topiaxl_torch.core.config import load_config

    from ..diffusion.schedule import create_diffusion
    from ..ops import _cuda
    from ..pipelines import infer as P
    from ..pipelines.synthetic import sphere_asset, write_bench_image
    from ..render import colored_box_payload, frontal_camera, render_primx
    from .infer import build_models, prepare_image

    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv:
        print(__doc__)
        return 1
    cfg = load_config(argv[0], overrides=argv[1:])
    device = torch.device(cfg.inference.get("device", "cuda"))
    if device.type != "cuda" or not torch.cuda.is_available():
        raise SystemExit("profile: needs a CUDA card (inference.device=cuda)")
    gen = torch.Generator(device=device).manual_seed(int(cfg.inference.seed))
    dit, vae, conditioner = build_models(cfg, device, gen)
    diffusion = create_diffusion(
        timestep_respacing=(f"ddim{cfg.inference.ddim}"
                            if cfg.inference.ddim > 0 else None),
        noise_schedule=cfg.diffusion.noise_schedule,
        diffusion_steps=cfg.diffusion.diffusion_steps,
        parameterization=cfg.diffusion.parameterization, device=device)
    cfg_scale = float(cfg.inference.get("cfg", 0.0))
    report: dict = {}

    with tempfile.TemporaryDirectory() as tmp, torch.inference_mode():
        png = os.path.join(tmp, "asset.png")
        write_bench_image(png)
        t0 = time.perf_counter()
        for _ in range(3):
            image = prepare_image(png)
        report["prepare"] = {"wall_ms": (time.perf_counter() - t0) * 1e3 / 3}
        print(f"[prepare] wall {report['prepare']['wall_ms']:.3f} ms (host)")
        img = torch.from_numpy(image[None]).to(device)
        report["encode"] = profile_region(
            "encode", lambda: conditioner.encode_image(img), 5)

        y = conditioner.encode_image(img)
        kvs = dit.precompute_kv(y)
        null_outs = dit.precompute_null_out()
        report["precompute"] = profile_region(
            "precompute", lambda: (dit.precompute_kv(y),
                                   dit.precompute_null_out()), 5)
        x = torch.randn((1, dit.seq_length, dit.in_channels), device=device,
                        generator=gen)
        t = torch.full((1,), 500, device=device, dtype=torch.long)
        report["cfg_step"] = profile_region(
            "cfg_step", lambda: dit.forward_with_cfg_fast(
                x, t, kvs, null_outs, cfg_scale), 5)
        report["chain"] = profile_region(
            "chain", lambda: P.sample_tokens(dit, diffusion, y, cfg_scale,
                                             generator=gen), 1, top=4)
        tokens = torch.randn((1, dit.seq_length, dit.in_channels),
                             device=device, generator=gen)
        report["vae_decode"] = profile_region(
            "vae_decode", lambda: P.decode_primx(
                vae, tokens, cfg.model.prim_shape, cfg.model.dim_feat), 3)

        sphere = sphere_asset(device, S=cfg.model.prim_shape)
        cam = frontal_camera(cfg.image_height, cfg.image_width, device=device)
        boxes = colored_box_payload(sphere.srt.shape[0], cfg.model.prim_shape,
                                    device=device)
        report["recon"] = profile_region("recon", lambda: [
            render_primx(sphere.srt, sphere.feat, cam, cfg.model.prim_shape,
                         num_steps=128, max_hits=8, payload=payload)
            for payload in (None, boxes)], 3, top=12)

        runs = []
        for fast_unwrap in (True, False, True, False):
            tm: dict = {}
            t0 = time.perf_counter()
            P.extract_glb(sphere, os.path.join(tmp, "sphere"),
                          mc_resolution=cfg.inference.mc_resolution,
                          decimate=cfg.inference.decimate, texture_size=1024,
                          batch_size=32768, pos_scale=1.0,
                          fast_unwrap=fast_unwrap, timings_out=tm)
            tm = dict(fast_unwrap=fast_unwrap,
                      seconds=time.perf_counter() - t0, **tm)
            print(f"[stage2] {json.dumps(tm)}", flush=True)
            runs.append(tm)
        report["stage2"] = runs
    del dit, vae, conditioner
    if cfg.model.generator.get("quant", False):
        print("[train_step] skipped: the trainer refuses model.generator.quant")
    else:
        report["train_step"] = profile_train_step(cfg, device)
    report["launches"] = dict(_cuda.launches)
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
