"""The port's benchmark on one CUDA card: ``python -m topiaxl_torch.bench``.

The counterpart of the JAX package's ``bench.py``, with the same keys,
run through the port's own entry points at the flagship config
(``configs/inference_dit.yml``: DiT 28 x 1152 with 16 heads of 72, 2048
prim tokens of 68 channels, DINOv2 ViT-B/14-reg at 518², DDIM 25, CFG 6)
on random weights from fixed seeds. After each section it prints the
metrics so far as one JSON line on stdout; the last complete line
carries every metric. Sections, in ``bench.py``'s order:

- ``dit_denoise_steps_per_sec`` (``value``, ``unit``, ``vs_baseline``,
  ``mfu``): the DDIM chain of ``pipelines/infer.py:sample_tokens`` on
  cross K/V and null outputs projected once before the timed chains, as
  ``bench.py`` projects them outside its timed scan; on a card the chain
  is one CUDA graph, as ``sample_tokens`` runs it there; four chains
  timed after a warm one (the capture). ``mfu`` is steps/s x
  ``cfg_step_flops`` (the products the CFG step runs: the null branch's
  cross-attention is not run, so it is not counted) over the card's dense
  bf16 peak (``PEAK_BF16_TFLOPS``, keyed on ``torch.cuda.get_device_name``;
  an unknown card raises).
- ``image_to_glb_seconds`` and its rows: U²-Net matting of a PNG on disk
  (``cli/infer.py:prepare_image``), DINOv2, ``generate_primx``, and
  ``extract_glb`` on the 2048-prim sphere (mc 256, decimate 100k, texture
  1024): one cold run, then the median of three warm runs (one with
  ``--fast``).
- the fidelity of the extraction chain on ``pipelines/synthetic.py:
  textured_sphere`` (``bench_fidelity``: albedo PSNR against the field,
  the vertices' distance to the sphere, UV stretch, coverage and charts
  of the box and LSCM unwraps).
- ``assets_per_min_pipelined``: ``bench.py``'s loop with the port's
  functions (matting, encode and the chain of each asset on this thread,
  ``extract_glb`` of the sphere on two worker threads), eight assets (four
  with ``--fast``). ``serve_assets`` takes encoded conditionings and
  extracts what it generates, so it would time neither the matting nor
  the sphere: the loop is written out here.
- the DPM gate: one noise through ``generate_primx`` with DDIM 25,
  DPM-Solver++ 12 and DDIM 200, the decoded payloads compared.
- ``flash_parity_on_card``: the flash forward and backward kernels
  against the plain version at ``benchmarks/check_flash_tpu.py``'s shapes
  (a head dim of 36 among them, zero-padded to 64 by the launchers).
- ``dit_denoise_steps_per_sec_int8``: the chain with the DiT's block
  matmuls W8A8 (``model.generator.quant``).
- ``train_steps_per_sec`` (batch 2, ``remat=True``, ``scan_blocks``) and
  ``train_steps_per_sec_bs8`` (batch 8, remat ``dots``, ``grad_accum``
  4): five steps of ``pipelines/train.py:make_train_step`` after one.

Times are wall seconds between two synchronisations of the card
(``core/profiling.py:timeit``); "warm" is after one cold run in the
process. A section that raises records ``<section>_error`` and the later
sections still run; the process then exits 1. Without a CUDA card (and
without ``--device cpu``) it exits 2 at once.

Left out of ``bench.py``'s keys, each on purpose: ``image_to_glb_vs_target``
(its 30 s target was set for a TPU v5e), ``albedo_psnr_vs_reference_db``
(it scores against the reference implementation, which is not in the
repository), ``slow_suite*`` (the record of the JAX package's slow test
tier) and the write of ``runs_meta/bench_latest.json`` (the JAX record
that the JAX package's documents are linted against).

``--device cpu`` and ``--tiny`` (a few narrow blocks, small images and
grids) exist for the CPU tests; ``--fast`` shortens the repeats and keeps
every section.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

BASELINE_STEPS_PER_SEC = 13.0   # the A100 estimate of BASELINE.md
# dense bf16 tensor-core peak by card name (data sheets: half the sparse
# figure)
PEAK_BF16_TFLOPS = {
    "NVIDIA H100 80GB HBM3": 989.4,   # H100 SXM5
    "NVIDIA H100 NVL": 835.5,
    "NVIDIA H100 PCIe": 756.5,
}
# benchmarks/check_flash_tpu.py:SHAPES, (B, Sq, Sk, H, D)
FLASH_SHAPES = [(2, 2048, 2048, 16, 72), (2, 2048, 1370, 16, 72),
                (1, 777, 333, 4, 72), (1, 640, 640, 2, 36)]
FLASH_BAR = 0.05                # check_flash_tpu.py's bar, fwd and grads

SIZES = {
    "flagship": dict(
        dit=dict(seq_length=2048, in_channels=68, condition_channels=768,
                 hidden_size=1152, depth=28, num_heads=16),
        vae=dict(), vae_dtype=torch.bfloat16,
        encoder="dinov2_vitb14_reg", image_size=518, u2net=("u2net", 320),
        sphere_prims=2048, cond_tokens=1370, chains=4,
        extract=dict(mc_resolution=256, decimate=100000, texture_size=1024,
                     batch_size=32768, pos_scale=1.0),
        fidelity=dict(mc_resolution=128, decimate=60000, texture_size=512),
        flash_shapes=FLASH_SHAPES, train_steps=5),
    "tiny": dict(
        dit=dict(seq_length=64, in_channels=68, condition_channels=32,
                 hidden_size=64, depth=2, num_heads=4),
        vae=dict(down_channels=(8, 16), up_channels=(16, 8),
                 layers_per_block=1), vae_dtype=torch.float32,
        encoder="dinov2_tiny_test", image_size=28, u2net=("u2netp", 64),
        sphere_prims=512, cond_tokens=16, chains=1,
        extract=dict(mc_resolution=32, decimate=3000, texture_size=128,
                     batch_size=4096, pos_scale=1.0),
        fidelity=dict(mc_resolution=32, decimate=3000, texture_size=128),
        flash_shapes=[(1, 40, 33, 2, 72), (1, 24, 20, 2, 36)],
        train_steps=1),
}


def cfg_step_flops(depth: int, hidden: int, heads: int, n: int, m: int,
                   cfg_fast: bool = True, batch: int = 1,
                   in_channels: int = 68, out_channels: int = 136,
                   mlp_ratio: float = 4.0, freq_dim: int = 256) -> float:
    """FLOPs (2 per multiply-add) of the products one CFG'd DiT step runs
    for ``batch`` assets: both halves (cond, uncond) through the token
    embedding, the timestep MLP, every block's adaLN, fused qkv,
    self-attention, proj and MLP, and the final layer; the cross-attention
    (q, attend over ``m`` keys, proj) on the cond half only where
    ``cfg_fast`` (``forward_with_cfg_fast`` takes the uncond half's from
    the precomputed null output), on both halves otherwise
    (``forward_with_cfg_kv``). ``heads`` splits the width and changes no
    count. At the flagship shapes: 192.9 GFLOP a block, 5.40 TFLOP a
    step."""
    del heads
    d, b2 = hidden, 2 * batch
    bc = batch if cfg_fast else b2
    block = (2 * b2 * d * 9 * d                      # adaLN
             + 2 * b2 * n * d * 3 * d                # qkv
             + 4 * b2 * n * n * d                    # self-attention
             + 2 * b2 * n * d * d                    # proj
             + 2 * 2 * b2 * n * d * int(mlp_ratio * d)   # MLP
             + 2 * bc * n * d * d                    # cross q
             + 4 * bc * n * m * d                    # cross-attend
             + 2 * bc * n * d * d)                   # cross proj
    embed = (2 * b2 * n * in_channels * d               # token embedding
             + 2 * b2 * (freq_dim * d + d * d))         # timestep MLP
    final = 2 * b2 * d * 2 * d + 2 * b2 * n * d * out_channels
    return float(depth * block + embed + final)


def peak_bf16_flops(name: str) -> float:
    """The card's dense bf16 peak in FLOP/s; raises for a card not in
    ``PEAK_BF16_TFLOPS``."""
    if name not in PEAK_BF16_TFLOPS:
        raise ValueError(f"no bf16 peak known for {name!r}: add it to "
                         f"PEAK_BF16_TFLOPS")
    return PEAK_BF16_TFLOPS[name] * 1e12


def tex_psnr(a: np.ndarray, b: np.ndarray) -> float:
    """Albedo PSNR (dB) of two decoded payloads [N, 6, S³], albedo clipped
    to [0, 1] as the bake clips it (``bench.py:bench_dpm_gate``)."""
    ta = np.clip(a[:, 1:4], 0.0, 1.0)
    tb = np.clip(b[:, 1:4], 0.0, 1.0)
    mse = float(np.mean((ta - tb) ** 2))
    return 10.0 * np.log10(1.0 / max(mse, 1e-12))


def sdf_p99(a: np.ndarray, b: np.ndarray) -> float:
    """99th percentile of the SDF channel's absolute difference."""
    return float(np.percentile(np.abs(a[:, 0] - b[:, 0]), 99))


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def random_u2net(arch: str, seed: int, device) -> torch.nn.Module:
    """A U²-Net whose parameters are N(0, 0.1) and BatchNorm variances in
    [0.5, 1.5], from a numpy seed, in eval mode (its cost does not depend
    on the weights)."""
    from .models.matting_u2net import U2Net

    model = U2Net(arch)
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for name, t in model.state_dict().items():
            if name.endswith("num_batches_tracked"):
                continue
            r = rng.standard_normal(tuple(t.shape)).astype(np.float32) * 0.1
            if name.endswith("running_var"):
                r = rng.uniform(0.5, 1.5, t.shape).astype(np.float32)
            t.copy_(torch.from_numpy(r))
    return model.to(device).eval()


def build_dit(size: dict, device, seed: int = 0, **kw):
    from .models.dit import DiT

    return DiT(**size["dit"], cond_drop_prob=0.1, attn_proj_bias=True,
               device=device, generator=torch.Generator(device).manual_seed(
                   seed), **kw).eval()


def ddim_chain(dit, y: torch.Tensor, noise: torch.Tensor, steps: int = 25,
               cfg_scale: float = 6.0):
    """A callable running the DDIM chain of ``sample_tokens`` (eta 0, CFG
    through ``forward_with_cfg_fast``) from ``noise`` on K/V and null
    outputs projected here once, as a served asset has them and as
    ``bench.py`` times its scan. On a card the chain is one CUDA graph
    (``pipelines/chain_graph.py:CapturedGraph``, as ``sample_tokens``
    captures its own): the first call captures, later calls replay."""
    from .diffusion import create_diffusion, gaussian
    from .pipelines.chain_graph import CapturedGraph

    diffusion = create_diffusion(
        timestep_respacing=f"ddim{steps}", noise_schedule="squaredcos_cap_v2",
        parameterization="v", diffusion_steps=1000, device=y.device)
    with torch.inference_mode():
        kvs = dit.precompute_kv(y)
        null_outs = dit.precompute_null_out()

    def model_fn(x, t):
        return dit.forward_with_cfg_fast(x, t, kvs, null_outs, cfg_scale)

    @torch.inference_mode()
    def chain():
        return gaussian.SAMPLERS["ddim"](diffusion, model_fn, noise.float())

    return CapturedGraph(chain, y.device) if y.is_cuda else chain


def bench_dit_steps(size: dict, dev: torch.device, quant: bool = False):
    """(steps/s, FLOPs a step) of the flagship DDIM chain, bf16 or W8A8."""
    from .core.profiling import timeit
    from .models.dit import quantize_dit_state_dict

    dit = build_dit(size, dev)
    if quant:
        qdit = build_dit(size, dev, quant=True)
        qdit.load_state_dict(quantize_dit_state_dict(qdit, dit.state_dict()))
        dit = qdit
    g = torch.Generator(dev).manual_seed(1)
    x = torch.randn((1, dit.seq_length, dit.in_channels), generator=g,
                    device=dev)
    y = torch.randn((1, size["cond_tokens"], dit.condition_channels),
                    generator=g, device=dev)
    chain = ddim_chain(dit, y, x)
    t = timeit(chain, iters=size["chains"], warmup=1)
    d = size["dit"]
    flops = cfg_step_flops(d["depth"], d["hidden_size"], d["num_heads"],
                           d["seq_length"], size["cond_tokens"],
                           in_channels=d["in_channels"],
                           out_channels=dit.out_channels)
    return 25 / t["mean_s"], flops


def bench_e2e_seconds(size: dict, dev: torch.device, tmp: str,
                      warm_runs: int = 3):
    """Image -> GLB at the flagship operating point from a PNG on disk:
    (rows summing to ``total``, the context the later sections reuse)."""
    from .cli.infer import prepare_image
    from .diffusion import create_diffusion
    from .models.conditioner.image import DinoV2Wrapper
    from .models.latent_stats import get_latent_stats
    from .models.vae3d import VAE3D
    from .ops.matting import U2NetMatting
    from .pipelines import infer as P
    from .pipelines.synthetic import sphere_asset, write_bench_image

    dit = build_dit(size, dev)
    vae = VAE3D(**size["vae"], dtype=size["vae_dtype"], device=dev,
                generator=torch.Generator(dev).manual_seed(2)).eval()
    diffusion = create_diffusion(
        timestep_respacing="ddim25", noise_schedule="squaredcos_cap_v2",
        parameterization="v", diffusion_steps=1000, device=dev)
    mean, std = get_latent_stats("primx_v1")
    png = os.path.join(tmp, "bench_input.png")
    write_bench_image(png)
    arch, input_size = size["u2net"]
    matter = U2NetMatting(random_u2net(arch, 3, dev), input_size=input_size)
    encoder = DinoV2Wrapper(size["encoder"], image_size=size["image_size"],
                            device=dev,
                            generator=torch.Generator(dev).manual_seed(4))
    encoder = encoder.eval()
    asset = sphere_asset(dev, n=size["sphere_prims"])
    ex_kw = size["extract"]

    def encode(image):
        with torch.inference_mode():
            return encoder(torch.from_numpy(image[None]).to(dev))

    def one_asset(tag, seed=2):
        r = {}
        t0 = time.perf_counter()
        image = prepare_image(png, matting="u2net", matter=matter)
        r["matting_s"] = round(time.perf_counter() - t0, 3)
        t0 = time.perf_counter()
        y = encode(image)
        _sync(dev)
        r["encode_s"] = round(time.perf_counter() - t0, 3)
        t0 = time.perf_counter()
        P.generate_primx(dit, vae, diffusion, y, mean, std, cfg_scale=6.0,
                         generator=torch.Generator(dev).manual_seed(seed))
        _sync(dev)
        r["stage1_denoise_decode_s"] = round(time.perf_counter() - t0, 3)
        t0 = time.perf_counter()
        tm = {}
        P.extract_glb(asset, os.path.join(tmp, f"e2e_{tag}"),
                      timings_out=tm, **ex_kw)
        r["stage2_extract_s"] = round(time.perf_counter() - t0, 3)
        r["stage2_breakdown_s"] = tm
        r["total"] = round(r["matting_s"] + r["encode_s"]
                           + r["stage1_denoise_decode_s"]
                           + r["stage2_extract_s"], 2)
        return r

    one_asset("cold")
    runs = [one_asset(f"warm{i}", seed=2 + i) for i in range(warm_runs)]
    rows = dict(sorted(runs, key=lambda r: r["total"])[len(runs) // 2])
    rows["e2e_runs_s"] = [r["total"] for r in runs]
    host = ("isosurface", "clean_mesh", "decimate", "uv_unwrap", "rasterize",
            "inpaint", "write_glb")
    rows["e2e_runs_stages_s"] = [
        {"matting": r["matting_s"], "encode": r["encode_s"],
         "stage1": r["stage1_denoise_decode_s"],
         "stage2": r["stage2_extract_s"],
         "stage2_host": round(sum(v for k, v in r["stage2_breakdown_s"].items()
                                  if k in host), 3)}
        for r in runs]
    ctx = dict(prepare_image=prepare_image, png=png, matter=matter,
               encode=encode, P=P, dit=dit, vae=vae, mean=mean, std=std,
               diffusion=diffusion, asset=asset, ex_kw=ex_kw, tmp=tmp)
    return rows, ctx


def bench_pipelined_assets_per_min(ctx: dict, dev: torch.device,
                                   n: int = 8) -> float:
    """Assets a minute with two extraction workers: asset i's matting,
    encode and chain on this thread while the workers extract the assets
    before it (``bench.py:bench_pipelined_assets_per_min``)."""
    P = ctx["P"]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=2) as pool:
        futs = []
        for i in range(n):
            image = ctx["prepare_image"](ctx["png"], matting="u2net",
                                         matter=ctx["matter"])
            y = ctx["encode"](image)
            P.generate_primx(ctx["dit"], ctx["vae"], ctx["diffusion"], y,
                             ctx["mean"], ctx["std"], cfg_scale=6.0,
                             generator=torch.Generator(dev).manual_seed(50 + i))
            _sync(dev)
            futs.append(pool.submit(
                P.extract_glb, ctx["asset"],
                os.path.join(ctx["tmp"], f"pipe_{i}"), **ctx["ex_kw"]))
        for f in futs:
            f.result()
    return 60.0 * n / (time.perf_counter() - t0)


def bench_dpm_gate(ctx: dict, dev: torch.device) -> dict:
    """One conditioning and one noise through DDIM 25, DPM-Solver++ 12 and
    DDIM 200 (a near-converged solution of the same ODE); the decoded
    payloads compared (``bench.py:bench_dpm_gate``)."""
    from .diffusion import create_diffusion

    P = ctx["P"]
    image = ctx["prepare_image"](ctx["png"], matting="u2net",
                                 matter=ctx["matter"])
    y = ctx["encode"](image)

    def run(spacing, sampler):
        diff = create_diffusion(
            timestep_respacing=spacing, noise_schedule="squaredcos_cap_v2",
            parameterization="v", diffusion_steps=1000, device=dev)
        params = P.generate_primx(
            ctx["dit"], ctx["vae"], diff, y, ctx["mean"], ctx["std"],
            cfg_scale=6.0, generator=torch.Generator(dev).manual_seed(7),
            sampler=sampler)
        # channel-major payload [N, 6, S^3]: SDF, albedo, rough, metal
        return params.feat.float().cpu().numpy().reshape(
            params.feat.shape[0], 6, -1)

    f_ddim25 = run("ddim25", "ddim")
    f_dpm12 = run("ddim12", "dpm")
    f_ref = run("ddim200", "ddim")
    return {
        "dpm_albedo_psnr_db": round(tex_psnr(f_dpm12, f_ddim25), 1),
        "dpm_geometry_p99_dev": round(sdf_p99(f_dpm12, f_ddim25), 5),
        "dpm12_vs_ode_psnr_db": round(tex_psnr(f_dpm12, f_ref), 1),
        "ddim25_vs_ode_psnr_db": round(tex_psnr(f_ddim25, f_ref), 1),
    }


def _glb_mesh(glb: str):
    """(vertices [V, 3] f32, uv [V, 2], faces [F, 3] uint32) of a GLB."""
    from .extract.glb import read_glb

    gltf, blob = read_glb(glb)
    prim = gltf["meshes"][0]["primitives"][0]

    def load(name, dtype, ncomp):
        acc = gltf["accessors"][name]
        view = gltf["bufferViews"][acc["bufferView"]]
        return np.frombuffer(blob, dtype, acc["count"] * ncomp,
                             view.get("byteOffset", 0)).reshape(-1, ncomp)

    return (load(prim["attributes"]["POSITION"], np.float32, 3),
            load(prim["attributes"]["TEXCOORD_0"], np.float32, 2),
            load(prim["indices"], np.uint32, 1).reshape(-1, 3))


def bench_fidelity(dev: torch.device, mc_resolution: int = 128,
                   decimate: int = 60000, texture_size: int = 512) -> dict:
    """Texture and geometry fidelity of the extraction chain against the
    PrimX field itself, on ``textured_sphere``: the baked ``texture.jpg``
    against ``primx.query`` at the same texel points (PSNR), the GLB's
    vertices against the sphere (99th percentile of |r - 0.55|), and the
    box and LSCM unwraps of the welded mesh (``uv_metrics``); the method
    of ``bench.py:bench_fidelity``."""
    import cv2

    from .extract import quality_uv_unwrap
    from .extract.meshproc import _weld_vertices
    from .extract.rasterize import rasterize_uv_atlas
    from .extract.uv_unwrap import (box_projection_uv_unwrap,
                                    compute_vertex_normal, uv_metrics)
    from .models import primx as primx_lib
    from .pipelines import infer as P
    from .pipelines.synthetic import psnr, textured_sphere

    params = textured_sphere(device=dev)
    with tempfile.TemporaryDirectory() as td:
        glb = P.extract_glb(params, td, mc_resolution=mc_resolution,
                            decimate=decimate, texture_size=texture_size,
                            batch_size=32768, pos_scale=1.0)
        verts, uv, faces = _glb_mesh(glb)
        xyz_map, mask = rasterize_uv_atlas(uv[faces], verts[faces],
                                           texture_size, texture_size)
        tex = cv2.imread(os.path.join(td, "texture.jpg"))[..., ::-1] / 255.0

    dev_r = np.abs(np.linalg.norm(verts, axis=1) - 0.55)
    ys, xs = np.nonzero(mask)
    sub = slice(0, len(ys), max(len(ys) // 8192, 1))
    pts = torch.from_numpy(np.ascontiguousarray(
        xyz_map[ys[sub], xs[sub]], np.float32)).to(dev)
    with torch.inference_mode():
        out = primx_lib.query(params, pts, top_k=32, with_fallback=False,
                              outputs=("tex",))
    result = {
        "albedo_psnr_db": round(psnr(tex[ys[sub], xs[sub]],
                                     out["tex"].float().cpu().numpy()), 1),
        "geometry_p99_dev": round(float(np.percentile(dev_r, 99)), 5),
    }
    # the GLB splits vertices at UV seams: weld by position so that the
    # metrics score the unwrap, not the first unwrap's seams
    verts_w, f64 = _weld_vertices(verts.astype(np.float64),
                                  faces.astype(np.int64))
    vn = compute_vertex_normal(verts_w, f64)
    mb = uv_metrics(verts_w, f64, *box_projection_uv_unwrap(verts_w, vn, f64))
    mq = uv_metrics(verts_w, f64, *quality_uv_unwrap(verts_w, vn, f64))
    result.update({
        "uv_stretch_l2_box": round(mb["stretch_l2"], 4),
        "uv_stretch_l2_lscm": round(mq["stretch_l2"], 4),
        "uv_stretch_linf_box": round(mb["stretch_linf"], 3),
        "uv_stretch_linf_lscm": round(mq["stretch_linf"], 3),
        "uv_coverage_box": round(mb["coverage"], 3),
        "uv_coverage_lscm": round(mq["coverage"], 3),
        "uv_charts_box": mb["charts"],
        "uv_charts_lscm": mq["charts"],
    })
    return result


def check_flash(shapes, dev: torch.device, verbose: bool = False) -> bool:
    """The flash forward and backward (``ops/flash_attention.py``: the
    kernels on a card) against the plain version's autograd, bf16, at
    ``shapes``: max |fwd error| and each gradient's max error over its max
    below ``FLASH_BAR`` (``benchmarks/check_flash_tpu.py:run``)."""
    from .ops.flash_attention import flash_attention, flash_attention_plain

    ok = True
    for (B, Sq, Sk, H, D) in shapes:
        g = torch.Generator(dev).manual_seed(Sq * 131 + Sk)
        q, k, v, do = (torch.randn(s, generator=g, device=dev).bfloat16()
                       for s in ((B, Sq, H, D), (B, Sk, H, D), (B, Sk, H, D),
                                 (B, Sq, H, D)))
        scale = D ** -0.5
        outs, grads = [], []
        for fn in (flash_attention, flash_attention_plain):
            qq, kk, vv = (t.clone().requires_grad_() for t in (q, k, v))
            out = fn(qq, kk, vv, scale)
            (out.float() * do.float()).sum().backward()
            outs.append(out.detach().float())
            grads.append([t.grad.float() for t in (qq, kk, vv)])
        rows = [(outs[0] - outs[1]).abs().max().item()]
        for a, b in zip(*grads):
            rows.append((a - b).abs().max().item()
                        / (b.abs().max().item() + 1e-6))
        shape_ok = all(r < FLASH_BAR for r in rows)
        ok = ok and shape_ok
        if verbose:
            print(f"  {B}x{Sq}x{Sk}x{H}x{D}: fwd={rows[0]:.4f} dq/dk/dv "
                  f"rel={rows[1]:.4f}/{rows[2]:.4f}/{rows[3]:.4f} "
                  f"{'ok' if shape_ok else 'FAIL'}", file=sys.stderr)
    return bool(ok)


def bench_train_steps(size: dict, dev: torch.device, batch: int, remat,
                      grad_accum: int = 1) -> float:
    """Steps a second of ``make_train_step`` on the DiT the registry builds
    (``scan_blocks: true``, f32 master weights, bf16 compute): one step,
    then ``train_steps`` timed ones on one synthetic batch."""
    from . import registry  # noqa: F401  (fills the factory table)
    from .core.attrdict import AttrDict
    from .core.config import build
    from .core.profiling import timeit
    from .diffusion import create_diffusion
    from .pipelines.train import (create_train_state, make_optimizer,
                                  make_train_step)

    node = AttrDict(class_name="topiaxl.DiT", **size["dit"],
                    cond_drop_prob=0.1, attn_proj_bias=True, remat=remat,
                    scan_blocks=True)
    dit = build(node, device=dev, generator=torch.Generator(dev).manual_seed(0),
                param_dtype=torch.float32)
    diffusion = create_diffusion(
        timestep_respacing=None, noise_schedule="squaredcos_cap_v2",
        parameterization="v", diffusion_steps=1000, device=dev)
    opt = make_optimizer(lr=1e-4, warmup_iters=3000, max_iters=200000)
    state = create_train_state(dit)
    rng = np.random.default_rng(0)
    d = size["dit"]
    batch_d = {
        "x": torch.from_numpy(rng.standard_normal(
            (batch, d["seq_length"], d["in_channels"])).astype("f")).to(dev),
        "y": torch.from_numpy(rng.standard_normal(
            (batch, size["cond_tokens"], d["condition_channels"])).astype(
                "f")).to(dev)}
    step = make_train_step(dit, diffusion, opt, grad_accum=grad_accum)
    t = timeit(lambda: step(state, batch_d, 0), iters=size["train_steps"],
               warmup=1)
    if not np.isfinite(float(t["out"]["loss"])):
        raise FloatingPointError(f"train loss {float(t['out']['loss'])}")
    return t["per_sec"]


def card_line() -> str:
    """``nvidia-smi``'s name and power limit of the card."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip()
    except (OSError, subprocess.CalledProcessError) as e:
        return f"nvidia-smi: {e!r}"[:120]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m topiaxl_torch.bench",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (tests)")
    ap.add_argument("--tiny", action="store_true",
                    help="a few narrow blocks and small grids (tests)")
    ap.add_argument("--fast", action="store_true",
                    help="one warm image -> GLB run, four pipelined assets")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("topiaxl_torch.bench: no CUDA device (pass --device cpu for "
              "a CPU run)", file=sys.stderr)
        return 2
    size = SIZES["tiny" if args.tiny else "flagship"]
    failed = []

    def section(name, fn):
        try:
            return fn()
        except Exception as e:  # noqa: BLE001 (recorded; the exit code says)
            result[f"{name}_error"] = repr(e)[:200]
            failed.append(name)
            return None

    result: dict = {}
    if dev.type == "cuda":
        print(json.dumps({"device": torch.cuda.get_device_name(dev),
                          "nvidia_smi": card_line(),
                          "torch": torch.__version__}), flush=True)
    steps = section("dit_steps", lambda: bench_dit_steps(size, dev))
    if steps is not None:
        sps, flops = steps
        result.update({
            "metric": "dit_denoise_steps_per_sec", "value": round(sps, 3),
            "unit": "steps/s",
            "vs_baseline": round(sps / BASELINE_STEPS_PER_SEC, 3),
            # counted FLOPs a step over the card's dense bf16 peak
            "mfu": (round(sps * flops / peak_bf16_flops(
                torch.cuda.get_device_name(dev)), 4)
                if dev.type == "cuda" else None)})
    print(json.dumps(result), flush=True)

    with tempfile.TemporaryDirectory() as tmp:
        e2e = section("image_to_glb", lambda: bench_e2e_seconds(
            size, dev, tmp, warm_runs=1 if args.fast else 3))
        ctx = None
        if e2e is not None:
            rows, ctx = e2e
            total = rows.pop("total")
            result["image_to_glb_seconds"] = total
            result.update(rows)
            result["assets_per_min_serial"] = round(60.0 / total, 2)
        fid = section("fidelity", lambda: bench_fidelity(dev, **size[
            "fidelity"]))
        if fid is not None:
            result.update(fid)
        print(json.dumps(result), flush=True)
        if ctx is not None:
            apm = section("pipelined", lambda: bench_pipelined_assets_per_min(
                ctx, dev, n=4 if args.fast else 8))
            if apm is not None:
                result["assets_per_min_pipelined"] = round(apm, 2)
            gate = section("dpm_gate", lambda: bench_dpm_gate(ctx, dev))
            if gate is not None:
                result.update(gate)
            print(json.dumps(result), flush=True)
        ctx = e2e = None
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    parity = section("flash_parity", lambda: check_flash(
        size["flash_shapes"], dev, verbose=True))
    if parity is not None:
        result["flash_parity_on_card"] = parity
    print(json.dumps(result), flush=True)
    int8 = section("int8", lambda: bench_dit_steps(size, dev, quant=True))
    if int8 is not None:
        result["dit_denoise_steps_per_sec_int8"] = round(int8[0], 3)
    print(json.dumps(result), flush=True)
    train = section("train", lambda: bench_train_steps(size, dev, 2, True))
    if train is not None:
        result["train_steps_per_sec"] = round(train, 3)
    print(json.dumps(result), flush=True)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    bs8 = section("train_bs8", lambda: bench_train_steps(
        size, dev, 8, "dots", grad_accum=4))
    if bs8 is not None:
        result["train_steps_per_sec_bs8"] = round(bs8, 3)
    print(json.dumps(result), flush=True)
    from .pipelines import chain_graph

    print(f"topiaxl_torch.bench: chain graphs {chain_graph.stats['captures']}"
          f" captured, {chain_graph.stats['replays']} replayed",
          file=sys.stderr)
    if failed:
        print(f"topiaxl_torch.bench: sections failed: {failed}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
