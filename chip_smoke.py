#!/usr/bin/env python3
"""Drive the PyTorch port (``topiaxl_torch``) once on one CUDA card.

    python3 chip_smoke.py

Phases (each prints one line with its seconds; any failure raises and
the script exits non-zero without a result line):

1. device: a CUDA card must be present; prints its name and power limit.
2. build: compiles ``topiaxl_torch/csrc/*.cu`` from this checkout (and
   readies the shared host stages' C++ library).
3. kernels: each kernel against its plain PyTorch version at the main
   path's shapes, in bf16 on the card, with max error and times.
4. serving: ``topiaxl_torch.cli.infer.main`` on two synthetic images at
   the flagship config (``configs/inference_dit.yml``, random weights,
   no GLB export), with the exact kernel launch counts per image.
5. stage 2: ``extract_glb`` on a 2048-prim sphere shell at mc 256,
   decimate 100k, texture 1024; the GLB must parse and lie on the sphere.
6. dit: one full-width, depth-2 DiT CFG step on the card (bf16, kernels)
   against the same weights on the CPU (f32, plain versions).

The second-to-last line is ``{"kernels": [...]}``; the last is
``{"ok": true, "device": {...}}``. Imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
FLAGSHIP = os.path.join(ROOT, "configs", "inference_dit.yml")

# per image at the flagship config: DINOv2's 12 blocks + 25 DDIM steps x
# 28 DiT blocks x (self + cross); 25 x (28 blocks + final layer); 25 x 28 x 2
EXPECTED_LAUNCHES = {"flash_attn_fwd": 12 + 25 * 56,
                     "ln_modulate": 25 * 29,
                     "ln_modulate_residual": 25 * 56}
# flash: max |kernel - plain| / max |plain| per shape (bf16 output, P
# rounded to bf16 on both sides; sound kernels read 3e-3 to 5e-3). A
# kernel that leaves its zero-padded keys unmasked reads 1.5e-2 to 2.7e-2
# at the ragged shapes; the phase computes that planted fault on the same
# inputs and fails unless it lands above the bar.
ATTN_REL_BAR = 1e-2
# LN: |kernel - plain| <= 1 bf16 ulp of the plain result + 1e-5. The two
# run the same f32 chain in another summation order (~1e-6 apart at these
# magnitudes); each then rounds to bf16 once. Where y*(1+scale) and shift
# nearly cancel, the result's own ulp is far below that f32 noise, hence
# the absolute term.
LN_ABS_SLACK = 1e-5
DIT_BAR = 5e-2      # max |card bf16 - cpu f32| / max |cpu f32|, one CFG step

KERNELS = {
    "flash_attn_fwd": ("topiaxl_torch/csrc/flash_attn_fwd.cu",
                       "topiaxl/ops/flash_attention.py:70"),
    "ln_modulate": ("topiaxl_torch/csrc/ln_modulate.cu",
                    "topiaxl/ops/fused_ln.py:30"),
    "ln_modulate_residual": ("topiaxl_torch/csrc/ln_modulate.cu",
                             "topiaxl/ops/fused_ln.py:108"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


class Phase:
    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, *_):
        if exc_type is None:
            log(f"[phase {self.name}] ok in {time.perf_counter() - self.t0:.3f} s")


def cuda_ms(fn, iters: int) -> float:
    """Mean device ms per call over ``iters`` calls after one warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def bf16_ulp_excess(got, ref) -> float:
    """max over elements of |got - ref| minus ref's bf16 ulp."""
    import torch

    ref = ref.float()
    ulp = torch.exp2(torch.floor(torch.log2(ref.abs().clamp_min(1e-30))) - 7)
    return ((got.float() - ref).abs() - ulp).max().item()


def ptxas_summary(build_log: str) -> list[str]:
    """One line per compiled kernel: registers, spills, shared memory."""
    out, name, spill = [], None, ""
    for line in build_log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
            for short in ("flash_fwd_kernel", "ln_modulate_kernel"):
                if short in name:
                    name = short + name.split(short)[1].split("EEv")[0]
        elif "spill stores" in line:
            spill = line.strip()
        elif "Used" in line and "registers" in line and name:
            out.append(f"  {name}: {line.split(':', 1)[1].strip()}; {spill}")
            name = None
    return out


def phase_device():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() "
                         "is false)")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def phase_build():
    from topiaxl_torch.ops import _cuda

    shutil.rmtree(_cuda.build_dir(), ignore_errors=True)   # build it here
    lib = _cuda.build()
    _cuda.library()
    log(f"built {lib.relative_to(ROOT)} from "
        f"{[str(p.relative_to(ROOT)) for p in _cuda.sources()]}")
    for line in ptxas_summary((lib.parent / "build.log").read_text()):
        log(line)
    # the shared host stages build their C++ library (g++) at first use;
    # do it here so that phase 5 times stage 2 and not the build
    from topiaxl.native import marching_cubes

    t0 = time.perf_counter()
    marching_cubes(np.zeros((2, 2, 2), np.float32))
    log(f"host C++ stages (topiaxl/native) ready in "
        f"{time.perf_counter() - t0:.3f} s")


def phase_kernels() -> dict:
    """Each kernel against its plain version at the main path's shapes."""
    import torch

    from topiaxl_torch.ops.flash_attention import (
        KEY_TILE, flash_attention, flash_attention_plain,
        flash_attention_unmasked)
    from topiaxl_torch.ops.fused_ln import (
        ln_modulate, ln_modulate_plain, ln_modulate_residual,
        ln_modulate_residual_plain)

    dev = torch.device("cuda")
    g = torch.Generator(dev).manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev).bfloat16()

    def rel_err(got, ref):
        ref = ref.float()
        return ((got.float() - ref).abs().max() / ref.abs().max()).item()

    results = {}
    # (tag, B, Sq, Sk, H, D, scale, q/k/v as strided views of one qkv)
    cases = [("dit_self", 2, 2048, 2048, 16, 72, 72 ** -0.5, True),
             ("dit_cross", 1, 2048, 1370, 16, 72, 72 ** -1.0, False),
             ("dinov2", 1, 1374, 1374, 12, 64, 64 ** -0.5, True)]
    flash = results.setdefault("flash_attn_fwd",
                                {"max_abs_err": 0.0, "max_rel_err": 0.0})
    for tag, B, Sq, Sk, H, D, scale, fused in cases:
        if fused:
            q, k, v = randn(B, Sq, 3, H, D).unbind(2)
        else:
            q, k, v = randn(B, Sq, H, D), randn(B, Sk, H, D), randn(B, Sk, H, D)
        got = flash_attention(q, k, v, scale)
        ref = flash_attention_plain(q, k, v, scale)
        torch.cuda.synchronize()
        err = (got.float() - ref.float()).abs().max().item()
        rel = rel_err(got, ref)
        if Sk % KEY_TILE:
            fault = rel_err(flash_attention_unmasked(q, k, v, scale), ref)
            fault_msg = f"unmasked-padding fault {fault:.3e}"
        else:
            fault, fault_msg = None, "no padded keys"
        ms = cuda_ms(lambda: flash_attention(q, k, v, scale), 50)
        plain_ms = cuda_ms(lambda: flash_attention_plain(q, k, v, scale), 10)
        log(f"  flash_attn_fwd {tag} {B}x{Sq}x{Sk}x{H}x{D}: max rel err "
            f"{rel:.3e} (bar {ATTN_REL_BAR}; {fault_msg}), max_abs_err "
            f"{err:.3e}, kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
        if not rel <= ATTN_REL_BAR:
            raise AssertionError(f"flash_attn_fwd {tag}: rel error {rel} > "
                                 f"{ATTN_REL_BAR}")
        if fault is not None and not fault > ATTN_REL_BAR:
            raise AssertionError(f"flash_attn_fwd {tag}: the bar {ATTN_REL_BAR} "
                                 f"cannot see unmasked padding ({fault})")
        flash["max_abs_err"] = max(flash["max_abs_err"], err)
        flash["max_rel_err"] = max(flash["max_rel_err"], rel)
        if tag == "dit_self":
            flash.update(ms=ms, plain_ms=plain_ms, at=f"{B}x{Sq}x{Sk}x{H}x{D}")

    D = 1152
    x, delta = randn(2, 2048, D), randn(2, 2048, D)
    mods = randn(2, 9 * D) * 0.5
    sh, sc, gate = mods[:, :D], mods[:, D:2 * D], mods[:, 2 * D:3 * D]
    lns = [("ln_modulate", lambda: (ln_modulate(x, sh, sc),),
            lambda: (ln_modulate_plain(x, sh, sc),)),
           ("ln_modulate_residual",
            lambda: ln_modulate_residual(x, delta, gate, sh, sc),
            lambda: ln_modulate_residual_plain(x, delta, gate, sh, sc))]
    for name, kern, plain in lns:
        got, ref = kern(), plain()
        torch.cuda.synchronize()
        excess = max(bf16_ulp_excess(a, b) for a, b in zip(got, ref))
        err = max((a.float() - b.float()).abs().max().item()
                  for a, b in zip(got, ref))
        rel = max(((a.float() - b.float()).abs() / b.float().abs().clamp_min(
            1e-3)).max().item() for a, b in zip(got, ref))
        ms = cuda_ms(kern, 200)
        plain_ms = cuda_ms(plain, 50)
        log(f"  {name} 2x2048x1152: max_abs_err {err:.3e}, max rel err "
            f"{rel:.3e} (|ref| >= 1e-3), max excess over 1 bf16 ulp "
            f"{excess:.3e} (bar {LN_ABS_SLACK}), kernel {ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms")
        if not excess <= LN_ABS_SLACK:
            raise AssertionError(f"{name}: {excess} over 1 ulp > {LN_ABS_SLACK}")
        results[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                         "at": "2x2048x1152"}
    return results


def phase_serving(tmp: str) -> dict:
    from topiaxl_torch.cli.infer import main
    from topiaxl_torch.ops import _cuda
    from topiaxl_torch.pipelines.synthetic import write_bench_image

    img_dir = os.path.join(tmp, "imgs")
    os.makedirs(img_dir)
    for i in range(2):
        write_bench_image(os.path.join(img_dir, f"asset{i}.png"), shift=12 * i)

    class PerImage(list):
        """Snapshots the launch counters as each image finishes."""

        def append(self, rec):
            super().append(dict(rec, launches=dict(_cuda.launches)))

    recs = PerImage()
    _cuda.reset_launch_counts()
    rc = main([FLAGSHIP, "inference.export_glb=false",
               f"inference.input_dir={img_dir}", f"root_data_dir={tmp}/runs"],
              timings_out=recs)
    total = dict(_cuda.launches)
    if rc != 0 or len(recs) != 2:
        raise AssertionError(f"cli main returned {rc} with {len(recs)} images")
    prev = dict.fromkeys(total, 0)
    for rec in recs:
        per = {k: rec["launches"][k] - prev[k] for k in total}
        prev = rec["launches"]
        log(f"  {rec['image']}: encode {rec['encode_s']:.3f} s, stage1 "
            f"{rec['stage1_s']:.3f} s, stage2 {rec['stage2_s']:.3f} s; "
            f"launches {per}")
        if per != EXPECTED_LAUNCHES:
            raise AssertionError(f"launches {per} != {EXPECTED_LAUNCHES}")
        z = np.load(os.path.join(tmp, "runs", "inference", "topiaxl-sview",
                                 "inference_folder", rec["image"],
                                 "denoised.npz"))
        if z["srt"].shape != (2048, 4) or z["feat"].shape != (2048, 3072):
            raise AssertionError(f"denoised shapes {z['srt'].shape} "
                                 f"{z['feat'].shape}")
        if not (np.isfinite(z["srt"]).all() and np.isfinite(z["feat"]).all()):
            raise AssertionError("denoised.npz is not finite")
    return total


def phase_stage2(tmp: str):
    import torch

    from topiaxl.extract.glb import read_glb
    from topiaxl_torch.pipelines.infer import extract_glb
    from topiaxl_torch.pipelines.synthetic import SPHERE_R, sphere_asset

    params = sphere_asset(torch.device("cuda"))
    tm: dict = {}
    t0 = time.perf_counter()
    glb = extract_glb(params, os.path.join(tmp, "sphere"), mc_resolution=256,
                      decimate=100000, texture_size=1024, batch_size=32768,
                      pos_scale=1.0, timings_out=tm)
    log(f"  extract_glb {time.perf_counter() - t0:.3f} s: {json.dumps(tm)}")
    gltf, blob = read_glb(glb)
    prim = gltf["meshes"][0]["primitives"][0]
    n_faces = gltf["accessors"][prim["indices"]]["count"] // 3
    acc = gltf["accessors"][prim["attributes"]["POSITION"]]
    view = gltf["bufferViews"][acc["bufferView"]]
    verts = np.frombuffer(blob, np.float32, acc["count"] * 3,
                          view.get("byteOffset", 0)).reshape(-1, 3)
    dev = np.abs(np.linalg.norm(verts, axis=1) - SPHERE_R)
    voxel = 2.0 / (256 - 1)
    log(f"  GLB: {n_faces} faces, {len(verts)} vertices, max |r - {SPHERE_R}| "
        f"{dev.max():.3e} = {dev.max() / voxel:.3f} voxels")
    if n_faces <= 0:
        raise AssertionError("GLB has no faces")
    if not dev.max() <= 2 * voxel:
        raise AssertionError(f"vertices off the sphere by {dev.max() / voxel} voxels")


def phase_dit():
    import torch

    from topiaxl_torch.models.dit import DiT
    from topiaxl_torch.models.layers import xavier_

    kw = dict(seq_length=2048, in_channels=68, condition_channels=768,
              hidden_size=1152, depth=2, num_heads=16)
    gen = torch.Generator().manual_seed(1)
    cpu = DiT(dtype=torch.float32, device="cpu", generator=gen, **kw).eval()
    with torch.no_grad():   # the zero-init layers would make the step vacuous
        for m in [b.adaLN_modulation[1] for b in cpu.blocks] + [
                cpu.final_layer.adaLN_modulation[1], cpu.final_layer.linear]:
            xavier_(m.weight, gen)
            m.bias.normal_(0.0, 0.02, generator=gen)
        cpu.null_cond_embedding.normal_(0.0, 1.0, generator=gen)
    card = DiT(dtype=torch.bfloat16, device="cuda", **kw).eval()
    card.load_state_dict(cpu.state_dict())
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((1, 2048, 68)).astype(np.float32))
    y = torch.from_numpy(rng.standard_normal((1, 1370, 768)).astype(np.float32))
    t = torch.tensor([500])

    def step(model, dev):
        with torch.inference_mode():
            return model.forward_with_cfg_fast(
                x.to(dev), t.to(dev), model.precompute_kv(y.to(dev)),
                model.precompute_null_out(), 6.0).float().cpu()

    got, ref = step(card, "cuda"), step(cpu, "cpu")
    rel = ((got - ref).abs().max() / ref.abs().max()).item()
    mean_rel = ((got - ref).abs().mean() / ref.abs().mean()).item()
    log(f"  one CFG step, depth 2 at full width: max|ref| "
        f"{ref.abs().max().item():.3f}, max rel err {rel:.3e} (bar {DIT_BAR}), "
        f"mean rel err {mean_rel:.3e}")
    if not (torch.isfinite(got).all() and rel <= DIT_BAR):
        raise AssertionError(f"card vs cpu DiT step: rel err {rel} > {DIT_BAR}")


def main() -> int:
    if not os.path.isdir(os.path.join(ROOT, "topiaxl_torch")):
        print("chip_smoke: run from a checkout of the repository "
              "(topiaxl_torch/ not found beside this script)", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import torch

    with Phase("device"):
        phase_device()
    with Phase("build"):
        phase_build()
    with Phase("kernels"):
        results = phase_kernels()
    with tempfile.TemporaryDirectory() as tmp:
        with Phase("serving"):
            launches = phase_serving(tmp)
        with Phase("stage2"):
            phase_stage2(tmp)
    with Phase("dit"):
        phase_dit()

    kernels = [dict(name=name, route="cuda", source=src, replaces=rep,
                    launches=launches[name], **results[name])
               for name, (src, rep) in KERNELS.items()]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
