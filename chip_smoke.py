#!/usr/bin/env python3
"""Drive the PyTorch port (``topiaxl_torch``) once on one CUDA card.

    python3 chip_smoke.py

Phases (each prints one line with its seconds; any failure raises and
the script exits non-zero without a result line):

1. device: a CUDA card must be present; prints its name and power limit.
2. build: compiles ``topiaxl_torch/csrc/*.cu`` from this checkout (no
   kernel may spill) and the host stages' C++ library
   (``topiaxl_torch/native``, g++).
3. kernels: each kernel against its plain PyTorch version at the main
   path's shapes, in bf16 on the card, with max error and times, beside
   its bound (the larger of its FLOPs over 989 TFLOP/s and its bytes over
   3.35 TB/s, counted from the shapes) and, where one PyTorch call
   computes the same function, that call's time (``library_ms``:
   ``scaled_dot_product_attention`` and its flash backward, used here as
   a yardstick and nowhere in the port).
4. serving: ``topiaxl_torch.cli.infer.main`` on two synthetic images at
   the flagship config (``configs/inference_dit.yml``, random weights,
   no GLB export), with the exact kernel launch counts per image.
5. stage 2: ``extract_glb`` on a 2048-prim sphere shell at mc 256,
   decimate 100k, texture 1024; the GLB must parse and lie on the sphere.
6. dit: one full-width, depth-2 DiT CFG step on the card (bf16, kernels)
   against the same weights on the CPU (f32, plain versions).
7. train: ``topiaxl_torch.cli.train.main`` at the flagship config
   (synthetic data, batch 8, random init) for 6 steps, then a resume from
   its checkpoint for one more, with the exact kernel launch counts per
   step, finite losses and gradient norms, step time and peak memory.
8. train_long: the same trainer at 4096 prims (depth 2, batch 2): the
   self-attention's 4096 keys take the two-pass backward pair.
9. train_parity: one full-width, depth-2 training step's loss and
   gradients on the card (bf16, kernels) against the CPU (f32, plain),
   and a control step whose attention backward leaves out delta, which
   must fail the bars.

Phase 3 also holds the forward's output and lse, the three backward
kernels and the LN kernels against their plain versions at the training
shapes (batch 8 for the flagship, 4096 prims at batch 2), with planted
faults that must land above each bar.

The second-to-last line is ``{"kernels": [...]}``; the last is
``{"ok": true, "device": {...}}``. Imports nothing of JAX and nothing of
the JAX package (``topiaxl``).
"""

from __future__ import annotations

import functools
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
# 28 DiT blocks x (self + cross); 25 x (28 blocks + final layer); 25 x 28 x 2;
# serving runs no backward kernel
EXPECTED_LAUNCHES = {"flash_attn_fwd": 12 + 25 * 56, "flash_attn_bwd": 0,
                     "flash_attn_bwd_dq": 0, "flash_attn_bwd_dkv": 0,
                     "ln_modulate": 25 * 29,
                     "ln_modulate_residual": 25 * 56}
# per training step at the flagship config (28 blocks): a forward flash
# and a single-pass backward launch per self- and cross-attention; the LN
# kernels as in serving, once per block and step (+ the final layer)
TRAIN_LAUNCHES = {"flash_attn_fwd": 56, "flash_attn_bwd": 56,
                  "flash_attn_bwd_dq": 0, "flash_attn_bwd_dkv": 0,
                  "ln_modulate": 29, "ln_modulate_residual": 56}
# at 4096 prims and depth 2 the self-attention (4096 keys) takes the
# two-pass pair, the cross-attention (1370 keys) the single pass
TRAIN_LONG_LAUNCHES = {"flash_attn_fwd": 4, "flash_attn_bwd": 2,
                       "flash_attn_bwd_dq": 2, "flash_attn_bwd_dkv": 2,
                       "ln_modulate": 3, "ln_modulate_residual": 4}
# one training step, card (bf16 compute, f32 master weights, kernels)
# against the CPU (f32, plain versions) at full width, depth 2: the loss
# and the global gradient norm relative to the CPU's, and the cosine of
# every parameter's gradient with the CPU's. The bf16 rounding of single
# outputs averages out in the loss and the norm: on an H100 the step reads
# loss 1.1e-6, norm 4.0e-5 and a worst cosine of 0.99987 (blocks.1.
# crossattn.to_q.bias); the bars sit 4.5x, 5x and 7.7x above. A control
# step on the card whose attention backward leaves out delta must fail
# at least one of them.
TRAIN_LOSS_BAR = 5e-6
TRAIN_GNORM_BAR = 2e-4
TRAIN_COS_BAR = 0.999
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
# lse: max |kernel - plain logsumexp| (f32 on both sides, ~log(Sk) + a
# few, so ~1e-6 of f32 summation order; a kernel that leaves its padded
# keys unmasked adds log(1 + n_pad / sum) ~ 1e-2 at the cross shape)
LSE_ABS_BAR = 1e-4
# backward: max |kernel - plain| / max |plain| per gradient, both from the
# same o and lse; bf16 P and dS on both sides, dq summed by f32 reductions in
# the single pass. Sound kernels read 1.1e-3 to 6.8e-3 at the training
# shapes. Two planted faults must land above the bar: the plain backward
# without delta for dq and dk (2.1e-2 at cross dk to 2.1e-1; delta does
# not enter dv), and, where Sk has padded keys, the pair of forward and
# backward with the padded keys unmasked for dv (the padded keys' share
# of the softmax mass, ~2.2e-2 to 2.9e-2 at these shapes).
ATTN_BWD_REL_BAR = 1.2e-2

# the card's peaks for the bounds (H100 SXM data sheet: dense bf16 on the
# tensor cores, f32 outside them, HBM3)
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12

KERNELS = {
    "flash_attn_fwd": ("topiaxl_torch/csrc/flash_attn_fwd.cu",
                       "topiaxl/ops/flash_attention.py:70"),
    "flash_attn_bwd": ("topiaxl_torch/csrc/flash_attn_bwd_sm90.cu",
                       "topiaxl/ops/flash_attention.py:369"),
    "flash_attn_bwd_dq": ("topiaxl_torch/csrc/flash_attn_bwd.cu",
                          "topiaxl/ops/flash_attention.py:282"),
    "flash_attn_bwd_dkv": ("topiaxl_torch/csrc/flash_attn_bwd.cu",
                           "topiaxl/ops/flash_attention.py:469"),
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
    """Mean device ms per call: ``iters`` calls captured in one CUDA graph
    after a warm-up call, its replay timed by CUDA events. The graph keeps
    the host's cost of each call through the kernel wrappers out of the
    reading: launched one by one, a kernel shorter than that (the DINOv2
    forward) reads the host's time."""
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    stop.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(stop) / iters


def bound(flops: float, nbytes: float,
          peak: float = PEAK_BF16_FLOPS) -> tuple[float, str]:
    """(least ms the card could take for ``flops`` at ``peak`` and
    ``nbytes`` at the memory rate, "operations" or "bytes")."""
    t_ops = flops / peak * 1e3
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def sdpa_forward_ms(q, k, v, scale: float, iters: int):
    """(ms, backend) of ``scaled_dot_product_attention`` on the same
    [B, S, H, D] tensors viewed as [B, H, S, D], its flash backend forced;
    (None, the error) where that backend refuses them."""
    import torch
    from torch.nn.attention import SDPBackend, sdpa_kernel
    from torch.nn.functional import scaled_dot_product_attention as sdpa

    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    try:
        with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
            return (cuda_ms(lambda: sdpa(qt, kt, vt, scale=scale), iters),
                    SDPBackend.FLASH_ATTENTION.name)
    except RuntimeError as e:
        return None, f"no flash backend: {e}"


def sdpa_backward_ms(q, k, v, do, scale: float, iters: int):
    """(ms, op) of PyTorch's flash-attention backward on the same tensors:
    ``aten._scaled_dot_product_flash_attention_backward`` on its own
    forward's output and logsumexp; (None, the error) where it refuses."""
    import torch

    aten = torch.ops.aten
    qt, kt, vt, dot = (t.transpose(1, 2) for t in (q, k, v, do))
    op = "_scaled_dot_product_flash_attention_backward"
    try:
        o, lse, cq, ck, mq, mk, seed, offset = (
            aten._scaled_dot_product_flash_attention(
                qt, kt, vt, 0.0, False, False, scale=scale)[:8])

        def backward():
            getattr(aten, op)(dot, qt, kt, vt, o, lse, cq, ck, mq, mk, 0.0,
                              False, seed, offset, scale=scale)

        return cuda_ms(backward, iters), f"aten.{op}"
    except RuntimeError as e:
        return None, f"no flash backward: {e}"


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
            for short in ("flash_fwd_kernel", "flash_bwd_sm90_kernel",
                          "flash_bwd_kv_kernel", "flash_bwd_dq_kernel",
                          "ln_modulate_kernel"):
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
    summary = ptxas_summary((lib.parent / "build.log").read_text())
    for line in summary:
        log(line)
    spills = [line for line in summary if " 0 bytes spill stores" not in line]
    if spills:
        raise AssertionError(f"kernels spill registers: {spills}")
    # the host stages' C++ library (g++): built here, from this checkout,
    # so that phase 5 is known to run the C++ stages and not their numpy
    # fall-backs, and times stage 2 and not the build; a failed g++ raises
    from topiaxl_torch import native

    t0 = time.perf_counter()
    shutil.rmtree(native.build_dir(), ignore_errors=True)
    so = native.build()
    native.marching_cubes(np.zeros((2, 2, 2), np.float32))
    if native.loaded_path() != so:
        raise AssertionError(f"loaded {native.loaded_path()}, built {so}")
    log(f"built {so.relative_to(ROOT)} (g++, topiaxl_torch/native) in "
        f"{time.perf_counter() - t0:.3f} s")


def rel_err(got, ref) -> float:
    ref = ref.float()
    return ((got.float() - ref).abs().max() / ref.abs().max()).item()


def check_flash_backward(results: dict, randn) -> None:
    """The forward's output and lse and the three backward kernels against
    the plain versions at the training shapes: the flagship's self- and
    cross-attention at batch 8 (single pass), the 4096-prim trainer's at
    batch 2 (two-pass pair and single pass), and a ragged two-pass shape
    whose padded q rows and keys the pair must mask."""
    import torch

    from topiaxl_torch.ops import flash_attention as fa

    cases = [("dit_self", 8, 2048, 2048, 16, 72, 72 ** -0.5, True),
             ("dit_cross", 8, 2048, 1370, 16, 72, 72 ** -1.0, False),
             ("long_self", 2, 4096, 4096, 16, 72, 72 ** -0.5, True),
             ("long_cross", 2, 4096, 1370, 16, 72, 72 ** -1.0, False),
             ("ragged_pair", 1, 1000, 2049, 16, 72, 72 ** -0.5, False)]
    flash = results["flash_attn_fwd"]
    lse_max = 0.0
    for tag, B, Sq, Sk, H, D, scale, fused in cases:
        if fused:
            q, k, v = randn(B, Sq, 3, H, D).unbind(2)
        else:
            q, k, v = randn(B, Sq, H, D), randn(B, Sk, H, D), randn(B, Sk, H, D)
        do = randn(B, Sq, H, D)
        shape = f"{B}x{Sq}x{Sk}x{H}x{D}"
        o, lse = fa._forward(q, k, v, scale, return_lse=True)
        o_ref, lse_ref = fa.flash_attention_plain(q, k, v, scale,
                                                  return_lse=True)
        torch.cuda.synchronize()
        o_rel = rel_err(o, o_ref)
        flash["max_abs_err"] = max(flash["max_abs_err"], (
            o.float() - o_ref.float()).abs().max().item())
        flash["max_rel_err"] = max(flash["max_rel_err"], o_rel)
        lse_err = (lse - lse_ref).abs().max().item()
        lse_max = max(lse_max, lse_err)
        msg = (f"  forward {tag} {shape}: o max rel err {o_rel:.3e} (bar "
               f"{ATTN_REL_BAR}), lse max abs err {lse_err:.3e} (bar "
               f"{LSE_ABS_BAR}")
        if Sk % fa.KEY_TILE:
            o_bad, lse_bad = fa.flash_attention_unmasked(q, k, v, scale,
                                                         return_lse=True)
            o_fault = rel_err(o_bad, o_ref)
            fault = (lse_bad - lse_ref).abs().max().item()
            log(f"{msg}; unmasked-padding fault o {o_fault:.3e}, lse "
                f"{fault:.3e})")
            if not (o_fault > ATTN_REL_BAR and fault > LSE_ABS_BAR):
                raise AssertionError(f"forward {tag}: the bars cannot see "
                                     f"unmasked padding ({o_fault}, {fault})")
            del o_bad, lse_bad
        else:
            log(f"{msg}; no padded keys)")
        if not (o_rel <= ATTN_REL_BAR and lse_err <= LSE_ABS_BAR):
            raise AssertionError(f"forward {tag}: o rel error {o_rel}, lse "
                                 f"error {lse_err}")
        del o_ref, lse_ref

        got = fa.flash_attention_backward(q, k, v, o, lse, do, scale)
        ref = fa.flash_attention_bwd_plain(q, k, v, o, lse, do, scale)
        torch.cuda.synchronize()
        rels = [rel_err(a, b) for a, b in zip(got, ref)]
        errs = [(a.float() - b.float()).abs().max().item()
                for a, b in zip(got, ref)]
        del got
        # planted faults: no delta (moves dq, dk); padded keys unmasked in
        # forward and backward (moves dv, at shapes with padded keys)
        no_delta = [rel_err(a, b) for a, b in zip(fa.flash_attention_bwd_plain(
            q, k, v, o, lse, do, scale, with_delta=False), ref)]
        unmasked = ([rel_err(a, b) for a, b in zip(
            fa.flash_attention_bwd_unmasked(q, k, v, do, scale), ref)]
            if Sk % fa.KEY_TILE else None)
        del ref
        form = fa.bwd_form(Sk)
        names = (["flash_attn_bwd"] if form == "fused"
                 else ["flash_attn_bwd_dq", "flash_attn_bwd_dkv"])
        dq_acc = torch.zeros_like(q, dtype=torch.float32)
        dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
        outs = {"flash_attn_bwd": (dq_acc, dk, dv),
                "flash_attn_bwd_dq": (dq, None, None),
                "flash_attn_bwd_dkv": (None, dk, dv)}
        times = {n: cuda_ms(lambda n=n: fa._bwd_launch(
            n, q, k, v, o, lse, do, *outs[n], scale), 10) for n in names}
        plain_ms = cuda_ms(lambda: fa.flash_attention_bwd_plain(
            q, k, v, o, lse, do, scale), 3)
        flops = 10 * B * H * Sq * Sk * D   # five Sq x Sk x D products
        # each kernel's own bound: q, o, dO, k, v (bf16) and lse (f32) read
        # once; the single pass does five products and writes dq as f32
        # scratch and dk, dv; the dq pass three products (S, dP, dQ) and
        # bf16 dq; the dk/dv pass four and dk, dv
        n_q, n_k = B * Sq * H * D, B * Sk * H * D
        reads = 2 * (3 * n_q + 2 * n_k) + 4 * B * H * Sq
        bounds = {"flash_attn_bwd": bound(flops, reads + 4 * n_q + 4 * n_k),
                  "flash_attn_bwd_dq": bound(6 * B * H * Sq * Sk * D,
                                             reads + 2 * n_q),
                  "flash_attn_bwd_dkv": bound(8 * B * H * Sq * Sk * D,
                                              reads + 4 * n_k)}
        lib_ms, how = sdpa_backward_ms(q, k, v, do, scale, 10)
        fault_msg = (f"unmasked-padding fault dq/dk/dv {unmasked[0]:.3e}/"
                     f"{unmasked[1]:.3e}/{unmasked[2]:.3e}"
                     if unmasked else "no padded keys")
        log(f"  backward {tag} {shape} ({form}): max rel err dq/dk/dv "
            f"{rels[0]:.3e}/{rels[1]:.3e}/{rels[2]:.3e} (bar "
            f"{ATTN_BWD_REL_BAR}; no-delta fault dq/dk {no_delta[0]:.3e}/"
            f"{no_delta[1]:.3e}; {fault_msg}), max abs err {max(errs):.3e}, "
            + ", ".join(f"{n} {t:.4f} ms (bound {bounds[n][0]:.4f} ms, "
                        f"{bounds[n][1]})" for n, t in times.items())
            + f" ({flops / sum(times.values()) / 1e9:.1f} TFLOP/s), plain "
            f"backward {plain_ms:.4f} ms, " + (
                f"PyTorch flash backward {lib_ms:.4f} ms ({how}; "
                f"kernels/library {sum(times.values()) / lib_ms:.2f})"
                if lib_ms else how))
        for name, rel in zip(("dq", "dk", "dv"), rels):
            if not rel <= ATTN_BWD_REL_BAR:
                raise AssertionError(f"backward {tag} {name}: rel error {rel} "
                                     f"> {ATTN_BWD_REL_BAR}")
        for name, fault in zip(("dq", "dk"), no_delta):
            if not fault > ATTN_BWD_REL_BAR:
                raise AssertionError(f"backward {tag} {name}: the bar cannot "
                                     f"see a missing delta ({fault})")
        if unmasked and not unmasked[2] > ATTN_BWD_REL_BAR:
            raise AssertionError(f"backward {tag} dv: the bar cannot see "
                                 f"unmasked padded keys ({unmasked[2]})")
        for n in names:
            entry = results.setdefault(n, {"max_abs_err": 0.0,
                                           "max_rel_err": 0.0})
            entry["max_abs_err"] = max(entry["max_abs_err"], max(errs))
            entry["max_rel_err"] = max(entry["max_rel_err"], max(rels))
            if "ms" not in entry:
                # library_ms: the whole backward in one call (the pair's
                # two kernels together compute what it computes)
                entry.update(ms=times[n], plain_ms=plain_ms, at=shape,
                             bound_ms=bounds[n][0], bound_by=bounds[n][1],
                             library_ms=lib_ms, library=how)
        del dq_acc, dq, dk, dv, o, lse
        torch.cuda.empty_cache()
    flash["lse_max_abs_err"] = lse_max


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
        # q, k, v read and o written once, bf16; no lse on this call
        bound_ms, bound_by = bound(4 * B * H * Sq * Sk * D,
                                   2 * (2 * B * Sq + 2 * B * Sk) * H * D)
        lib_ms, backend = sdpa_forward_ms(q, k, v, scale, 50)
        lib_msg = (f"sdpa ({backend}) {lib_ms:.4f} ms, kernel/sdpa "
                   f"{ms / lib_ms:.2f}" if lib_ms else f"sdpa: {backend}")
        log(f"  flash_attn_fwd {tag} {B}x{Sq}x{Sk}x{H}x{D}: max rel err "
            f"{rel:.3e} (bar {ATTN_REL_BAR}; {fault_msg}), max_abs_err "
            f"{err:.3e}, kernel {ms:.4f} ms "
            f"({4 * B * H * Sq * Sk * D / ms / 1e9:.1f} TFLOP/s), plain "
            f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}; "
            f"kernel/bound {ms / bound_ms:.2f}), {lib_msg}")
        if not rel <= ATTN_REL_BAR:
            raise AssertionError(f"flash_attn_fwd {tag}: rel error {rel} > "
                                 f"{ATTN_REL_BAR}")
        if fault is not None and not fault > ATTN_REL_BAR:
            raise AssertionError(f"flash_attn_fwd {tag}: the bar {ATTN_REL_BAR} "
                                 f"cannot see unmasked padding ({fault})")
        flash["max_abs_err"] = max(flash["max_abs_err"], err)
        flash["max_rel_err"] = max(flash["max_rel_err"], rel)
        if tag == "dit_self":
            flash.update(ms=ms, plain_ms=plain_ms, at=f"{B}x{Sq}x{Sk}x{H}x{D}",
                         bound_ms=bound_ms, bound_by=bound_by,
                         library_ms=lib_ms, library=f"sdpa {backend}")
    check_flash_backward(results, randn)

    # serving runs the LN kernels at batch 2 (CFG), training at batch 8
    D = 1152
    for B in (2, 8):
        x, delta = randn(B, 2048, D), randn(B, 2048, D)
        mods = randn(B, 9 * D) * 0.5
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
            rel = max(((a.float() - b.float()).abs()
                       / b.float().abs().clamp_min(1e-3)).max().item()
                      for a, b in zip(got, ref))
            ms = cuda_ms(kern, 200)
            plain_ms = cuda_ms(plain, 50)
            # bf16 rows in and out once, the [B, D] modulation vectors;
            # ~10 f32 operations an element outside the tensor cores
            n_x, n_mod = B * 2048 * D, B * D
            nbytes = (2 * (2 * n_x + 2 * n_mod) if name == "ln_modulate"
                      else 2 * (4 * n_x + 3 * n_mod))
            bound_ms, bound_by = bound(10 * n_x, nbytes, PEAK_F32_FLOPS)
            log(f"  {name} {B}x2048x1152: max_abs_err {err:.3e}, max rel err "
                f"{rel:.3e} (|ref| >= 1e-3), max excess over 1 bf16 ulp "
                f"{excess:.3e} (bar {LN_ABS_SLACK}), kernel {ms:.4f} ms, "
                f"plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
                f"({bound_by}; kernel/bound {ms / bound_ms:.2f}), library: "
                f"none (no single PyTorch call computes it)")
            if not excess <= LN_ABS_SLACK:
                raise AssertionError(f"{name} at batch {B}: {excess} over 1 "
                                     f"ulp > {LN_ABS_SLACK}")
            entry = results.setdefault(name, {
                "max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
                "at": f"{B}x2048x1152", "bound_ms": bound_ms,
                "bound_by": bound_by, "library_ms": None})
            entry["max_abs_err"] = max(entry["max_abs_err"], err)
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

    from topiaxl_torch.extract.glb import read_glb
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


class PerStep(list):
    """Snapshots the launch counters as each step's metrics arrive."""

    def append(self, rec):
        from topiaxl_torch.ops import _cuda

        super().append(dict(rec, launches=dict(_cuda.launches)))


def run_trainer(args: list, expected: dict, steps: list) -> dict:
    """``cli.train.main`` with the counters zeroed first; checks each
    step's launches, finite metrics and the step numbers; returns the
    run's total launches and its records."""
    import torch

    from topiaxl_torch.cli.train import main
    from topiaxl_torch.ops import _cuda

    recs = PerStep()
    _cuda.reset_launch_counts()
    rc = main(args, metrics_out=recs)
    total = dict(_cuda.launches)
    if rc != 0 or [r["step"] for r in recs] != steps:
        raise AssertionError(f"train main returned {rc} after steps "
                             f"{[r['step'] for r in recs]}, expected {steps}")
    prev = dict.fromkeys(total, 0)
    for rec in recs:
        per = {k: rec["launches"][k] - prev[k] for k in total}
        prev = rec["launches"]
        log(f"  step {rec['step']}: {rec['seconds']:.3f} s, loss "
            f"{rec['loss']:.5f} (mse {rec['loss_mse']:.5f}, vb "
            f"{rec['loss_vb']:.5f}), grad norm {rec['grad_norm']:.5f}; "
            f"launches {per}")
        if per != expected:
            raise AssertionError(f"launches {per} != {expected}")
        vals = [rec[k] for k in ("loss", "loss_mse", "loss_vb", "grad_norm")]
        if not np.isfinite(vals).all():
            raise AssertionError(f"step {rec['step']}: metrics {vals}")
    torch.cuda.synchronize()
    return total, recs


def phase_train(tmp: str) -> dict:
    import torch

    args = [FLAGSHIP, "train.synthetic=true", "train.batch_size=8",
            "train.log_every_n_steps=1", "train.ckpt_every_n_steps=1000000",
            "train.keep_ckpts=1", f"root_data_dir={tmp}/train"]
    torch.cuda.reset_peak_memory_stats()
    total, recs = run_trainer(args + ["train.max_steps=6"], TRAIN_LAUNCHES,
                              list(range(1, 7)))
    peak = torch.cuda.max_memory_allocated()
    warm = sorted(r["seconds"] for r in recs[1:])
    median = warm[len(warm) // 2]
    # the five products of the attention backward and the matmuls of
    # forward (x1) and backward (x2) at batch 8, from the shapes
    log(f"  flagship step, batch 8: first {recs[0]['seconds']:.3f} s, steps "
        f"2-6 median {median:.3f} s (min {warm[0]:.3f}, max {warm[-1]:.3f}); "
        f"peak device memory {peak / 2 ** 30:.2f} GiB "
        f"(torch.cuda.max_memory_allocated)")
    t0 = time.perf_counter()
    run_trainer(args + ["train.max_steps=7"], TRAIN_LAUNCHES, [7])
    log(f"  resumed from step 6 and ran step 7 in "
        f"{time.perf_counter() - t0:.3f} s (checkpoint load, step, save)")
    return {**total, "step_s": median, "peak_gib": peak / 2 ** 30}


def phase_train_long(tmp: str) -> dict:
    args = [FLAGSHIP, "model.num_prims=4096", "model.generator.depth=2",
            "train.synthetic=true", "train.batch_size=2", "train.max_steps=2",
            "train.log_every_n_steps=1", f"root_data_dir={tmp}/train_long"]
    total, _ = run_trainer(args, TRAIN_LONG_LAUNCHES, [1, 2])
    return total


def phase_train_parity():
    import torch

    from topiaxl_torch.diffusion import create_diffusion, gaussian
    from topiaxl_torch.models.dit import DiT
    from topiaxl_torch.models.layers import xavier_
    from topiaxl_torch.ops import _cuda

    kw = dict(seq_length=2048, in_channels=68, condition_channels=768,
              hidden_size=1152, depth=2, num_heads=16, cond_drop_prob=0.1,
              param_dtype=torch.float32)
    gen = torch.Generator().manual_seed(5)
    cpu = DiT(dtype=torch.float32, device="cpu", generator=gen, **kw)
    with torch.no_grad():   # the zero-init layers would stop the gradients
        for m in [b.adaLN_modulation[1] for b in cpu.blocks] + [
                cpu.final_layer.adaLN_modulation[1], cpu.final_layer.linear]:
            xavier_(m.weight, gen)
            m.bias.normal_(0.0, 0.02, generator=gen)
    card = DiT(dtype=torch.bfloat16, device="cuda", **kw)
    card.load_state_dict(cpu.state_dict())
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.standard_normal((2, 2048, 68)).astype(np.float32))
    y = torch.from_numpy(rng.standard_normal((2, 1370, 768)).astype(np.float32))
    noise = torch.from_numpy(rng.standard_normal(x.shape).astype(np.float32))
    t = torch.tensor([10, 700])
    drop = torch.tensor([True, False])

    def step(model, dev):
        diffusion = create_diffusion(
            timestep_respacing=None, noise_schedule="squaredcos_cap_v2",
            diffusion_steps=1000, parameterization="v", device=dev)
        yd, dd = y.to(dev), drop.to(dev)
        terms = gaussian.training_losses(
            diffusion, lambda x_t, t_o: model(x_t, t_o, yd, dd), x.to(dev),
            t.to(dev), noise=noise.to(dev))
        loss = terms["loss_total"].mean()
        loss.backward()
        return loss.item(), {n: p.grad.float().cpu()
                             for n, p in model.named_parameters()}

    _cuda.reset_launch_counts()
    got_loss, got = step(card, "cuda")
    launches = dict(_cuda.launches)
    ref_loss, ref = step(cpu, "cpu")
    expect = {"flash_attn_fwd": 4, "flash_attn_bwd": 4, "flash_attn_bwd_dq": 0,
              "flash_attn_bwd_dkv": 0, "ln_modulate": 3,
              "ln_modulate_residual": 4}
    if launches != expect:
        raise AssertionError(f"parity step launches {launches} != {expect}")
    gnorm = lambda g: torch.sqrt(sum((v.double() ** 2).sum()  # noqa: E731
                                     for v in g.values())).item()
    ref_norm = gnorm(ref)
    # crossattn.to_k.bias's gradient is zero in exact arithmetic (softmax
    # ignores the shift), so it has no direction to compare
    compared = [n for n in ref if not n.endswith("crossattn.to_k.bias")]

    def readings(loss, grads):
        """(loss rel, grad norm rel, worst cosine, its tensor) vs the CPU."""
        cos = {}
        for n in compared:
            a, b = grads[n].flatten().double(), ref[n].flatten().double()
            cos[n] = (a @ b / (a.norm() * b.norm())).item()
        worst = min(cos, key=cos.get)
        return (abs(loss - ref_loss) / abs(ref_loss),
                abs(gnorm(grads) - ref_norm) / ref_norm, cos[worst], worst)

    def within(loss_rel, gn_rel, cos, _):
        return (loss_rel <= TRAIN_LOSS_BAR and gn_rel <= TRAIN_GNORM_BAR
                and cos >= TRAIN_COS_BAR)

    sound = readings(got_loss, got)
    log(f"  one training step, depth 2 at full width, batch 2: loss card "
        f"{got_loss:.6f} cpu {ref_loss:.6f} (rel {sound[0]:.3e}, bar "
        f"{TRAIN_LOSS_BAR}); grad norm rel {sound[1]:.3e} (bar "
        f"{TRAIN_GNORM_BAR}); min cosine {sound[2]:.6f} at {sound[3]} (bar "
        f"{TRAIN_COS_BAR}, {len(compared)} tensors); launches {launches}")
    if not within(*sound):
        raise AssertionError("card vs cpu training step outside its bars")

    # control: the same card step with the attention backward leaving out
    # delta (the plain backward's planted fault) must fail a bar
    from topiaxl_torch.ops import flash_attention as fa

    sound_backward = fa.flash_attention_backward
    fa.flash_attention_backward = functools.partial(
        fa.flash_attention_bwd_plain, with_delta=False)
    try:
        card.zero_grad(set_to_none=True)
        control = readings(*step(card, "cuda"))
    finally:
        fa.flash_attention_backward = sound_backward
    log(f"  control (backward without delta): loss rel {control[0]:.3e}, "
        f"grad norm rel {control[1]:.3e}, min cosine {control[2]:.6f} at "
        f"{control[3]}")
    if within(*control):
        raise AssertionError("the parity bars cannot see a backward without "
                             "delta")


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
    with tempfile.TemporaryDirectory() as tmp:
        with Phase("train"):
            train = phase_train(tmp)
    with tempfile.TemporaryDirectory() as tmp:
        with Phase("train_long"):
            train_long = phase_train_long(tmp)
    with Phase("train_parity"):
        phase_train_parity()

    # launches: serving for the forward and LN kernels, the flagship
    # trainer for the single-pass backward, the 4096-prim trainer for the
    # two-pass pair
    launches.update(flash_attn_bwd=train["flash_attn_bwd"],
                    flash_attn_bwd_dq=train_long["flash_attn_bwd_dq"],
                    flash_attn_bwd_dkv=train_long["flash_attn_bwd_dkv"])
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
