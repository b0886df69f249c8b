#!/usr/bin/env python3
"""Drive the PyTorch port (``topiaxl_torch``) once on one CUDA card.

    python3 chip_smoke.py

Phases (each prints one line with its seconds; any failure raises and
the script exits non-zero without a result line):

1. device: a CUDA card must be present; prints its name and power limit.
2. build: compiles ``topiaxl_torch/csrc/*.cu`` from this checkout (no
   kernel may spill, and ptxas may serialise no wgmma of the flash
   forward) and the host stages' C++ library
   (``topiaxl_torch/native``, g++).
3. kernels: each kernel against its plain PyTorch version at the main
   path's shapes, in bf16 on the card, with max error and times, beside
   its bound (the larger of its FLOPs over 989 TFLOP/s and its bytes over
   3.35 TB/s, counted from the shapes) and, where one PyTorch call
   computes the same function, that call's time (``library_ms``:
   ``scaled_dot_product_attention`` and its flash backward, used here as
   a yardstick and nowhere in the port).
4. probes: the three tensor-core probe kernels (``csrc/mma_probe.cu``:
   the int8/bf16 rate loop and the attention dot forms) against their
   plain versions at the probe path's shapes, with planted faults, each
   form's time, bound and the PyTorch call that computes one product,
   the blocks that share each output tile (S) and the launch's block
   count, and whether two launches give the same bits (they must).
5. probe_path: ``python -m topiaxl_torch.benchmarks.microbench_int8`` and
   ``...exp_dot_forms`` as a user runs them (their ``main``), with the
   launch counters zeroed before and read after.
6. serving: ``topiaxl_torch.cli.infer.main`` on two synthetic images at
   the flagship config (``configs/inference_dit.yml``, random weights,
   no GLB export), with the exact kernel launch counts per image, and
   the flash forwards by tile layout: the chain's 1,400 split (head dim
   72) and DINOv2's 12 swizzled (64), and by loop: all 1,412 overlapped,
   the same for the image whose chain ran eager and was captured (the
   first) and the one that replayed it.
7. serving_int8: the same with ``model.generator.quant=true`` (W8A8), in
   turns with bf16 (int8, bf16, int8 after phase 6's bf16): stage 1 of
   each run's warm image, and the same launch counts.
8. serving_pos_emb: one image with ``model.generator.class_name=
   topiaxl.DiTAdditivePosEmb`` (the registry builds the point-embedding
   DiT), with the same launch counts.
9. serving_samplers: ``inference.sampler=dpm`` on a 12-step chain and
   ``ancestral`` on 25, one image each, with the launches of that many
   steps.
10. stage 2: ``extract_glb`` on a 2048-prim sphere shell at mc 256,
    decimate 100k, texture 1024; the GLB must parse and lie on the
    sphere.
11. dit: one full-width, depth-2 DiT CFG step on the card (bf16, kernels)
    against the same weights on the CPU (f32, plain versions).
12. dit_int8: the same step with both DiTs W8A8 from the same int8
    weights (the card's activations bf16, the CPU's f32).
13. train: ``topiaxl_torch.cli.train.main`` at the flagship config
    (synthetic data, batch 8, random init) for 6 steps, then a resume
    from its checkpoint for one more, with the exact kernel launch counts
    per step, finite losses and gradient norms, step time and peak memory.
14. train_remat: two steps of the same recipe with
    ``model.generator.gradient_checkpointing=true`` (each block recomputed
    in the backward: its launches doubled), step time and peak memory
    beside the plain trainer's. Then train_remat_policies: three
    ``make_train_step`` steps under each remat mode (``remat=True`` twice,
    plain, ``dots``, ``dots_plus``, ``flash``, ``flash_mlp``) from one set
    of enlivened weights and draws, with each step's launches (the counts
    tests/test_torch_remat.py holds on the CPU), step seconds, peak memory
    and the forward and backward's own peak; each policy's loss and grad
    norm against ``remat=True``'s at steps 1 and 2, beside a planted fault
    (the flash output kept without its graph to q, k, v); and one
    depth-2 ``cli.train`` step with ``model.generator.remat=flash``.
15. train_long: the same trainer at 4096 prims (depth 2, batch 2): the
    self-attention's 4096 keys take the single pass, as every key length
    at head dim 72 does.
16. train_parity: one full-width, depth-2 training step's loss and
    gradients on the card (bf16, kernels) against the CPU (f32, plain),
    and a control step whose attention backward leaves out delta, which
    must fail the bars.
17. prepare_data: ``topiaxl_torch.cli.prepare_data.main`` on two meshes
    written here (a 20480-face icosphere and a concave box less a sphere)
    at the flagship config, 150 shape steps in a 250-step fit: 12 flash
    forwards an asset and no other launch; the shard's shapes; each fitted
    field's held-out SDF error below half the zero payload's; ``MeshSDF``
    card vs CPU at 8192 points and its peak memory; one fit step's loss
    and gradients card vs CPU with a planted fault; seconds an asset
    (mesh SDF, fit, encode, condition), ms a fit step, peak memory.
18. train_from_shards: ``cli.train`` on that shard at the flagship width,
    batch 2, two steps, with the trainer's exact launches.
19. train_vae: the flagship VAE (bf16 compute, f32 masters) for 20 Adam
    steps on the 2048 fitted payloads of one asset: the loss falls; step
    1 card vs CPU in f32 with a planted fault; ms a step, peak memory.

20. clip: both CLIP towers (``models/conditioner/clip.py``) at the JAX
    defaults (B/32) and at CLIP ViT-L/14's published widths, random
    weights, card vs CPU with planted faults, ms per batch of 8; then one
    image served through ``cli.infer`` on B/32's 50 tokens to a GLB
    (``CLIPImageEncoder`` with ``tokens``, read from a transformers-layout
    directory this phase writes; stage 2 at mc 128, decimated to 5000
    faces, box unwrap),
    with the chain's exact launches (flash for self-attention only: 50
    keys take the plain form).
21. vgg: the masked VGG19 loss at 512², batch 4, card vs CPU with a
    planted fault, its ms and peak memory.
22. ring: ring attention over P token blocks emulated in one process
    (``ops/ring_attention.py``'s ``LocalRing``: the ranks' code with the
    rotation in memory) at the flagship shape (P = 2, 4) and at 8192
    prims (P = 2), every block's backward the single pass, against one
    flash forward and backward over the whole sequence, with the
    block's-own-lse fault, its launches of #1 and #4-#6 and its ms.
23. dp: ``cli.train`` with ``train.mesh.dp=-1`` over two ranks on the
    one card (``torchrun``; gloo, which NCCL's one-rank-a-card rule
    leaves) at the flagship width (``DP_DEPTH`` blocks, remat, every run
    resumed from one step-0 checkpoint whose zero-init layers are filled),
    against one process at the same global batch of 8: losses, grad norms,
    Adam moments, parameters; then the same under two planted faults (no
    gradient sync; both ranks on the same rows).
24. tp: two ranks on the one card (``torchrun``, gloo) at dp 1 x tp 2:
    ``generate_primx_sharded`` with ``dit_param_rules()`` at a depth of
    ``TP_GEN_DEPTH`` = 8 on a 5-step DDIM chain (two assets) and two
    ``cli.train``
    steps at ``train.mesh={dp: 1, tp: 2}`` (flagship width at 4 blocks,
    remat, batch 8, lr 1e-5, resumed from a step-0 checkpoint whose
    zero-init layers are filled, its gates at 1),
    each against one process on the same inputs and beside the planted
    fault (qkv's rows split as one block); per rank the flash forwards by
    head count (8), the launches, step time and peak memory.
25. pp: ``make_pp_train_step`` at pp 2 and pp 4 over ``PP_DEPTH`` = 8
    blocks (4 and 2 a stage), ``n_micro`` 4, flagship width, batch 8,
    against one process's
    ``make_train_step``: loss, grad norm, Adam mu, update; step time, the
    GPipe bubble and each stage's peak memory and launches.
26. restore: a tp = 2 ``cli.train`` run's checkpoint (flagship width,
    depth 4) restores into one process bit for bit (``sharded_restore``),
    and step 3 resumed there has the loss of step 3 resumed on tp = 2.
27. app: ``App.run`` (``topiaxl_torch/app.py``) on one synthetic image at
    the flagship config (stage 2 at mc 128, 5000 faces): a GLB that
    parses, and the serving launches of one image.
28. bench: ``python -m topiaxl_torch.bench --fast`` in its own process
    (every section of the port's benchmark, one warm image -> GLB run and
    four pipelined assets): exit 0, a last line with every key
    (``BENCH_KEYS``), an MFU in (0, 1), an albedo PSNR above 30 dB, the
    flash parity passed; its last line and seconds printed.

After the kernels phase, flash_head_dims runs the flash forward (#1), the
single-pass backward (#4) and the pair (#5, #6) at head dims 80, 96, 128
and 256 (their own instances) and 36, 88, 160 and 200 (zero-padded by the
launchers to 64, 96 and 256) on the flagship's 2 x 2048 x {2048, 1370} x
16, the head dims above 128 also at 2 x 4096 x 4096 x 16, each against
its plain version at the kernels phase's bars, with a scale computed from
the padded head dim as a planted fault, ms beside the bound, SDPA's and
the old form's in the log only (before the wide heads' redesign, copied
from PERF.md, not measured by the run), the backward form the shape rule
takes (``bwd_form``; ``flash_attention_backward`` launches that form and
no other, within the bar), and the redesigned forms' own planted faults:
the forward above 80 with its second O column half left
unrescaled, the 256 backward's dQ without its first 64-key block; each
forward's launch counted under its loop (``fwd_loop``: ``pingpong`` above
72, ``overlapped`` at 36, padded to 64). Then the forward's overlapped
loop at head dim 72 on the serving chain's 2 x 2048 x 2048 x 16 and 1 x
2048 x 1370 x 16 (``fwd_overlap_row``: o and lse within the bars, the
unmasked-padding fault above, one launch under ``overlapped``, ms beside
the bound; ss_flow runs it at TRELLIS's shapes too); then
the single pass (its overlapped loop) beside the pair at head dim 72 on
the flagship trainer's 8 x 2048 x {2048, 1370} x 16 and at 2 x 4096 x 4096
x 16 (``bwd_side_by_side``: both within the bar, the wrapper's one launch
under the ``overlapped`` loop, the single pass faster past 2048 keys); and
the ring over two blocks at head dims 36 and 80. Its rows go into each
kernel's entry of the kernels line under ``head_dims``. The kernels
phase prints the flagship rows (D 64 / 72) beside PERF.md's, and the
script its total seconds before the kernels line.

After serving_samplers, chain_graph holds ``sample_tokens``' CUDA graph
(``pipelines/chain_graph.py``) against the eager chain at the flagship
width, bf16 and W8A8, for ddim, dpm and ancestral (a CUDA generator): bit
for bit at the first call, at a replay and for a second asset, a planted
fault (y not copied in) above the bar, exact launches, the capture's
seconds, wall ms graphed and eager and the idle shares. Every serving
phase, serve_assets, app and bench print the captures and replays their
chains made (the CLI: one capture a run, a replay for each later image).

After flash_head_dims, ss_flow runs the kernels of TRELLIS's
sparse-structure flow transformer at its training shapes (batch 8, 16
heads of 64): the QK-norm forward and backward (``csrc/qk_rmsnorm.cu``) on
q read in place from a fused qkv tensor at 8 x 4096 x 16 x 64, flash #1
at 8 x 4096 x {4096, 1374} x 16 x 64, and the single pass (#4) beside
the pair (#5, #6) at both (the rule takes the single pass), each against
its plain version (the attention on the batch's first two rows, which the
plain version's f32 logits fit), a planted fault above each bar, ms
beside the bound (bytes for the QK norm, operations for flash). After
train_long, ss_flow_train runs ``cli.train`` on
``configs/trellis_ss_flow.yml`` at the published widths for three steps
(synthetic stream, batch 8): each step's exact launches
(``SS_FLOW_LAUNCHES``) and single-pass backwards by loop (48
``overlapped``), finite losses, step seconds and peak memory. Their rows print as ``{"ss_flow": ...}`` before the kernels
line. After ss_flow_train, mmdit runs Hunyuan3D-2's shape DiT's kernels at
its training shapes (batch 4, 16 heads of 64): the QK norm's rms form on
q read in place from a single block's linear1 rows at 4 x 4442 x 16 x 64,
flash #1 and #4 beside the pair at the joint shape 4 x 4442 x 4442 x 16 x
64 (a ragged last q tile), then three ``cli.train`` steps of
``configs/hunyuan3d_dit.yml`` (``MMDIT_LAUNCHES``, 48 ``overlapped``
backwards a step); its rows print as ``{"mmdit": ...}``. After mmdit, h21
runs Hunyuan3D-2.1's shape DiT's kernels at its training shapes (batch 2,
16 heads of 128): the QK norm's rms form at 2 x 4097 x 16 x 128, flash #1
(its ping-pong loop) and the backward the rule takes (the pair over 4097
keys, the single pass over 1370) beside the other form at 2 x 4097 x
{4097, 1370} x 16 x 128 (ragged last q and key tiles), both LN kernels
at 2 x 4097 x 2048 with the blocks' operands, one MoE block at
the published widths forward and backward with no host sync and its
grouped product's rate, then three ``cli.train`` steps of
``configs/hunyuan3d21_dit.yml`` (``H21_LAUNCHES``, 13 ``serial``
backwards a step, every MoE layer's slots 2 x 8194 a step); its rows
print as ``{"h21": ...}``.

After ss_flow, adamw_ema runs the trainers' clip + AdamW + EMA kernel
(``csrc/adamw_ema.cu``) on each trainer's parameters as ``cli.train``
builds them (the flagship DiT, TRELLIS's flow transformer, Hunyuan3D-2's
shape DiT): one step against the plain foreach version with a planted
fault (no second-moment bias correction), one launch a call, ms beside
its 36 B-a-parameter bound, the plain version's ms and
``torch.optim.AdamW(fused=True)``'s (a yardstick the port never calls),
and the host's median ms a call of ``fused_adamw_ema_update``, the kernel's
wrapper and the plain version, the card idle at each; its rows print
as ``{"adamw_ema": ...}``. Every training phase's launch table holds one
``adamw_ema`` launch a step; serving, stage 2 and data preparation none.

The serving phases (6-9) also check each image's ``recon.jpg`` (the
renderer's frontal rgb | prim-box snapshot, 518 x 1036) and print its
seconds. After stage 2 come four phases of the renderer, U^2-Net and
multi-asset serving (plain PyTorch; they launch no counted kernel of
their own):

- render: ``visualize_primvolume`` of the 2048-prim sphere at 518², its
  alpha silhouette against the sphere's projected disc, the pair's ms and
  peak memory; ``render_primx`` on the card against the CPU at 64² with a
  planted fault (no border fade); one orbit video (``view_counts=3``),
  its files and ms per frame.
- matting: the CLI on one image with ``inference.matting=u2net`` and a
  randomised full ``u2net`` ``.pth`` (same launches as serving), and the
  network on the card against the CPU at 320², with its ms.
- conditioner_render: ``condition_from_primx`` on two sphere assets at
  518² through the flagship DINOv2 (12 flash launches), and the registry's
  ``topiaxl.ImageMultiViewConditioner`` with two views.
- serve_assets: four DINOv2-encoded images through the flagship DiT and
  VAE, stage 2 on the sphere asset (mc 256, decimate 100k, texture 1024,
  box unwrap), serially, pipelined and batched two at a time: assets per
  minute each, the exact launches of every chain, every GLB on the sphere.

Phase 3 also runs the flash forward at one tp = 2 rank's 8 heads
(2x2048x2048 and 2x2048x1370) and the single-pass backward at 8x2048x2048
with 8 heads. It also holds the forward's output and lse, the three backward
kernels and the LN kernels against their plain versions at the training
shapes (batch 8 for the flagship, 4096 prims at batch 2), with planted
faults that must land above each bar; past 2048 keys the two-pass pair,
off the rule's route at head dim 72, is checked and timed beside the
single pass and must repeat its gradients bit for bit. The flagship
trainer's steps also count their single-pass backwards by loop (56
``overlapped``).

The second-to-last line is ``{"kernels": [...]}``; the last is
``{"ok": true, "device": {...}}``. Imports nothing of JAX and nothing of
the JAX package (``topiaxl``).
"""

from __future__ import annotations

import functools
import gc
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
FLAGSHIP = os.path.join(ROOT, "configs", "inference_dit.yml")

# the probes run on no path of the system but their own
NO_PROBES = {"mma_rate_loop": 0, "dot_form_chain": 0, "dot_form_accum": 0}
# the QK norm runs on TRELLIS's flow transformer (models/ss_flow.py; the
# l2 form) and Hunyuan3D-2's shape DiT (models/mmdit.py; the rms form) only
NO_QK_NORM = {"qk_rmsnorm": 0, "qk_rmsnorm_bwd": 0, "qk_rmsnorm_rms": 0,
              "qk_rmsnorm_rms_bwd": 0}
# per image at the flagship config: DINOv2's 12 blocks + 25 DDIM steps x
# 28 DiT blocks x (self + cross); 25 x (28 blocks + final layer); 25 x 28 x 2;
# serving runs no backward kernel and no optimizer
EXPECTED_LAUNCHES = {"flash_attn_fwd": 12 + 25 * 56, "flash_attn_bwd": 0,
                     "flash_attn_bwd_dq": 0, "flash_attn_bwd_dkv": 0,
                     "ln_modulate": 25 * 29,
                     "ln_modulate_residual": 25 * 56, **NO_PROBES,
                     **NO_QK_NORM, "adamw_ema": 0}
# the same image's flash forwards by tile layout (flash_attention.
# fwd_tile_layout): the chain's 1,400 at head dim 72 split (a swizzled
# 64-column box and one 8-column chunk), DINOv2's 12 at 64 one swizzled box
EXPECTED_FWD_LAYOUTS = {"split": 25 * 56, "swizzled": 12}
# and by loop (flash_attention.fwd_loop): every one at head dims 72 and 64
# in the overlapped loop
EXPECTED_FWD_LOOPS = {"overlapped": 25 * 56 + 12, "pingpong": 0}


def train_launches(remat=False, depth: int = 28) -> dict:
    """Kernel launches of one training step (28 blocks: the flagship) by
    remat mode: a forward flash and a single-pass backward launch per self-
    and cross-attention, the LN kernels as in serving, once per block and
    step (+ the final layer). With remat (``True``, gradient_checkpointing)
    each block's forward runs again in the backward: its two flash forwards
    and three LN kernels twice. A remat policy keeps the flash outputs
    (every policy) and the LN outputs (``dots_plus``), whose kernels then
    run once. ``tests/test_torch_remat.py`` counts the same ops on the CPU
    at depth 3. Every step ends in one clip + AdamW + EMA launch."""
    again = 2 if remat is True else 1
    ln_again = 2 if remat and remat != "dots_plus" else 1
    return {"flash_attn_fwd": 2 * depth * again,
            "flash_attn_bwd": 2 * depth, "flash_attn_bwd_dq": 0,
            "flash_attn_bwd_dkv": 0, "ln_modulate": depth * ln_again + 1,
            "ln_modulate_residual": 2 * depth * ln_again, **NO_PROBES,
            **NO_QK_NORM, "adamw_ema": 1}


TRAIN_LAUNCHES = train_launches()
TRAIN_REMAT_LAUNCHES = train_launches(True)
# a flagship step's single-pass backwards by loop (flash_attention.
# bwd_loop): all 56 at head dim 72, the overlapped loop
TRAIN_BWD_LOOPS = {"overlapped": 56, "serial": 0}
# at 4096 prims and depth 2 the self-attention (4096 keys) and the
# cross-attention (1370 keys) take the single pass, as at every key length
# at head dim 72
TRAIN_LONG_LAUNCHES = {"flash_attn_fwd": 4, "flash_attn_bwd": 4,
                       "flash_attn_bwd_dq": 0, "flash_attn_bwd_dkv": 0,
                       "ln_modulate": 3, "ln_modulate_residual": 4,
                       **NO_PROBES, **NO_QK_NORM, "adamw_ema": 1}
# one training step of TRELLIS's flow transformer (24 blocks, 16 heads of
# 64): flash forwards for self-attention (4096 keys) and cross-attention
# (1374), the single pass (its overlapped loop) for both backwards, the QK
# norm on q and k, the LN kernels three a block, one optimizer update
SS_FLOW_LAUNCHES = {"flash_attn_fwd": 48, "flash_attn_bwd": 48,
                    "flash_attn_bwd_dq": 0, "flash_attn_bwd_dkv": 0,
                    "ln_modulate": 24, "ln_modulate_residual": 48,
                    **NO_QK_NORM, "qk_rmsnorm": 48, "qk_rmsnorm_bwd": 48,
                    **NO_PROBES, "adamw_ema": 1}
SS_FLOW_BWD_LOOPS = {"overlapped": 48, "serial": 0}
SS_FLOW_CONFIG = os.path.join(ROOT, "configs", "trellis_ss_flow.yml")
# one training step of Hunyuan3D-2's shape DiT (16 double and 32 single
# blocks, 16 heads of 64, 3072 + 1370 tokens joined): a flash forward and
# a single-pass backward (its overlapped loop) a block over 4442 keys; the
# rms QK norm on q and k of each stream of a double block and of each
# single block; LN+modulate before each stream's attention and each single
# block, LN+modulate+residual into each stream's MLP, one optimizer update
MMDIT_LAUNCHES = {"flash_attn_fwd": 48, "flash_attn_bwd": 48,
                  "flash_attn_bwd_dq": 0, "flash_attn_bwd_dkv": 0,
                  "ln_modulate": 64, "ln_modulate_residual": 32,
                  **NO_QK_NORM, "qk_rmsnorm_rms": 128,
                  "qk_rmsnorm_rms_bwd": 128, **NO_PROBES, "adamw_ema": 1}
MMDIT_BWD_LOOPS = {"overlapped": 48, "serial": 0}
MMDIT_CONFIG = os.path.join(ROOT, "configs", "hunyuan3d_dit.yml")
# one training step of Hunyuan3D-2.1's shape DiT as configs/hunyuan3d21_dit.yml
# cuts it (13 blocks, 16 heads of 128, 4096 latent tokens and the time
# token, 1370 conditioning tokens): in each block a flash forward over 4097
# and over 1370 keys (the ping-pong loop at 128), the pair for the
# self-attention's backward (past FUSED_BWD_MAX_KEYS at 80-128) and the
# single pass (its serial loop at 128) for the cross-attention's; the rms
# QK norm on the self-attention's q and k and the cross-attention's q and
# k; LN+modulate for norm1 in every block and skip_norm in the 6 skip
# blocks, LN+modulate+residual for norm2 and norm3; one optimizer update.
# The experts' grouped products are PyTorch's (torch._grouped_mm): no
# counted kernel.
H21_LAUNCHES = {"flash_attn_fwd": 26, "flash_attn_bwd": 13,
                "flash_attn_bwd_dq": 13, "flash_attn_bwd_dkv": 13,
                "ln_modulate": 19, "ln_modulate_residual": 26,
                **NO_QK_NORM, "qk_rmsnorm_rms": 52, "qk_rmsnorm_rms_bwd": 52,
                **NO_PROBES, "adamw_ema": 1}
H21_BWD_LOOPS = {"overlapped": 0, "serial": 13}
H21_CONFIG = os.path.join(ROOT, "configs", "hunyuan3d21_dit.yml")
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
# remat against the plain trainer, the same seed and synthetic batches:
# |remat - plain| / |plain| of each of the first two steps' loss and grad
# norm. The forward kernels are deterministic, so the step-1 loss agrees
# to f32 rounding; the single-pass backward adds dq in an order that may
# vary from run to run, which can move the grad norm (and through the
# update the step-2 loss) in its last f32 digits. Recomputing a block
# with other inputs (a wrong RNG or drop mask) moves them by far more.
REMAT_REL_BAR = 1e-4
# train_remat_policies: each remat policy against remat=True on filled
# weights and the same draws, |policy - remat=True| / |remat=True| of the
# loss and the grad norm. Step 1 is held at REMAT_REL_BAR (the same
# forward; the grad norm moves with the single pass's dq order). Step 2
# at the second bar: Adam's first update moves each weight by about lr *
# sign(g), so gradient entries near 0 whose sign the dq order flips move
# step 2. On an H100, over two runs, the policies read a step-1 loss equal
# to remat=True's and grad norms 2.3e-7 to 4.7e-6 from it, at step 2 up to
# 1.8e-5 / 9.9e-5 (a second remat=True run up to 3.4e-6, then 2.2e-5 /
# 1.2e-4; the plain step up to 2.9e-6, then 2.1e-5 / 4.5e-5); the planted
# fault 1.05e-3 to 1.06e-3 at step 1's grad norm, then 1.5e-2 / 3.2e-3.
REMAT_STEP_BARS = (REMAT_REL_BAR, 1e-3)
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
# probes: int8 exact (int32 sums); bf16 max |kernel - plain| / max |plain|
# (f32 sums of exact bf16 products, in another order: the kernel stages
# 256 bytes of the contraction at a time). Planted faults: the rate loop
# with every coefficient +1; every dot form with one product fewer (1/64
# and 1/512 of the sum); a contraction of 72 with its pad filled with
# ones; an output width of 72 with its last 8 left zero.
PROBE_REL_BAR = 1e-3
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

# render: the 2048-prim sphere at 518² (focal 1054.7 px, principal point
# 259): its projected disc has radius f r / sqrt(d^2 - r^2) = 116.7 px. The
# opaque pixels (alpha > 0.5) have the disc's area to within
# RENDER_AREA_PX of radius; none lies beyond the disc by more than
# RENDER_EDGE_PX (the prims' payload reaches 0.07 past the surface, ~1/3
# voxel of alpha blur) and RENDER_FILL of the pixels inside the disc less
# RENDER_EDGE_PX are opaque (a few rays miss the sparse alpha shell).
RENDER_AREA_PX = 3.0
RENDER_EDGE_PX = 8.0
RENDER_FILL = 0.97
# render_primx card vs CPU (f32 both, 64²): rgb max |card - cpu| / max
# |cpu rgb|, alpha max |card - cpu|; the march without its border fade must
# land above one of them
RENDER_RGB_REL = 1e-3
RENDER_ALPHA_ABS = 1e-4
# U^2-Net card vs CPU (f32 both, TF32 off, 320²): max |card - cpu| over the
# CPU saliency's spread (max - min); upsampling with aligned corners (a
# planted fault) must land above it
U2NET_REL_BAR = 1e-3

# prepare_data: per mesh, DINOv2's 12 flash forwards (one rendered view)
# and nothing else: the fit, the mesh SDF and the VAE (64 tokens, head dim
# 32, einsum attention) run no counted kernel
PREP_LAUNCHES = dict({k: 0 for k in EXPECTED_LAUNCHES}, flash_attn_fwd=12)
# one fit step at full width (2048 prims of 8^3 x 6, 8192 points), card
# against CPU, f32 on both (TF32 off): loss |card - cpu| / |cpu| and each
# gradient's max |card - cpu| / max |cpu|. They sum in other orders, and
# the card's gather backward is a scatter-add in a varying order. The
# volume term with scale in place of 1/scale (a planted fault) must land
# above a bar.
FIT_LOSS_BAR = 1e-5
FIT_GRAD_BAR = 1e-4
# MeshSDF card vs CPU: |distance| (the closest-point arithmetic in f32,
# fused differently); signs exact on the convex icosphere, where the faces
# of an argmin tie all give the same sign; on the concave bowl only printed
MESH_SDF_ABS_BAR = 1e-5
# train_vae: step 1 of the flagship VAE on 32 fitted payloads, card against
# CPU, f32 on both (TF32 off), the same posterior draw: loss and grad norm
# relative; decoding the posterior's mode instead of its draw (a planted
# fault) must land above a bar. Over 20 bf16 steps on 2048 payloads the
# mean of the last five losses must fall below VAE_FALL of the first five's.
VAE_LOSS_BAR = 1e-5
VAE_GNORM_BAR = 1e-4
VAE_FALL = 0.7
# clip: each tower card vs CPU, f32 on both (TF32 off): max |card - cpu| /
# max |cpu| of pooled and last_hidden_state; the planted faults (the text
# tower pooling at the last position or attending without its causal mask,
# the vision tower pooling a patch token or skipping its pre-LayerNorm)
# must land above it. The widths: the JAX towers' defaults (B/32) and CLIP
# ViT-L/14's published ones.
CLIP_REL_BAR = 1e-4
CLIP_WIDTHS = {
    "B/32": ({}, {}),
    "L/14": (dict(hidden_size=768, num_layers=12, num_heads=12, mlp_dim=3072),
             dict(hidden_size=1024, num_layers=24, num_heads=16, mlp_dim=4096,
                  patch_size=14)),
}
# vgg: the masked VGG19 loss at 512², batch 4, card vs CPU (f32, TF32 off),
# relative; the loss without its mask (a planted fault) must land above it
VGG_REL_BAR = 1e-4
# ring: the ring emulated in one process (LocalRing) against one flash
# forward and backward over the whole sequence, at the flash kernels' bars
# (max |ring - one launch| / max |one launch|); the backward against each
# block's own o and lse (a planted fault) must land above the backward's
RING_CASES = (("flagship", 2, 2048, (2, 4)), ("8192 prims", 1, 8192, (2,)))
# dp: cli.train over two ranks on the one card (train.mesh.dp=-1, batch 4 a
# rank) against one process at batch 8, the flagship DiT with remat, lr
# from step 0: each step's loss and grad norm, Adam's first moment (norm of
# the difference over norm), and the parameters' update (norm of the
# difference over the update's norm: Adam's first step moves each weight by
# about lr * sign(g), so a gradient entry near 0 whose sign rounding flips
# moves by 2 lr, and bf16 weight gradients summed per rank round apart).
# On the DiT's random init every block is the identity (its adaLN zero),
# and on an H100 sound ranks read 0 / 1.8e-5 / 2.9e-3 / 3.2e-2; ranks
# without the gradient sync 7.6e-6 / 0.42 / 1.05 / 1.20, ranks on the same
# rows 9.7e-4 / 7.7e-2 / 0.94 / 1.30, at 28, 8 and 4 blocks alike. Every
# run now resumes one step-0 checkpoint whose zero-init layers are filled
# (seed_checkpoint): at 4 blocks sound ranks read 2.6e-6 / 1.1e-5 /
# 1.5e-3 / 2.8e-3, without the sync 1.8e-3 / 8.1e-3 / 8.9e-2 / 0.56, on
# the same rows 1.3e-3 / 1.6e-3 / 4.4e-2 / 0.27: each fault crosses every
# bar. At DP_DEPTH = 2 (two runs) sound ranks read 2.3e-6-5.9e-6 /
# 7.6e-6-1.2e-5 / 1.45e-3 / 2.3e-3-2.4e-3, without the sync 7.1e-4 /
# 4.2e-3 / 7.3e-2 / 0.53, on the same rows 2.3e-3 / 3.1e-3 / 4.3e-2 /
# 0.28: each fault still crosses every bar, and sound ranks stay 13x or
# more under each. Each bar sits between the sound reading and the
# faults', and each fault must cross one
# the dp phase's depth: the whole script's time; each of its checkpoints
# is 13.6 GB at 28 blocks (the phase took 82 s at 4 blocks on one H100
# machine)
DP_DEPTH = 2
DP_LOSS_REL = 1e-4
DP_GNORM_REL = 1e-3
DP_MU_REL = 2e-2
DP_UPDATE_REL = 0.2

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
    "flash_attn_bwd_dkv": ("topiaxl_torch/csrc/flash_attn_bwd_sm90.cu",
                           "topiaxl/ops/flash_attention.py:469"),
    "ln_modulate": ("topiaxl_torch/csrc/ln_modulate.cu",
                    "topiaxl/ops/fused_ln.py:30"),
    "ln_modulate_residual": ("topiaxl_torch/csrc/ln_modulate.cu",
                             "topiaxl/ops/fused_ln.py:108"),
    "mma_rate_loop": ("topiaxl_torch/csrc/mma_probe.cu",
                      "benchmarks/microbench_pallas_int8.py:22"),
    "dot_form_chain": ("topiaxl_torch/csrc/mma_probe.cu",
                       "benchmarks/exp_dot_forms.py:35"),
    "dot_form_accum": ("topiaxl_torch/csrc/mma_probe.cu",
                       "benchmarks/exp_dot_forms2.py:37"),
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
                          "flash_bwd_overlap_kernel",
                          "flash_bwd_wide_kernel", "flash_bwd_dq_kernel",
                          "ln_modulate_kernel", "qk_rmsnorm_fwd_kernel",
                          "qk_rmsnorm_bwd_kernel", "adamw_ema_kernel",
                          "mma_probe_kernel", "reduce_splits_kernel"):
                if short in name:
                    name = short + name.split(short)[1].split("EEv")[0]
        elif "spill stores" in line:
            spill = line.strip()
        elif "Performance Loss" in line:   # e.g. wgmma serialised (C7514)
            out.append(f"  {line.strip()}")
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
    spills = [line for line in summary if " 0 bytes spill stores" not in line
              and "Performance Loss" not in line]
    if spills:
        raise AssertionError(f"kernels spill registers: {spills}")
    # the forward's wgmmas run unserialised (flash_attn_fwd.cu's header)
    serialised = [line for line in summary if "Performance Loss" in line
                  and "flash_fwd_kernel" in line]
    if serialised:
        raise AssertionError(f"ptxas serialises the flash forward's wgmmas: "
                             f"{serialised}")
    # the host stages' C++ library (g++): built here, from this checkout,
    # so that the stage 2 phase is known to run the C++ stages and not
    # their numpy fall-backs, and times stage 2 and not the build; a failed
    # g++ raises
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
    cross-attention at batch 8, the 4096-prim trainer's at batch 2, and a
    ragged shape past 2048 keys whose padded q rows and keys the kernels
    must mask, each through the shape rule (the single pass at head dim
    72). Past 2048 keys the two-pass pair, which the rule no longer takes
    at 72, is checked and timed on the same inputs as the single pass's
    yardstick, and must give bitwise-equal gradients in two launches."""
    import torch

    from topiaxl_torch.ops import flash_attention as fa

    cases = [("dit_self", 8, 2048, 2048, 16, 72, 72 ** -0.5, True),
             ("dit_cross", 8, 2048, 1370, 16, 72, 72 ** -1.0, False),
             ("dit_self_tp2", 8, 2048, 2048, 8, 72, 72 ** -0.5, True),
             ("long_self", 2, 4096, 4096, 16, 72, 72 ** -0.5, True),
             ("long_cross", 2, 4096, 1370, 16, 72, 72 ** -1.0, False),
             ("ragged", 1, 1000, 2049, 16, 72, 72 ** -0.5, False)]
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

        form = fa.bwd_form(Sk, D)
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
        names = (["flash_attn_bwd"] if form == "fused"
                 else ["flash_attn_bwd_dq", "flash_attn_bwd_dkv"])
        yardstick = form == "fused" and Sk > fa.FUSED_BWD_MAX_KEYS
        if yardstick:
            names += ["flash_attn_bwd_dq", "flash_attn_bwd_dkv"]
        # each kernel's (max abs, max rel) error: the rule's form's
        errors = dict.fromkeys(names, (max(errs), max(rels)))
        dq_acc = torch.zeros_like(q, dtype=torch.float32)
        dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
        delta = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
        # (delta, dq, dk, dv) of each launch; the dq pass, timed first,
        # writes the delta the dk/dv pass reads
        outs = {"flash_attn_bwd": (None, dq_acc, dk, dv),
                "flash_attn_bwd_dq": (delta, dq, None, None),
                "flash_attn_bwd_dkv": (delta, None, dk, dv)}
        times = {n: cuda_ms(lambda n=n: fa._bwd_launch(
            n, q, k, v, o, lse, do, *outs[n], scale), 10) for n in names}
        plain_ms = cuda_ms(lambda: fa.flash_attention_bwd_plain(
            q, k, v, o, lse, do, scale), 3)
        # the whole backward's bound: its four products (dP, dV, dQ, dK; S
        # recomputed is not counted), each input read once and each output
        # written once (portbench/counts.py:attention_bwd); a pass alone:
        # the products it runs, the dq pass three (S, dP, dQ) writing bf16
        # dq and delta, the dk/dv pass four reading delta, writing dk, dv
        n_q, n_k, n_r = B * Sq * H * D, B * Sk * H * D, B * H * Sq
        flops = 8 * B * H * Sq * Sk * D
        bounds = {"flash_attn_bwd": bound(
                      flops, 2 * (4 * n_q + 4 * n_k) + 4 * n_r),
                  "flash_attn_bwd_dq": bound(
                      6 * B * H * Sq * Sk * D,
                      2 * (3 * n_q + 2 * n_k) + 4 * n_r + 2 * n_q + 4 * n_r),
                  "flash_attn_bwd_dkv": bound(
                      8 * B * H * Sq * Sk * D,
                      2 * (2 * n_q + 2 * n_k) + 8 * n_r + 4 * n_k)}
        lib_ms, how = sdpa_backward_ms(q, k, v, do, scale, 10)
        if yardstick:
            # the pair on the single pass's inputs, its yardstick past 2048
            # keys: within the bar, and bitwise equal across two launches
            # (it writes each gradient once, with no atomics)
            def pair():
                for n in ("flash_attn_bwd_dq", "flash_attn_bwd_dkv"):
                    fa._bwd_launch(n, q, k, v, o, lse, do, *outs[n], scale)
                return dq.clone(), dk.clone(), dv.clone()
            first, again = pair(), pair()
            torch.cuda.synchronize()
            pair_rels = [rel_err(a, b) for a, b in zip(first, ref)]
            pair_abs = max((a.float() - b.float()).abs().max().item()
                           for a, b in zip(first, ref))
            for n in ("flash_attn_bwd_dq", "flash_attn_bwd_dkv"):
                errors[n] = (pair_abs, max(pair_rels))
            same = [torch.equal(a, b) for a, b in zip(first, again)]
            pair_ms = times["flash_attn_bwd_dq"] + times["flash_attn_bwd_dkv"]
            log(f"  the pair at {tag} {shape} (yardstick, not the shape "
                f"rule's route): max rel err dq/dk/dv "
                f"{pair_rels[0]:.3e}/{pair_rels[1]:.3e}/{pair_rels[2]:.3e} "
                f"(bar {ATTN_BWD_REL_BAR}), dq/dk/dv bitwise equal across "
                f"two launches: {same}; {pair_ms:.4f} ms (share of the "
                f"backward's bound {bounds['flash_attn_bwd'][0] / pair_ms:.1%}"
                f"), pair / single pass "
                f"{pair_ms / times['flash_attn_bwd']:.2f}")
            if not (max(pair_rels) <= ATTN_BWD_REL_BAR and all(same)):
                raise AssertionError(f"the pair at {tag}: rel errors "
                                     f"{pair_rels}, repeats {same}")
            del first, again
        del ref
        fault_msg = (f"unmasked-padding fault dq/dk/dv {unmasked[0]:.3e}/"
                     f"{unmasked[1]:.3e}/{unmasked[2]:.3e}"
                     if unmasked else "no padded keys")
        rule_ms = sum(times[n] for n in names[:2 if form == "two_pass" else 1])
        log(f"  backward {tag} {shape} ({form}): max rel err dq/dk/dv "
            f"{rels[0]:.3e}/{rels[1]:.3e}/{rels[2]:.3e} (bar "
            f"{ATTN_BWD_REL_BAR}; no-delta fault dq/dk {no_delta[0]:.3e}/"
            f"{no_delta[1]:.3e}; {fault_msg}), max abs err {max(errs):.3e}, "
            + ", ".join(f"{n} {t:.4f} ms (bound {bounds[n][0]:.4f} ms, "
                        f"{bounds[n][1]}; share {bounds[n][0] / t:.1%})"
                        for n, t in times.items())
            + f" (the rule's form {flops / rule_ms / 1e9:.1f} TFLOP/s of the "
            f"backward's four products), plain backward {plain_ms:.4f} ms, "
            + (f"PyTorch flash backward {lib_ms:.4f} ms ({how}; "
               f"kernels/library {rule_ms / lib_ms:.2f})" if lib_ms else how))
        if form == "fused":
            vs_recorded("flash_attn_bwd", tag, times["flash_attn_bwd"])
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
            entry["max_abs_err"] = max(entry["max_abs_err"], errors[n][0])
            entry["max_rel_err"] = max(entry["max_rel_err"], errors[n][1])
            if "ms" not in entry:
                # library_ms: the whole backward in one call (the pair's
                # two kernels together compute what it computes)
                entry.update(ms=times[n], plain_ms=plain_ms, at=shape,
                             bound_ms=bounds[n][0], bound_by=bounds[n][1],
                             library_ms=lib_ms, library=how)
        del dq_acc, dq, dk, dv, delta, o, lse
        torch.cuda.empty_cache()
    flash["lse_max_abs_err"] = lse_max


# the flagship rows of PERF.md's kernel table (ms on an H100 80GB HBM3 at
# 700 W): the D 64 / 72 instances, the forward's on swizzled tiles (the
# split layout at 72) in its overlapped loop, the backward's single pass in
# its own; the kernels phase prints each reading beside them
FLAGSHIP_MS = {("flash_attn_fwd", "dit_self"): 0.0966,
               ("flash_attn_fwd", "dit_cross"): 0.0386,
               ("flash_attn_fwd", "dinov2"): 0.0201,
               ("flash_attn_bwd", "dit_self"): 0.9357,
               ("flash_attn_bwd", "dit_cross"): 0.6462}
FLAGSHIP_TOL = 0.04


def vs_recorded(name: str, tag: str, ms: float) -> None:
    """Logs ``ms`` beside PERF.md's reading of the same row, if it has one."""
    rec = FLAGSHIP_MS.get((name, tag))
    if rec is not None:
        ratio = ms / rec
        log(f"  {name} {tag}: {ms:.4f} ms against PERF.md's {rec:.4f} ms, "
            f"ratio {ratio:.3f} (within {FLAGSHIP_TOL:.0%}: "
            f"{abs(ratio - 1) <= FLAGSHIP_TOL})")


def phase_kernels() -> dict:
    """Each kernel against its plain version at the main path's shapes."""
    import torch

    from topiaxl_torch.ops.flash_attention import (
        KEY_TILE, flash_attention, flash_attention_plain,
        flash_attention_unmasked)

    dev = torch.device("cuda")
    g = torch.Generator(dev).manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev).bfloat16()

    results = {}
    # (tag, B, Sq, Sk, H, D, scale, q/k/v as strided views of one qkv)
    # the tp rows: one tensor-parallel rank's 8 of the 16 heads (tp = 2)
    cases = [("dit_self", 2, 2048, 2048, 16, 72, 72 ** -0.5, True),
             ("dit_cross", 1, 2048, 1370, 16, 72, 72 ** -1.0, False),
             ("dinov2", 1, 1374, 1374, 12, 64, 64 ** -0.5, True),
             ("dit_self_tp2", 2, 2048, 2048, 8, 72, 72 ** -0.5, True),
             ("dit_cross_tp2", 2, 2048, 1370, 8, 72, 72 ** -1.0, False)]
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
        vs_recorded("flash_attn_fwd", tag, ms)
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
        for name, row in ln_rows(x, delta, gate, sh, sc).items():
            entry = results.setdefault(name, dict(
                max_abs_err=0.0, library_ms=None,
                **{k: row[k] for k in ("ms", "plain_ms", "at", "bound_ms",
                                       "bound_by")}))
            entry["max_abs_err"] = max(entry["max_abs_err"], row["max_abs_err"])
    return results


def ln_rows(x, delta, gate, sh, sc) -> dict:
    """``ln_modulate`` and ``ln_modulate_residual`` on x, delta [B, N, D]
    with the modulation rows gate, shift, scale [B, D] (any batch stride
    the kernels take) against their plain versions: each output within
    one bf16 ulp of the plain result plus ``LN_ABS_SLACK``, the relative
    error printed, the times beside the bound. Returns {name: row}."""
    import torch

    from topiaxl_torch.ops.fused_ln import (
        ln_modulate, ln_modulate_plain, ln_modulate_residual,
        ln_modulate_residual_plain)

    B, N, D = x.shape
    at = f"{B}x{N}x{D}"
    lns = [("ln_modulate", lambda: (ln_modulate(x, sh, sc),),
            lambda: (ln_modulate_plain(x, sh, sc),)),
           ("ln_modulate_residual",
            lambda: ln_modulate_residual(x, delta, gate, sh, sc),
            lambda: ln_modulate_residual_plain(x, delta, gate, sh, sc))]
    rows = {}
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
        n_x, n_mod = B * N * D, B * D
        nbytes = (2 * (2 * n_x + 2 * n_mod) if name == "ln_modulate"
                  else 2 * (4 * n_x + 3 * n_mod))
        bound_ms, bound_by = bound(10 * n_x, nbytes, PEAK_F32_FLOPS)
        log(f"  {name} {at}: max_abs_err {err:.3e}, max rel err "
            f"{rel:.3e} (|ref| >= 1e-3), max excess over 1 bf16 ulp "
            f"{excess:.3e} (bar {LN_ABS_SLACK}), kernel {ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
            f"({bound_by}; kernel/bound {ms / bound_ms:.2f}), library: "
            f"none (no single PyTorch call computes it)")
        if not excess <= LN_ABS_SLACK:
            raise AssertionError(f"{name} at {at}: {excess} over 1 ulp > "
                                 f"{LN_ABS_SLACK}")
        rows[name] = dict(max_abs_err=err, max_rel_err=rel, ms=ms,
                          plain_ms=plain_ms, at=at, bound_ms=bound_ms,
                          bound_by=bound_by)
    return rows


# flash_head_dims: the head dims of the instances past 72 and four that the
# launchers zero-pad (36 -> 64, 88 -> 96, 160 and 200 -> 256), at the
# flagship token counts; the wide heads also at 4096 tokens, where JAX's
# rule takes the pair and the port's (measured here) the single pass
HEAD_DIM_CASES = (80, 96, 128, 36, 88, 256, 160, 200)
HEAD_DIM_SHAPES = (("self", 2, 2048, 2048, 16), ("cross", 2, 2048, 1370, 16))
HEAD_DIM_LONG = ("long", 2, 4096, 4096, 16)
# the forward's overlapped loop at head dim 72 on the serving chain's
# self-attention (CFG's batch 2) and cross-attention (batch 1: the null
# branch takes no cross-attention)
FWD_OVERLAP_72_SHAPES = (("dit_self", 2, 2048, 2048, 16),
                         ("dit_cross", 1, 2048, 1370, 16))
# the overlapped loop at head dim 72 beside the pair: the flagship
# trainer's self- and cross-attention, and 4096 keys
OVERLAP_72_SHAPES = (("dit_self", 8, 2048, 2048, 16),
                     ("dit_cross", 8, 2048, 1370, 16),
                     ("long_self", 2, 4096, 4096, 16))
# the forms before the redesign of the wide heads (forward above 80,
# flash_bwd_wide_kernel at 129-256), ms of forward / single pass / pair on
# an H100 80GB HBM3 at 700 W as PERF.md records them (this phase, before
# the redesign): copies, not readings of this run, so they go into the log
# line beside today's for reference and never into the kernels line;
# None: not recorded
HEAD_DIM_OLD_MS = {
    (80, "self"): (0.1541, 0.3786, 0.4385), (80, "cross"): (0.1155, None, None),
    (96, "self"): (0.1835, 0.4169, 0.4969), (96, "cross"): (0.1364, None, None),
    (128, "self"): (0.2540, 0.5574, 0.6061),
    (128, "cross"): (0.1902, None, None),
    (36, "self"): (0.1255, 0.3665, 0.4237), (36, "cross"): (0.0901, None, None),
    (88, "self"): (0.1802, 0.4134, 0.4997), (88, "cross"): (0.1348, None, None),
    (256, "self"): (0.5015, 4.3028, 2.0038),
    (256, "cross"): (0.3706, 3.1920, 1.3710),
    (256, "long"): (1.9492, 16.3071, 7.2568),
    (160, "self"): (0.5016, 4.2189, 1.9637),
    (160, "cross"): (0.3685, 3.2439, 1.3827),
    (160, "long"): (1.9659, 16.5703, 7.3006),
    (200, "self"): (0.5042, 4.2322, 1.9815),
    (200, "cross"): (0.3720, 3.2351, 1.3763),
    (200, "long"): (1.9919, 16.3707, 7.3365)}


def padded_bwd_launch(form: str, q, k, v, o, lse, do, scale: float):
    """(dq, dk, dv) of one backward form launched on q, k, v, o, dO
    zero-padded in D to their instance, sliced back: ``fused`` (#4) or
    ``pair`` (#5 then #6), whatever the shape rule would take; a callable
    that launches the same kernels again on the padded inputs (for
    timing: the pad is not in it); and one callable a kernel, by name."""
    import torch
    import torch.nn.functional as F

    from topiaxl_torch.ops import flash_attention as fa

    B, Sq, H, D = q.shape
    inst = fa.kernel_head_dim(D)
    qp, kp, vp, op, dop = (F.pad(t, (0, inst - D)) if inst != D else t
                           for t in (q, k, v, o, do))
    dk = torch.empty_like(kp)
    dv = torch.empty_like(vp)
    # the pair's dq pass writes delta for its dk/dv pass; at 256 the
    # single pass writes it for itself
    delta = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    if form == "fused":
        dq = torch.zeros(qp.shape, dtype=torch.float32, device=q.device)
        outs = {"flash_attn_bwd": (delta, dq, dk, dv)}
    else:
        dq = torch.empty_like(qp)
        outs = {"flash_attn_bwd_dq": (delta, dq, None, None),
                "flash_attn_bwd_dkv": (delta, None, dk, dv)}
    parts = {name: (lambda name=name: fa._bwd_launch(
        name, qp, kp, vp, op, lse, dop, *outs[name], scale)) for name in outs}

    def launch():
        for part in parts.values():
            part()

    launch()
    return (dq[..., :D].to(q.dtype), dk[..., :D], dv[..., :D]), launch, parts


def fwd_overlap_row(tag: str, q, k, v, scale: float, nb: int) -> dict:
    """The forward at a head dim whose kernel runs the overlapped loop (64,
    72): o and lse against the plain version on the first ``nb`` batch rows
    (whose f32 logits fit) within ``ATTN_REL_BAR`` and ``LSE_ABS_BAR``, and
    where Sk leaves padded keys the plain version with them unmasked (a
    planted fault) above the bar; one wrapper launch counted under the
    ``"overlapped"`` loop; ms (a CUDA graph of 20 calls, with the lse)
    beside the bound. Returns the row."""
    import torch

    from topiaxl_torch.ops import _cuda
    from topiaxl_torch.ops import flash_attention as fa

    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    shape = f"{B}x{Sq}x{Sk}x{H}x{D}"
    before = dict(_cuda.fwd_loops)
    o, lse = fa._forward(q, k, v, scale, return_lse=True)
    loops = {n: c - before[n] for n, c in _cuda.fwd_loops.items()}
    part = [t[:nb] for t in (q, k, v)]
    o_ref, lse_ref = fa.flash_attention_plain(*part, scale, return_lse=True)
    torch.cuda.synchronize()
    o_rel = rel_err(o[:nb], o_ref)
    lse_err = (lse[:nb] - lse_ref).abs().max().item()
    fault = (rel_err(fa.flash_attention_unmasked(*part, scale), o_ref)
             if Sk % fa.KEY_TILE else None)
    del o, lse, o_ref, lse_ref
    ms = cuda_ms(lambda: fa._forward(q, k, v, scale, return_lse=True), 20)
    bound_ms, bound_by = bound(4 * B * H * Sq * Sk * D,
                               2 * (2 * B * Sq + 2 * B * Sk) * H * D)
    fault_msg = ("no padded keys" if fault is None
                 else f"unmasked-padding fault {fault:.3e}")
    log(f"  overlapped forward at {tag} {shape}: o max rel err {o_rel:.3e} "
        f"(bar {ATTN_REL_BAR}; {fault_msg}), lse {lse_err:.3e} (bar "
        f"{LSE_ABS_BAR}) on the first {nb} rows; {ms:.4f} ms (bound "
        f"{bound_ms:.4f} ms, {bound_by}; share {bound_ms / ms:.1%}); loops "
        f"{loops} ({card_line()})")
    if not (o_rel <= ATTN_REL_BAR and lse_err <= LSE_ABS_BAR):
        raise AssertionError(f"overlapped forward at {tag}: o {o_rel}, lse "
                             f"{lse_err}")
    if fault is not None and not fault > ATTN_REL_BAR:
        raise AssertionError(f"overlapped forward at {tag}: the bar "
                             f"{ATTN_REL_BAR} cannot see unmasked padding "
                             f"({fault})")
    if fa.fwd_loop(D) != "overlapped" or loops != {"overlapped": 1,
                                                   "pingpong": 0}:
        raise AssertionError(f"overlapped forward at {tag}: loops {loops}")
    return dict(at=shape, ms=ms, bound_ms=bound_ms, bound_by=bound_by,
                max_rel_err=o_rel, lse_max_abs_err=lse_err)


def bwd_side_by_side(tag: str, q, k, v, o, lse, do, scale: float,
                     nb: int) -> dict:
    """The single pass (#4) and the pair (#5 then #6) on the same inputs at
    an instance whose single pass runs the overlapped loop (64, 72), where
    the rule takes the single pass at every key length: each against the
    plain backward on the first ``nb`` batch rows (whose f32 logits fit)
    within ``ATTN_BWD_REL_BAR``, the plain backward without delta above
    it; ms of each (a CUDA graph of 5 calls) beside the backward's bound
    (its four products, ``portbench/counts.py:attention_bwd``'s basis);
    the wrapper's launches, one ``flash_attn_bwd`` counted under the
    ``"overlapped"`` loop. Past 2048 keys the single pass must be the
    faster: its ms and the pair's are ``bwd_form``'s evidence. Returns the
    row."""
    import torch

    from topiaxl_torch.ops import _cuda
    from topiaxl_torch.ops import flash_attention as fa

    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    shape = f"{B}x{Sq}x{Sk}x{H}x{D}"
    part = [t[:nb] for t in (q, k, v, o, lse, do)]
    ref = fa.flash_attention_bwd_plain(*part, scale)
    fault = max(rel_err(a, r) for a, r in zip(fa.flash_attention_bwd_plain(
        *part, scale, with_delta=False)[:2], ref[:2]))
    forms = {}
    for form in ("fused", "pair"):
        got, launch, _ = padded_bwd_launch(form, q, k, v, o, lse, do, scale)
        torch.cuda.synchronize()
        forms[form] = ([rel_err(a[:nb], r) for a, r in zip(got, ref)],
                       cuda_ms(launch, 5))
        del got, launch
    names = ("flash_attn_bwd", "flash_attn_bwd_dq", "flash_attn_bwd_dkv")
    before = dict(_cuda.launches), dict(_cuda.bwd_loops)
    grads = fa.flash_attention_backward(q, k, v, o, lse, do, scale)
    torch.cuda.synchronize()
    rule_rel = max(rel_err(a[:nb], r) for a, r in zip(grads, ref))
    launched = {n: _cuda.launches[n] - before[0][n] for n in names}
    loops = {n: c - before[1][n] for n, c in _cuda.bwd_loops.items()}
    del grads, ref
    bound_ms, bound_by = bound(8 * B * H * Sq * Sk * D,
                               2 * B * H * D * (4 * Sq + 4 * Sk) + 4 * B * H * Sq)
    (one_rels, one_ms), (pair_rels, pair_ms) = forms["fused"], forms["pair"]
    form = fa.bwd_form(Sk, D)
    log(f"  backward forms at {tag} {shape}: single pass dq/dk/dv "
        f"{'/'.join(f'{r:.3e}' for r in one_rels)} {one_ms:.4f} ms (share "
        f"{bound_ms / one_ms:.1%}), pair {'/'.join(f'{r:.3e}' for r in pair_rels)} "
        f"{pair_ms:.4f} ms (share {bound_ms / pair_ms:.1%}), pair / single "
        f"pass {pair_ms / one_ms:.2f}; bound {bound_ms:.4f} ms ({bound_by}, "
        f"four products); max rel err on the first {nb} rows (bar "
        f"{ATTN_BWD_REL_BAR}; no-delta fault {fault:.3e}); the rule takes "
        f"{form} (through the wrapper: max rel err {rule_rel:.3e}, launches "
        f"{launched}, loops {loops}) ({card_line()})")
    if not (max(one_rels + pair_rels + [rule_rel]) <= ATTN_BWD_REL_BAR < fault):
        raise AssertionError(f"backward forms at {tag}: single pass "
                             f"{one_rels}, pair {pair_rels}, rule {rule_rel}, "
                             f"fault {fault}")
    if (form != "fused" or launched != dict(zip(names, (1, 0, 0)))
            or loops != {"overlapped": 1, "serial": 0}):
        raise AssertionError(f"backward forms at {tag}: the rule's {form} "
                             f"launched {launched}, loops {loops}")
    if Sk > fa.FUSED_BWD_MAX_KEYS and not one_ms < pair_ms:
        raise AssertionError(f"backward forms at {tag}: the rule takes the "
                             f"single pass past {fa.FUSED_BWD_MAX_KEYS} keys, "
                             f"but it read {one_ms} ms against the pair's "
                             f"{pair_ms}")
    return dict(at=shape, single_pass_ms=one_ms, pair_ms=pair_ms,
                bound_ms=bound_ms, bound_by=bound_by,
                max_rel_err=max(one_rels), pair_max_rel_err=max(pair_rels))


def phase_flash_head_dims() -> dict:
    """Flash #1, #4 and the #5/#6 pair at every head dim in HEAD_DIM_CASES
    on the flagship's token counts (16 heads, batch 2): each against its
    plain version at the kernels phase's bars, a planted fault (the scale
    computed from the padded head dim) above them, ms beside the bound
    (counted at the true head dim), SDPA's and, in the log only, the old
    form's (``HEAD_DIM_OLD_MS``); the backward form ``bwd_form`` takes. The
    redesigned kernels' own faults: for the forward above 80 (O in
    two column halves sharing one softmax) the second half left
    unrescaled, for the 256 backward (dQ summed over 64-key blocks) dQ
    without the first block; each lands above its bar. Then the ring over
    two blocks at a padded head dim. Returns the rows for the kernels
    line."""
    import torch

    from topiaxl_torch.ops import _cuda
    from topiaxl_torch.ops import flash_attention as fa
    from topiaxl_torch.ops.ring_attention import (LocalRing, ring_backward,
                                                  ring_forward)

    card_id = card_line()
    g = torch.Generator("cuda").manual_seed(11)

    def randn(*shape):
        return torch.randn(shape, generator=g, device="cuda").bfloat16()

    rows = {"flash_attn_fwd": [], "flash_attn_bwd": [],
            "flash_attn_bwd_dq": [], "flash_attn_bwd_dkv": []}
    for D in HEAD_DIM_CASES:
        inst = fa.kernel_head_dim(D)
        shapes = HEAD_DIM_SHAPES + ((HEAD_DIM_LONG,) if D > 128 else ())
        for tag, B, Sq, Sk, H in shapes:
            scale = 1.0 / D if tag == "cross" else D ** -0.5
            if tag == "self":
                q, k, v = randn(B, Sq, 3, H, D).unbind(2)
            else:
                q, k, v = randn(B, Sq, H, D), randn(B, Sk, H, D), randn(B, Sk, H, D)
            do = randn(B, Sq, H, D)
            shape = f"{B}x{Sq}x{Sk}x{H}x{D}"
            loops0 = dict(_cuda.fwd_loops)
            o, lse = fa._forward(q, k, v, scale, return_lse=True)
            loops = {n: c - loops0[n] for n, c in _cuda.fwd_loops.items()}
            want_loop = "overlapped" if inst <= 72 else "pingpong"
            if fa.fwd_loop(D) != want_loop or loops[want_loop] != 1:
                raise AssertionError(f"head dim {D} {tag}: forward loops "
                                     f"{loops}, {want_loop} expected")
            o_ref, lse_ref = fa.flash_attention_plain(q, k, v, scale,
                                                      return_lse=True)
            ref = fa.flash_attention_bwd_plain(q, k, v, o, lse, do, scale)
            torch.cuda.synchronize()
            o_rel, lse_err = rel_err(o, o_ref), (lse - lse_ref).abs().max().item()
            o_abs = (o.float() - o_ref.float()).abs().max().item()
            # the planted fault: a launcher that recomputed the scale from
            # the padded head dim (only a padded D can have it)
            fault = bwd_fault = None
            if inst != D:
                fault = rel_err(fa.flash_attention_plain(q, k, v, inst ** -0.5),
                                o_ref)
                bwd_fault = max(rel_err(a, b) for a, b in zip(
                    fa.flash_attention_bwd_plain(q, k, v, o, lse, do,
                                                 inst ** -0.5), ref))
            # the redesigned forms' planted faults (plain versions on the
            # same inputs): the swizzled forward's second O half left
            # unrescaled; the 256 backward's dQ without one key block
            design = {}
            if inst > 80:
                design["o half unrescaled"] = (rel_err(
                    fa.flash_attention_online(q, k, v, scale,
                                              fa.fwd_key_tile(D),
                                              stale_half=True), o_ref),
                    ATTN_REL_BAR)
            if inst == fa.HEAD_DIMS[-1]:
                design["dq without a key block"] = (rel_err(
                    fa.flash_attention_bwd_dq_blocks(q, k, v, o, lse, do,
                                                     scale, drop=0),
                    ref[0]), ATTN_BWD_REL_BAR)
            qp, kp, vp = (torch.nn.functional.pad(t, (0, inst - D))
                          for t in (q, k, v))
            fwd_ms = cuda_ms(lambda: fa._forward(qp, kp, vp, scale, False), 20)
            fwd_bound = bound(4 * B * H * Sq * Sk * D,
                              2 * (2 * B * Sq + 2 * B * Sk) * H * D)
            sdpa_ms, sdpa_how = sdpa_forward_ms(q, k, v, scale, 20)
            forms, pass_ms = {}, {}
            for form in ("fused", "pair"):
                got, launch, parts = padded_bwd_launch(form, q, k, v, o, lse,
                                                       do, scale)
                torch.cuda.synchronize()
                rels = [rel_err(a, b) for a, b in zip(got, ref)]
                errs = [(a.float() - b.float()).abs().max().item()
                        for a, b in zip(got, ref)]
                forms[form] = (rels, max(errs), cuda_ms(launch, 5))
                if form == "pair":   # each pass alone (#6 after #5's delta)
                    pass_ms = {n: cuda_ms(p, 5) for n, p in parts.items()}
            # the wrapper takes the rule's form, and only its kernels
            rule_form = fa.bwd_form(Sk, D)
            before = dict(_cuda.launches)
            rule_rel = max(rel_err(a, b) for a, b in zip(
                fa.flash_attention_backward(q, k, v, o, lse, do, scale), ref))
            torch.cuda.synchronize()
            rule_launches = {n: _cuda.launches[n] - before[n]
                             for n in rows if n != "flash_attn_fwd"}
            want = ({"flash_attn_bwd": 1} if rule_form == "fused" else
                    {"flash_attn_bwd_dq": 1, "flash_attn_bwd_dkv": 1})
            if ({n: c for n, c in rule_launches.items() if c} != want
                    or not rule_rel <= ATTN_BWD_REL_BAR):
                raise AssertionError(f"head dim {D} {tag}: the rule's form "
                                     f"{rule_form} launched {rule_launches}, "
                                     f"grads {rule_rel}")
            plain_fwd = cuda_ms(lambda: fa.flash_attention_plain(
                q, k, v, scale), 3)
            plain_bwd = cuda_ms(lambda: fa.flash_attention_bwd_plain(
                q, k, v, o, lse, do, scale), 2)
            lib_bwd, lib_how = sdpa_backward_ms(q, k, v, do, scale, 5)
            # the whole backward (either form): its four products (dP, dV,
            # dQ, dK; portbench/counts.py:attention_bwd); a pass alone: the
            # products it runs
            n_q, n_k, n_r = B * Sq * H * D, B * Sk * H * D, B * H * Sq
            bounds = {
                "fused": bound(8 * B * H * Sq * Sk * D,
                               2 * (4 * n_q + 4 * n_k) + 4 * n_r),
                "dq": bound(6 * B * H * Sq * Sk * D,
                            2 * (3 * n_q + 2 * n_k) + 8 * n_r + 2 * n_q),
                "dkv": bound(8 * B * H * Sq * Sk * D,
                             2 * (2 * n_q + 2 * n_k) + 8 * n_r + 4 * n_k)}
            pair_bound = bounds["fused"][0]
            fault_msg = (f"; padded-scale fault o {fault:.3e}, grads "
                         f"{bwd_fault:.3e}" if fault is not None
                         else "; own instance") + "".join(
                f"; {name} fault {val:.3e} (bar {bar})"
                for name, (val, bar) in design.items())
            old = HEAD_DIM_OLD_MS.get((D, tag), (None,) * 3)
            old_msg = ", ".join(
                f"{n} {t:.4f}" for n, t in zip(("forward", "single pass",
                                                "pair"), old) if t)
            lib_f = (f"sdpa {sdpa_ms:.4f} ms" if sdpa_ms
                     else f"sdpa: {sdpa_how[:60]}")
            lib_b = (f"PyTorch flash backward {lib_bwd:.4f} ms" if lib_bwd
                     else f"PyTorch flash backward: {lib_how[:60]}")
            log(f"  head dim {D} (instance {inst}) {tag} {shape}: forward o "
                f"max rel err {o_rel:.3e} (bar {ATTN_REL_BAR}), lse "
                f"{lse_err:.3e}; {fwd_ms:.4f} ms (bound {fwd_bound[0]:.4f} ms, "
                f"{fwd_bound[1]}; share {fwd_bound[0] / fwd_ms:.1%}), plain "
                f"{plain_fwd:.4f} ms, {lib_f}; single pass dq/dk/dv "
                f"{'/'.join(f'{r:.3e}' for r in forms['fused'][0])} "
                f"{forms['fused'][2]:.4f} ms (bound {bounds['fused'][0]:.4f}; "
                f"share {bounds['fused'][0] / forms['fused'][2]:.1%}); pair "
                f"{'/'.join(f'{r:.3e}' for r in forms['pair'][0])} "
                f"{forms['pair'][2]:.4f} ms (bound {pair_bound:.4f}; share "
                f"{pair_bound / forms['pair'][2]:.1%}; #5 "
                f"{pass_ms['flash_attn_bwd_dq']:.4f}, #6 "
                f"{pass_ms['flash_attn_bwd_dkv']:.4f} ms alone); plain "
                f"backward {plain_bwd:.4f} ms, {lib_b} (bar "
                f"{ATTN_BWD_REL_BAR}{fault_msg}); the rule takes "
                f"{rule_form} (through the wrapper: max rel err "
                f"{rule_rel:.3e}); the old form's ms (PERF.md): "
                f"{old_msg or 'not recorded'}; the forward's loop "
                f"{want_loop} ({card_id})")
            if not (o_rel <= ATTN_REL_BAR and lse_err <= LSE_ABS_BAR):
                raise AssertionError(f"head dim {D} {tag}: forward {o_rel}, "
                                     f"lse {lse_err}")
            for form, (rels, _, _) in forms.items():
                if not max(rels) <= ATTN_BWD_REL_BAR:
                    raise AssertionError(f"head dim {D} {tag} {form}: {rels}")
            if fault is not None and not (fault > ATTN_REL_BAR
                                          and bwd_fault > ATTN_BWD_REL_BAR):
                raise AssertionError(f"head dim {D} {tag}: the bars cannot see "
                                     f"a padded scale ({fault}, {bwd_fault})")
            for name, (val, bar) in design.items():
                if not val > bar:
                    raise AssertionError(f"head dim {D} {tag}: the bar {bar} "
                                         f"cannot see the fault {name} ({val})")
            at = dict(at=shape, instance=inst, bwd_form=rule_form)
            rows["flash_attn_fwd"].append(dict(
                at, ms=fwd_ms, bound_ms=fwd_bound[0], bound_by=fwd_bound[1],
                plain_ms=plain_fwd, library_ms=sdpa_ms, max_abs_err=o_abs,
                max_rel_err=o_rel))
            rows["flash_attn_bwd"].append(dict(
                at, ms=forms["fused"][2], bound_ms=bounds["fused"][0],
                bound_by=bounds["fused"][1], plain_ms=plain_bwd,
                library_ms=lib_bwd, max_abs_err=forms["fused"][1],
                max_rel_err=max(forms["fused"][0])))
            for name, key in (("flash_attn_bwd_dq", "dq"),
                              ("flash_attn_bwd_dkv", "dkv")):
                rows[name].append(dict(
                    at, ms=pass_ms[name], pair_ms=forms["pair"][2],
                    bound_ms=bounds[key][0],
                    bound_by=bounds[key][1], plain_ms=plain_bwd,
                    library_ms=lib_bwd, max_abs_err=forms["pair"][1],
                    max_rel_err=max(forms["pair"][0])))
            del q, k, v, do, o, lse, o_ref, lse_ref, ref, qp, kp, vp
            torch.cuda.empty_cache()
    # the forward's overlapped loop at head dim 72 on the serving chain's
    # shapes (self-attention on a strided qkv view)
    for tag, B, Sq, Sk, H in FWD_OVERLAP_72_SHAPES:
        D = 72
        if Sq == Sk:
            q, k, v = randn(B, Sq, 3, H, D).unbind(2)
        else:
            q, k, v = randn(B, Sq, H, D), randn(B, Sk, H, D), randn(B, Sk, H, D)
        row = fwd_overlap_row(tag, q, k, v, 1.0 / D if Sq != Sk else
                              D ** -0.5, nb=B)
        rows["flash_attn_fwd"].append(dict(row, instance=D,
                                           loop="overlapped"))
        del q, k, v
        torch.cuda.empty_cache()
    # the overlapped loop at head dim 72 beside the pair, on the flagship
    # trainer's shapes and past 2048 keys
    for tag, B, Sq, Sk, H in OVERLAP_72_SHAPES:
        D = 72
        scale = 1.0 / D if Sq != Sk else D ** -0.5
        if Sq == Sk:
            q, k, v = randn(B, Sq, 3, H, D).unbind(2)
        else:
            q, k, v = randn(B, Sq, H, D), randn(B, Sk, H, D), randn(B, Sk, H, D)
        do = randn(B, Sq, H, D)
        o, lse = fa._forward(q, k, v, scale, return_lse=True)
        row = bwd_side_by_side(tag, q, k, v, o, lse, do, scale, nb=2)
        rows["flash_attn_bwd"].append(dict(row, instance=D, bwd_form="fused",
                                           ms=row["single_pass_ms"]))
        del q, k, v, do, o, lse
        torch.cuda.empty_cache()
    # the ring's per-block launches at a padded and a new head dim
    for D in (36, 80):
        q, k, v, do = (randn(1, 2200, 4, D) for _ in range(4))
        scale = D ** -0.5
        o, lse = fa._forward(q, k, v, scale, return_lse=True)
        ref = fa.flash_attention_backward(q, k, v, o, lse, do, scale)
        parts = [[c.contiguous() for c in t.chunk(2, dim=1)]
                 for t in (q, k, v, do)]
        outs, lses = ring_forward(LocalRing(2), *parts[:3], scale)
        grads = ring_backward(LocalRing(2), *parts[:3], outs, lses, parts[3],
                              scale)
        o_err = rel_err(torch.cat(outs, 1), o)
        g_err = max(rel_err(torch.cat(a, 1), b) for a, b in zip(grads, ref))
        log(f"  ring P=2 at head dim {D} (1x2200x4): out max rel err "
            f"{o_err:.3e}, dq/dk/dv {g_err:.3e} against one launch")
        if not (o_err <= ATTN_REL_BAR and g_err <= ATTN_BWD_REL_BAR):
            raise AssertionError(f"ring at head dim {D}: {o_err}, {g_err}")
    return rows


def library_ms(fn, calls: int) -> float:
    """ms of ``calls`` back-to-back PyTorch calls in one CUDA graph."""
    return cuda_ms(fn, calls) * calls


def plan_msg(plan: dict) -> str:
    return (f"S={plan['splits']} x {plan['tiles']} tiles = {plan['blocks']} "
            f"blocks on {plan['slots']} slots, bitwise repeat "
            f"{plan['bitwise_repeat']}")


def check_probe(name: str, tag: str, got, ref, faults: dict, exact: bool):
    """Kernel against plain: exact (int8) or max |kernel - plain| / max
    |plain| within PROBE_REL_BAR (bf16); each planted fault, computed by the
    plain version on the same inputs, must land above the bar. Returns
    (max abs err, rel err, fault readings)."""
    err = (got.double() - ref.double()).abs().max().item()
    rel = rel_err(got.double(), ref.double())
    readings = {k: rel_err(f.double(), ref.double()) for k, f in faults.items()}
    if (err != 0.0) if exact else not rel <= PROBE_REL_BAR:
        raise AssertionError(f"{name} {tag}: max abs err {err}, rel {rel}")
    for k, r in readings.items():
        if not r > PROBE_REL_BAR:
            raise AssertionError(f"{name} {tag}: the bar cannot see the "
                                 f"planted fault {k} ({r})")
    return err, rel, readings


def phase_probes() -> dict:
    """The three probe kernels against their plain versions at the probe
    path's shapes, with planted faults; each form's time by CUDA-graph
    replay beside its bound (operations over the peak of its type), its
    plain version's and the PyTorch call that computes one product
    (``torch.matmul`` bf16, ``torch._int_mm`` int8), made as many times in
    one graph as the kernel makes products."""
    import torch

    from topiaxl_torch.benchmarks import PEAK_BF16_FLOPS, PEAK_INT8_OPS, plans
    from topiaxl_torch.benchmarks import exp_dot_forms as edf
    from topiaxl_torch.benchmarks import microbench_int8 as mbi

    dev = torch.device("cuda")
    results = {}

    def split_and_repeat(name, got, again):
        """The last launch's plan (blocks sharing each output tile) and
        whether a second launch gave the same bits; raises if it did not
        (the partial sums are reduced in a fixed order)."""
        plan = dict(plans[name])
        plan["bitwise_repeat"] = torch.equal(got, again)
        if not plan["bitwise_repeat"]:
            raise AssertionError(f"{name}: two launches differ ({plan})")
        return plan

    # 7: the rate loop, at the TPU's shape and with two tiles per SM
    forms = {}
    for m in (mbi.M, mbi.M_FULL):
        for dtype, tag in ((torch.bfloat16, "bf16"), (torch.int8, "int8")):
            int8 = dtype == torch.int8
            a, b = mbi.operands(m, dtype, dev, seed=7)
            got = mbi.mma_rate_loop(a, b, mbi.L)
            plan = split_and_repeat("mma_rate_loop", got,
                                    mbi.mma_rate_loop(a, b, mbi.L))
            ref = mbi.mma_rate_loop_plain(a, b, mbi.L)
            fault = mbi.mma_rate_loop_plain(a, b, mbi.L, coef=lambda i: 1)
            torch.cuda.synchronize()
            err, rel, faults = check_probe(
                "mma_rate_loop", f"{tag} M={m}", got, ref,
                {"coefficients +1": fault}, int8)
            del got, ref, fault
            ms = cuda_ms(lambda: mbi.mma_rate_loop(a, b, mbi.L), 5)
            plain_ms = cuda_ms(lambda: mbi.mma_rate_loop_plain(a, b, mbi.L), 1)
            ops = 2.0 * m * mbi.N * mbi.K * mbi.L
            peak = PEAK_INT8_OPS if int8 else PEAK_BF16_FLOPS
            nbytes = a.numel() * a.element_size() + b.numel() * b.element_size() \
                + 4 * m * mbi.N
            bound_ms, bound_by = bound(ops, nbytes, peak)
            if int8:
                bt = b.t().contiguous()    # cuBLASLt's int8 layout for B
                lib = lambda: torch._int_mm(a, bt.t())   # noqa: E731
            else:
                lib = lambda: torch.matmul(a, b)         # noqa: E731
            lib_ms = library_ms(lib, mbi.L)
            unit = "TOP/s" if int8 else "TFLOP/s"
            log(f"  mma_rate_loop {tag} {m}x{mbi.K}x{mbi.N} x{mbi.L}: max abs "
                f"err {err:.3e}, rel {rel:.3e} ({'exact' if int8 else PROBE_REL_BAR}; "
                f"fault {faults['coefficients +1']:.3e}), {plan_msg(plan)}, "
                f"kernel {ms:.4f} ms "
                f"({ops / ms / 1e9:.1f} {unit}, {ops / ms / 1e9 / (peak / 1e12):.3f}"
                f" of peak), plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
                f"({bound_by}), library {lib_ms:.4f} ms "
                f"({ops / lib_ms / 1e9:.1f} {unit}, {'_int_mm' if int8 else 'matmul'}"
                f" x{mbi.L}; kernel/library {ms / lib_ms:.2f})")
            forms[f"{tag}_m{m}"] = dict(
                ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=lib_ms, max_abs_err=err, max_rel_err=rel,
                rate_t=ops / ms / 1e9, library_rate_t=ops / lib_ms / 1e9,
                fault=faults["coefficients +1"], **plan)
    head = forms[f"int8_m{mbi.M_FULL}"]
    results["mma_rate_loop"] = dict(
        {k: head[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                              "library_ms")},
        max_abs_err=max(f["max_abs_err"] for f in forms.values()),
        at=f"int8 {mbi.M_FULL}x{mbi.K}x{mbi.N} x{mbi.L}",
        library="torch._int_mm / torch.matmul, one call a product",
        forms=forms)

    def form_faults(a, b, dn, plain, iters, ref):
        """One product fewer; where 72 is contracted, the pad (72-79) of
        both operands filled with ones; where 72 is an output width, its
        last 8 rows or columns left zero (an n64 kernel)."""
        ca, cb = dn
        faults = {"one product fewer": plain(a, b, dn, iters - 1)}
        if a.shape[ca] == 72:
            pa = [0, 0, 0, 0]
            pa[2 * (1 - ca) + 1] = 8       # F.pad's order: last dim first
            pb = [0, 0, 0, 0]
            pb[2 * (1 - cb) + 1] = 8
            faults["pad of ones"] = plain(
                torch.nn.functional.pad(a, pa, value=1.0),
                torch.nn.functional.pad(b, pb, value=1.0), dn, iters)
        if 72 in ref.shape:
            n64 = ref.clone()
            if ref.shape[0] == 72:
                n64[64:] = 0
            else:
                n64[:, 64:] = 0
            faults["n64 output"] = n64
        return faults

    def lib_product(a, b, dn):
        ca, cb = dn
        lhs = a if ca == 1 else a.t()
        rhs = b if cb == 0 else b.t()
        return lambda: torch.matmul(lhs, rhs)

    # 8 and 9: the dot forms
    for name, table, iters, kernel, plain in (
            ("dot_form_chain", edf.CHAIN_FORMS, edf.N_ITER, edf.dot_form_chain,
             edf.dot_form_chain_plain),
            ("dot_form_accum", edf.ACCUM_FORMS, edf.G_LO, edf.dot_form_accum,
             edf.dot_form_accum_plain)):
        forms = {}
        for label, a_shape, b_shape, dn in table:
            a, b = edf.operands(a_shape, b_shape, dev, seed=8)
            got = kernel(a, b, dn, iters)
            plan = split_and_repeat(name, got, kernel(a, b, dn, iters))
            ref = plain(a, b, dn, iters)
            faults = form_faults(a, b, dn, plain, iters, ref)
            torch.cuda.synchronize()
            err, rel, readings = check_probe(name, label, got, ref, faults,
                                             False)
            del got, ref, faults
            ms = cuda_ms(lambda: kernel(a, b, dn, iters), 5)
            plain_ms = cuda_ms(lambda: plain(a, b, dn, iters), 1)
            flops = edf.form_flops(a_shape, b_shape, dn)
            X, Y = a_shape[1 - dn[0]], b_shape[1 - dn[1]]
            bound_ms, bound_by = bound(
                iters * flops, 2 * (a.numel() + b.numel()) + 4 * X * Y)
            lib_ms = library_ms(lib_product(a, b, dn), iters)
            per_dot = {"us_per_dot": ms * 1e3 / iters}
            if name == "dot_form_accum":   # the slope, as the TPU script
                hi = cuda_ms(lambda: kernel(a, b, dn, edf.G_HI), 2)
                # the slope cancels the fixed cost, the reduction's
                # included, only if both G share one S
                if plans[name]["splits"] != plan["splits"]:
                    raise AssertionError(
                        f"{name} {label}: S={plan['splits']} at G={edf.G_LO}"
                        f" but S={plans[name]['splits']} at G={edf.G_HI}")
                per_dot = {"us_per_dot": (hi - ms) * 1e3 / (edf.G_HI - edf.G_LO),
                           "ms_g_hi": hi, "splits_g_hi": plans[name]["splits"]}
            us = per_dot["us_per_dot"]
            log(f"  {name} {label} {list(a_shape)}x{list(b_shape)} c={list(dn)} "
                f"x{iters}: max rel err {rel:.3e} (bar {PROBE_REL_BAR}; faults "
                + ", ".join(f"{k} {v:.3e}" for k, v in readings.items())
                + f"), {plan_msg(plan)}, kernel {ms:.4f} ms, {us:.3f} us/dot "
                f"({flops / us / 1e6:.1f} TFLOP/s, "
                f"{flops / us / 1e6 / (PEAK_BF16_FLOPS / 1e12):.3f} of peak"
                + (f"; S={per_dot['splits_g_hi']} at G={edf.G_HI}"
                   if "splits_g_hi" in per_dot else "")
                + f"), plain {plain_ms:.4f} ms, "
                f"bound {bound_ms:.4f} ms ({bound_by}), library {lib_ms:.4f} ms "
                f"({lib_ms * 1e3 / iters:.3f} us/dot, matmul bf16 out; "
                f"kernel/library {ms / lib_ms:.2f})")
            forms[label] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                                bound_by=bound_by, library_ms=lib_ms,
                                max_abs_err=err, max_rel_err=rel,
                                tflops=flops / us / 1e6, faults=readings,
                                **per_dot, **plan)
        head = forms[table[-1][0] if name == "dot_form_chain" else table[0][0]]
        results[name] = dict(
            {k: head[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                  "library_ms")},
            max_abs_err=max(f["max_abs_err"] for f in forms.values()),
            at=(f"{table[-1][0]} x{iters}" if name == "dot_form_chain"
                else f"{table[0][0]} x{iters}"),
            library="torch.matmul bf16, one call a product", forms=forms)
    return results


def phase_probe_path() -> dict:
    """The probe path as a user runs it: the two modules' ``main`` (their
    printed rates go to this log), the counters zeroed just before and
    read just after; each probe kernel must have launched."""
    import contextlib
    import io

    from topiaxl_torch.benchmarks import exp_dot_forms, microbench_int8
    from topiaxl_torch.ops import _cuda

    buf = io.StringIO()
    _cuda.reset_launch_counts()
    with contextlib.redirect_stdout(buf):
        microbench_int8.main([])
        exp_dot_forms.main([])
    counts = {k: _cuda.launches[k] for k in NO_PROBES}
    for line in buf.getvalue().splitlines():
        if not line.startswith("{"):
            log(f"  {line}")
    log(f"  probe path launches {counts}")
    if not all(counts.values()):
        raise AssertionError(f"a probe kernel did not launch: {counts}")
    return counts


def serving_launches(steps: int) -> dict:
    """Launches per image at the flagship config for a chain of ``steps``:
    DINOv2's 12 blocks + steps x 28 DiT blocks x (self + cross) flash;
    steps x (28 blocks + final layer) and steps x 28 x 2 LN; no backward."""
    return dict(EXPECTED_LAUNCHES, flash_attn_fwd=12 + steps * 56,
                ln_modulate=steps * 29, ln_modulate_residual=steps * 56)


def write_images(tmp: str, n: int) -> str:
    from topiaxl_torch.pipelines.synthetic import write_bench_image

    img_dir = os.path.join(tmp, f"imgs{n}")
    if not os.path.isdir(img_dir):
        os.makedirs(img_dir)
        for i in range(n):
            write_bench_image(os.path.join(img_dir, f"asset{i}.png"),
                              shift=12 * i)
    return img_dir


def run_cli(tmp: str, tag: str, images: int, overrides: list,
            expected: dict, layouts: dict | None = None) -> tuple[dict, list]:
    """``cli.infer.main`` at the flagship config on ``images`` synthetic
    images (no GLB export), the counters zeroed just before; checks each
    image's launches against ``expected`` (and, given ``layouts``, its
    flash forwards by tile layout and by loop), its denoised PrimX (finite, shaped) and
    its ``recon.jpg`` (decodes at 518 x 1036). Returns the run's total
    launches and one record per image (stage seconds, launches)."""
    import cv2

    from topiaxl_torch.cli.infer import main
    from topiaxl_torch.ops import _cuda
    from topiaxl_torch.pipelines import chain_graph

    class PerImage(list):
        """Snapshots the launch counters as each image finishes."""

        def append(self, rec):
            super().append(dict(rec, launches=dict(_cuda.launches),
                                layouts=dict(_cuda.fwd_layouts),
                                loops=dict(_cuda.fwd_loops)))

    recs = PerImage()
    root = os.path.join(tmp, f"runs_{tag}")
    stats0 = dict(chain_graph.stats)
    _cuda.reset_launch_counts()
    rc = main([FLAGSHIP, "inference.export_glb=false",
               f"inference.input_dir={write_images(tmp, images)}",
               f"root_data_dir={root}", *overrides], timings_out=recs)
    total = dict(_cuda.launches)
    made = {k: chain_graph.stats[k] - stats0[k] for k in stats0}
    log(f"  [{tag}] chain graphs: {made['captures']} captured, "
        f"{made['replays']} replayed")
    if made != {"captures": 1, "replays": images - 1}:
        raise AssertionError(f"{tag}: chain graphs {made}")
    if rc != 0 or len(recs) != images:
        raise AssertionError(f"cli main ({tag}) returned {rc} with "
                             f"{len(recs)} images")
    prev = dict.fromkeys(total, 0)
    prev_layouts = dict.fromkeys(_cuda.fwd_layouts, 0)
    prev_loops = dict.fromkeys(_cuda.fwd_loops, 0)
    for rec in recs:
        per = {k: rec["launches"][k] - prev[k] for k in total}
        per_layout = {k: n - prev_layouts[k] for k, n in rec["layouts"].items()}
        per_loop = {k: n - prev_loops[k] for k, n in rec["loops"].items()}
        prev, prev_layouts = rec["launches"], rec["layouts"]
        prev_loops = rec["loops"]
        log(f"  [{tag}] {rec['image']}: encode {rec['encode_s']:.3f} s, "
            f"stage1 {rec['stage1_s']:.3f} s, recon {rec['recon_s']:.3f} s, "
            f"stage2 {rec['stage2_s']:.3f} s; launches {per}; flash forwards "
            f"by tile layout {per_layout}, by loop {per_loop}")
        if per != expected:
            raise AssertionError(f"{tag}: launches {per} != {expected}")
        if layouts is not None and per_layout != layouts:
            raise AssertionError(f"{tag}: flash forwards by tile layout "
                                 f"{per_layout} != {layouts}")
        if layouts is not None and per_loop != EXPECTED_FWD_LOOPS:
            raise AssertionError(f"{tag}: flash forwards by loop {per_loop} "
                                 f"!= {EXPECTED_FWD_LOOPS}")
        out = os.path.join(root, "inference", "topiaxl-sview",
                           "inference_folder", rec["image"])
        recon = cv2.imread(os.path.join(out, "recon.jpg"))
        if recon is None or recon.shape != (518, 1036, 3):
            raise AssertionError(f"{tag}: recon.jpg is "
                                 f"{None if recon is None else recon.shape}")
        z = np.load(os.path.join(out, "denoised.npz"))
        if z["srt"].shape != (2048, 4) or z["feat"].shape != (2048, 3072):
            raise AssertionError(f"denoised shapes {z['srt'].shape} "
                                 f"{z['feat'].shape}")
        if not (np.isfinite(z["srt"]).all() and np.isfinite(z["feat"]).all()):
            raise AssertionError("denoised.npz is not finite")
    return total, recs


def phase_serving(tmp: str) -> tuple[dict, list]:
    return run_cli(tmp, "bf16", 2, [], EXPECTED_LAUNCHES,
                   EXPECTED_FWD_LAYOUTS)


def phase_serving_int8(tmp: str, bf16: list) -> None:
    """W8A8 (``model.generator.quant=true``) and bf16 in turns, in this
    process, after the serving phase's bf16 run: stage 1 of each run's
    warm (second) image, and the same launch counts. (The random init's
    zero adaLN gates make every block the identity, so the two runs'
    tokens agree whatever the W8A8 layers compute: phase dit_int8 holds
    their numerics.)"""
    stage1 = {"bf16": [bf16[-1]["stage1_s"]], "int8": []}
    runs = [("int8", ["model.generator.quant=true"]), ("bf16", []),
            ("int8", ["model.generator.quant=true"])]
    for n, (tag, overrides) in enumerate(runs):
        _, recs = run_cli(tmp, f"{tag}_{n}", 2, overrides, EXPECTED_LAUNCHES)
        stage1[tag].append(recs[-1]["stage1_s"])
    log(f"  stage 1 of the warm image, in run order bf16, int8, bf16, int8: "
        f"bf16 {[round(v, 3) for v in stage1['bf16']]} s, int8 "
        f"{[round(v, 3) for v in stage1['int8']]} s")


def phase_serving_pos_emb(tmp: str) -> None:
    """``model.generator.class_name=topiaxl.DiTAdditivePosEmb``: the CLI
    builds and serves the point-embedding DiT, with the launches of the
    plain DiT's image."""
    run_cli(tmp, "pos_emb", 1,
            ["model.generator.class_name=topiaxl.DiTAdditivePosEmb"],
            EXPECTED_LAUNCHES)


def phase_serving_samplers(tmp: str) -> None:
    """``inference.sampler=dpm`` on a 12-step chain and ``ancestral`` on the
    config's 25: the launches of that many steps, finite tokens."""
    for tag, steps, overrides in (
            ("dpm", 12, ["inference.sampler=dpm", "inference.ddim=12"]),
            ("ancestral", 25, ["inference.sampler=ancestral"])):
        run_cli(tmp, tag, 1, overrides, serving_launches(steps))


# chain_graph: max |graph - eager| / max |eager| of the sampled tokens
# (the same kernels on the same buffers: 0 expected); a graph whose call
# skips the copy of y (a planted fault) replays the last asset's chain
# and must land above it
CHAIN_GRAPH_BAR = 1e-6
CHAIN_GRAPH_CASES = (("ddim", 25), ("dpm", 12), ("ancestral", 25))


def chain_launches(steps: int) -> dict:
    """Launches of the chain alone (``sample_tokens``, no DINOv2)."""
    return dict(serving_launches(steps),
                flash_attn_fwd=serving_launches(steps)["flash_attn_fwd"] - 12)


def phase_chain_graph() -> None:
    """``sample_tokens`` as one CUDA graph (``pipelines/chain_graph.py``)
    at the flagship width (28 blocks of 1152, 16 heads of 72, 2048 tokens,
    1370 conditioning tokens, CFG 6; the zero-init layers filled), bf16 and
    W8A8, for ``ddim`` (25 steps), ``dpm`` (12) and ``ancestral`` (25, a
    CUDA generator): the first call (the eager warm-up, whose result it
    returns, and the capture), the same asset replayed, a second asset
    replayed, each against ``_sample_tokens_eager`` on the same inputs at
    ``CHAIN_GRAPH_BAR``; the two calls of the first asset must give the
    same bits; the planted fault (y not copied in) must land above the
    bar; every call's launches exact. Prints the capture's seconds, the
    memory the key's graph holds (``memory_reserved`` after
    ``empty_cache``, beside the reading before its first call), wall
    ms a chain graphed and eager, the kernels' device ms of a replay (the
    profiler's kernel sum, ``cli/profile.py:profile_region``) and the idle
    shares it gives (1 - device / wall; the eager chain runs the same
    kernels, which bf16 ``ddim`` shows by profiling it too)."""
    import torch

    from topiaxl_torch.cli.profile import profile_region
    from topiaxl_torch.diffusion import create_diffusion
    from topiaxl_torch.models.dit import DiT, quantize_dit_state_dict
    from topiaxl_torch.ops import _cuda
    from topiaxl_torch.pipelines import chain_graph as CG
    from topiaxl_torch.pipelines import infer as P

    card_id = card_line()
    dev = torch.device("cuda")
    kw = dict(seq_length=2048, in_channels=68, condition_channels=768,
              hidden_size=1152, depth=28, num_heads=16)
    dit = enliven_(DiT(device=dev, generator=torch.Generator(dev).manual_seed(
        21), **kw).eval(), 22)
    qdit = DiT(device=dev, quant=True, **kw).eval()
    qdit.load_state_dict(quantize_dit_state_dict(qdit, dit.state_dict()))
    g = torch.Generator(dev).manual_seed(23)
    ys = [torch.randn((1, 1370, 768), generator=g, device=dev)
          for _ in range(2)]
    noise = torch.randn((1, 2048, 68), generator=g, device=dev)

    def rel(a, b):
        return ((a - b).abs().max() / b.abs().max()).item()

    def timed(fn, n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3 / n

    for tag, model in (("bf16", dit), ("W8A8", qdit)):
        for sampler, steps in CHAIN_GRAPH_CASES:
            diffusion = create_diffusion(
                timestep_respacing=f"ddim{steps}",
                noise_schedule="squaredcos_cap_v2", parameterization="v",
                diffusion_steps=1000, device=dev)
            want = chain_launches(steps)

            def graphed(y, seed=24):
                return P.sample_tokens(
                    model, diffusion, y, 6.0, noise=noise,
                    generator=torch.Generator(dev).manual_seed(seed),
                    sampler=sampler).sample

            def eager(y, seed=24):
                return P._sample_tokens_eager(
                    model, diffusion, y, 6.0, noise=noise,
                    generator=torch.Generator(dev).manual_seed(seed),
                    sampler=sampler).sample

            CG.forget(model)
            gc.collect()
            torch.cuda.empty_cache()
            reserved0 = torch.cuda.memory_reserved()
            stats0 = dict(CG.stats)
            runs = []
            for y in (ys[0], ys[0], ys[1]):
                _cuda.reset_launch_counts()
                t0 = time.perf_counter()
                out = graphed(y)
                torch.cuda.synchronize()
                runs.append((out, time.perf_counter() - t0,
                             dict(_cuda.launches)))
            chain = CG.graph_for(model, diffusion, ys[0], noise, 6.0, sampler)
            # what the key's graph holds: its pool, buffers and outputs
            gc.collect()
            torch.cuda.empty_cache()
            held_mib = (torch.cuda.memory_reserved() - reserved0) / 2**20
            refs = [eager(ys[0]), eager(ys[1])]
            errs = [rel(runs[0][0], refs[0]), rel(runs[1][0], refs[0]),
                    rel(runs[2][0], refs[1])]
            same = torch.equal(runs[0][0], runs[1][0])
            # the planted fault: every input of the first asset loaded but
            # y, which keeps the second asset's (the last call's)
            with chain.lock, torch.inference_mode():
                chain.noise.copy_(noise)
                if chain.generator is not None:
                    chain.generator.set_state(
                        torch.Generator(dev).manual_seed(24).get_state())
                fault = chain.replay().sample
            fault_err = rel(fault, refs[0])
            graph_ms = timed(lambda: graphed(ys[0]), 2)
            eager_ms = timed(lambda: eager(ys[0]), 1)
            # the kernels' own device time (the profiler's kernel sum) of a
            # replay; the eager chain runs the same kernels (profiled too
            # for bf16 ddim, where its trace is cheapest)
            device_ms = profile_region(f"chain {tag} {sampler} graphed",
                                       lambda: graphed(ys[0]), 1,
                                       top=3)["device_ms"]
            prof = ""
            if (tag, sampler) == ("bf16", "ddim"):
                pr = profile_region(f"chain {tag} {sampler} eager",
                                    lambda: eager(ys[0]), 1, top=3)
                prof = (f"; the eager chain's own: device ms "
                        f"{pr['device_ms']:.3f} (idle {pr['idle_share']:.3f})")
            made = {k: CG.stats[k] - stats0[k] for k in stats0}
            log(f"  chain_graph {tag} {sampler} {steps} steps: graph vs eager "
                f"max rel err first call {errs[0]:.3e}, replay {errs[1]:.3e}, "
                f"second asset {errs[2]:.3e} (bar {CHAIN_GRAPH_BAR}); replay "
                f"of the same asset same bits: {same}; y-not-copied fault "
                f"{fault_err:.3e}; first call {runs[0][1]:.3f} s (capture "
                f"{chain.capture_s:.3f} s; the graph holds {held_mib:.1f} MiB "
                f"reserved after empty_cache), replays {runs[1][1]:.3f} / "
                f"{runs[2][1]:.3f} s; wall ms a chain graphed {graph_ms:.3f}, "
                f"eager {eager_ms:.3f} ({eager_ms / graph_ms:.2f}x); device "
                f"ms {device_ms:.3f} (profiler), idle share graphed "
                f"{1 - device_ms / graph_ms:.3f}, eager "
                f"{1 - device_ms / eager_ms:.3f}{prof}; launches per call "
                f"{ {k: v for k, v in runs[1][2].items() if v} }; captures "
                f"{made['captures']}, replays {made['replays']} ({card_id})")
            if max(errs) > CHAIN_GRAPH_BAR or not same:
                raise AssertionError(f"chain_graph {tag} {sampler}: {errs}, "
                                     f"same bits {same}")
            if not fault_err > CHAIN_GRAPH_BAR:
                raise AssertionError(f"chain_graph {tag} {sampler}: the bar "
                                     f"cannot see a stale y ({fault_err})")
            for n, (_, _, counts) in enumerate(runs):
                if counts != want:
                    raise AssertionError(f"chain_graph {tag} {sampler} call "
                                         f"{n}: launches {counts} != {want}")
            if made["captures"] != 1:
                raise AssertionError(f"chain_graph {tag} {sampler}: "
                                     f"{made['captures']} captures")
            CG.forget(model)
            # the last key's graph goes before the next key's reading
            del chain, refs, runs, fault
            torch.cuda.empty_cache()


def check_sphere_glb(glb: str) -> str:
    """The GLB parses, has faces and its vertices lie within two voxels (of
    the mc 256 lattice) of the sphere; returns a summary."""
    from topiaxl_torch.extract.glb import read_glb
    from topiaxl_torch.pipelines.synthetic import SPHERE_R

    gltf, blob = read_glb(glb)
    prim = gltf["meshes"][0]["primitives"][0]
    n_faces = gltf["accessors"][prim["indices"]]["count"] // 3
    acc = gltf["accessors"][prim["attributes"]["POSITION"]]
    view = gltf["bufferViews"][acc["bufferView"]]
    verts = np.frombuffer(blob, np.float32, acc["count"] * 3,
                          view.get("byteOffset", 0)).reshape(-1, 3)
    dev = np.abs(np.linalg.norm(verts, axis=1) - SPHERE_R)
    voxel = 2.0 / (256 - 1)
    if n_faces <= 0:
        raise AssertionError(f"{glb}: no faces")
    if not dev.max() <= 2 * voxel:
        raise AssertionError(f"{glb}: vertices off the sphere by "
                             f"{dev.max() / voxel} voxels")
    return (f"{n_faces} faces, {len(verts)} vertices, max |r - {SPHERE_R}| "
            f"{dev.max():.3e} = {dev.max() / voxel:.3f} voxels")


def phase_stage2(tmp: str):
    import torch

    from topiaxl_torch.pipelines.infer import extract_glb
    from topiaxl_torch.pipelines.synthetic import sphere_asset

    params = sphere_asset(torch.device("cuda"))
    tm: dict = {}
    t0 = time.perf_counter()
    glb = extract_glb(params, os.path.join(tmp, "sphere"), mc_resolution=256,
                      decimate=100000, texture_size=1024, batch_size=32768,
                      pos_scale=1.0, timings_out=tm)
    log(f"  extract_glb {time.perf_counter() - t0:.3f} s: {json.dumps(tm)}")
    log(f"  GLB: {check_sphere_glb(glb)}")


def events_ms(fn, iters: int) -> float:
    """Mean ms of ``iters`` calls of ``fn`` between two CUDA events, after
    a warm-up call (for work a CUDA graph cannot hold: host syncs, cuDNN)."""
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


def phase_render(tmp: str) -> None:
    """The renderer on the 2048-prim sphere: the recon pair at 518² (time,
    peak memory, silhouette), ``render_primx`` card vs CPU at 64² with a
    planted fault, and a three-view orbit video."""
    import cv2
    import torch

    from topiaxl_torch.models.primx import PrimXParams
    from topiaxl_torch.pipelines.synthetic import SPHERE_R, sphere_asset
    from topiaxl_torch.render import (colored_box_payload, compute_rays,
                                      frontal_camera, raymarch, render_primx)
    from topiaxl_torch.render.camera import REF_FOCAL_1024
    from topiaxl_torch.render.visualize import (primx_to_payload,
                                                visualize_primvolume,
                                                visualize_video_primvolume)

    dev = torch.device("cuda")
    asset = sphere_asset(dev)
    out = os.path.join(tmp, "render")
    os.makedirs(out)
    H = 518
    path = os.path.join(out, "recon.jpg")
    visualize_primvolume(path, asset, H, H)            # warm-up
    t0 = time.perf_counter()
    for _ in range(3):
        rgb, _ = visualize_primvolume(path, asset, H, H)
    recon_ms = (time.perf_counter() - t0) / 3 * 1e3
    img = cv2.imread(path)
    if img is None or img.shape != (H, 2 * H, 3):
        raise AssertionError(f"recon.jpg is {None if img is None else img.shape}")

    # the pair alone, as visualize_primvolume renders it, and its memory
    cam = frontal_camera(H, H, device=dev)
    boxes = colored_box_payload(asset.srt.shape[0], 8, device=dev)
    with torch.inference_mode():
        def pair():
            render_primx(asset.srt, asset.feat, cam, num_steps=128, max_hits=8)
            render_primx(asset.srt, asset.feat, cam, num_steps=128, max_hits=8,
                         payload=boxes)

        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        pair_ms = events_ms(pair, 3)
        peak = torch.cuda.max_memory_allocated() - base

    # silhouette: the opaque pixels against the sphere's projected disc
    focal = REF_FOCAL_1024 * H / 1024
    r_disc = focal * SPHERE_R / np.sqrt(25.0 - SPHERE_R ** 2)
    c = 512.0 * H / 1024
    yy, xx = np.mgrid[0:H, 0:H]
    d = np.hypot(xx - c, yy - c)
    opaque = rgb[..., 3] > 0.5
    r_area = np.sqrt(opaque.sum() / np.pi)
    beyond = float(d[opaque].max() - r_disc)
    fill = float(opaque[d < r_disc - RENDER_EDGE_PX].mean())
    log(f"  recon.jpg of the 2048-prim sphere at {H}²: {recon_ms:.3f} ms "
        f"(visualize_primvolume: pair, copy back, JPEG); the pair on the card "
        f"{pair_ms:.3f} ms (CUDA events), peak memory {peak / 2 ** 20:.1f} MiB "
        f"above the {base / 2 ** 20:.1f} MiB held before (chunk 32768 rays); "
        f"silhouette: area radius {r_area:.2f} px against the disc's "
        f"{r_disc:.2f} (bar {RENDER_AREA_PX}), farthest opaque pixel "
        f"{beyond:+.2f} px past it (bar {RENDER_EDGE_PX}), {fill:.4f} of the "
        f"disc less {RENDER_EDGE_PX} px opaque (bar {RENDER_FILL})")
    if not (abs(r_area - r_disc) <= RENDER_AREA_PX and beyond <= RENDER_EDGE_PX
            and fill >= RENDER_FILL):
        raise AssertionError("the sphere's silhouette is not its disc")

    # render_primx, card against CPU at 64², and the march without its fade
    cpu = PrimXParams(asset.srt.cpu(), asset.feat.cpu())
    with torch.inference_mode():
        got = render_primx(asset.srt, asset.feat, frontal_camera(64, 64, device=dev),
                           num_steps=128, max_hits=8).cpu()
        ref = render_primx(cpu.srt, cpu.feat, frontal_camera(64, 64, device="cpu"),
                           num_steps=128, max_hits=8)
        rp, rd, tm = (t.reshape(-1, t.shape[-1]) for t in
                      compute_rays(frontal_camera(64, 64, device=dev)))
        no_fade = raymarch(primx_to_payload(asset.srt, asset.feat), asset.srt[:, 1:4],
                           1.0 / asset.srt[:, 0], rp, rd, tm, num_steps=128,
                           max_hits=8, fadescale=0.0).reshape(64, 64, 4).cpu()

    def readings(img):
        return ((img[..., :3] - ref[..., :3]).abs().max().item()
                / ref[..., :3].abs().max().item(),
                (img[..., 3] - ref[..., 3]).abs().max().item())

    sound, fault = readings(got), readings(no_fade)
    log(f"  render_primx card vs CPU at 64²: rgb max rel err {sound[0]:.3e} "
        f"(bar {RENDER_RGB_REL}), alpha max abs err {sound[1]:.3e} (bar "
        f"{RENDER_ALPHA_ABS}); planted fault (no border fade) rgb "
        f"{fault[0]:.3e}, alpha {fault[1]:.3e}")
    if not (sound[0] <= RENDER_RGB_REL and sound[1] <= RENDER_ALPHA_ABS):
        raise AssertionError(f"render_primx card vs CPU: {sound}")
    if fault[0] <= RENDER_RGB_REL and fault[1] <= RENDER_ALPHA_ABS:
        raise AssertionError(f"the render bars cannot see a missing fade: {fault}")

    # one orbit video: 4 frames of rgb, prim boxes and materials
    video = os.path.join(out, "video")
    t0 = time.perf_counter()
    branches = visualize_video_primvolume(video, asset, view_counts=3,
                                          height=H, width=H)
    frame_ms = (time.perf_counter() - t0) / 4 * 1e3
    for name, branch in sorted(branches.items()):
        files = ([os.path.join(video, f"{name}.mp4")] if branch == "mp4" else
                 [os.path.join(video, name, f"{i:04d}.jpg") for i in range(4)])
        for f in files:
            if branch == "jpg":
                fr = cv2.imread(f)
                if fr is None or fr.shape != (H, H, 3):
                    raise AssertionError(f"{f}: {None if fr is None else fr.shape}")
            elif not os.path.getsize(f) > 0:
                raise AssertionError(f"{f} is empty")
    if sorted(branches) != ["mat", "prim", "rgb"]:
        raise AssertionError(f"video wrote {branches}")
    log(f"  orbit video, view_counts=3 at {H}²: {frame_ms:.3f} ms per frame "
        f"(rgb, prim and mat renders), written as {branches}")


def phase_matting(tmp: str) -> None:
    """The CLI mattes with a U^2-Net ``.pth`` (full ``u2net``, random), with
    serving's launches; the network on the card against the CPU at 320²."""
    import torch
    import torch.nn.functional as F

    from topiaxl_torch.bench import random_u2net
    from topiaxl_torch.models import matting_u2net

    model = random_u2net("u2net", 12, "cpu")
    pth = os.path.join(tmp, "u2net.pth")
    torch.save(model.state_dict(), pth)
    run_cli(tmp, "u2net", 1, ["inference.matting=u2net",
                              f"inference.u2net_checkpoint={pth}"],
            EXPECTED_LAUNCHES)

    x = torch.from_numpy(np.random.default_rng(13).standard_normal(
        (1, 3, 320, 320)).astype(np.float32))
    card = random_u2net("u2net", 12, "cuda")
    xc = x.cuda()
    with torch.inference_mode():
        ref = model(x)
        got = card(xc).cpu()
        sound_up = matting_u2net._up_to
        matting_u2net._up_to = lambda a, like: (
            a if a.shape[2:] == like.shape[2:] else F.interpolate(
                a, size=like.shape[2:], mode="bilinear", align_corners=True))
        try:
            fault = card(xc).cpu()
        finally:
            matting_u2net._up_to = sound_up
        ms = events_ms(lambda: card(xc), 10)
    spread = (ref.max() - ref.min()).item()
    rel = (got - ref).abs().max().item() / spread
    fault_rel = (fault - ref).abs().max().item() / spread
    log(f"  U^2-Net (u2net, f32) at 320²: card {ms:.3f} ms (CUDA events, "
        f"cuDNN, TF32 off); card vs CPU max |err| / spread {rel:.3e} (spread "
        f"{spread:.3e}, bar {U2NET_REL_BAR}); planted fault (aligned-corner "
        f"upsampling) {fault_rel:.3e}")
    if not rel <= U2NET_REL_BAR:
        raise AssertionError(f"U^2-Net card vs CPU: {rel} > {U2NET_REL_BAR}")
    if not fault_rel > U2NET_REL_BAR:
        raise AssertionError(f"the U^2-Net bar cannot see its fault ({fault_rel})")


def phase_conditioner_render() -> None:
    """``condition_from_primx`` on two sphere assets through the flagship
    DINOv2 (random, bf16): [2, 1370, 768] finite tokens and 12 flash
    launches; then the registry's multi-view conditioner with two views:
    [2, 2740, 768] and 24."""
    import torch

    from topiaxl_torch import registry  # noqa: F401  (fills the table)
    from topiaxl_torch.core.attrdict import AttrDict
    from topiaxl_torch.core.config import build, load_config
    from topiaxl_torch.ops import _cuda
    from topiaxl_torch.pipelines.synthetic import sphere_asset

    dev = torch.device("cuda")
    node = load_config(FLAGSHIP).model.conditioner
    gen = torch.Generator(device=dev).manual_seed(3)
    a, b = sphere_asset(dev, seed=0), sphere_asset(dev, seed=1)
    srt, feat = torch.stack([a.srt, b.srt]), torch.stack([a.feat, b.feat])
    for tag, cls, views in (("frontal", "topiaxl.ImageConditioner", 1),
                            ("multi-view", "topiaxl.ImageMultiViewConditioner",
                             2)):
        cond = build(AttrDict(dict(node, class_name=cls, view_counts=views)),
                     device=dev, generator=gen).eval()
        with torch.inference_mode():
            cond.condition_from_primx(srt, feat)      # warm-up
            torch.cuda.synchronize()
            _cuda.reset_launch_counts()
            t0 = time.perf_counter()
            tokens = cond.condition_from_primx(srt, feat)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
        launches = {k: v for k, v in _cuda.launches.items() if v}
        log(f"  {cls} ({tag}, {views} view(s)) on two 2048-prim assets at "
            f"518²: tokens {list(tokens.shape)}, {ms:.3f} ms, launches "
            f"{launches}")
        want = {"flash_attn_fwd": 12 * views}
        if tuple(tokens.shape) != (2, 1370 * views, 768) or launches != want:
            raise AssertionError(f"{cls}: {tuple(tokens.shape)}, {launches}")
        if not torch.isfinite(tokens).all():
            raise AssertionError(f"{cls}: tokens are not finite")
        del cond


def phase_serve_assets(tmp: str) -> None:
    """Four DINOv2-encoded synthetic images through the flagship DiT and
    VAE, serially (``generate_primx`` then ``extract_glb`` per asset),
    pipelined (``serve_assets``, ``stage1_batch=1``) and batched
    (``stage1_batch=2``), in one process. Random weights give degenerate
    fields, so here (and only here) the extractor ``serve_assets`` calls
    runs the real ``extract_glb`` on the sphere asset. Assets per minute
    of each way; every chain's launches exact; every GLB on the sphere."""
    import torch

    from topiaxl_torch.cli.infer import build_models, prepare_image
    from topiaxl_torch.core.config import load_config
    from topiaxl_torch.diffusion import create_diffusion
    from topiaxl_torch.models.latent_stats import resolve_latent_stats
    from topiaxl_torch.ops import _cuda
    from topiaxl_torch.pipelines import chain_graph
    from topiaxl_torch.pipelines import infer as P
    from topiaxl_torch.pipelines.synthetic import sphere_asset

    dev = torch.device("cuda")
    cfg = load_config(FLAGSHIP)
    dit, vae, cond = build_models(cfg, dev, torch.Generator(dev).manual_seed(4))
    diffusion = create_diffusion(
        timestep_respacing=f"ddim{cfg.inference.ddim}",
        noise_schedule=cfg.diffusion.noise_schedule,
        diffusion_steps=cfg.diffusion.diffusion_steps,
        parameterization=cfg.diffusion.parameterization, device=dev)
    mean, std = resolve_latent_stats(cfg.model)
    img_dir = write_images(tmp, 4)
    ys = []
    with torch.inference_mode():
        for name in sorted(os.listdir(img_dir)):
            image = prepare_image(os.path.join(img_dir, name))
            ys.append(cond.encode_image(torch.from_numpy(image[None]).to(dev)))
    del cond
    sphere = sphere_asset(dev)
    extract_kw = dict(mc_resolution=256, decimate=100000, texture_size=1024,
                      batch_size=32768, fast_unwrap=True, pos_scale=1.0)
    chain_kw = dict(cfg_scale=float(cfg.inference.cfg))
    want = dict(serving_launches(cfg.inference.ddim),
                flash_attn_fwd=serving_launches(cfg.inference.ddim)[
                    "flash_attn_fwd"] - 12)          # no DINOv2 here

    real_extract, real_generate = P.extract_glb, P.generate_primx
    chains = []
    # the timeline of a way: each chain and extraction on its thread, with
    # wall and thread CPU seconds; a chain's end on the card from an event
    spans = []
    origin = {}

    def on_sphere(params, output_dir, **kw):
        tm, s, c = {}, time.perf_counter(), time.thread_time()
        out = real_extract(sphere, output_dir, timings_out=tm, **kw)
        spans.append((f"extract {os.path.basename(output_dir)}", s,
                      time.perf_counter(), time.thread_time() - c, tm))
        return out

    def counted(*args, **kw):
        before = dict(_cuda.launches)
        s, c = time.perf_counter(), time.thread_time()
        out = real_generate(*args, **kw)
        done = torch.cuda.Event(enable_timing=True)
        done.record()
        spans.append(("chain", s, time.perf_counter(),
                      time.thread_time() - c, done))
        chains.append({k: _cuda.launches[k] - before[k] for k in before})
        return out

    def timeline():
        rows = []
        for what, s, e, cpu, extra in sorted(spans, key=lambda r: r[1]):
            s, e = s - origin["t"], e - origin["t"]
            if what == "chain":
                detail = (f"its last kernel done at "
                          f"{origin['ev'].elapsed_time(extra) / 1e3:.3f} s")
            else:
                detail = ", ".join(
                    f"{k} {v}" for k, v in extra.items()
                    if k in ("sdf_grid", "clean_mesh", "decimate", "uv_unwrap",
                             "bake_queries", "inpaint", "write_glb"))
                detail += (f" (sdf_grid's coarse query "
                           f"{extra['sdf_grid_phases']['coarse_query']}, "
                           f"refine {extra['sdf_grid_phases']['refine_query']})")
            rows.append(f"    {what}: {s:.3f}-{e:.3f} s wall, {cpu:.3f} s "
                        f"thread CPU; {detail}")
        return "\n".join(rows)

    rates = {}
    P.extract_glb, P.generate_primx = on_sphere, counted
    try:
        for way, batch in (("serial", None), ("pipelined", 1), ("batched", 2)):
            dirs = [os.path.join(tmp, "serve", way, f"a{i}") for i in range(4)]
            gen = torch.Generator(dev).manual_seed(5)
            stats0 = dict(chain_graph.stats)
            chains.clear()
            spans.clear()
            torch.cuda.synchronize()
            origin["ev"] = torch.cuda.Event(enable_timing=True)
            origin["ev"].record()
            t0 = origin["t"] = time.perf_counter()
            if batch is None:
                glbs = []
                for y, d in zip(ys, dirs):
                    p = P.generate_primx(dit, vae, diffusion, y, mean, std,
                                         generator=gen, **chain_kw)
                    glbs.append(P.extract_glb(p, d, **extract_kw))
            else:
                glbs = P.serve_assets(dit, vae, diffusion, ys, dirs, mean, std,
                                      stage1_batch=batch, generator=gen,
                                      **chain_kw, **extract_kw)
            torch.cuda.synchronize()
            sec = time.perf_counter() - t0
            rates[way] = 4 / sec * 60
            summary = [check_sphere_glb(g) for g in glbs]
            made = {k: chain_graph.stats[k] - stats0[k] for k in stats0}
            log(f"  {way}: 4 assets in {sec:.3f} s = {rates[way]:.3f} assets/min"
                f" ({len(chains)} chains; chain graphs {made['captures']} "
                f"captured, {made['replays']} replayed); GLB 0: {summary[0]}"
                f"\n{timeline()}")
            if len(chains) != (4 if batch is None else -(-4 // batch)):
                raise AssertionError(f"{way}: {len(chains)} chains")
            for n, got in enumerate(chains):
                if got != want:
                    raise AssertionError(f"{way} chain {n}: launches {got} != "
                                         f"{want}")
    finally:
        P.extract_glb, P.generate_primx = real_extract, real_generate
    log(f"  launches per chain (any batch) {want}; assets/min serial "
        f"{rates['serial']:.3f}, pipelined {rates['pipelined']:.3f}, batched "
        f"{rates['batched']:.3f}")


def phase_dit(quant: bool = False):
    """One full-width, depth-2 CFG step on the card (bf16, kernels)
    against the same weights on the CPU (f32, plain versions). With
    ``quant`` both DiTs serve W8A8 from the same int8 codes and scales:
    the card's activations are bf16 and its int8 products
    ``torch._int_mm``'s, the CPU's f32 and exact."""
    import torch

    from topiaxl_torch.models.dit import DiT, quantize_dit_state_dict
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
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((1, 2048, 68)).astype(np.float32))
    y = torch.from_numpy(rng.standard_normal((1, 1370, 768)).astype(np.float32))
    t = torch.tensor([500])

    def step(model, dev):
        with torch.inference_mode():
            return model.forward_with_cfg_fast(
                x.to(dev), t.to(dev), model.precompute_kv(y.to(dev)),
                model.precompute_null_out(), 6.0).float().cpu()

    what = "one CFG step"
    if quant:
        float_ref = step(cpu, "cpu")
        qcpu = DiT(dtype=torch.float32, device="cpu", quant=True, **kw).eval()
        qcpu.load_state_dict(quantize_dit_state_dict(qcpu, cpu.state_dict()))
        cpu = qcpu
        what = "one W8A8 CFG step"
    card = DiT(dtype=torch.bfloat16, device="cuda", quant=quant, **kw).eval()
    card.load_state_dict(cpu.state_dict())
    got, ref = step(card, "cuda"), step(cpu, "cpu")
    rel = ((got - ref).abs().max() / ref.abs().max()).item()
    mean_rel = ((got - ref).abs().mean() / ref.abs().mean()).item()
    extra = ""
    if quant:
        q_rel = ((ref - float_ref).abs().max() / float_ref.abs().max()).item()
        extra = f"; CPU W8A8 vs CPU float step max rel {q_rel:.3e}"
    log(f"  {what}, depth 2 at full width: max|ref| "
        f"{ref.abs().max().item():.3f}, max rel err {rel:.3e} (bar {DIT_BAR}), "
        f"mean rel err {mean_rel:.3e}{extra}")
    if not (torch.isfinite(got).all() and rel <= DIT_BAR):
        raise AssertionError(f"card vs cpu DiT step: rel err {rel} > {DIT_BAR}")


class PerStep(list):
    """Snapshots the launch counters (and the single-pass backward's
    launches by loop) as each step's metrics (or each asset's record)
    arrive."""

    def append(self, rec):
        from topiaxl_torch.ops import _cuda

        super().append(dict(rec, launches=dict(_cuda.launches),
                            bwd_loops=dict(_cuda.bwd_loops)))


def step_loops(recs: list, expected: dict) -> None:
    """Each step's single-pass backwards by loop must be ``expected``."""
    prev = dict.fromkeys(expected, 0)
    for rec in recs:
        per = {k: rec["bwd_loops"][k] - prev[k] for k in expected}
        prev = rec["bwd_loops"]
        if per != expected:
            raise AssertionError(f"step {rec['step']}: backward loops {per} "
                                 f"!= {expected}")
    log(f"  every step's single-pass backwards by loop: {expected}")


def run_trainer(args: list, expected: dict, steps: list,
                loops: dict | None = None) -> dict:
    """``cli.train.main`` with the counters zeroed first; checks each
    step's launches (and, given ``loops``, its single-pass backwards by
    loop), finite metrics and the step numbers; returns the run's total
    launches and its records."""
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
    if loops is not None:
        step_loops(recs, loops)
    torch.cuda.synchronize()
    return total, recs


def phase_train(tmp: str) -> dict:
    import torch

    args = [FLAGSHIP, "train.synthetic=true", "train.batch_size=8",
            "train.log_every_n_steps=1", "train.ckpt_every_n_steps=1000000",
            "train.keep_ckpts=1", f"root_data_dir={tmp}/train"]
    torch.cuda.reset_peak_memory_stats()
    total, recs = run_trainer(args + ["train.max_steps=6"], TRAIN_LAUNCHES,
                              list(range(1, 7)), TRAIN_BWD_LOOPS)
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
    return {**total, "step_s": median, "peak_gib": peak / 2 ** 30,
            "recs": recs[:2]}


def phase_train_remat(tmp: str, plain: dict) -> dict:
    """Two steps of the flagship recipe with the reference's
    ``gradient_checkpointing: true`` (``remat``): every block's forward runs
    again in the backward, so its flash and LN launches double (the final
    layer's LN does not); each step's loss and grad norm within
    ``REMAT_REL_BAR`` of the plain trainer's, and step seconds and peak
    memory beside its."""
    import torch

    args = [FLAGSHIP, "train.synthetic=true", "train.batch_size=8",
            "train.max_steps=2", "train.log_every_n_steps=1",
            "train.ckpt_every_n_steps=1000000", "train.keep_ckpts=1",
            "model.generator.gradient_checkpointing=true",
            f"root_data_dir={tmp}/train_remat"]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _, recs = run_trainer(args, TRAIN_REMAT_LAUNCHES, [1, 2])
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"  remat step, batch 8: first {recs[0]['seconds']:.3f} s, second "
        f"{recs[1]['seconds']:.3f} s (plain steps 2-6 median "
        f"{plain['step_s']:.3f} s); peak device memory {peak:.2f} GiB (plain "
        f"{plain['peak_gib']:.2f} GiB)")
    for rec, ref in zip(recs, plain["recs"]):
        rels = {k: abs(rec[k] - ref[k]) / abs(ref[k])
                for k in ("loss", "grad_norm")}
        log(f"  step {rec['step']} against the plain trainer's: loss "
            f"{rec['loss']:.8f} / {ref['loss']:.8f}, grad norm "
            f"{rec['grad_norm']:.8f} / {ref['grad_norm']:.8f}; rel "
            + ", ".join(f"{k} {v:.3e}" for k, v in rels.items())
            + f" (bar {REMAT_REL_BAR})")
        if max(rels.values()) > REMAT_REL_BAR:
            raise AssertionError(f"remat step {rec['step']}: {rels} "
                                 f"> {REMAT_REL_BAR}")
    return {"step_s": recs[1]["seconds"], "peak_gib": peak}


# the remat modes of the train_remat_policies phase: remat=True first (the
# reference each policy is held to), then again (the card's run-to-run
# spread), the plain step and the four policies
REMAT_MODES = (("remat=True", True), ("remat=True again", True),
               ("plain", False), ("dots", "dots"), ("dots_plus", "dots_plus"),
               ("flash", "flash"), ("flash_mlp", "flash_mlp"))


def detached_flash(q, k, v, scale):
    """The planted remat fault: the flash forward's output kept (the op a
    policy saves) without its graph to q, k and v, so the projections
    that make them get no gradient from attention."""
    from topiaxl_torch.ops import flash_attention as fa

    return fa.flash_fwd(q.detach(), k.detach(), v.detach(), scale)[0]


def phase_train_remat_policies(tmp: str) -> None:
    """The flagship recipe at batch 8 on enlivened weights (the zero-init
    layers filled, as the pp phase builds them), three ``make_train_step``
    steps under each remat mode from the same weights and draws: step
    seconds, peak memory and the launches of each step (which must be
    ``train_launches(mode)``, the counts tests/test_torch_remat.py holds
    on the CPU); each policy's loss and grad norm within
    ``REMAT_STEP_BARS`` of ``remat=True``'s at steps 1 and 2, and the
    planted fault (``detached_flash`` under ``flash``) beyond one; then,
    the train state held, one forward and backward of the DiT alone, whose
    peak leaves out the optimizer's. Then one short ``cli.train`` run with
    ``model.generator.remat=flash``."""
    import torch

    import topiaxl_torch.ops.attention as attention
    from topiaxl_torch.ops import _cuda
    from topiaxl_torch.pipelines.train import (create_train_state,
                                               make_train_step)

    card_id = card_line()
    cfg, dit, batch = pp_inputs(seed=20)
    p0 = {n: t.detach().cpu() for n, t in dit.state_dict().items()}
    diffusion, optimizer = pp_optimizer(cfg)

    def run(mode) -> dict:
        dit.load_state_dict(p0)
        dit.zero_grad(set_to_none=True)
        dit.remat = mode
        state = create_train_state(dit)
        step = make_train_step(dit, diffusion, optimizer)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        steps = []
        for _ in range(3):
            _cuda.reset_launch_counts()
            allocs = torch.cuda.memory_stats()["num_device_alloc"]
            t0 = time.perf_counter()
            m = {k: float(v) for k, v in step(state, batch, 0).items()}
            torch.cuda.synchronize()
            steps.append(dict(m, seconds=time.perf_counter() - t0,
                              launches=dict(_cuda.launches),
                              cuda_mallocs=torch.cuda.memory_stats()[
                                  "num_device_alloc"] - allocs))
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        # the model's own forward and backward, the train state held: the
        # peak without the optimizer's update, where the kept outputs show
        dit.zero_grad(set_to_none=True)
        torch.cuda.reset_peak_memory_stats()
        t = torch.arange(8, device="cuda") * 111
        dit(batch["x"], t, batch["y"]).square().mean().backward()
        fwd_bwd = torch.cuda.max_memory_allocated() / 2 ** 30
        del state, step
        dit.zero_grad(set_to_none=True)
        torch.cuda.empty_cache()
        return {"steps": steps, "peak_gib": peak, "fwd_bwd_gib": fwd_bwd}

    def rel(got: dict) -> list:
        """Per held step: {loss, grad_norm} relative to remat=True's."""
        return [{k: abs(a[k] - b[k]) / abs(b[k]) for k in ("loss",
                                                            "grad_norm")}
                for a, b in zip(got["steps"], ref["steps"])][:2]

    def crosses(r: list) -> bool:
        return any(v > bar for step, bar in zip(r, REMAT_STEP_BARS)
                   for v in step.values())

    def readings(r: list) -> str:
        return "; ".join(f"step {i + 1} loss {x['loss']:.3e} grad norm "
                         f"{x['grad_norm']:.3e} (bar {bar:.0e})"
                         for i, (x, bar) in enumerate(zip(r, REMAT_STEP_BARS)))

    runs = {label: run(mode) for label, mode in REMAT_MODES}
    keep = attention.flash_attention
    attention.flash_attention = detached_flash
    try:
        fault = run("flash")
    finally:
        attention.flash_attention = keep
    ref = runs["remat=True"]
    for label, mode in REMAT_MODES:
        res = runs[label]
        want = train_launches(mode)
        got = [{k: st["launches"][k] for k in want} for st in res["steps"]]
        st = res["steps"]
        log(f"  {label}: steps {st[0]['seconds']:.3f} / {st[1]['seconds']:.3f}"
            f" / {st[2]['seconds']:.3f} s (cudaMalloc calls "
            f"{' / '.join(str(x['cuda_mallocs']) for x in st)}), peak "
            f"{res['peak_gib']:.2f} GiB (forward and backward alone "
            f"{res['fwd_bwd_gib']:.2f} GiB); launches a step #1 "
            f"{got[0]['flash_attn_fwd']}, #4 {got[0]['flash_attn_bwd']}, #2 "
            f"{got[0]['ln_modulate']}, #3 {got[0]['ln_modulate_residual']}; "
            "loss " + " / ".join(f"{x['loss']:.8f}" for x in st)
            + ", grad norm " + " / ".join(f"{x['grad_norm']:.8f}" for x in st)
            + f"; against remat=True: {readings(rel(res))} ({card_id})")
        if any(g != want for g in got):
            raise AssertionError(f"{label} launches {got} != {want}")
        if isinstance(mode, str) and crosses(rel(res)):
            raise AssertionError(f"{label}: {rel(res)} > {REMAT_STEP_BARS}")
    log("  planted fault (the flash output kept without its graph to q, k, v)"
        f" under 'flash', against remat=True: {readings(rel(fault))}")
    if not crosses(rel(fault)):
        raise AssertionError(f"the planted remat fault passes: {rel(fault)}")
    del dit, p0
    torch.cuda.empty_cache()
    # the entry point takes a policy by name (two blocks: a short run)
    args = [FLAGSHIP, "train.synthetic=true", "train.batch_size=8",
            "train.max_steps=1", "train.log_every_n_steps=1",
            "train.ckpt_every_n_steps=1000000", "train.keep_ckpts=1",
            "model.generator.depth=2", "model.generator.remat=flash",
            f"root_data_dir={tmp}/train_flash"]
    run_trainer(args, train_launches("flash", 2), [1])


def phase_train_long(tmp: str) -> dict:
    args = [FLAGSHIP, "model.num_prims=4096", "model.generator.depth=2",
            "train.synthetic=true", "train.batch_size=2", "train.max_steps=2",
            "train.log_every_n_steps=1", f"root_data_dir={tmp}/train_long"]
    total, _ = run_trainer(args, TRAIN_LONG_LAUNCHES, [1, 2],
                           {"overlapped": 4, "serial": 0})
    return total


def qk_norm_rows(q, gamma, dy, scale: float, form: str, where: str) -> dict:
    """The QK norm's kernels in ``form`` ("l2", TRELLIS's; "rms", FLUX's)
    on q [B, N, H, D] against their plain twins: the forward within one
    bf16 rounding (2^-8), dx and dgamma within 2^-7, a planted fault (the
    gains left out) above each bar; ms beside the bytes bound and the
    plain version's. Returns the rows, keyed by the launch counters' names
    of the form."""
    import torch

    from topiaxl_torch.ops import qk_norm as Q

    card_id = card_line()
    fwd, bwd = Q._NAMES[form]
    B, N, H, D = q.shape
    y, (dx, dgam) = (Q._forward(q, gamma, scale, form),
                     Q._backward(q, dy, gamma, scale, form))
    y_ref = Q.qk_rms_norm_plain(q, gamma, scale, form)
    dx_ref, dg_ref = Q.qk_rms_norm_bwd_plain(q, dy, gamma, scale, form)
    ones = torch.ones_like(gamma)
    fault, _ = Q.qk_rms_norm_bwd_plain(q, dy, ones, scale, form)
    errs = {fwd: rel_err(y, y_ref),
            bwd: max(rel_err(dx, dx_ref), rel_err(dgam, dg_ref))}
    bars = {fwd: 2 ** -8, bwd: 2 ** -7}
    faults = {fwd: rel_err(Q.qk_rms_norm_plain(q, ones, scale, form), y_ref),
              bwd: rel_err(fault, dx_ref)}
    del y, dx, fault, y_ref, dx_ref
    elems = B * N * H * D
    calls = {fwd: (lambda: Q._forward(q, gamma, scale, form),
                   lambda: Q.qk_rms_norm_plain(q, gamma, scale, form),
                   2 * 2 * elems + 4 * H * D),
             bwd: (lambda: Q._backward(q, dy, gamma, scale, form),
                   lambda: Q.qk_rms_norm_bwd_plain(q, dy, gamma, scale, form),
                   3 * 2 * elems + 8 * H * D)}
    rows = {}
    for name, (kern, plain, nbytes) in calls.items():
        ms, plain_ms = cuda_ms(kern, 50), cuda_ms(plain, 5)
        bound_ms, bound_by = bound(10 * elems, nbytes, PEAK_F32_FLOPS)
        log(f"  {name} {B}x{N}x{H}x{D} ({where}): max rel err "
            f"{errs[name]:.3e} (bar {bars[name]:.3e}; gains-left-out fault "
            f"{faults[name]:.3e}), kernel {ms:.4f} ms, plain {plain_ms:.4f} "
            f"ms, bound {bound_ms:.4f} ms ({bound_by}; share "
            f"{bound_ms / ms:.1%}), library: none (no single PyTorch call "
            f"computes it) ({card_id})")
        if not errs[name] <= bars[name] < faults[name]:
            raise AssertionError(f"{name}: error {errs[name]}, fault "
                                 f"{faults[name]}, bar {bars[name]}")
        rows[name] = dict(at=f"{B}x{N}x{H}x{D}", ms=ms, plain_ms=plain_ms,
                          bound_ms=bound_ms, bound_by=bound_by,
                          max_rel_err=errs[name])
    return rows


def phase_ss_flow() -> dict:
    """TRELLIS's flow transformer's kernels at its training shapes: the QK
    norm forward and backward, flash #1 in its overlapped loop
    (``fwd_overlap_row``), and the single pass (#4) beside the pair (#5,
    #6) at head dim 64 (``bwd_side_by_side``), each against
    its plain version with a planted fault, ms beside its bound and the
    plain version's. Returns the rows."""
    import torch

    from topiaxl_torch.ops import flash_attention as fa

    g = torch.Generator("cuda").manual_seed(19)

    def randn(*shape):
        return torch.randn(shape, generator=g, device="cuda").bfloat16()

    rows = {}
    B, N, M, H, D = 8, 4096, 1374, 16, 64
    q = randn(B, N, 3, H, D).unbind(2)[0]
    gamma = 1 + 0.1 * torch.randn((H, D), generator=g, device="cuda")
    rows.update(qk_norm_rows(q, gamma, randn(B, N, H, D), D ** 0.5, "l2",
                             "q in place in qkv"))
    del q
    for tag, Sk in (("self", N), ("cross", M)):
        sc = D ** -0.5
        if tag == "self":
            qq, k, v = randn(B, N, 3, H, D).unbind(2)
            qq = qq.contiguous()
        else:
            qq, k, v = randn(B, N, H, D), randn(B, Sk, H, D), randn(B, Sk, H, D)
        do = randn(B, N, H, D)
        # the forward: its overlapped loop against the plain version
        fwd = fwd_overlap_row(f"ss_flow {tag}", qq, k, v, sc, nb=2)
        f_ms, f_bound = fwd["ms"], fwd["bound_ms"]
        shape = fwd["at"]
        o, lse = fa._forward(qq, k, v, sc, return_lse=True)
        # the backward: the single pass (its overlapped loop) beside the
        # pair, the rule's form through the wrapper
        back = bwd_side_by_side(f"ss_flow {tag}", qq, k, v, o, lse, do, sc,
                                nb=2)
        rows[f"flash_{tag}"] = dict(at=shape, fwd_ms=f_ms, fwd_bound_ms=f_bound,
                                    bwd_form=fa.bwd_form(Sk, D),
                                    bwd_ms=back["single_pass_ms"],
                                    bwd_pair_ms=back["pair_ms"],
                                    bwd_bound_ms=back["bound_ms"])
        del qq, k, v, do, o, lse
        torch.cuda.empty_cache()
    return rows


def cli_train_rows(config: str, tag: str, expected: dict, loops: dict,
                   tmp: str) -> dict:
    """``cli.train`` on ``config`` at its published widths: three steps on
    the synthetic stream, each step's launches ``expected`` and its
    single-pass backwards by loop ``loops``, finite losses; step seconds
    and peak memory."""
    import torch

    from topiaxl_torch.cli.train import main
    from topiaxl_torch.ops import _cuda

    torch.cuda.reset_peak_memory_stats()
    recs = PerStep()
    _cuda.reset_launch_counts()
    rc = main([config, "train.synthetic=true", "train.max_steps=3",
               "train.log_every_n_steps=1", "train.ckpt_every_n_steps=1000",
               f"root_data_dir={tmp}/{tag}"], metrics_out=recs)
    if rc != 0 or [r["step"] for r in recs] != [1, 2, 3]:
        raise AssertionError(f"{tag} cli.train returned {rc} after steps "
                             f"{[r['step'] for r in recs]}")
    prev = dict.fromkeys(_cuda.launches, 0)
    for rec in recs:
        per = {k: rec["launches"][k] - prev[k] for k in prev}
        prev = rec["launches"]
        log(f"  {tag} step {rec['step']}: {rec['seconds']:.3f} s, loss "
            f"{rec['loss']:.5f}, grad norm {rec['grad_norm']:.5f}; launches "
            f"{per}")
        if per != expected or not np.isfinite(
                [rec["loss"], rec["grad_norm"]]).all():
            raise AssertionError(f"{tag} step {rec['step']}: launches "
                                 f"{per} != {expected} or metrics {rec}")
    step_loops(recs, loops)
    peak = torch.cuda.max_memory_allocated() / 1e9
    log(f"  {tag}: peak memory {peak:.2f} GB ({card_line()})")
    return {"step_s": [r["seconds"] for r in recs], "peak_gb": peak}


def phase_ss_flow_train(tmp: str) -> dict:
    """``cli.train`` on TRELLIS's flow transformer at its published widths
    (``cli_train_rows``), each step's launches ``SS_FLOW_LAUNCHES``."""
    return cli_train_rows(SS_FLOW_CONFIG, "ss_flow", SS_FLOW_LAUNCHES,
                          SS_FLOW_BWD_LOOPS, tmp)


def phase_mmdit(tmp: str) -> dict:
    """Hunyuan3D-2's shape DiT at its training shapes (batch 4, 16 heads of
    64, 3072 latent + 1370 conditioning tokens joined): the QK norm's rms
    form on q read in place from a single block's linear1 rows (7168 wide)
    at 4 x 4442 x 16 x 64 (``qk_norm_rows``); flash #1 in its overlapped
    loop (``fwd_overlap_row``) and the single pass (#4) beside the pair
    (``bwd_side_by_side``) at the joint shape 4 x 4442 x 4442 x 16 x 64,
    whose last q tile is ragged (4442 = 34 x 128 + 90), v strided as
    linear1 leaves it; then three ``cli.train`` steps of
    ``configs/hunyuan3d_dit.yml`` (``cli_train_rows``, each step's launches
    ``MMDIT_LAUNCHES``). Returns the rows."""
    import torch

    from topiaxl_torch.ops import flash_attention as fa

    g = torch.Generator("cuda").manual_seed(23)

    def randn(*shape):
        return torch.randn(shape, generator=g, device="cuda").bfloat16()

    B, L, H, D, W = 4, 4442, 16, 64, 7168
    lin = randn(B, L, W)
    q = lin[..., :3 * H * D].unflatten(-1, (3, H, D)).unbind(2)[0]
    gain = 1 + 0.1 * torch.randn((D,), generator=g, device="cuda")
    rows = qk_norm_rows(q, gain.expand(H, D).contiguous(), randn(B, L, H, D),
                        1.0, "rms", "q in place in linear1's rows")
    q, k, v = lin[..., :3 * H * D].unflatten(-1, (3, H, D)).unbind(2)
    q, k = q.contiguous(), k.contiguous()
    do = randn(B, L, H, D)
    sc = D ** -0.5
    fwd = fwd_overlap_row("mmdit joint", q, k, v, sc, nb=1)
    o, lse = fa._forward(q, k, v, sc, return_lse=True)
    back = bwd_side_by_side("mmdit joint", q, k, v, o, lse, do, sc, nb=1)
    rows["flash_joint"] = dict(at=fwd["at"], fwd_ms=fwd["ms"],
                               fwd_bound_ms=fwd["bound_ms"],
                               bwd_form=fa.bwd_form(L, D),
                               bwd_ms=back["single_pass_ms"],
                               bwd_pair_ms=back["pair_ms"],
                               bwd_bound_ms=back["bound_ms"])
    del lin, q, k, v, do, o, lse
    torch.cuda.empty_cache()
    rows["train"] = cli_train_rows(MMDIT_CONFIG, "mmdit", MMDIT_LAUNCHES,
                                   MMDIT_BWD_LOOPS, tmp)
    return rows


def flash_d128_rows(tag: str, q, k, v, do, scale: float) -> dict:
    """#1 (its ping-pong loop at 128) and the backward the rule takes
    (``bwd_form``) through the wrappers, beside the other form
    (``padded_bwd_launch``), against the plain versions on the first batch
    row within ``ATTN_REL_BAR``, ``LSE_ABS_BAR`` and ``ATTN_BWD_REL_BAR``,
    the unmasked-padding and no-delta faults above them; ms (CUDA graphs)
    beside the bounds. Returns the row."""
    import torch

    from topiaxl_torch.ops import _cuda
    from topiaxl_torch.ops import flash_attention as fa

    B, Sq, H, D = q.shape
    Sk = k.shape[1]
    shape = f"{B}x{Sq}x{Sk}x{H}x{D}"
    before = dict(_cuda.fwd_loops), dict(_cuda.launches)
    o, lse = fa._forward(q, k, v, scale, return_lse=True)
    grads = fa.flash_attention_backward(q, k, v, o, lse, do, scale)
    torch.cuda.synchronize()
    loops = {n: c - before[0][n] for n, c in _cuda.fwd_loops.items()}
    names = ("flash_attn_bwd", "flash_attn_bwd_dq", "flash_attn_bwd_dkv")
    launched = {n: _cuda.launches[n] - before[1][n] for n in names}
    part = [t[:1] for t in (q, k, v)]
    o_ref, lse_ref = fa.flash_attention_plain(*part, scale, return_lse=True)
    o_rel = rel_err(o[:1], o_ref)
    lse_err = (lse[:1] - lse_ref).abs().max().item()
    unmasked = (rel_err(fa.flash_attention_unmasked(*part, scale), o_ref)
                if Sk % fa.KEY_TILE else None)
    del o_ref, lse_ref
    ref = fa.flash_attention_bwd_plain(*part, o[:1], lse[:1], do[:1], scale)
    b_rel = max(rel_err(a[:1], r) for a, r in zip(grads, ref))
    no_delta = max(rel_err(a, r) for a, r in zip(fa.flash_attention_bwd_plain(
        *part, o[:1], lse[:1], do[:1], scale, with_delta=False)[:2], ref[:2]))
    del grads, ref
    f_ms = cuda_ms(lambda: fa._forward(q, k, v, scale, return_lse=True), 10)
    f_bound, _ = bound(4 * B * H * Sq * Sk * D,
                       2 * (2 * B * Sq + 2 * B * Sk) * H * D)
    form = fa.bwd_form(Sk, D)
    ms = {}
    for name in ("fused", "pair"):
        _, launch, _ = padded_bwd_launch(name, q, k, v, o, lse, do, scale)
        ms[name] = cuda_ms(launch, 3)
    b_bound, _ = bound(8 * B * H * Sq * Sk * D,
                       2 * B * H * D * (4 * Sq + 4 * Sk) + 4 * B * H * Sq)
    rule_ms = ms["fused" if form == "fused" else "pair"]
    log(f"  h21 {tag} {shape}: forward (loops {loops}) o max rel err "
        f"{o_rel:.3e} (bar {ATTN_REL_BAR}; unmasked-padding fault "
        f"{unmasked}), lse {lse_err:.3e}, {f_ms:.4f} ms (bound {f_bound:.4f}, "
        f"share {f_bound / f_ms:.1%}); backward {form} (launches {launched}) "
        f"max rel err {b_rel:.3e} (bar {ATTN_BWD_REL_BAR}; no-delta fault "
        f"{no_delta:.3e}), single pass {ms['fused']:.4f} ms, pair "
        f"{ms['pair']:.4f} ms (bound {b_bound:.4f}, the rule's share "
        f"{b_bound / rule_ms:.1%}) ({card_line()})")
    pair = form != "fused"
    if not (o_rel <= ATTN_REL_BAR and lse_err <= LSE_ABS_BAR
            and b_rel <= ATTN_BWD_REL_BAR < no_delta
            and (unmasked is None or unmasked > ATTN_REL_BAR)):
        raise AssertionError(f"h21 {tag}: o {o_rel}, lse {lse_err}, backward "
                             f"{b_rel}, faults {unmasked} / {no_delta}")
    if loops != {"overlapped": 0, "pingpong": 1} or launched != dict(
            zip(names, (int(not pair), int(pair), int(pair)))):
        raise AssertionError(f"h21 {tag}: loops {loops}, launches {launched}")
    return dict(at=shape, fwd_ms=f_ms, fwd_bound_ms=f_bound, bwd_form=form,
                bwd_ms=rule_ms, bwd_single_pass_ms=ms["fused"],
                bwd_pair_ms=ms["pair"], bwd_bound_ms=b_bound,
                max_rel_err=max(o_rel, b_rel))


def phase_h21(tmp: str) -> dict:
    """Hunyuan3D-2.1's shape DiT at its training shapes (batch 2, 16 heads
    of 128, 4096 latent tokens and the time token, 1370 conditioning
    tokens): the QK norm's rms form at D 128 on q read in place from the
    joined heads (``qk_norm_rows``); flash #1 and the backward the rule
    takes at 2 x 4097 x {4097, 1370} x 16 x 128, ragged last q (and key)
    tiles (``flash_d128_rows``); ``ln_modulate`` and
    ``ln_modulate_residual`` at 2 x 4097 x 2048 with the blocks' operands
    (``ln_rows``); one MoE block at the published widths,
    forward and backward under ``torch.cuda.set_sync_debug_mode("error")``
    (no read to the host), its grouped products timed beside their
    operations; then three ``cli.train`` steps of
    ``configs/hunyuan3d21_dit.yml`` (``cli_train_rows``, each step's
    launches ``H21_LAUNCHES``), every MoE layer's slot counter at 2 x
    8194 a step. Returns the rows."""
    import torch

    from topiaxl_torch.models import hunyuandit as H
    from topiaxl_torch.models import moe as MOE

    g = torch.Generator("cuda").manual_seed(25)

    def randn(*shape):
        return torch.randn(shape, generator=g, device="cuda").bfloat16()

    B, L, M, H_, D = 2, 4097, 1370, 16, 128
    joined = randn(B, L, H_, 3 * D)
    gain = 1 + 0.1 * torch.randn((D,), generator=g, device="cuda")
    rows = qk_norm_rows(joined[..., :D], gain.expand(H_, D).contiguous(),
                        randn(B, L, H_, D), 1.0, "rms",
                        "q in place in the joined heads")
    q, k, v = (t.contiguous() if i < 2 else t
               for i, t in enumerate(joined.split(D, dim=-1)))
    rows["flash_self"] = flash_d128_rows("self", q, k, v, randn(B, L, H_, D),
                                         D ** -0.5)
    kv = randn(B, M, H_, 2 * D)
    rows["flash_cross"] = flash_d128_rows(
        "cross", randn(B, L, H_, D), kv[..., :D].contiguous(), kv[..., D:],
        randn(B, L, H_, D), D ** -0.5)
    del joined, q, k, v, kv
    # the LNs at width 2048 (the launcher's widest-row instance) with the
    # operands the blocks pass: an affine LN as a modulation (shift the
    # bias, scale the gain less one, one row for the batch) and a gate of
    # ones
    C = 2048
    weight = 1 + 0.1 * torch.randn((C,), generator=g, device="cuda")
    bias = 0.1 * torch.randn((C,), generator=g, device="cuda")
    sh = bias.bfloat16()[None].expand(B, -1)
    sc = (weight - 1).bfloat16()[None].expand(B, -1)
    one = torch.ones(C, dtype=torch.bfloat16, device="cuda")[None].expand(B, -1)
    rows["ln"] = ln_rows(randn(B, L, C), randn(B, L, C), one, sh, sc)
    torch.cuda.empty_cache()
    blk = H.HunYuanDiTBlock(2048, 16, 1024, skip=True, moe=True,
                            param_dtype=torch.float32)
    blk.to_empty(device="cuda")
    with torch.no_grad():
        for name, p in blk.named_parameters():
            if name.endswith("bias"):
                p.normal_(0.0, 0.02, generator=g)
            elif p.dim() == 1:
                p.normal_(1.0, 0.02, generator=g)
            else:
                p.normal_(0.0, p.shape[-1] ** -0.5, generator=g)
    blk.moe.counter = "block"
    blk.train()
    x, skip = (randn(B, L, 2048).requires_grad_() for _ in range(2))
    y = torch.nn.functional.layer_norm(torch.randn(
        (B, M, 1024), generator=g, device="cuda"), (1024,)).bfloat16()
    blk(x, y, skip).float().square().mean().backward()
    torch.cuda.synchronize()
    MOE.reset_expert_tokens()
    torch.cuda.set_sync_debug_mode("error")
    try:
        blk(x, y, skip).float().square().mean().backward()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    counted = MOE.read_expert_tokens()["block"]
    if sum(counted) != 2 * B * L:
        raise AssertionError(f"h21 MoE block: slots {counted}")
    flat = x.detach().reshape(-1, 2048)
    experts, _, _ = blk.moe.route(flat)
    dest, offs, row_expert, _ = MOE.dispatch_plan(experts.reshape(-1), 8)
    buf = flat.new_zeros((MOE.rows(2 * B * L, 8), 2048)).index_copy(
        0, dest, flat.repeat_interleave(2, dim=0))
    w1 = blk.moe.fc1_weight.detach().bfloat16()
    ms = cuda_ms(lambda: MOE.grouped_mm(buf, w1.transpose(1, 2), offs), 10)
    flops = 2 * 2 * B * L * 2048 * 8192
    log(f"  h21 MoE block: forward and backward with no host sync, slots by "
        f"expert {counted}; fc1's grouped product {ms:.4f} ms ("
        f"{flops / ms / 1e9:.1f} TFLOP/s, {flops / ms / 1e9 / 989.4:.1%} of "
        f"the bf16 peak) ({card_line()})")
    rows["moe_fc1"] = dict(at=f"{2 * B * L}x2048x8192 in 8 groups", ms=ms,
                           tflops=flops / ms / 1e9, slots=counted)
    del blk, x, skip, y, flat, buf, w1
    torch.cuda.empty_cache()
    MOE.reset_expert_tokens()
    rows["train"] = cli_train_rows(H21_CONFIG, "h21", H21_LAUNCHES,
                                   H21_BWD_LOOPS, tmp)
    slots = MOE.read_expert_tokens()
    if len(slots) != 4 or any(sum(c) != 3 * 2 * B * L for c in slots.values()):
        raise AssertionError(f"h21 cli.train: slots {slots}")
    log(f"  h21 cli.train: slots by layer and expert over three steps {slots}")
    return rows


# adamw_ema: the trainers' parameter sets (each model as cli.train builds
# it: f32 masters on the card), one update through the kernel against the
# plain foreach version on copies, both on the card: p, m, v and e within
# 1e-6 of each tensor's max |plain|, and the change p' - p, beyond one f32
# ulp of the tensor's largest weight, within 1e-5 of its max |plain
# change| (where the two round u an ulp apart, p' may land an ulp away: at
# LayerNorm gains of 1 and lr 1e-4 that ulp is ~1e-3 of the change); the
# plain version without the second moment's bias correction (a planted
# fault) must land above the change's bar. 36 bytes a parameter bound it.
ADAMW_SETS = (("xl_train", FLAGSHIP), ("trellis_ss_flow", SS_FLOW_CONFIG),
              ("hunyuan3d_dit", MMDIT_CONFIG))
ADAMW_BYTES = 36
ADAMW_BARS = {"p": 1e-6, "m": 1e-6, "v": 1e-6, "e": 1e-6, "change": 1e-5}


def adamw_gaps(got: dict, ref: dict, p0: list) -> dict:
    """Worst over the tensors of max |got - ref| / max |ref| for p, m, v,
    e, and of the change p' - p against ``ref``'s beyond one f32 ulp of
    the tensor's largest weight, over ``ref``'s max change (p0 the weights
    before the step)."""
    import torch

    out = {}
    for key in "pmve":
        out[key] = max(float((a - b).abs().max() / b.abs().max())
                       for a, b in zip(got[key], ref[key]) if b.numel())
    ulp = torch.finfo(torch.float32).eps
    out["change"] = max(
        max(float((a - b).abs().max() - ulp * b.abs().max()), 0.0)
        / float((b - w).abs().max())
        for a, b, w in zip(got["p"], ref["p"], p0) if w.numel())
    return out


def phase_adamw_ema() -> dict:
    """The clip + AdamW + EMA kernel (``csrc/adamw_ema.cu``) at the three
    trainers' parameter sets: its errors against the plain version with a
    planted fault, its ms beside its 36 B-a-parameter bound, the plain
    foreach version's ms, ``torch.optim.AdamW(fused=True)``'s (a yardstick:
    no clip, no EMA; the port never calls it), the host's ms a call
    (``fused_adamw_ema_update`` through the kernel, the wrapper alone, the
    plain version alone; each call started with the card idle) and one
    launch a call. Returns the rows."""
    import torch

    from topiaxl_torch.cli.train import build_dit
    from topiaxl_torch.core.config import load_config
    from topiaxl_torch.ops import _cuda
    from topiaxl_torch.ops import adamw_ema as A
    from topiaxl_torch.pipelines import train as T

    rows = {}
    for tag, config in ADAMW_SETS:
        gen = torch.Generator("cuda").manual_seed(24)
        model = build_dit(load_config(config).model.generator, "cuda", gen)
        params = list(model.parameters())
        p = [t.data for t in params]
        n = sum(t.numel() for t in p)

        def draw(scale, like):
            return [scale * torch.randn(t.shape, generator=gen, device="cuda")
                    for t in like]

        g, m = draw(1e-3, p), draw(1e-4, p)
        v = [t.square() for t in draw(1e-4, p)]
        e = [t + d for t, d in zip(p, draw(1e-3, p))]
        # the count of a step well into training: bias corrections near 1
        hyper = dict(lr=1e-4, c1=float(1 - np.float32(0.9) ** 101),
                     c2=float(1 - np.float32(0.999) ** 101), b1=0.9,
                     b2=0.999, eps=1e-8, wd=0.01, decay=0.9999)
        gscale = torch.full((), 0.5, device="cuda")
        items = len(A.work_items([t.numel() for t in p]))

        def copies(*lists):
            return [[t.clone() for t in ts] for ts in lists]

        # one step from the same state each way
        p0, *ref = copies(p, p, m, v, e)
        before = _cuda.launches["adamw_ema"]
        A.adamw_ema(p, g, m, v, e, gscale, **hyper)
        launched = _cuda.launches["adamw_ema"] - before
        A.adamw_ema_plain(*ref[:1], g, *ref[1:], gscale, **hyper)
        gaps = adamw_gaps(dict(p=p, m=m, v=v, e=e), dict(zip("pmve", ref)),
                          p0)
        del p0, ref
        torch.cuda.empty_cache()
        # the next step from the kernel's state, against the plain version
        # without the second moment's bias correction (c2 = 1)
        p1, *bad = copies(p, p, m, v, e)
        A.adamw_ema(p, g, m, v, e, gscale, **hyper)
        A.adamw_ema_plain(*bad[:1], g, *bad[1:], gscale,
                          **dict(hyper, c2=1.0))
        fault = adamw_gaps(dict(p=p, m=m, v=v, e=e), dict(zip("pmve", bad)),
                           p1)["change"]
        del p1, bad
        torch.cuda.empty_cache()
        if launched != 1 or fault <= ADAMW_BARS["change"] or any(
                gaps[k] > bar for k, bar in ADAMW_BARS.items()):
            raise AssertionError(f"adamw_ema {tag}: launches {launched}, gaps "
                                 f"{gaps} (bars {ADAMW_BARS}), planted fault "
                                 f"{fault:.3e}")
        kernel_ms = events_ms(lambda: A.adamw_ema(p, g, m, v, e, gscale,
                                                  **hyper), 20)
        plain_ms = events_ms(lambda: A.adamw_ema_plain(p, g, m, v, e, gscale,
                                                       **hyper), 5)
        torch.cuda.empty_cache()

        # the host's median ms a call, each call started with the card idle
        # (so nothing waits on a full queue or a busy pinned buffer): the
        # trainer's whole update through the kernel, the kernel's wrapper
        # alone and the plain foreach version alone
        names = [str(i) for i in range(len(p))]
        state = T.AdamState(100, dict(zip(names, m)), dict(zip(names, v)))
        spec = T.make_optimizer(lr=1e-4, weight_decay=0.01, grad_clip=1.0,
                                schedule="constant")
        args = (dict(zip(names, g)), state, dict(zip(names, params)),
                dict(zip(names, e)), spec)

        def host_ms(update, calls=21) -> float:
            """The median of ``calls`` calls' host ms."""
            times = []
            for _ in range(calls):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                update()
                times.append((time.perf_counter() - t0) * 1e3)
            torch.cuda.synchronize()
            return statistics.median(times)

        host = host_ms(lambda: T.fused_adamw_ema_update(*args))
        wrapper_host = host_ms(lambda: A.adamw_ema(p, g, m, v, e, gscale,
                                                   **hyper))
        plain_host = host_ms(lambda: A.adamw_ema_plain(p, g, m, v, e, gscale,
                                                       **hyper))
        torch.cuda.empty_cache()
        del m, v, e, state, args
        for t, d in zip(params, g):
            t.grad = d
        opt = torch.optim.AdamW(params, lr=1e-4, weight_decay=0.01,
                                fused=True)
        library = events_ms(opt.step, 10)
        del opt, g, p, params, model
        bound_ms = ADAMW_BYTES * n / PEAK_BYTES_PER_S * 1e3
        rows[tag] = dict(params=n, tensors=len(names), items=items,
                         ms=kernel_ms, bound_ms=bound_ms,
                         share=bound_ms / kernel_ms, plain_ms=plain_ms,
                         library_ms=library, host_ms=host,
                         wrapper_host_ms=wrapper_host,
                         plain_host_ms=plain_host, gaps=gaps,
                         planted_fault=fault)
        log(f"  adamw_ema {tag}: {n} parameters in {len(names)} tensors, "
            f"{items} work items: {kernel_ms:.4f} ms (bound "
            f"{bound_ms:.4f} ms at {ADAMW_BYTES} B a parameter, "
            f"{100 * bound_ms / kernel_ms:.1f}%), plain foreach "
            f"{plain_ms:.4f} ms, torch.optim.AdamW(fused=True) {library:.4f}"
            f" ms; host ms a call {host:.3f} (the wrapper {wrapper_host:.3f}"
            f", the plain version {plain_host:.3f}); gaps "
            + ", ".join(f"{k} {v:.2e}" for k, v in gaps.items())
            + f" (bars {ADAMW_BARS}), planted fault {fault:.2e}; "
            f"{card_line()}")
        torch.cuda.empty_cache()
    return rows


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
              "ln_modulate_residual": 4, **NO_PROBES, **NO_QK_NORM,
              "adamw_ema": 0}
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


def icosphere_mesh(subdivisions: int = 5, radius: float = 0.5):
    """An icosahedron subdivided ``subdivisions`` times onto the sphere
    (20 * 4^n faces), faces wound outward."""
    t = (1 + 5 ** 0.5) / 2
    v = [(-1, t, 0), (1, t, 0), (-1, -t, 0), (1, -t, 0), (0, -1, t),
         (0, 1, t), (0, -1, -t), (0, 1, -t), (t, 0, -1), (t, 0, 1),
         (-t, 0, -1), (-t, 0, 1)]
    v = [np.asarray(p, np.float64) / np.linalg.norm(p) for p in v]
    f = [(0, 11, 5), (0, 5, 1), (0, 1, 7), (0, 7, 10), (0, 10, 11), (1, 5, 9),
         (5, 11, 4), (11, 10, 2), (10, 7, 6), (7, 1, 8), (3, 9, 4), (3, 4, 2),
         (3, 2, 6), (3, 6, 8), (3, 8, 9), (4, 9, 5), (2, 4, 11), (6, 2, 10),
         (8, 6, 7), (9, 8, 1)]
    for _ in range(subdivisions):
        mids: dict = {}

        def mid(a, b):
            key = (min(a, b), max(a, b))
            if key not in mids:
                m = v[a] + v[b]
                v.append(m / np.linalg.norm(m))
                mids[key] = len(v) - 1
            return mids[key]

        f = [g for a, b, c in f for g in (
            (a, mid(a, b), mid(c, a)), (b, mid(b, c), mid(a, b)),
            (c, mid(c, a), mid(b, c)), (mid(a, b), mid(b, c), mid(c, a)))]
    v = radius * np.asarray(v, np.float32)
    f = np.asarray(f, np.int64)
    tri = v[f]
    n = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    inward = (n * tri.mean(1)).sum(-1) < 0
    f[inward] = f[inward][:, ::-1]
    return v, f


def bowl_mesh(res: int = 64):
    """A concave solid: the box [-0.5, 0.5]^3 less a sphere of radius 0.4
    centred on its top face, through the port's marching tetrahedra."""
    from topiaxl_torch.extract.isosurface import extract_isosurface

    lin = np.linspace(-1, 1, res, dtype=np.float32)
    z, y, x = np.meshgrid(lin, lin, lin, indexing="ij")
    box = np.maximum(np.maximum(np.abs(x), np.abs(y)), np.abs(z)) - 0.5
    ball = np.sqrt(x ** 2 + y ** 2 + (z - 0.5) ** 2) - 0.4
    return extract_isosurface(np.maximum(box, -ball))


def near_surface_points(sdf, n: int, seed: int) -> np.ndarray:
    """Surface samples with N(0, 0.05) jitter, as the fit draws its
    near-surface half, from seeds the fit does not use."""
    rng = np.random.default_rng(seed)
    pts = sdf.sample_surface(n, seed=seed) + rng.normal(0, 0.05, (n, 3))
    return pts.astype(np.float32).clip(-1, 1)


def faulty_fit_loss(params, pts, tgt_sdf, tgt_tex, tgt_mat, it, cfg,
                    weights):
    """``pipelines/fit.py:fit_loss`` with the volume term over scale in
    place of 1/scale (the planted fault)."""
    from topiaxl_torch.models import primx as PX
    from topiaxl_torch.pipelines.losses import primsdf_fit_loss

    out = PX.query(params, pts, dim_feat=cfg.dim_feat,
                   prim_shape=cfg.prim_shape, training=True)
    N = params.srt.shape[0]
    preds = {"sdf": out["sdf"], "tex": out["feat"][:, 1:4],
             "mat": out["feat"][:, 4:6],
             "prim_scale": params.srt[:, 0:1].expand(N, 3)[None]}
    return primsdf_fit_loss({"sdf": tgt_sdf, "tex": tgt_tex, "mat": tgt_mat},
                            preds, weights, it, cfg.shape_opt_steps,
                            cfg.tex_opt_steps)


def check_fit_step(params, sdf, surface) -> None:
    """One fit step's loss and gradients (shape stage) at full width, card
    against CPU in f32, and the planted fault against the CPU."""
    import torch

    from topiaxl_torch.models.primx import PrimXParams
    from topiaxl_torch.pipelines import fit as F

    cfg = F.FitConfig(shape_opt_steps=150, tex_opt_steps=250)
    weights = F.fit_weights(cfg, None, None)
    pts = F.sample_batch(np.random.default_rng(5), cfg, surface)
    arrs = (pts, sdf(pts)[:, None], np.zeros((len(pts), 3), np.float32),
            np.zeros((len(pts), 2), np.float32))

    def run(dev, loss_fn):
        p = PrimXParams(params.srt.detach().to(dev).clone().requires_grad_(),
                        params.feat.detach().to(dev).clone().requires_grad_())
        batch = [torch.from_numpy(a).to(dev) for a in arrs]
        loss, _ = loss_fn(p, *batch, 100, cfg, weights)
        loss.backward()
        return loss.item(), {"srt": p.srt.grad.cpu(), "feat": p.feat.grad.cpu()}

    ref_loss, ref = run("cpu", F.fit_loss)

    def readings(loss, grads):
        rels = {k: ((g - ref[k]).abs().max() / ref[k].abs().max()).item()
                for k, g in grads.items()}
        return abs(loss - ref_loss) / abs(ref_loss), rels

    loss_rel, rels = readings(*run("cuda", F.fit_loss))
    f_loss, f_rels = readings(*run("cuda", faulty_fit_loss))
    log(f"  one fit step (2048 prims, 8192 points, shape stage) card vs cpu "
        f"f32: loss {ref_loss:.6f}, rel {loss_rel:.3e} (bar {FIT_LOSS_BAR}); "
        f"grad rel srt {rels['srt']:.3e}, feat {rels['feat']:.3e} (bar "
        f"{FIT_GRAD_BAR}); planted fault (volume over scale): loss rel "
        f"{f_loss:.3e}, grad rel srt {f_rels['srt']:.3e}, feat "
        f"{f_rels['feat']:.3e}")
    if loss_rel > FIT_LOSS_BAR or max(rels.values()) > FIT_GRAD_BAR:
        raise AssertionError("fit step: card vs cpu outside its bars")
    if f_loss <= FIT_LOSS_BAR and max(f_rels.values()) <= FIT_GRAD_BAR:
        raise AssertionError("fit step: the bars cannot see the planted fault")


def phase_prepare_data(tmp: str) -> dict:
    """``topiaxl_torch.cli.prepare_data.main`` on two meshes written here (a
    20480-face icosphere and a concave box less a sphere) at the flagship
    config: 2048 prims of 8^3, 150 shape steps in 250, the flagship VAE and
    DINOv2. Checks each asset's launches, the shard, each fitted field
    against its mesh, MeshSDF and one fit step card vs CPU."""
    import torch

    from topiaxl_torch.cli.prepare_data import main
    from topiaxl_torch.extract.mesh_sdf import MeshSDF
    from topiaxl_torch.extract.objio import (load_obj, normalize_to_unit_cube,
                                             save_obj)
    from topiaxl_torch.models import primx as PX
    from topiaxl_torch.ops import _cuda

    mesh_dir = os.path.join(tmp, "meshes")
    os.makedirs(mesh_dir)
    for name, (v, f) in (("icosphere", icosphere_mesh()),
                         ("bowl", bowl_mesh())):
        save_obj(os.path.join(mesh_dir, f"{name}.obj"), v, f)
    out = os.path.join(tmp, "shards")
    recs = PerStep()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    _cuda.reset_launch_counts()
    t0 = time.perf_counter()
    rc = main([FLAGSHIP, f"data.input_glob={mesh_dir}/*.obj",
               f"data.output_dir={out}", "data.assets_per_shard=2",
               "data.shape_opt_steps=150", "data.tex_opt_steps=250",
               f"root_data_dir={tmp}/prep"], records_out=recs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    if rc != 0 or len(recs) != 2:
        raise AssertionError(f"prepare_data returned {rc}, {len(recs)} assets")
    prev = dict.fromkeys(PREP_LAUNCHES, 0)
    fitted = {}
    for rec in recs:
        per = {k: rec["launches"][k] - prev[k] for k in PREP_LAUNCHES}
        prev = rec["launches"]
        name = os.path.splitext(os.path.basename(rec["path"]))[0]
        mesh = load_obj(rec["path"])
        v, _, _ = normalize_to_unit_cube(mesh["v"])
        sdf = MeshSDF(v, mesh["f"], device="cuda")
        pts = near_surface_points(sdf, 8192, seed=11)
        tgt = sdf(pts)
        errs = {}
        for training in (False, True):
            with torch.no_grad():
                pred = PX.query(rec["params"], torch.from_numpy(pts).cuda(),
                                training=training)["sdf"][:, 0].cpu().numpy()
            errs[training] = float(np.abs(pred - tgt).mean())
        base = float(np.abs(tgt).mean())
        fitted[name] = (rec["params"], sdf, v, mesh["f"])
        log(f"  {name} ({len(mesh['f'])} faces): mesh SDF "
            f"{rec['mesh_sdf_s']:.3f} s, fit {rec['fit_s']:.3f} s "
            f"({rec['fit_s'] / rec['fit_steps'] * 1e3:.3f} ms a step, "
            f"{rec['fit_steps']} steps), encode {rec['encode_s']:.3f} s, "
            f"condition {rec['condition_s']:.3f} s; launches {per}; held-out "
            f"near-surface mean |SDF error| {errs[False]:.5f} (training query "
            f"{errs[True]:.5f}) against the zero payload's {base:.5f}")
        if per != PREP_LAUNCHES:
            raise AssertionError(f"{name}: launches {per} != {PREP_LAUNCHES}")
        if not errs[False] < 0.5 * base:
            raise AssertionError(f"{name}: the fit left the SDF error at "
                                 f"{errs[False]} (zero payload {base})")
    log(f"  two assets in {wall:.3f} s; peak device memory {peak:.2f} GiB "
        f"(torch.cuda.max_memory_allocated)")

    with np.load(os.path.join(out, "shard_00000.npz")) as z:
        x, y = z["x"], z["y"]
    log(f"  shard: x {list(x.shape)}, y {list(y.shape)}")
    if x.shape != (2, 2048, 68) or y.shape != (2, 1370, 768):
        raise AssertionError(f"shard shapes {x.shape}, {y.shape}")
    if not (np.isfinite(x).all() and np.isfinite(y).all()):
        raise AssertionError("shard values are not finite")

    # MeshSDF on the card against the CPU, and its peak at chunk 2048
    for name, (_, sdf, v, f) in fitted.items():
        rng = np.random.default_rng(12)
        pts = np.concatenate([rng.uniform(-1, 1, (4096, 3)).astype(np.float32),
                              near_surface_points(sdf, 4096, seed=13)])
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        got = sdf(pts)
        card_ms = (time.perf_counter() - t0) * 1e3
        sdf_peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
        ref = MeshSDF(v, f, chunk=512, device="cpu")(pts)
        dist = float(np.abs(np.abs(got) - np.abs(ref)).max())
        agree = float((np.sign(got) == np.sign(ref)).mean())
        log(f"  MeshSDF {name} ({len(f)} faces), 8192 points: card "
            f"{card_ms:.3f} ms, peak {sdf_peak:.2f} GiB above its inputs at "
            f"chunk 2048; card vs cpu max |distance| diff {dist:.3e} (bar "
            f"{MESH_SDF_ABS_BAR}), signs agree {agree:.6f}")
        if dist > MESH_SDF_ABS_BAR or (name == "icosphere" and agree != 1.0):
            raise AssertionError(f"MeshSDF {name}: card vs cpu {dist}, {agree}")

    params, sdf, _, _ = fitted["icosphere"]
    check_fit_step(params, sdf, sdf.sample_surface(20000))
    return {"shards": os.path.join(out, "*.npz"), "params": params}


def phase_train_from_shards(tmp: str, shards: str) -> None:
    """``cli.train`` on prepare_data's shards at the flagship width, batch
    2, two steps: the trainer's launches per step and finite metrics."""
    args = [FLAGSHIP, f"train.data_glob={shards}", "train.batch_size=2",
            "train.max_steps=2", "train.log_every_n_steps=1",
            "train.ckpt_every_n_steps=1000000", "train.keep_ckpts=1",
            f"root_data_dir={tmp}/train_shards"]
    _, recs = run_trainer(args, TRAIN_LAUNCHES, [1, 2])
    log(f"  two steps on the shards, batch 2: {recs[0]['seconds']:.3f} s, "
        f"{recs[1]['seconds']:.3f} s")


def phase_train_vae(params) -> None:
    """The flagship VAE (bf16 compute, f32 masters) trained 20 Adam steps
    on the 2048 normalised payloads of the fitted icosphere; step 1 card
    vs CPU in f32 on 32 of them, beside the planted fault."""
    import torch

    from topiaxl_torch import registry  # noqa: F401  (fills the table)
    from topiaxl_torch.core.attrdict import AttrDict
    from topiaxl_torch.core.config import build, load_config
    from topiaxl_torch.pipelines.data import normalize_payload
    from topiaxl_torch.pipelines.losses import vae_loss
    from topiaxl_torch.pipelines.train_vae import (DEFAULT_WEIGHTS,
                                                   create_vae_train_state,
                                                   make_vae_train_step)

    node = load_config(FLAGSHIP).model.vae
    gen = torch.Generator(device="cuda").manual_seed(7)
    vae = build(node, device="cuda", generator=gen,
                param_dtype=torch.float32).train()
    gt = normalize_payload(params.feat.detach())
    init = {k: v.detach().clone() for k, v in vae.state_dict().items()}

    # step 1 in f32 on 32 payloads, the same draw on both sides
    sub = gt[:32].cpu()
    noise = torch.randn((32, 1, 4, 4, 4), generator=torch.Generator()
                        .manual_seed(8))

    def first_step(dev, mode=False):
        model = build(AttrDict(dict(node, dtype="fp32")), device=dev)
        model.load_state_dict(init)
        x = sub.to(dev)
        post = model.encode(x)
        z = post.mode() if mode else post.sample(noise=noise.to(dev))
        loss, _ = vae_loss(x, model.decode(z), post, DEFAULT_WEIGHTS,
                           "sep_l1")
        loss.backward()
        gnorm = torch.sqrt(sum((p.grad.double() ** 2).sum()
                               for p in model.parameters()))
        return loss.item(), gnorm.item()

    ref = first_step("cpu")
    got, fault = first_step("cuda"), first_step("cuda", mode=True)
    rel = lambda a: (abs(a[0] - ref[0]) / abs(ref[0]),  # noqa: E731
                     abs(a[1] - ref[1]) / ref[1])
    log(f"  VAE step 1, 32 payloads, f32: loss cpu {ref[0]:.6f} card "
        f"{got[0]:.6f}, rel {rel(got)[0]:.3e} (bar {VAE_LOSS_BAR}); grad norm "
        f"rel {rel(got)[1]:.3e} (bar {VAE_GNORM_BAR}); planted fault (the "
        f"mode decoded): rel {rel(fault)[0]:.3e}, {rel(fault)[1]:.3e}")
    if rel(got)[0] > VAE_LOSS_BAR or rel(got)[1] > VAE_GNORM_BAR:
        raise AssertionError("VAE step: card vs cpu outside its bars")
    if rel(fault)[0] <= VAE_LOSS_BAR and rel(fault)[1] <= VAE_GNORM_BAR:
        raise AssertionError("VAE step: the bars cannot see the planted fault")

    state = create_vae_train_state(vae, torch.optim.Adam(vae.parameters(),
                                                         lr=3e-3))
    step = make_vae_train_step(vae)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    losses, secs = [], []
    for _ in range(20):
        t0 = time.perf_counter()
        m = step(state, {"gt": gt}, 9)
        losses.append(m["loss_total"].item())
        secs.append(time.perf_counter() - t0)
        if not np.isfinite([losses[-1], m["grad_norm"].item()]).all():
            raise AssertionError(f"VAE step {state.step}: not finite")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    warm = sorted(secs[1:])
    first, last = np.mean(losses[:5]), np.mean(losses[-5:])
    log(f"  flagship VAE, batch 2048, bf16 compute, f32 masters: 20 Adam "
        f"steps, loss {losses[0]:.5f} -> {losses[-1]:.5f} (first five mean "
        f"{first:.5f}, last five {last:.5f}, bar {VAE_FALL}x); step "
        f"{secs[0] * 1e3:.3f} ms first, median {warm[len(warm) // 2] * 1e3:.3f}"
        f" ms after; peak device memory {peak:.2f} GiB")
    if not last < VAE_FALL * first:
        raise AssertionError(f"VAE loss did not fall: {first} -> {last}")


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def clip_inputs(kind: str, kw: dict, rng):
    """A batch of 8: token ids [8, 77] whose rows end at their first EOS
    (padded with EOS after it, as CLIP's tokenizer pads), the last row
    without one; or normalised pixels [8, 224, 224, 3]."""
    import torch

    if kind == "vision":
        return torch.from_numpy(rng.standard_normal(
            (8, 224, 224, 3)).astype(np.float32))
    ids = rng.integers(1, 49406, (8, 77))
    for b, end in enumerate(rng.integers(4, 77, 7)):
        ids[b, end:] = 49407
    return torch.from_numpy(ids)


def write_clip_dir(path: str, tower) -> str:
    """A transformers-layout directory (config.json, pytorch_model.bin
    under ``vision_model.``) holding ``tower``, as a user's checkpoint
    would be laid out; nothing of transformers is needed."""
    import torch

    os.makedirs(path, exist_ok=True)
    blk = tower.encoder.layers[0]
    cfg = {"model_type": "clip_vision_model", "hidden_act": "quick_gelu",
           "hidden_size": blk.mlp.fc1.in_features,
           "intermediate_size": blk.mlp.fc1.out_features,
           "num_hidden_layers": len(tower.encoder.layers),
           "num_attention_heads": blk.self_attn.num_heads,
           "patch_size": tower.embeddings.patch_embedding.kernel_size[0],
           "image_size": tower.image_size}
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(cfg, f)
    torch.save({f"vision_model.{k}": v.cpu() for k, v in
                tower.state_dict().items()},
               os.path.join(path, "pytorch_model.bin"))
    return path


def phase_clip(tmp: str) -> None:
    """Both CLIP towers at B/32 and L/14 widths, random weights, card vs
    CPU with planted faults, ms per batch of 8; then one image served
    through the CLI on B/32's 50 tokens (``CLIPImageEncoder``, tokens)."""
    import torch

    from topiaxl_torch.models.conditioner.clip import (
        CLIPTextTower, CLIPVisionTower, load_clip_tower)

    card_id = card_line()
    b32_vision = None
    for tag, (text_kw, vision_kw) in CLIP_WIDTHS.items():
        for kind, cls, kw in (("text", CLIPTextTower, text_kw),
                              ("vision", CLIPVisionTower, vision_kw)):
            cpu = cls(generator=torch.Generator().manual_seed(3), **kw).eval()
            card = cls(device="cuda", **kw).eval()
            card.load_state_dict(cpu.state_dict())
            x = clip_inputs(kind, kw, np.random.default_rng(5))
            xc = x.cuda()
            with torch.no_grad():
                ref = cpu(x)
                got = {k: v.cpu() for k, v in card(xc).items()}
                if kind == "text":
                    f_pool = got["last_hidden_state"][:, -1]
                    for layer in card.encoder.layers:
                        layer.self_attn.causal = False
                    f_lhs = card(xc)["last_hidden_state"].cpu()
                    for layer in card.encoder.layers:
                        layer.self_attn.causal = True
                    names = ("pooling at the last position",
                             "no causal mask")
                else:
                    f_pool = card.post_layernorm(
                        got["last_hidden_state"][:, 1].cuda()).cpu()
                    pre, card.pre_layrnorm = (card.pre_layrnorm,
                                              torch.nn.Identity())
                    f_lhs = card(xc)["last_hidden_state"].cpu()
                    card.pre_layrnorm = pre
                    names = ("pooling patch 1", "no pre-LayerNorm")
                ms = events_ms(lambda: card(xc), 10)
            errs = {k: rel_err(got[k], ref[k]) for k in ref}
            faults = {names[0]: rel_err(f_pool, ref["pooled"]),
                      names[1]: rel_err(f_lhs, ref["last_hidden_state"])}
            log(f"  {tag} {kind} tower {tuple(x.shape)}: card vs cpu max rel "
                f"err pooled {errs['pooled']:.3e}, last_hidden_state "
                f"{errs['last_hidden_state']:.3e} (bar {CLIP_REL_BAR}); "
                f"faults {', '.join(f'{k} {v:.3e}' for k, v in faults.items())}"
                f"; {ms:.3f} ms per batch of 8 ({card_id})")
            if not max(errs.values()) <= CLIP_REL_BAR:
                raise AssertionError(f"clip {tag} {kind}: {errs}")
            if not min(faults.values()) > CLIP_REL_BAR:
                raise AssertionError(f"clip {tag} {kind}: the bar cannot see "
                                     f"{faults}")
            if tag == "B/32" and kind == "vision":
                b32_vision = cpu
            del cpu, card
    path = write_clip_dir(os.path.join(tmp, "clip_b32"), b32_vision)
    loaded = load_clip_tower(path, "vision")
    for k, v in b32_vision.state_dict().items():
        if not torch.equal(loaded.state_dict()[k], v):
            raise AssertionError(f"load_clip_tower: {k} differs")
    enc = "model.conditioner.encoder_config"
    # flash for the 2048-key self-attention only: the cross-attention's 50
    # keys, and the encoder's, take the plain form (the shape rule)
    launches = dict(serving_launches(25), flash_attn_fwd=25 * 28)
    # a random DiT's field is rough (1.4M isosurface faces at mc 128): the
    # unwrap of 100k of them took 219 s on the card, of 5k it is short
    _, recs = run_cli(tmp, "clip", 1, [
        f"{enc}.class_name=topiaxl.CLIPImageEncoder",
        f"{enc}.model_name_or_path={path}", f"{enc}.tokens=true",
        "inference.export_glb=true", "inference.mc_resolution=128",
        "inference.fast_unwrap=true", "inference.decimate=5000"], launches)
    out = os.path.join(tmp, "runs_clip", "inference", "topiaxl-sview",
                       "inference_folder", recs[0]["image"])
    glb = os.path.join(out, "pbr_mesh.glb")
    if os.path.exists(glb):
        from topiaxl_torch.extract.glb import read_glb

        glb_msg = f"GLB parses ({len(read_glb(glb)[0]['meshes'])} mesh)"
    else:
        glb_msg = "no GLB: the random DiT's field has no isosurface"
    log(f"  served on B/32's 50 tokens through cli.infer: encode "
        f"{recs[0]['encode_s']:.3f} s, stage1 {recs[0]['stage1_s']:.3f} s, "
        f"stage2 {recs[0]['stage2_s']:.3f} s; {glb_msg} ({card_id})")


def phase_vgg() -> None:
    """The masked VGG19 loss at 512², batch 4: card vs CPU with a planted
    fault, the loss's ms and peak memory."""
    import torch

    from topiaxl_torch.models.vgg import VGG19Features, vgg_loss_masked

    cpu = VGG19Features(generator=torch.Generator().manual_seed(4)).eval()
    card = VGG19Features(device="cuda").eval()
    card.load_state_dict(cpu.state_dict())
    rng = np.random.default_rng(6)
    x, y = (torch.from_numpy(rng.uniform(0, 1, (4, 512, 512, 3)).astype(
        np.float32)) for _ in "xy")
    mask = torch.from_numpy((rng.uniform(0, 1, (4, 512, 512, 1)) > 0.3)
                            .astype(np.float32))
    xc, yc, mc = x.cuda(), y.cuda(), mask.cuda()
    with torch.no_grad():
        ref = vgg_loss_masked(cpu, x, y, mask).item()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        got = vgg_loss_masked(card, xc, yc, mc).item()
        peak = torch.cuda.max_memory_allocated() - base
        fault = vgg_loss_masked(card, xc, yc, torch.ones_like(mc)).item()
        ms = events_ms(lambda: vgg_loss_masked(card, xc, yc, mc), 5)
    rel, f_rel = abs(got - ref) / abs(ref), abs(fault - ref) / abs(ref)
    log(f"  vgg_loss_masked 4x512x512: card {got:.6f}, cpu {ref:.6f}, rel err "
        f"{rel:.3e} (bar {VGG_REL_BAR}; fault without the mask {f_rel:.3e}); "
        f"{ms:.3f} ms, peak {peak / 2 ** 30:.2f} GiB above its inputs "
        f"({card_line()})")
    if not rel <= VGG_REL_BAR:
        raise AssertionError(f"vgg loss card vs cpu: {rel}")
    if not f_rel > VGG_REL_BAR:
        raise AssertionError(f"vgg: the bar cannot see the unmasked loss "
                             f"({f_rel})")


def phase_ring() -> dict:
    """The ring over P token blocks emulated in one process (the same
    ``ring_forward`` / ``ring_backward`` as across ranks, the rotation a
    list rotation) against one flash forward and backward over the whole
    sequence, with a planted fault; launches and ms per ring pass."""
    import torch

    from topiaxl_torch.ops import _cuda
    from topiaxl_torch.ops import flash_attention as fa
    from topiaxl_torch.ops.ring_attention import (LocalRing, ring_backward,
                                                  ring_forward)

    card_id = card_line()
    g = torch.Generator("cuda").manual_seed(7)
    scale = 72 ** -0.5
    launches = {}

    def counted(fn):
        _cuda.reset_launch_counts()
        out = fn()
        torch.cuda.synchronize()
        return out, {k: v for k, v in _cuda.launches.items() if v}

    for tag, B, N, parts in RING_CASES:
        q, k, v, do = (torch.randn((B, N, 16, 72), generator=g, device="cuda")
                       .bfloat16() for _ in range(4))
        o_ref, lse_ref = fa._forward(q, k, v, scale, return_lse=True)
        grads_ref = fa.flash_attention_backward(q, k, v, o_ref, lse_ref, do,
                                                scale)
        one_fwd = events_ms(lambda: fa._forward(q, k, v, scale, True), 10)
        one_bwd = events_ms(lambda: fa.flash_attention_backward(
            q, k, v, o_ref, lse_ref, do, scale), 10)
        for P in parts:
            qs, ks, vs, dos = ([c.contiguous() for c in t.chunk(P, dim=1)]
                               for t in (q, k, v, do))
            ring = LocalRing(P)
            (outs, lses), fwd_n = counted(
                lambda: ring_forward(ring, qs, ks, vs, scale))
            grads, bwd_n = counted(lambda: ring_backward(
                ring, qs, ks, vs, outs, lses, dos, scale))
            o_err = rel_err(torch.cat(outs, 1), o_ref)
            lse_err = (torch.cat(lses, 2) - lse_ref).abs().max().item()
            g_err = max(rel_err(torch.cat(a, 1), b)
                        for a, b in zip(grads, grads_ref))
            # planted fault: each block's backward on its own o and lse
            fq = [torch.zeros_like(t, dtype=torch.float32) for t in qs]
            fk = [torch.zeros_like(t, dtype=torch.float32) for t in ks]
            fv = [torch.zeros_like(t, dtype=torch.float32) for t in vs]
            for i in range(P):
                for j in range(P):
                    o_b, l_b = fa._forward(qs[i], ks[j], vs[j], scale, True)
                    gq, gk, gv = fa.flash_attention_backward(
                        qs[i], ks[j], vs[j], o_b, l_b, dos[i], scale)
                    fq[i] += gq.float()
                    fk[j] += gk.float()
                    fv[j] += gv.float()
            fault = max(rel_err(torch.cat(a, 1), b)
                        for a, b in zip((fq, fk, fv), grads_ref))
            fwd_ms = events_ms(lambda: ring_forward(ring, qs, ks, vs, scale), 5)
            bwd_ms = events_ms(lambda: ring_backward(
                ring, qs, ks, vs, outs, lses, dos, scale), 5)
            form = fa.bwd_form(N // P, 72)
            want_fwd = {"flash_attn_fwd": P * P}
            want_bwd = ({"flash_attn_bwd": P * P} if form == "fused" else
                        {"flash_attn_bwd_dq": P * P,
                         "flash_attn_bwd_dkv": P * P})
            log(f"  ring {tag} {B}x{N}x16x72 bf16 over P={P} ({N // P} keys a "
                f"block, {form} backward): out max rel err {o_err:.3e} (bar "
                f"{ATTN_REL_BAR}), lse max abs err {lse_err:.3e}, dq/dk/dv "
                f"max rel err {g_err:.3e} (bar {ATTN_BWD_REL_BAR}; fault "
                f"block's own lse {fault:.3e}); launches forward {fwd_n}, "
                f"backward {bwd_n}; ring forward {fwd_ms:.4f} ms, backward "
                f"{bwd_ms:.4f} ms (all P ranks in turn) against one launch's "
                f"{one_fwd:.4f} / {one_bwd:.4f} ms ({card_id})")
            if fwd_n != want_fwd or bwd_n != want_bwd:
                raise AssertionError(f"ring launches {fwd_n}, {bwd_n} != "
                                     f"{want_fwd}, {want_bwd}")
            if not (o_err <= ATTN_REL_BAR and lse_err <= LSE_ABS_BAR
                    and g_err <= ATTN_BWD_REL_BAR):
                raise AssertionError(f"ring {tag} P={P}: {o_err}, {lse_err}, "
                                     f"{g_err}")
            if not fault > ATTN_BWD_REL_BAR:
                raise AssertionError(f"ring {tag} P={P}: the bar cannot see "
                                     f"the block's own lse ({fault})")
            launches[f"{tag} P={P}"] = {"forward": fwd_n, "backward": bwd_n}
    return launches


# ranks that run cli.train's main under a planted fault, one fault after
# the other in one torchrun (the process group made here, so main leaves
# it standing): argv[1] is the repository, argv[2] a JSON list of
# [fault, overrides...]
DP_FAULT_DRIVER = r'''
import gc, json, sys

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.parallel

sys.path.insert(0, sys.argv[1])
from topiaxl_torch.cli.train import main
from topiaxl_torch.parallel.mesh import init_distributed
from topiaxl_torch.pipelines import data


def same_rows(batches):
    """Both halves of every global batch are its first half: the two
    ranks read the same rows."""
    def patched(batch_size, *a, **k):
        for b in batches(batch_size, *a, **k):
            h = batch_size // 2
            yield {n: np.concatenate([v[:h], v[:h]]) for n, v in b.items()}
    return patched


FAULTS = {
    # every rank steps on its own gradient
    "no gradient sync": (torch.nn.parallel, "DistributedDataParallel",
                         lambda module, **kw: module),
    "same rows on both ranks": (data, "synthetic_batches",
                                same_rows(data.synthetic_batches)),
}
init_distributed(torch.device("cuda"))
for fault, *argv in json.loads(sys.argv[2]):
    owner, name, patch = FAULTS[fault]
    keep = getattr(owner, name)
    setattr(owner, name, patch)
    try:
        if main(argv) != 0:
            raise SystemExit(f"{fault}: cli.train failed")
    finally:
        setattr(owner, name, keep)
    gc.collect()
    torch.cuda.empty_cache()
dist.destroy_process_group()
'''


def phase_dp(tmp: str) -> None:
    """``cli.train`` with ``train.mesh.dp=-1`` over two ranks on the one
    card (``torchrun``; the kernels were built by the build phase, so the
    ranks load them and never build at once) against one process at the
    same global batch, at the flagship width (``DP_DEPTH`` blocks, remat),
    every run resumed from one enlivened step-0 checkpoint; then the same
    comparison under each planted fault (``DP_FAULT_DRIVER``)."""
    import torch

    from topiaxl_torch.cli.train import main
    from topiaxl_torch.core.checkpoint import CheckpointManager
    from topiaxl_torch.core.config import load_config

    card_id = card_line()
    # depth DP_DEPTH (flagship width): the whole script's time, with the
    # tp, pp, restore and app phases after this one
    common = ["train.synthetic=true", "model.generator.remat=true",
              "scheduler.warmup_iters=0", "train.max_steps=2",
              "train.log_every_n_steps=1", "train.ckpt_every_n_steps=1000000",
              "train.keep_ckpts=1", f"model.generator.depth={DP_DEPTH}"]
    ranks = ["train.batch_size=4", "train.mesh.dp=-1"]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [ROOT, os.environ.get("PYTHONPATH", "")]))
    torchrun = [sys.executable, "-m", "torch.distributed.run", "--standalone",
                "--nproc-per-node", "2"]

    seed_ckpt = os.path.join(tmp, "step0", "step_000000000.pt")
    p0 = seed_checkpoint(seed_ckpt, common, 11)

    def overrides(name: str, extra: list) -> list:
        return [*common, f"root_data_dir={tmp}/dp_{name}", *extra]

    def resumed(name: str, extra: list) -> list:
        return resume_from(seed_ckpt, overrides(name, extra))

    def result(name: str, extra: list) -> tuple[list, dict]:
        """A run's logged metrics and its last checkpoint's parameters and
        Adam mu (on the host); the checkpoint is then deleted."""
        d = os.path.join(load_config(FLAGSHIP, overrides=overrides(
            name, extra)).output_dir, "train")
        with open(os.path.join(d, "metrics.jsonl")) as f:
            metrics = [json.loads(line) for line in f]
        sd = CheckpointManager(os.path.join(d, "ckpts")).restore()
        shutil.rmtree(os.path.join(d, "ckpts"))
        return metrics, {"params": sd["params"], "mu": sd["opt"]["mu"]}

    def launch(cmd: list, what: str) -> tuple[str, float]:
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                              text=True, timeout=600)
        out = proc.stdout + proc.stderr
        if proc.returncode != 0:
            log(out[-6000:])
            raise AssertionError(f"torchrun {what} exited {proc.returncode}")
        return out, time.perf_counter() - t0

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    if main([FLAGSHIP, *resumed("single", ["train.batch_size=8"])]) != 0:
        raise AssertionError("cli.train (one process) failed")
    wall_single = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    single = result("single", ["train.batch_size=8"])
    torch.cuda.empty_cache()

    def norm_rel(d_a: dict, d_b: dict, base: dict | None = None) -> float:
        """|a - b| / |b - base| over every tensor, on the card."""
        num = den = 0.0
        for n, b in d_b.items():
            b = b.cuda().float()
            num += ((d_a[n].cuda().float() - b) ** 2).sum().item()
            den += ((b if base is None else b - base[n].cuda().float())
                    ** 2).sum().item()
        return (num / den) ** 0.5

    def readings(run: tuple) -> dict:
        (m_a, s_a), (m_b, s_b) = run, single
        if [m["step"] for m in m_a] != [1, 2]:
            raise AssertionError(f"two ranks logged {m_a}")
        return {
            "loss": max(abs(x["loss"] - y["loss"]) / abs(y["loss"])
                        for x, y in zip(m_a, m_b)),
            "grad norm": max(abs(x["grad_norm"] - y["grad_norm"])
                             / y["grad_norm"] for x, y in zip(m_a, m_b)),
            "Adam mu": norm_rel(s_a["mu"], s_b["mu"]),
            "update": norm_rel(s_a["params"], s_b["params"], p0)}

    out, wall_ranks = launch(
        [*torchrun, "-m", "topiaxl_torch.cli.train", FLAGSHIP,
         *resumed("ranks", ranks)], "cli.train")
    groups = sorted({line.split("process group: ", 1)[1] for line in
                     out.splitlines() if "process group: " in line})
    sound_run = result("ranks", ranks)
    sound = readings(sound_run)
    metrics = sound_run[0]
    del sound_run
    faults = ["no gradient sync", "same rows on both ranks"]
    driver = os.path.join(tmp, "dp_faults.py")
    with open(driver, "w") as f:
        f.write(DP_FAULT_DRIVER)
    _, wall_faults = launch(
        [*torchrun, driver, ROOT, json.dumps(
            [[fault, FLAGSHIP, *resumed(f"fault{i}", ranks)]
             for i, fault in enumerate(faults)])], "the planted faults")
    planted = {fault: readings(result(f"fault{i}", ranks))
               for i, fault in enumerate(faults)}
    bars = {"loss": DP_LOSS_REL, "grad norm": DP_GNORM_REL,
            "Adam mu": DP_MU_REL, "update": DP_UPDATE_REL}
    log(f"  dp=2 on one card ({', '.join(groups)}), flagship width, depth "
        f"{DP_DEPTH} (enlivened), remat, "
        f"global batch 8: steps " + ", ".join(
            f"{m['step']}: loss {m['loss']:.5f} grad norm "
            f"{m['grad_norm']:.5f}" for m in metrics)
        + "; one process at batch 8: " + ", ".join(
            f"loss {m['loss']:.5f} grad norm {m['grad_norm']:.5f}"
            for m in single[0]) + f" ({card_id})")
    log("  relative to one process (bar | sound | "
        + " | ".join(faults) + "): " + "; ".join(
            f"{k} {bars[k]:.1e} | {sound[k]:.3e} | " + " | ".join(
                f"{planted[f][k]:.3e}" for f in faults) for k in bars))
    log(f"  step 2: one process {1 / single[0][1]['steps_per_sec']:.3f} s, "
        f"two ranks {1 / metrics[1]['steps_per_sec']:.3f} s; wall: one"
        f" process {wall_single:.1f} s (peak {peak / 2 ** 30:.2f} GiB), "
        f"torchrun with two ranks {wall_ranks:.1f} s, the two faults "
        f"{wall_faults:.1f} s ({card_id})")
    if any(sound[k] > bars[k] for k in bars):
        raise AssertionError(f"dp=2 against one process: {sound}")
    for fault, got in planted.items():
        if not any(got[k] > bars[k] for k in bars):
            raise AssertionError(f"planted fault {fault!r} passes: {got}")


# tp: a tensor-parallel rank pair (dp 1 x tp 2) against one process, bf16
# on both: generation's PrimX (max |a - b| / max |b| of srt and of feat)
# after a 5-step DDIM chain over a DiT of TP_GEN_DEPTH blocks, and two
# cli.train steps' loss, grad norm, Adam mu and update (as in dp). Each rank rounds
# its partial products to bf16 before the all-reduce, which one process
# does not. The planted fault (qkv's rows split as one block: rank 0 holds
# all of q and half of k) must cross a bar. On an H100 sound ranks read
# srt / feat 2.4e-2 / 4.2e-2 at 28 blocks (fault 0.128 / 0.208). Training
# TP_TRAIN_DEPTH = 8 blocks with the filled gates at ~0.03, loss / grad
# norm / mu / update read 9.7e-6 / 3.8e-5 / 1.37e-3 / 1.52e-2 and the fault
# 2.1e-4 / 3.2e-4 / 4.8e-2 / 0.743: attention reached the loss so weakly
# that only the update's bar caught it. So the trainer's gates are filled
# at TP_TRAIN_GATE, and it steps at TP_TRAIN_LR: at the flagship's 1e-4
# the first update tripled the loss, and the sound step-2 loss read 4.9e-4
# at gates of 1 and 1.6e-3 at 0.3. Gates of 1 at 1e-5 read 1.1e-4 /
# 1.2e-3 / 3.7e-3 / 2.6e-2, the fault 3.3e-2 / 3.9e-2 / 1.29 / 1.28
# (gates of 0.3: the fault's grad norm 9.3e-3, under its bar).
# At the cut depths (two runs each): generation at TP_GEN_DEPTH = 8 reads
# srt / feat 2.1e-2 / 3.7e-2 sound and 5.5e-2 / 0.198 faulted (the check
# takes the larger of the two: 3.7e-2 sound, 1.3x under the bar, and
# 0.198 faulted, 3.9x over it); training at TP_TRAIN_DEPTH = 4 reads loss
# / grad norm / mu / update 4.3e-4-4.9e-4 / 1.5e-3-1.6e-3 / 2.3e-3 /
# 2.2e-2 sound (2x or more under each bar) and 8.7e-2 / 0.117 / 1.20 /
# 1.24 faulted (over every bar).
TP_GEN_REL = 5e-2
TP_BARS = {"loss": 1e-3, "grad norm": 1e-2, "Adam mu": 5e-2, "update": 0.3}
TP_TRAIN_GATE = 1.0
TP_TRAIN_LR = 1e-5
# pp: make_pp_train_step against make_train_step at the same batch of 8;
# microbatching changes only the GEMMs' row counts (on an H100: loss equal,
# grad norm <= 3.4e-6, mu 1.1e-3, update 7.7e-3)
PP_BARS = {"loss": 1e-4, "grad norm": 1e-3, "Adam mu": 2e-2, "update": 0.2}
PP_MICRO = 4
# the pp phase's depth at the flagship width: the script's time (at 28
# blocks its two torchruns took 47.5 and 63.3 s, a pp = 4 step 28.2 s
# through gloo); 8 divides over 2 and 4 stages
PP_DEPTH = 8
# restore: the checkpoint of a tp = 2 run at depth 4 (flagship width) loads
# into one process bit for bit; step 3 resumed there against the same step
# resumed on tp = 2 (bf16 rounding as above)
RESTORE_LOSS_REL = 1e-3
TP_GEN_STEPS = 5
# the tp generation's depth (flagship width): at 28 blocks each of its two
# chains over gloo took 15.4 s of the phase's 138.6 s on one H100 machine
TP_GEN_DEPTH = 8
# the tp trainer's depth (flagship width): at 28 blocks each of the phase's
# four 13.6 GB checkpoints is written and read through the host, and the
# phase took 244-561 s on one H100 machine (107 s at 8 blocks, generation
# at TP_GEN_DEPTH)
TP_TRAIN_DEPTH = 4
# per step with remat on each tp rank: the trainer's launches at that depth
# (every block runs on each rank, on half the heads; its forward twice)
TP_TRAIN_LAUNCHES = train_launches(True, TP_TRAIN_DEPTH)
TP_GEN_LAUNCHES = {"flash_attn_fwd": TP_GEN_STEPS * 2 * TP_GEN_DEPTH,
                   "flash_attn_bwd": 0, "flash_attn_bwd_dq": 0,
                   "flash_attn_bwd_dkv": 0,
                   "ln_modulate": TP_GEN_STEPS * (TP_GEN_DEPTH + 1),
                   "ln_modulate_residual": TP_GEN_STEPS * 2 * TP_GEN_DEPTH,
                   **NO_PROBES, **NO_QK_NORM, "adamw_ema": 0}


# the ranks of the tp, pp and restore phases: argv[1] is the repository,
# argv[2] a JSON list of jobs for chip_smoke.rank_jobs
RANKS_DRIVER = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
import chip_smoke
chip_smoke.rank_jobs(json.loads(sys.argv[2]))
"""


def contiguous_qkv_rules():
    """The planted tp fault: ``dit_param_rules`` with the fused qkv's rows
    split as one block (what a contiguous ``P(fs, tp)`` does without
    GSPMD's reshard)."""
    from topiaxl_torch.parallel.sharding import Split, dit_param_rules

    return [(pat, tuple(e.axis if isinstance(e, Split) else e for e in spec))
            for pat, spec in dit_param_rules()]


def enliven_(dit, seed: int, gate: float = 0.0):
    """Xavier weights and N(0, 0.02) biases in the layers the DiT's init
    zeroes (every adaLN and the final projection), from a seeded generator
    on the DiT's device: the same numbers in every process. Without this
    each block is the identity, the output zero, and every block gradient
    zero, which no dp, tp or pp fault could move. ``gate`` is added to the
    bias of each block's three gates (adaLN chunks 2, 5 and 8 of 9): the
    filled gates are ~0.03 on their own, so attention reaches the loss
    weakly; at ~1 each sublayer adds at full weight."""
    import torch

    from topiaxl_torch.models.layers import xavier_

    dev = next(dit.parameters()).device
    g = torch.Generator(dev).manual_seed(seed)
    with torch.no_grad():
        for m in [b.adaLN_modulation[1] for b in dit.blocks] + [
                dit.final_layer.adaLN_modulation[1], dit.final_layer.linear]:
            xavier_(m.weight, g)
            m.bias.normal_(0.0, 0.02, generator=g)
        for b in dit.blocks:
            b.adaLN_modulation[1].bias.view(9, -1)[2::3] += gate
    return dit


def seed_checkpoint(path: str, overrides: list, seed: int,
                    gate: float = 0.0) -> dict:
    """Write step 0 of ``cli.train``'s DiT under ``overrides`` (the flagship
    config), its zero-init layers filled (``enliven_``), as the checkpoint
    ``path`` (``<dir>/step_000000000.pt``) that runs resume
    (``resume_from``); returns its parameters on the host."""
    import torch

    from topiaxl_torch.cli.train import build_dit
    from topiaxl_torch.core.checkpoint import CheckpointManager
    from topiaxl_torch.core.config import load_config
    from topiaxl_torch.pipelines.train import create_train_state

    cfg = load_config(FLAGSHIP, overrides=overrides)
    dit = enliven_(build_dit(cfg.model.generator, torch.device("cuda"),
                             torch.Generator("cuda").manual_seed(
                                 int(cfg.global_seed))), seed, gate)
    p0 = {n: t.detach().cpu() for n, t in dit.state_dict().items()}
    CheckpointManager(os.path.dirname(path)).save(
        0, create_train_state(dit).state_dict())
    del dit
    torch.cuda.empty_cache()
    return p0


def resume_from(seed_ckpt: str, overrides: list) -> list:
    """``overrides`` (a ``cli.train`` run's), after hard-linking
    ``seed_ckpt`` into the run's checkpoint directory: the run resumes
    from it."""
    from topiaxl_torch.core.config import load_config

    d = os.path.join(load_config(FLAGSHIP, overrides=overrides).output_dir,
                     "train", "ckpts")
    os.makedirs(d)
    os.link(seed_ckpt, os.path.join(d, os.path.basename(seed_ckpt)))
    return overrides


def tp_generate_inputs(assets: int = 2):
    """The flagship DiT (bf16, enlivened) and VAE, a DDIM chain of
    TP_GEN_STEPS, conditioning and initial noise for ``assets`` assets,
    all from seeds on the card: the same in every process. The DiT has
    TP_GEN_DEPTH blocks."""
    import torch

    import topiaxl_torch.registry  # noqa: F401
    from topiaxl_torch.core.config import build, load_config
    from topiaxl_torch.diffusion.schedule import create_diffusion
    from topiaxl_torch.models.latent_stats import resolve_latent_stats

    cfg = load_config(FLAGSHIP,
                      overrides=[f"model.generator.depth={TP_GEN_DEPTH}"])
    dev = torch.device("cuda")
    dit = enliven_(build(cfg.model.generator, device=dev, generator=torch.
                         Generator(dev).manual_seed(3)).eval(), 4)
    vae = build(cfg.model.vae, device=dev,
                generator=torch.Generator(dev).manual_seed(5)).eval()
    g = torch.Generator(dev).manual_seed(6)
    y = torch.randn((assets, 1370, 768), generator=g, device=dev)
    noise = torch.randn((assets, 2048, 68), generator=g, device=dev)
    diffusion = create_diffusion(
        timestep_respacing=f"ddim{TP_GEN_STEPS}",
        noise_schedule=cfg.diffusion.noise_schedule,
        diffusion_steps=cfg.diffusion.diffusion_steps,
        parameterization=cfg.diffusion.parameterization, device=dev)
    mean, std = resolve_latent_stats(cfg.model)
    return dit, vae, diffusion, y, noise, mean, std


def pp_inputs(seed: int = 8, depth: int = 28):
    """The flagship trainer's DiT (f32 masters, enlivened) at ``depth``
    blocks and a batch of 8 from seeds on the card."""
    import torch

    from topiaxl_torch.cli.train import build_dit
    from topiaxl_torch.core.config import load_config

    cfg = load_config(FLAGSHIP, overrides=[f"model.generator.depth={depth}"])
    dev = torch.device("cuda")
    dit = enliven_(build_dit(cfg.model.generator, dev, torch.Generator(
        dev).manual_seed(seed)).train(), seed + 1)
    g = torch.Generator(dev).manual_seed(seed + 2)
    batch = {"x": torch.randn((8, 2048, 68), generator=g, device=dev),
             "y": torch.randn((8, 1370, 768), generator=g, device=dev)}
    return cfg, dit, batch


def pp_optimizer(cfg):
    from topiaxl_torch.diffusion.schedule import create_diffusion
    from topiaxl_torch.pipelines.train import make_optimizer

    diffusion = create_diffusion(
        noise_schedule=cfg.diffusion.noise_schedule,
        diffusion_steps=cfg.diffusion.diffusion_steps,
        parameterization=cfg.diffusion.parameterization, device="cuda")
    return diffusion, make_optimizer(lr=float(cfg.optimizer.lr),
                                     warmup_iters=0, max_iters=1000)


def rel_readings(steps: list, ref_steps: list, sd: dict, ref: dict,
                 p0: dict) -> dict:
    """The largest relative difference of the steps' loss and grad norm
    from the reference's, and Adam mu and the update (from ``p0``) by norm
    of the difference over norm (on the card)."""
    out = {"loss": 0.0, "grad norm": 0.0}
    for m, r in zip(steps, ref_steps):
        out["loss"] = max(out["loss"], abs(m["loss"] - r["loss"])
                          / abs(r["loss"]))
        out["grad norm"] = max(out["grad norm"], abs(
            m["grad_norm"] - r["grad_norm"]) / r["grad_norm"])
    for key, part in (("Adam mu", "mu"), ("update", "params")):
        num = den = 0.0
        for n, a in sd[part].items():
            b = ref[part][n].cuda().float()
            num += ((a.cuda().float() - b) ** 2).sum().item()
            base = b if part == "mu" else b - p0[n].cuda().float()
            den += (base ** 2).sum().item()
        out[key] = (num / den) ** 0.5
    return out


def rank_jobs(jobs: list) -> None:
    """A torchrun rank of the tp, pp and restore phases: each job in turn,
    every rank writing ``<out>.rank<r>.json`` (launches, the heads each
    flash forward ran on, peak memory, seconds, the job's results)."""
    import collections

    import torch
    import torch.distributed as dist

    import topiaxl_torch.ops.attention as attention
    from topiaxl_torch.ops import _cuda
    from topiaxl_torch.parallel import sharding
    from topiaxl_torch.parallel.mesh import init_distributed

    init_distributed(torch.device("cuda"))
    rank = dist.get_rank()
    heads = collections.Counter()
    flash = attention.flash_attention

    def counted(q, *a, **k):
        heads[q.shape[2]] += 1
        return flash(q, *a, **k)

    attention.flash_attention = counted
    keep_rules, bad_rules = sharding.dit_param_rules, contiguous_qkv_rules()
    for job in jobs:
        if job["kind"] == "copy":
            if rank == 0:
                shutil.copytree(job["src"], job["dst"])
            dist.barrier()
            continue
        heads.clear()
        _cuda.reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        if job.get("fault"):
            sharding.dit_param_rules = lambda *a, **k: bad_rules
        t0 = time.perf_counter()
        try:
            res = RANK_JOBS[job["kind"]](job, rank)
        finally:
            sharding.dit_param_rules = keep_rules
        torch.cuda.synchronize()
        res.update(seconds=time.perf_counter() - t0,
                   launches={k: v for k, v in _cuda.launches.items()},
                   heads=dict(heads),
                   peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
        with open(f"{job['out']}.rank{rank}.json", "w") as f:
            json.dump(res, f)
        torch.cuda.empty_cache()
    dist.destroy_process_group()


def rank_cli(job: dict, rank: int) -> dict:
    from topiaxl_torch.cli.train import main

    recs = PerStep()
    if main(job["argv"], metrics_out=recs) != 0:
        raise SystemExit("cli.train failed")
    return {"steps": recs}


def rank_generate(job: dict, rank: int) -> dict:
    import torch

    from topiaxl_torch.parallel import make_mesh, sharding
    from topiaxl_torch.parallel.sharding import gather_params
    from topiaxl_torch.pipelines.infer import generate_primx_sharded

    dit, vae, diffusion, y, noise, mean, std = tp_generate_inputs()
    mesh = make_mesh({"dp": 1, "tp": 2})
    rules = sharding.dit_param_rules()   # the fault's under "fault"
    t0 = time.perf_counter()
    out = generate_primx_sharded(dit, vae, diffusion, y, mean, std, mesh,
                                 cfg_scale=6.0, noise=noise,
                                 param_rules=rules)
    torch.cuda.synchronize()
    chain_s = time.perf_counter() - t0
    if rank == 0:
        torch.save({"srt": torch.stack([p.srt for p in out]).cpu(),
                    "feat": torch.stack([p.feat for p in out]).cpu()},
                   job["out"] + ".pt")
    # the tp parts of a fresh copy gather back to the weights exactly
    from copy import deepcopy

    from topiaxl_torch.parallel import shard_params

    local = shard_params(deepcopy(dit), mesh, rules)
    exact = all(torch.equal(t, dit.state_dict()[n])
                for n, t in gather_params(local).items())
    return {"chain_s": chain_s, "gathers_exact": exact}


def rank_pp(job: dict, rank: int) -> dict:
    import torch

    from topiaxl_torch.parallel import (make_mesh, make_pp_train_step,
                                        shard_pp_params)
    from topiaxl_torch.pipelines.train import create_train_state

    cfg, dit, batch = pp_inputs(depth=PP_DEPTH)
    p0 = {n: t.detach().float().cpu() for n, t in dit.state_dict().items()}
    mesh = make_mesh({"pp": job["pp"]})
    stage = shard_pp_params(dit, mesh)
    torch.cuda.empty_cache()
    state = create_train_state(stage)
    diffusion, optimizer = pp_optimizer(cfg)
    step = make_pp_train_step(stage, diffusion, optimizer, mesh,
                              n_micro=PP_MICRO)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    metrics = {k: float(v) for k, v in step(state, batch, 0).items()}
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    ref = torch.load(job["ref"], map_location="cpu", weights_only=True,
                     mmap=True)
    # this stage's blocks and, on stage 0 only, the replicated tensors
    mine = {n for n in state.params() if n.startswith("blocks.") or rank == 0}
    sd = {"params": {n: p.detach() for n, p in state.params().items()
                     if n in mine},
          "mu": {n: m for n, m in state.opt_state.mu.items() if n in mine}}
    parts = {}
    for part in ("mu", "params"):
        num = den = 0.0
        for n, a in sd[part].items():
            b = ref[part][n].cuda().float()
            num += ((a.float() - b) ** 2).sum().item()
            base = b if part == "mu" else b - p0[n].cuda()
            den += (base ** 2).sum().item()
        parts[part] = [num, den]
    sums = torch.tensor([parts["mu"] + parts["params"]], dtype=torch.float64,
                        device="cuda")
    torch.distributed.all_reduce(sums)
    mu_n, mu_d, p_n, p_d = sums[0].tolist()
    return {"metrics": metrics, "step_s": step_s,
            "Adam mu": (mu_n / mu_d) ** 0.5, "update": (p_n / p_d) ** 0.5,
            "blocks": len(stage.blocks)}


RANK_JOBS = {"cli": rank_cli, "generate": rank_generate, "pp": rank_pp}


def torchrun(tmp: str, nproc: int, jobs: list, what: str) -> float:
    """``RANKS_DRIVER`` on ``nproc`` ranks of the one card; its wall
    seconds. Raises with the end of its output if it fails."""
    driver = os.path.join(tmp, "ranks.py")
    with open(driver, "w") as f:
        f.write(RANKS_DRIVER)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [ROOT, os.environ.get("PYTHONPATH", "")]))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", str(nproc), driver, ROOT, json.dumps(jobs)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        log((proc.stdout + proc.stderr)[-6000:])
        raise AssertionError(f"torchrun {what} exited {proc.returncode}")
    return time.perf_counter() - t0


def read_ranks(out: str, n: int) -> list:
    res = []
    for r in range(n):
        with open(f"{out}.rank{r}.json") as f:
            res.append(json.load(f))
    return res


def phase_tp(tmp: str) -> None:
    """Tensor parallelism over two ranks on the one card (dp 1 x tp 2,
    gloo): ``generate_primx_sharded`` with ``dit_param_rules()`` at
    ``TP_GEN_DEPTH`` blocks on a short DDIM chain, and two ``cli.train``
    steps at
    ``train.mesh={dp: 1, tp: 2}`` (flagship width at ``TP_TRAIN_DEPTH``
    blocks, remat, batch 8, lr ``TP_TRAIN_LR``, resumed from an enlivened
    step-0 checkpoint whose gates are ``TP_TRAIN_GATE``), each against one
    process on the same inputs and beside the planted contiguous-qkv
    fault."""
    import torch

    from topiaxl_torch.cli.train import main
    from topiaxl_torch.core.checkpoint import CheckpointManager
    from topiaxl_torch.core.config import load_config
    from topiaxl_torch.pipelines.infer import generate_primx

    card_id = card_line()
    # one process: the chain, and the step-0 checkpoint both trainers resume
    dit, vae, diffusion, y, noise, mean, std = tp_generate_inputs()
    t0 = time.perf_counter()
    ref = generate_primx(dit, vae, diffusion, y, mean, std, cfg_scale=6.0,
                         noise=noise)
    torch.cuda.synchronize()
    one_chain_s = time.perf_counter() - t0
    ref_srt = torch.stack([p.srt for p in ref]).float()
    ref_feat = torch.stack([p.feat for p in ref]).float()
    del dit, vae, ref
    common = ["train.synthetic=true", "model.generator.remat=true",
              "scheduler.warmup_iters=0", "train.max_steps=2",
              "train.log_every_n_steps=1", "train.ckpt_every_n_steps=1000000",
              "train.keep_ckpts=1", "train.batch_size=8",
              f"model.generator.depth={TP_TRAIN_DEPTH}",
              f"optimizer.lr={TP_TRAIN_LR}"]
    seed_ckpt = os.path.join(tmp, "step0", "step_000000000.pt")
    p0 = seed_checkpoint(seed_ckpt, common, 9, gate=TP_TRAIN_GATE)

    def run_dir(name: str) -> list:
        return resume_from(seed_ckpt,
                           [*common, f"root_data_dir={tmp}/tp_{name}"])

    def final(name: str) -> dict:
        d = os.path.join(load_config(FLAGSHIP, overrides=[
            *common, f"root_data_dir={tmp}/tp_{name}"]).output_dir, "train")
        sd = CheckpointManager(os.path.join(d, "ckpts")).restore()
        shutil.rmtree(os.path.join(d, "ckpts"))
        return {"params": sd["params"], "mu": sd["opt"]["mu"]}

    torch.cuda.reset_peak_memory_stats()
    single = PerStep()
    t0 = time.perf_counter()
    if main([FLAGSHIP, *run_dir("single")], metrics_out=single) != 0:
        raise AssertionError("cli.train (one process) failed")
    one_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    one_wall = time.perf_counter() - t0
    single_sd = final("single")
    torch.cuda.empty_cache()

    ranks_args = ["train.mesh.dp=1", "train.mesh.tp=2"]
    out = os.path.join(tmp, "tp")
    jobs = [{"kind": "generate", "out": f"{out}_gen"},
            {"kind": "generate", "fault": True, "out": f"{out}_gen_fault"},
            {"kind": "cli", "argv": [FLAGSHIP, *run_dir("ranks"),
                                     *ranks_args], "out": f"{out}_train"},
            {"kind": "cli", "fault": True, "argv": [
                FLAGSHIP, *run_dir("fault"), *ranks_args],
             "out": f"{out}_train_fault"}]
    wall = torchrun(tmp, 2, jobs, "tp")

    def gen_errs(name: str) -> tuple:
        got = torch.load(f"{out}_{name}.pt", weights_only=True)
        return tuple(rel_err(got[k].cuda(), r) for k, r in
                     (("srt", ref_srt), ("feat", ref_feat)))

    sound, fault = gen_errs("gen"), gen_errs("gen_fault")
    gen_ranks = read_ranks(f"{out}_gen", 2)
    for r, res in enumerate(gen_ranks):
        launches = {k: res["launches"].get(k, 0) for k in TP_GEN_LAUNCHES}
        log(f"  tp generate rank {r}: flash forward launches by heads "
            f"{res['heads']}, launches {launches}, chain {res['chain_s']:.3f}"
            f" s (one process {one_chain_s:.3f} s), peak "
            f"{res['peak_gib']:.2f} GiB, parts gather back exactly: "
            f"{res['gathers_exact']}")
        if launches != TP_GEN_LAUNCHES or res["heads"] != {
                "8": TP_GEN_LAUNCHES["flash_attn_fwd"]} or not res[
                    "gathers_exact"]:
            raise AssertionError(f"tp generate rank {r}: {res}")
    log(f"  tp generate (2 assets, {TP_GEN_STEPS} DDIM steps, depth "
        f"{TP_GEN_DEPTH}): srt "
        f"/ feat max rel err vs one process {sound[0]:.3e} / {sound[1]:.3e} "
        f"(bar {TP_GEN_REL}); contiguous-qkv fault {fault[0]:.3e} / "
        f"{fault[1]:.3e} ({card_id})")
    if max(sound) > TP_GEN_REL or not max(fault) > TP_GEN_REL:
        raise AssertionError(f"tp generate: sound {sound}, fault {fault}")

    readings = {}
    for name in ("train", "train_fault"):
        recs = read_ranks(f"{out}_{name}", 2)
        sd = final("ranks" if name == "train" else "fault")
        steps = recs[0]["steps"]
        readings[name] = rel_readings(steps, single, sd, single_sd, p0)
        if name == "train":
            for r, res in enumerate(recs):
                per = {k: res["launches"].get(k, 0) // 2
                       for k in TP_TRAIN_LAUNCHES}
                log(f"  tp train rank {r}: steps " + ", ".join(
                    f"{m['step']}: {m['seconds']:.3f} s loss {m['loss']:.5f}"
                    f" grad norm {m['grad_norm']:.5f}" for m in res["steps"])
                    + f"; launches a step {per}, flash forwards by heads "
                    f"{res['heads']}, peak {res['peak_gib']:.2f} GiB")
                if per != TP_TRAIN_LAUNCHES or set(res["heads"]) != {"8"}:
                    raise AssertionError(f"tp train rank {r}: {per}, "
                                         f"{res['heads']}")
    log("  one process: " + ", ".join(
        f"{m['step']}: {m['seconds']:.3f} s loss {m['loss']:.5f} grad norm "
        f"{m['grad_norm']:.5f}" for m in single)
        + f"; peak {one_peak:.2f} GiB, wall {one_wall:.1f} s; torchrun "
        f"(both chains, both trainers) {wall:.1f} s ({card_id})")
    log(f"  tp train ({TP_TRAIN_DEPTH} blocks) relative to one process (bar "
        "| sound | contiguous qkv): "
        + "; ".join(f"{k} {TP_BARS[k]:.1e} | {readings['train'][k]:.3e} | "
                    f"{readings['train_fault'][k]:.3e}" for k in TP_BARS))
    if any(readings["train"][k] > TP_BARS[k] for k in TP_BARS):
        raise AssertionError(f"tp train: {readings['train']}")
    if not any(readings["train_fault"][k] > TP_BARS[k] for k in TP_BARS):
        raise AssertionError(f"tp train fault passes: {readings}")


def phase_pp(tmp: str) -> None:
    """``make_pp_train_step`` at pp 2 and pp 4 (``PP_DEPTH`` / pp blocks a
    stage), ``n_micro`` 4, the flagship DiT's width (enlivened) at batch 8,
    against one process's ``make_train_step`` on the same weights and
    batch."""
    import torch

    from topiaxl_torch.pipelines.train import (create_train_state,
                                               make_train_step)

    card_id = card_line()
    cfg, dit, batch = pp_inputs(depth=PP_DEPTH)
    p0 = {n: t.detach().float().cpu() for n, t in dit.state_dict().items()}
    state = create_train_state(dit)
    diffusion, optimizer = pp_optimizer(cfg)
    step = make_train_step(dit, diffusion, optimizer)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref_metrics = {k: float(v) for k, v in step(state, batch, 0).items()}
    torch.cuda.synchronize()
    one_s = time.perf_counter() - t0
    one_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    ref_path = os.path.join(tmp, "pp_ref.pt")
    torch.save({"params": {n: p.detach().cpu() for n, p in
                           state.params().items()},
                "mu": {n: m.cpu() for n, m in state.opt_state.mu.items()}},
               ref_path)
    del dit, state, step, batch
    torch.cuda.empty_cache()
    log(f"  one process: loss {ref_metrics['loss']:.5f} grad norm "
        f"{ref_metrics['grad_norm']:.5f}, step {one_s:.3f} s (first), peak "
        f"{one_peak:.2f} GiB ({card_id})")
    for pp in (2, 4):
        out = os.path.join(tmp, f"pp{pp}")
        wall = torchrun(tmp, pp, [{"kind": "pp", "pp": pp, "ref": ref_path,
                                   "out": out}], f"pp={pp}")
        res = read_ranks(out, pp)
        m = res[0]["metrics"]
        got = {"loss": abs(m["loss"] - ref_metrics["loss"])
               / abs(ref_metrics["loss"]),
               "grad norm": abs(m["grad_norm"] - ref_metrics["grad_norm"])
               / ref_metrics["grad_norm"],
               "Adam mu": res[0]["Adam mu"], "update": res[0]["update"]}
        bubble = (pp - 1) / (PP_MICRO + pp - 1)
        log(f"  pp={pp}, n_micro {PP_MICRO} (GPipe bubble {bubble:.3f} of "
            f"each stage's ticks): loss {m['loss']:.5f} grad norm "
            f"{m['grad_norm']:.5f}; relative to one process (bar | reading) "
            + "; ".join(f"{k} {PP_BARS[k]:.1e} | {got[k]:.3e}"
                        for k in PP_BARS)
            + "; per stage (blocks, step s, peak GiB, launches #1/#4): "
            + ", ".join(f"{r['blocks']}, {r['step_s']:.3f}, "
                        f"{r['peak_gib']:.2f}, "
                        f"{r['launches'].get('flash_attn_fwd', 0)}/"
                        f"{r['launches'].get('flash_attn_bwd', 0)}"
                        for r in res)
            + f"; torchrun {wall:.1f} s ({card_id})")
        if any(got[k] > PP_BARS[k] for k in PP_BARS):
            raise AssertionError(f"pp={pp}: {got}")
        # each stage's blocks, self- and cross-attention, each microbatch
        per_stage = 2 * (PP_DEPTH // pp) * PP_MICRO
        for r in res:
            if (r["launches"].get("flash_attn_fwd", 0) != per_stage
                    or r["launches"].get("flash_attn_bwd", 0) != per_stage):
                raise AssertionError(f"pp={pp} launches {r['launches']}")


def phase_restore(tmp: str) -> None:
    """A tp = 2 run's checkpoint (the flagship width at depth 4, two steps)
    restores into one process bit for bit (``sharded_restore``); step 3
    resumed in one process against step 3 resumed on tp = 2."""
    import torch

    from topiaxl_torch.cli.train import build_dit, main
    from topiaxl_torch.core.checkpoint import (CheckpointManager,
                                               sharded_restore)
    from topiaxl_torch.core.config import load_config
    from topiaxl_torch.pipelines.train import create_train_state

    card_id = card_line()
    common = ["train.synthetic=true", "model.generator.depth=4",
              "scheduler.warmup_iters=0", "train.log_every_n_steps=1",
              "train.ckpt_every_n_steps=1000000", "train.keep_ckpts=2",
              "train.batch_size=8"]
    tp = ["train.mesh.dp=1", "train.mesh.tp=2"]

    def root(name):
        return load_config(FLAGSHIP, overrides=[
            *common, f"root_data_dir={tmp}/restore_{name}"]).output_dir

    def over(name, steps):
        return [FLAGSHIP, *common, f"root_data_dir={tmp}/restore_{name}",
                f"train.max_steps={steps}"]

    ckpts = os.path.join(root("tp"), "train", "ckpts")
    out = os.path.join(tmp, "restore")
    torchrun(tmp, 2, [
        {"kind": "cli", "argv": over("tp", 2) + tp, "out": f"{out}_a"},
        {"kind": "copy", "src": ckpts,
         "dst": os.path.join(root("tp_resumed"), "train", "ckpts")},
        {"kind": "cli", "argv": over("tp_resumed", 3) + tp,
         "out": f"{out}_b"}], "restore")
    path = CheckpointManager(ckpts).path(2)
    written = torch.load(path, map_location="cpu", weights_only=True)
    cfg = load_config(FLAGSHIP, overrides=common)
    state = create_train_state(build_dit(cfg.model.generator, torch.device(
        "cuda"), torch.Generator("cuda").manual_seed(1)))
    sharded_restore(path, state)
    back = state.state_dict()
    same = (back["step"] == written["step"] == 2
            and back["opt"]["count"] == written["opt"]["count"]
            and all(torch.equal(back[p][n].cpu(), t)
                    for p in ("params", "ema") for n, t in written[p].items())
            and all(torch.equal(back["opt"][p][n].cpu(), t)
                    for p in ("mu", "nu")
                    for n, t in written["opt"][p].items()))
    del state, back
    torch.cuda.empty_cache()
    shutil.copytree(ckpts, os.path.join(root("one"), "train", "ckpts"))
    one: list = []
    if main(over("one", 3), metrics_out=one) != 0:
        raise AssertionError("cli.train (one process, resumed) failed")
    tp_step3 = read_ranks(f"{out}_b", 2)[0]["steps"]
    if [m["step"] for m in one] != [3] or [m["step"] for m in tp_step3] != [3]:
        raise AssertionError(f"resumed steps {one}, {tp_step3}")
    rel = abs(one[0]["loss"] - tp_step3[0]["loss"]) / abs(tp_step3[0]["loss"])
    log(f"  tp=2 checkpoint at step 2 (depth 4) into one process: bit for "
        f"bit {same}; step 3 resumed: one process loss {one[0]['loss']:.6f}, "
        f"tp=2 {tp_step3[0]['loss']:.6f}, rel {rel:.3e} (bar "
        f"{RESTORE_LOSS_REL}) ({card_id})")
    if not same or not rel <= RESTORE_LOSS_REL:
        raise AssertionError(f"restore: bitwise {same}, loss rel {rel}")


def phase_app(tmp: str) -> None:
    """``App.run`` on one synthetic image at the flagship config (random
    weights; stage 2 at mc 128 decimated to 5000 faces, box unwrap, as the
    clip phase exports): a GLB that parses."""
    from topiaxl_torch.app import App
    from topiaxl_torch.extract.glb import read_glb
    from topiaxl_torch.ops import _cuda

    from topiaxl_torch.pipelines import chain_graph

    img_dir = write_images(os.path.join(tmp, "app_img"), 1)
    image = os.path.join(img_dir, sorted(os.listdir(img_dir))[0])
    stats0 = dict(chain_graph.stats)
    _cuda.reset_launch_counts()
    t0 = time.perf_counter()
    app = App(FLAGSHIP, workdir=os.path.join(tmp, "app"))
    built = time.perf_counter() - t0
    glb = app.run(image, mc_resolution=128, decimate=5000, texture_size=1024)
    gltf, _ = read_glb(glb)
    log(f"  App: models built in {built:.1f} s, preprocess + generate + "
        f"export in {time.perf_counter() - t0 - built:.1f} s; {glb} glTF "
        f"{gltf['asset']['version']}, {os.path.getsize(glb)} bytes; launches "
        f"{ {k: v for k, v in _cuda.launches.items() if v} }; chain graphs "
        f"{ {k: chain_graph.stats[k] - stats0[k] for k in stats0} } "
        f"({card_line()})")
    if gltf["asset"]["version"] != "2.0" or dict(_cuda.launches) != {
            k: EXPECTED_LAUNCHES.get(k, 0) for k in _cuda.launches}:
        raise AssertionError(f"app: {gltf['asset']}, {_cuda.launches}")


# bench: the keys of python -m topiaxl_torch.bench's last line (bench.py's,
# less the four the port leaves out; tests/test_torch_bench.py holds the
# set equal to bench.py's on the CPU)
BENCH_KEYS = (
    "metric", "value", "unit", "vs_baseline", "mfu", "image_to_glb_seconds",
    "matting_s", "encode_s", "stage1_denoise_decode_s", "stage2_extract_s",
    "stage2_breakdown_s", "e2e_runs_s", "e2e_runs_stages_s",
    "assets_per_min_serial", "albedo_psnr_db", "geometry_p99_dev",
    "uv_stretch_l2_box", "uv_stretch_l2_lscm", "uv_stretch_linf_box",
    "uv_stretch_linf_lscm", "uv_coverage_box", "uv_coverage_lscm",
    "uv_charts_box", "uv_charts_lscm", "assets_per_min_pipelined",
    "dpm_albedo_psnr_db", "dpm_geometry_p99_dev", "dpm12_vs_ode_psnr_db",
    "ddim25_vs_ode_psnr_db", "flash_parity_on_card",
    "dit_denoise_steps_per_sec_int8", "train_steps_per_sec",
    "train_steps_per_sec_bs8")
BENCH_TIMEOUT_S = 480


def phase_bench() -> None:
    """``python -m topiaxl_torch.bench --fast`` as a user runs it, in its
    own process (every section, one warm image -> GLB run, four pipelined
    assets): exit 0, a last line with every key, an MFU in (0, 1), an
    albedo PSNR above 30 dB and the flash kernels within their parity bar.
    Prints the last line and the run's seconds."""
    import torch

    torch.cuda.empty_cache()     # the bench trains at batch 8 in its process
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "topiaxl_torch.bench",
                           "--fast"], cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=BENCH_TIMEOUT_S)
    secs = time.perf_counter() - t0
    lines = proc.stdout.strip().splitlines()
    for line in proc.stderr.strip().splitlines()[-12:]:
        log(f"  bench stderr: {line}")
    log(f"  bench: exit {proc.returncode} in {secs:.1f} s; first line "
        f"{lines[0] if lines else None}")
    log(f"  bench last line: {lines[-1] if lines else None}")
    if proc.returncode != 0 or not lines:
        raise AssertionError(f"bench exited {proc.returncode}")
    last = json.loads(lines[-1])
    missing = [k for k in BENCH_KEYS if k not in last]
    errors = {k: v for k, v in last.items() if k.endswith("_error")}
    if missing or errors:
        raise AssertionError(f"bench: missing {missing}, errors {errors}")
    if not 0.0 < last["mfu"] < 1.0:
        raise AssertionError(f"bench: mfu {last['mfu']} outside (0, 1)")
    if not last["albedo_psnr_db"] > 30.0:
        raise AssertionError(f"bench: albedo PSNR {last['albedo_psnr_db']}")
    if last["flash_parity_on_card"] is not True:
        raise AssertionError("bench: the flash kernels failed their parity")


def main() -> int:
    if not os.path.isdir(os.path.join(ROOT, "topiaxl_torch")):
        print("chip_smoke: run from a checkout of the repository "
              "(topiaxl_torch/ not found beside this script)", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import torch

    t_start = time.perf_counter()
    with Phase("device"):
        phase_device()
    with Phase("build"):
        phase_build()
    with Phase("kernels"):
        results = phase_kernels()
    with Phase("flash_head_dims"):
        for name, rows in phase_flash_head_dims().items():
            results[name]["head_dims"] = rows
    with Phase("ss_flow"):
        ss_flow = phase_ss_flow()
    with Phase("adamw_ema"):
        adamw = phase_adamw_ema()
    with Phase("probes"):
        results.update(phase_probes())
    with Phase("probe_path"):
        probe_launches = phase_probe_path()
    with tempfile.TemporaryDirectory() as tmp:
        with Phase("serving"):
            launches, bf16_recs = phase_serving(tmp)
        with Phase("serving_int8"):
            phase_serving_int8(tmp, bf16_recs)
        with Phase("serving_pos_emb"):
            phase_serving_pos_emb(tmp)
        with Phase("serving_samplers"):
            phase_serving_samplers(tmp)
        with Phase("chain_graph"):
            phase_chain_graph()
        with Phase("stage2"):
            phase_stage2(tmp)
        with Phase("render"):
            phase_render(tmp)
        with Phase("matting"):
            phase_matting(tmp)
        with Phase("conditioner_render"):
            phase_conditioner_render()
        with Phase("serve_assets"):
            phase_serve_assets(tmp)
    with Phase("dit"):
        phase_dit()
    with Phase("dit_int8"):
        phase_dit(quant=True)
    with tempfile.TemporaryDirectory() as tmp:
        with Phase("train"):
            train = phase_train(tmp)
    with tempfile.TemporaryDirectory() as tmp:
        with Phase("train_remat"):
            phase_train_remat(tmp, train)
        with Phase("train_remat_policies"):
            phase_train_remat_policies(tmp)
    with tempfile.TemporaryDirectory() as tmp:
        with Phase("train_long"):
            train_long = phase_train_long(tmp)
    with tempfile.TemporaryDirectory() as tmp:
        with Phase("ss_flow_train"):
            ss_flow["train"] = phase_ss_flow_train(tmp)
    with tempfile.TemporaryDirectory() as tmp:
        with Phase("mmdit"):
            mmdit = phase_mmdit(tmp)
    with tempfile.TemporaryDirectory() as tmp:
        with Phase("h21"):
            h21 = phase_h21(tmp)
    with Phase("train_parity"):
        phase_train_parity()
    with tempfile.TemporaryDirectory() as tmp:
        with Phase("prepare_data"):
            prepared = phase_prepare_data(tmp)
        with Phase("train_from_shards"):
            phase_train_from_shards(tmp, prepared["shards"])
    with Phase("train_vae"):
        phase_train_vae(prepared["params"])
    with tempfile.TemporaryDirectory() as tmp:
        with Phase("clip"):
            phase_clip(tmp)
    with Phase("vgg"):
        phase_vgg()
    with Phase("ring"):
        ring_launches = phase_ring()
    with tempfile.TemporaryDirectory() as tmp:
        with Phase("dp"):
            phase_dp(tmp)
    with tempfile.TemporaryDirectory() as tmp:
        with Phase("tp"):
            phase_tp(tmp)
    with tempfile.TemporaryDirectory() as tmp:
        with Phase("pp"):
            phase_pp(tmp)
    with tempfile.TemporaryDirectory() as tmp:
        with Phase("restore"):
            phase_restore(tmp)
    with tempfile.TemporaryDirectory() as tmp:
        with Phase("app"):
            phase_app(tmp)
    with Phase("bench"):
        phase_bench()

    # launches: serving for the forward and LN kernels, the flagship
    # trainer for the single-pass backward, the 4096-prim trainer for the
    # two-pass pair (0: at head dim 72 the rule takes the single pass)
    launches.update(flash_attn_bwd=train["flash_attn_bwd"],
                    flash_attn_bwd_dq=train_long["flash_attn_bwd_dq"],
                    flash_attn_bwd_dkv=train_long["flash_attn_bwd_dkv"],
                    **probe_launches)
    kernels = [dict(name=name, route="cuda", source=src, replaces=rep,
                    launches=launches[name], **results[name])
               for name, (src, rep) in KERNELS.items()]
    log(f"ring launches (kernels line: main paths only): {ring_launches}")
    print(json.dumps({"ss_flow": ss_flow}))
    print(json.dumps({"mmdit": mmdit}))
    print(json.dumps({"h21": h21}))
    print(json.dumps({"adamw_ema": adamw}))
    log(f"chip_smoke: every phase passed in {time.perf_counter() - t_start:.1f}"
        f" s (limit 1200 s)")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
