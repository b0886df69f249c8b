"""The plain reference the benchmark holds the program to.

Plain PyTorch in float32 (TF32 off), written from the published 3DTopia-XL
architecture: DINOv2 ViT-B/14-reg (``dinov2.py``), the cross-attention DiT
(``dit.py``), the PrimX VAE decoder (``vae.py``), the squaredcos schedule,
the DDIM chain and the v-prediction loss with its variational-bound term
(``diffusion.py``), and clip-by-global-norm AdamW (``train.py``). It
imports nothing of the program: it reads the weights the benchmark made,
by their checkpoint names, and judges what the program produced
(``judge.py``).

Every product goes through ``ops.mm``, which computes in float32, or, with
``ops.PRECISION = "fp8"``, rounds both operands to float8 e4m3 (one scale
per tensor) first: the control that the checks must fail.
"""
