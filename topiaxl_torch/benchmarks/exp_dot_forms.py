"""Tensor-core cost of the attention dot forms against head-dim padding
(the counterparts of ``benchmarks/exp_dot_forms.py:_loop_kernel`` and
``benchmarks/exp_dot_forms2.py:_kernel``).

    python -m topiaxl_torch.benchmarks.exp_dot_forms

A form is a product ``dot_general(A, B)`` named by the dimension each
operand contracts (JAX's ``dimension_numbers``): A [X, K] or [K, X], B
[K, Y] or [Y, K], out [X, Y] in f32. On the card each operand is read
K-major (contraction contiguous) or MN-major by wgmma; a contraction of
72 pads to 80 (wgmma's depth is 16 bf16) and an output width of 72 is a
legal n72 (an output of 72 or 80 rows is computed as its transpose).

- ``dot_form_chain`` (TPU ``exp_dot_forms``): ``N_ITER`` products in one
  launch, summed; time per product is the launch's over ``N_ITER``.
- ``dot_form_accum`` (TPU ``exp_dot_forms2``): G products in one launch
  with the operands resident; time per product is the slope between
  G = ``G_LO`` and ``G_HI`` launches, which cancels the fixed cost.

Times are CUDA-graph replay; rates count 2 X Y K operations a product on
the operands as given. The last line is one JSON object with every
number printed.
"""

from __future__ import annotations

import json

import torch

from . import PEAK_BF16_FLOPS, card, device_ms, probe_launch, require_card

N_ITER = 64
G_LO, G_HI = 512, 8192
# (label, A shape, B shape, (A's contracted dim, B's contracted dim)): the
# TPU probes' forms, bq 512 and sk 1024 (chain) or 2048 (accum)
CHAIN_FORMS = [
    ("qk_lane", (512, 128), (1024, 128), (1, 1)),
    ("qk_sub", (80, 512), (80, 1024), (0, 0)),
    ("pv_std", (512, 1024), (1024, 128), (1, 0)),
    ("pv_lane", (80, 1024), (512, 1024), (1, 1)),
    ("ref", (1024, 1152), (1152, 2048), (1, 0)),
]
ACCUM_FORMS = [
    ("cal", (512, 1152), (1152, 1152), (1, 0)),
    ("qk_lane", (512, 128), (2048, 128), (1, 1)),
    ("pv_std", (512, 2048), (2048, 128), (1, 0)),
    ("qk_l72", (512, 72), (2048, 72), (1, 1)),
    ("pv_s72", (512, 2048), (2048, 72), (1, 0)),
    ("pv_lane", (72, 2048), (512, 2048), (1, 1)),
    ("dq_lane", (72, 2048), (512, 2048), (1, 1)),
    ("qk_sub", (72, 512), (72, 2048), (0, 0)),
]


def form_flops(a_shape, b_shape, dn) -> float:
    """2 X Y K: the operations of one product on the operands as given."""
    ca, cb = dn
    return 2.0 * a_shape[1 - ca] * b_shape[1 - cb] * a_shape[ca]


def dot_general(a: torch.Tensor, b: torch.Tensor, dn) -> torch.Tensor:
    """The f32 product of one form (bf16 products are exact in f32)."""
    ca, cb = dn
    lhs = a if ca == 1 else a.t()
    rhs = b if cb == 0 else b.t()
    return lhs.float() @ rhs.float()


def dot_form_chain_plain(a, b, dn, n_iter: int = N_ITER) -> torch.Tensor:
    """The TPU chain: step i adds ``dot(bf16(f32(a) + i * 1e-20), b)``."""
    acc = 0.0
    for i in range(n_iter):
        # f32(i) * f32(1e-20), made on a's device (no host copy, so the
        # loop can be captured in a CUDA graph)
        eps = torch.full((), float(i), device=a.device) * 1e-20
        ai = (a.float() + eps).to(a.dtype)
        acc = acc + dot_general(ai, b, dn)
    return acc


def dot_form_accum_plain(a, b, dn, g: int) -> torch.Tensor:
    """The TPU grid: each of g steps adds ``dot(a, b)`` to the output."""
    acc = 0.0
    for _ in range(g):
        acc = acc + dot_general(a, b, dn)
    return acc


def _launch(name: str, a, b, dn, iters: int) -> torch.Tensor:
    """The kernel computes out [X, Y] directly when X is a multiple of 128,
    else (X of 72 or 80) its transpose [Y, X] with the operands swapped,
    and stores it transposed."""
    ca, cb = dn
    X, Y = a.shape[1 - ca], b.shape[1 - cb]
    out = torch.empty((X, Y), device=a.device, dtype=torch.float32)
    if X % 128 == 0:
        probe_launch(name, a, b, out, coef=False, ta=ca == 0, tb=cb == 0,
                     iters=iters, out_t=False)
    else:
        probe_launch(name, b, a, out, coef=False, ta=cb == 0, tb=ca == 0,
                     iters=iters, out_t=True)
    return out


def dot_form_chain(a, b, dn, n_iter: int = N_ITER) -> torch.Tensor:
    """``sum_{i<n_iter} dot(a, b)`` in one launch on a CUDA tensor (without
    the TPU's anti-hoisting perturbation, see ``csrc/mma_probe.cu``); the
    plain version on a CPU one."""
    if a.device.type == "cpu":
        return dot_form_chain_plain(a, b, dn, n_iter)
    return _launch("dot_form_chain", a, b, dn, n_iter)


def dot_form_accum(a, b, dn, g: int) -> torch.Tensor:
    """``sum_{i<g} dot(a, b)`` in one launch on a CUDA tensor; the plain
    version on a CPU one."""
    if a.device.type == "cpu":
        return dot_form_accum_plain(a, b, dn, g)
    return _launch("dot_form_accum", a, b, dn, g)


def operands(a_shape, b_shape, device, seed: int = 0):
    g = torch.Generator(device).manual_seed(seed)
    return (torch.randn(a_shape, generator=g, device=device).bfloat16(),
            torch.randn(b_shape, generator=g, device=device).bfloat16())


def measure_chain(form, launches: int = 5) -> dict:
    label, a_shape, b_shape, dn = form
    a, b = operands(a_shape, b_shape, torch.device("cuda"))
    ms = device_ms(lambda: dot_form_chain(a, b, dn, N_ITER), launches)
    us = ms * 1e3 / N_ITER
    flops = form_flops(a_shape, b_shape, dn)
    return {"form": label, "a": list(a_shape), "b": list(b_shape),
            "dn": list(dn), "launch_ms": ms, "us_per_dot": us,
            "tflops": flops / us / 1e6}


def measure_accum(form, launches: int = 3) -> dict:
    label, a_shape, b_shape, dn = form
    a, b = operands(a_shape, b_shape, torch.device("cuda"))
    lo = device_ms(lambda: dot_form_accum(a, b, dn, G_LO), launches)
    hi = device_ms(lambda: dot_form_accum(a, b, dn, G_HI), launches)
    us = (hi - lo) * 1e3 / (G_HI - G_LO)
    flops = form_flops(a_shape, b_shape, dn)
    return {"form": label, "a": list(a_shape), "b": list(b_shape),
            "dn": list(dn), "ms_g_lo": lo, "ms_g_hi": hi, "us_per_dot": us,
            "tflops": flops / us / 1e6}


def main(argv=None) -> int:
    require_card()
    peak = PEAK_BF16_FLOPS / 1e12
    print(f"{card()}; bf16 -> f32, peak {peak:.0f} TFLOP/s", flush=True)
    print(f"chain: {N_ITER} products in one launch", flush=True)
    chain = []
    for form in CHAIN_FORMS:
        r = measure_chain(form)
        chain.append(r)
        print(f"  {r['form']:8s} {r['a']} x {r['b']} c={r['dn']}: "
              f"{r['us_per_dot']:8.2f} us/dot {r['tflops']:6.1f} TFLOP/s "
              f"({100 * r['tflops'] / peak:.1f}%)", flush=True)
    print(f"accum: slope between G={G_LO} and G={G_HI} products", flush=True)
    accum = []
    for form in ACCUM_FORMS:
        r = measure_accum(form)
        accum.append(r)
        print(f"  {r['form']:8s} {r['a']} x {r['b']} c={r['dn']}: "
              f"{r['us_per_dot']:8.2f} us/dot {r['tflops']:6.1f} TFLOP/s "
              f"({100 * r['tflops'] / peak:.1f}%)", flush=True)
    print(json.dumps({"chain": chain, "accum": accum}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
