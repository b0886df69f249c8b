"""In-kernel tensor-core rate, int8 against bf16 (the counterpart of
``benchmarks/microbench_pallas_int8.py:loop_kernel``).

    python -m topiaxl_torch.benchmarks.microbench_int8

One launch of ``mma_rate_loop`` runs L products of A [M, K] by B [K, N]
on operands staged in shared memory and sums ``(i % 3 - 1) * (A B)``,
bf16 into f32 or int8 into int32 (``csrc/mma_probe.cu``). The time is
CUDA-graph replay of whole launches; the rate counts 2 M N K L
operations. Two shapes: the TPU probe's (M = 512: 32 output tiles of
128 x 128, so 32 of the 132 SMs work) and M = 4224 (264 tiles, two for
every SM), which is the reading of what the card gives. The last line
is one JSON object with every number printed.
"""

from __future__ import annotations

import json

import torch

from . import PEAK_BF16_FLOPS, PEAK_INT8_OPS, card, device_ms, probe_launch, require_card

M, K, N = 512, 1024, 1024   # the TPU probe's shape
L = 256                     # products per launch
M_FULL = 4224               # 33 x 8 output tiles: two per SM on 132 SMs


def coefficient(i: int) -> int:
    return i % 3 - 1


def mma_rate_loop_plain(a: torch.Tensor, b: torch.Tensor, iters: int,
                        coef=coefficient) -> torch.Tensor:
    """``sum_{i<iters} coef(i) * (a @ b)`` as the TPU body computes it,
    one product a step: bf16 products exact in f32 with f32 sums, or
    int8 products exact (in f64) summed in int32."""
    int8 = a.dtype == torch.int8
    acc = torch.zeros((a.shape[0], b.shape[1]), device=a.device,
                      dtype=torch.int32 if int8 else torch.float32)
    for i in range(iters):
        if int8:
            d = (a.double() @ b.double()).to(torch.int32)
        else:
            d = a.float() @ b.float()
        acc = acc + d * coef(i)
    return acc


def mma_rate_loop(a: torch.Tensor, b: torch.Tensor,
                  iters: int = L) -> torch.Tensor:
    """``sum_{i<iters} (i % 3 - 1) * (a @ b)`` for a [M, K], b [K, N],
    both bf16 (f32 out) or both int8 (int32 out): the kernel for CUDA
    tensors, the plain version for CPU ones."""
    if a.device.type == "cpu":
        return mma_rate_loop_plain(a, b, iters)
    out = torch.empty((a.shape[0], b.shape[1]), device=a.device,
                      dtype=torch.int32 if a.dtype == torch.int8
                      else torch.float32)
    probe_launch("mma_rate_loop", a, b, out, coef=True, ta=False, tb=True,
                 iters=iters, out_t=False)
    return out


def operands(m: int, dtype: torch.dtype, device, seed: int = 0):
    """A [m, K], B [K, N]: N(0, 1) in bf16, or uniform in [-127, 127)
    int8, as the TPU probe draws them."""
    g = torch.Generator(device).manual_seed(seed)
    if dtype == torch.int8:
        return (torch.randint(-127, 127, (m, K), generator=g, device=device,
                              dtype=torch.int8),
                torch.randint(-127, 127, (K, N), generator=g, device=device,
                              dtype=torch.int8))
    return (torch.randn((m, K), generator=g, device=device).bfloat16(),
            torch.randn((K, N), generator=g, device=device).bfloat16())


def measure(m: int, dtype: torch.dtype, launches: int = 5) -> dict:
    """ms per launch at [m, K] x [K, N], L products, and the rate."""
    a, b = operands(m, dtype, torch.device("cuda"))
    ms = device_ms(lambda: mma_rate_loop(a, b, L), launches)
    ops = 2.0 * m * N * K * L
    peak = PEAK_INT8_OPS if dtype == torch.int8 else PEAK_BF16_FLOPS
    return {"m": m, "k": K, "n": N, "iters": L, "ms": ms,
            "rate_t": ops / ms / 1e9, "peak_t": peak / 1e12,
            "share": ops / ms / 1e9 / (peak / 1e12)}


def main(argv=None) -> int:
    require_card()
    print(f"{card()}; in-kernel products [M, {K}] x [{K}, {N}], {L} per "
          f"launch", flush=True)
    results = {}
    for m, what in ((M, "the TPU probe's shape, 32 tiles"),
                    (M_FULL, "two tiles per SM")):
        for dtype, tag in ((torch.bfloat16, "bf16"), (torch.int8, "int8")):
            r = measure(m, dtype)
            results[f"{tag}_m{m}"] = r
            unit = "TOP/s" if dtype == torch.int8 else "TFLOP/s"
            print(f"{tag} M={m:<5d} ({what}): {r['ms']:.4f} ms -> "
                  f"{r['rate_t']:.1f} {unit} of {r['peak_t']:.0f} "
                  f"({100 * r['share']:.1f}%)", flush=True)
        ratio = results[f"int8_m{m}"]["rate_t"] / results[f"bf16_m{m}"]["rate_t"]
        results[f"int8_over_bf16_m{m}"] = ratio
        print(f"int8 / bf16 rate at M={m}: {ratio:.3f}", flush=True)
    print(json.dumps(results))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
