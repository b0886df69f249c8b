"""Tensor-core probes on the card, the port's counterparts of the JAX
package's ``benchmarks/microbench_pallas_int8.py`` and
``benchmarks/exp_dot_forms{,2}.py``:

    python -m topiaxl_torch.benchmarks.microbench_int8
    python -m topiaxl_torch.benchmarks.exp_dot_forms

Both launch the kernel of ``csrc/mma_probe.cu`` through ``probe_launch``
and print their rates beside the card's peaks (H100 SXM data sheet,
dense: 989 TFLOP/s bf16, 1,979 TOP/s int8). Each module also holds the
plain PyTorch version of what its kernel computes.
"""

from __future__ import annotations

import torch

from ..ops import _cuda

PEAK_BF16_FLOPS = 989e12
PEAK_INT8_OPS = 1979e12
BLOCK_M = 128   # output rows of one block of the kernel


def require_card() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card (torch.cuda.is_available() is "
                         "false)")


def probe_launch(name: str, a: torch.Tensor, b: torch.Tensor,
                 out: torch.Tensor, *, coef: bool, ta: bool, tb: bool,
                 iters: int, out_t: bool) -> None:
    """One launch of the probe kernel into ``out`` (see the source's C
    entry for what each flag means); counts under ``launches[name]``."""
    for label, t in (("a", a), ("b", b), ("out", out)):
        if t.device.type != "cuda" or t.device != a.device:
            raise ValueError(f"{name}: {label} on {t.device}, a on {a.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name}: {label} must be contiguous and "
                             f"16-byte aligned")
    if a.dtype != b.dtype or a.dtype not in (torch.bfloat16, torch.int8):
        raise ValueError(f"{name}: bf16 or int8 operands, got {a.dtype}, "
                         f"{b.dtype}")
    int8 = a.dtype == torch.int8
    M, K = (a.shape[1], a.shape[0]) if ta else tuple(a.shape)
    N, Kb = (b.shape[1], b.shape[0]) if tb else tuple(b.shape)
    if K != Kb or tuple(out.shape) != ((N, M) if out_t else (M, N)):
        raise ValueError(f"{name}: shapes {tuple(a.shape)} {tuple(b.shape)} "
                         f"-> {tuple(out.shape)} do not match")
    if out.dtype != (torch.int32 if int8 else torch.float32):
        raise ValueError(f"{name}: out must be int32 for int8, f32 for bf16")
    if M % BLOCK_M or K * a.element_size() % 16:
        raise ValueError(f"{name}: M={M} must be a multiple of {BLOCK_M} "
                         f"and K={K} of {16 // a.element_size()}")
    if coef or int8:
        if not coef or ta or not tb or N % 128:
            raise ValueError(f"{name}: the rate loop takes A [M, K], "
                             f"B [K, N] with N a multiple of 128")
    elif (N % 128 and N not in (72, 80)) or (ta and not tb):
        raise ValueError(f"{name}: N={N} must be 72, 80 or a multiple of "
                         f"128, and a transposed A needs a [K, N] B")
    rc = _cuda.library().topiaxl_mma_probe(
        a.data_ptr(), b.data_ptr(), out.data_ptr(), int(int8), int(ta),
        int(tb), int(coef), M, N, K, int(iters), int(out_t),
        _cuda.stream_of(a))
    _cuda.check(rc, name)
    _cuda.count_launch(name)


def device_ms(fn, iters: int) -> float:
    """Mean device ms per call of ``fn``: ``iters`` calls captured in one
    CUDA graph after a warm-up call, its replay timed by CUDA events."""
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


def card() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    import subprocess

    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
