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
CHUNK_BYTES = 256   # contraction bytes of each row the kernel stages at once


def require_card() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card (torch.cuda.is_available() is "
                         "false)")


# how an output tile's sum is shared among blocks (``pick_splits``)
MIN_PRODUCTS = 16   # products a block keeps at least, so that staging its
                    # chunks stays small beside them
MAX_WAVES = 4       # blocks at most, in waves of the card's block slots
SPLIT_SLACK = 0.02  # a smaller S within 2% of the best is taken

# the last plan of each probe launch, by counter name (``probe_launch``)
plans: dict = {}
_SLOTS: dict = {}   # blocks the card holds at once, by kernel and device


def pick_splits(tiles: int, work: int, slots: int) -> int:
    """S, the blocks that share each of ``tiles`` output tiles, when a
    tile's ``work`` products (one per chunk of the contraction and
    iteration) are cut into S ranges and the card holds ``slots`` blocks
    at once. Each S takes ``ceil(tiles S / slots)`` waves of ``ceil(work /
    S)`` products; the smallest S within ``SPLIT_SLACK`` of the fewest is
    taken, with at least ``MIN_PRODUCTS`` products a block and at most
    ``MAX_WAVES`` waves. Many tiles (the rate loop at M = 4224) give 1."""
    most = max(1, min(work // MIN_PRODUCTS, MAX_WAVES * slots // tiles))

    def cost(s: int) -> int:
        return -(-tiles * s // slots) * -(-work // s)

    best = min(cost(s) for s in range(1, most + 1))
    return next(s for s in range(1, most + 1)
                if cost(s) <= best * (1 + SPLIT_SLACK))


def tiles_and_work(M: int, N: int, K: int, elem_bytes: int,
                   iters: int) -> tuple[int, int]:
    """The kernel's output tiles (128 x 128, or 128 x N for N of 72 or 80)
    and each tile's products: one per staged chunk of the contraction and
    iteration."""
    block_n = 128 if N % 128 == 0 else N
    chunks = -(-K * elem_bytes // CHUNK_BYTES)
    return (M // BLOCK_M) * (N // block_n), chunks * iters


def _slots(int8: bool, ta: bool, tb: bool, coef: bool, n: int,
           device: torch.device) -> int:
    """Blocks of this kernel the card holds at once: per SM (registers,
    shared memory) times the SMs."""
    key = (int8, ta, tb, coef, n, device.index)
    if key not in _SLOTS:
        with torch.cuda.device(device):
            per_sm = _cuda.library().topiaxl_mma_probe_occupancy(
                int(int8), int(ta), int(tb), int(coef), n)
        if per_sm < 1:
            raise RuntimeError(f"probe kernel: no occupancy for {key}")
        sms = torch.cuda.get_device_properties(device).multi_processor_count
        _SLOTS[key] = per_sm * sms
    return _SLOTS[key]


def probe_launch(name: str, a: torch.Tensor, b: torch.Tensor,
                 out: torch.Tensor, *, coef: bool, ta: bool, tb: bool,
                 iters: int, out_t: bool) -> None:
    """One launch of the probe kernel into ``out`` (see the source's C
    entry for what each flag means); counts under ``launches[name]``.
    ``pick_splits`` blocks share each output tile; with more than one,
    their partial sums go to a workspace that a second kernel reduces, in
    a fixed order. The plan (tiles, splits, blocks, slots) is kept in
    ``plans[name]``."""
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
    block_n = 128 if N % 128 == 0 else N
    slots = _slots(int8, ta, tb, coef, block_n, a.device)
    tiles, work = tiles_and_work(M, N, K, a.element_size(), iters)
    splits = pick_splits(tiles, work, slots)
    ws = (torch.empty((splits, *out.shape), device=out.device, dtype=out.dtype)
          if splits > 1 else None)
    with _cuda.on_device(a):
        rc = _cuda.library().topiaxl_mma_probe(
            a.data_ptr(), b.data_ptr(), out.data_ptr(),
            None if ws is None else ws.data_ptr(), int(int8), int(ta),
            int(tb), int(coef), M, N, K, int(iters), int(out_t), splits,
            _cuda.stream_of(a))
    _cuda.check(rc, name)
    _cuda.count_launch(name)
    plans[name] = {"tiles": tiles, "splits": splits, "blocks": tiles * splits,
                   "slots": slots}


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
