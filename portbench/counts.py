"""The yardstick's arithmetic: peaks of the card, and the operations and
bytes that the work needs, from its shapes, whatever implements it.

``PEAK_BF16_TFLOPS`` and ``cfg_step_flops`` are frozen copies of
``topiaxl_torch/bench.py``'s (the table of dense bf16 peaks by card name;
the products of one CFG'd DiT step). A card whose name is not in the table
has no peak, and a run on it fails.
"""

from __future__ import annotations

import subprocess

# dense bf16 tensor-core peak by card name (data sheets: half the sparse
# figure)
PEAK_BF16_TFLOPS = {
    "NVIDIA H100 80GB HBM3": 989.4,   # H100 SXM5
    "NVIDIA H100 NVL": 835.5,
    "NVIDIA H100 PCIe": 756.5,
}
# device-memory bandwidth by card name, TB/s
PEAK_HBM_TBPS = {
    "NVIDIA H100 80GB HBM3": 3.35,
    "NVIDIA H100 NVL": 3.9,
    "NVIDIA H100 PCIe": 2.0,
}


def peaks(name: str) -> tuple[float, float]:
    """(bf16 FLOP/s, bytes/s) of the card; raises for a card not listed."""
    if name not in PEAK_BF16_TFLOPS:
        raise ValueError(f"no bf16 peak known for {name!r}")
    return PEAK_BF16_TFLOPS[name] * 1e12, PEAK_HBM_TBPS[name] * 1e12


def card_line() -> str:
    """``nvidia-smi``'s name and power limit of the card."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {e!r}"[:120]


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


def dit_forward_flops(batch: int, depth: int, hidden: int, n: int, m: int,
                      cond_dim: int, in_channels: int = 68,
                      out_channels: int = 136, mlp_ratio: float = 4.0,
                      freq_dim: int = 256) -> float:
    """FLOPs of the training forward for ``batch`` samples: every sample's
    cross-attention K/V projected from its conditioning in every block,
    then the step's products as ``cfg_step_flops`` counts them for one
    half."""
    d = hidden
    kv = 2 * 2 * batch * m * cond_dim * d
    block = (2 * batch * d * 9 * d + 2 * batch * n * d * 3 * d
             + 4 * batch * n * n * d + 2 * batch * n * d * d
             + 2 * 2 * batch * n * d * int(mlp_ratio * d)
             + 2 * batch * n * d * d + 4 * batch * n * m * d
             + 2 * batch * n * d * d + kv)
    embed = 2 * batch * n * in_channels * d + 2 * batch * (freq_dim * d + d * d)
    final = 2 * batch * d * 2 * d + 2 * batch * n * d * out_channels
    return float(depth * block + embed + final)


def train_step_flops(*args, **kw) -> float:
    """Model FLOPs of a training step: three times the forward (the
    backward's products are twice the forward's), no recomputation."""
    return 3.0 * dit_forward_flops(*args, **kw)


def attention_fwd(b: int, sq: int, sk: int, h: int, d: int,
                  elem: int = 2) -> tuple[float, float]:
    """(FLOPs, bytes) an attention forward needs: QK^T and PV; q, k, v
    read and o written once in ``elem``-byte elements, the f32 row
    log-sum-exp written once."""
    flops = 4.0 * b * h * sq * sk * d
    nbytes = elem * b * h * d * (2 * sq + 2 * sk) + 4.0 * b * h * sq
    return flops, nbytes


def attention_bwd(b: int, sq: int, sk: int, h: int, d: int,
                  elem: int = 2) -> tuple[float, float]:
    """(FLOPs, bytes) an attention backward needs: the products of dP, dV,
    dQ and dK (a kernel that recomputes QK^T does more than the work
    needs); q, k, v, o, dO and the log-sum-exp read once, dq, dk, dv
    written once."""
    flops = 8.0 * b * h * sq * sk * d
    nbytes = (elem * b * h * d * (3 * sq + 2 * sk)   # q, o, dO; k, v
              + 4.0 * b * h * sq                     # lse
              + elem * b * h * d * (sq + 2 * sk))    # dq; dk, dv
    return flops, nbytes


def least_seconds(flops: float, nbytes: float, card: str) -> float:
    """The least time the card could take: the larger of operations over
    its peak and bytes over its bandwidth."""
    peak, bw = peaks(card)
    return max(flops / peak, nbytes / bw)
