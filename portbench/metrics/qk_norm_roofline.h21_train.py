"""The QK-norm kernels' share of their bandwidth bound over the window's
steps, in the RMS form at head dim 128: the bytes their calls need
(``counts_h21.step_qk_norm_bytes``: in each block the self-attention's q
and k and the cross-attention's q over 4097 tokens, its k over 1370,
forward and backward) over the card's bandwidth, over the device time of
the kernels this metric's JSON names. None where the program launches no
such kernel."""

from portbench import counts
from portbench import trace as T


def read(run, params):
    need = run.work.get("qk_norm_bytes")
    if run.trace is None or not run.units or not need:
        return None
    spent = T.kernel_seconds(run.trace, params["kernels"])
    if spent <= 0:
        return None
    _, bandwidth = counts.peaks(run.card)
    return 100.0 * run.units * need / bandwidth / spent
