"""Attention forwards and backwards of the window's flow-transformer steps
(head dim 64: self-attention over 4096 keys, whose backward is the
two-pass pair, and cross-attention over 1374), each bounded by operations
over the peak or bytes over the bandwidth, over the device time of the
kernels this metric's JSON names."""

from portbench.readers import roofline_pct


def read(run, params):
    return roofline_pct(run, params["kernels"],
                        {"attn_fwd": run.work.get("attn_fwd", []),
                         "attn_bwd": run.work.get("attn_bwd", [])})
