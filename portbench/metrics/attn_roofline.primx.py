"""Attention forwards of the window's requests (the chain's self- and
cross-attention, DINOv2's self-attention), each bounded by operations
over the peak or bytes over the bandwidth, over the device time of the
kernels this metric's JSON names."""

from portbench.readers import roofline_pct


def read(run, params):
    return roofline_pct(run, params["kernels"],
                        {"attn_fwd": run.work.get("attn_fwd", [])})
