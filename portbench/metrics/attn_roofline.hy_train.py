"""The joint attention's forwards and backwards of the window's steps
(head dim 64 over 3072 latent + 1370 conditioning tokens, in each of the
16 double and 32 single blocks), each bounded by operations over the peak
or bytes over the bandwidth (``counts.attention_fwd``, ``.attention_bwd``),
over the device time of the kernels this metric's JSON names."""

from portbench.readers import roofline_pct


def read(run, params):
    return roofline_pct(run, params["kernels"],
                        {"attn_fwd": run.work.get("attn_fwd", []),
                         "attn_bwd": run.work.get("attn_bwd", [])})
