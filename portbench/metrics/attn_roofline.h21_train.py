"""The attentions' forwards and backwards of the window's steps (head dim
128: in each of the 13 blocks the self-attention over 4096 latent tokens
and the time token, 4097 keys, and the cross-attention of those 4097
queries over 1370 conditioning tokens), each bounded by operations over
the peak or bytes over the bandwidth (``counts.attention_fwd``,
``.attention_bwd``), over the device time of the kernels this metric's
JSON names (the forward, and the single pass or the dq and dk/dv pair the
backward's shape rule takes)."""

from portbench.readers import roofline_pct


def read(run, params):
    return roofline_pct(run, params["kernels"],
                        {"attn_fwd": run.work.get("attn_fwd", []),
                         "attn_bwd": run.work.get("attn_bwd", [])})
