"""The chain's model FLOPs (the DDIM steps' CFG'd DiT products, as
``counts.cfg_step_flops`` counts them) for the PrimX completed in the
traced window, over the window and the card's dense bf16 peak."""

from portbench.readers import mfu_pct


def read(run, params):
    return mfu_pct(run)
