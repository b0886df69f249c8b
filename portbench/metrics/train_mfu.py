"""Model FLOPs of the steps completed in the traced window (three times
the batch's forward, cross-attention K/V projected every step, no
recomputation: ``counts.train_step_flops``), over the window and the
card's dense bf16 peak."""

from portbench.readers import mfu_pct


def read(run, params):
    return mfu_pct(run)
