"""Model FLOPs of Hunyuan3D-2's shape DiT's steps completed in the traced
window (three times the batch's forward, no recomputation:
``counts_mmdit.train_step_flops``), over the window and the card's dense
bf16 peak."""

from portbench.readers import mfu_pct


def read(run, params):
    return mfu_pct(run)
