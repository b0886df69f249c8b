"""Model FLOPs of Hunyuan3D-2.1's shape DiT's steps completed in the traced
window (three times the batch's forward, the top-2 routed experts, the
shared expert and the gate counted, no recomputation:
``counts_h21.train_step_flops``), over the window and the card's dense
bf16 peak."""

from portbench.readers import mfu_pct


def read(run, params):
    return mfu_pct(run)
