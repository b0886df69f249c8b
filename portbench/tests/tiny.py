"""Tiny copies of the benchmark's cells for the CPU tests: the same
configuration keys and drivers at a few narrow blocks, small images and a
short chain."""

from __future__ import annotations

import copy

from portbench import run as R

TINY_GENERATOR = dict(seq_length=64, condition_channels=32, hidden_size=64,
                      depth=2, num_heads=4)
TINY_ENCODER = dict(model_name="dinov2_tiny_test", image_size=28, patch=7,
                    registers=4, width=32, depth=1, heads=4)
TINY_VAE = dict(down_channels=[8, 16], up_channels=[16, 8], layers_per_block=1)


def tiny_cell(name: str, **limits) -> dict:
    cell = copy.deepcopy(R.load_cell(name))
    c = cell["config_data"]
    c["generator"].update(TINY_GENERATOR)
    c["cond_tokens"] = 17
    if "encoder" in c:
        c["encoder"].update(TINY_ENCODER)
        c["vae"].update(TINY_VAE)
        c["inference"]["ddim"] = 4
        cell["traffic_data"]["image_pool"] = 3
    if "train" in c:
        c["train"]["batch_size"] = 4
    cell["limits"].update(limits)
    return cell
