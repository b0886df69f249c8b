"""Per-channel statistics of the PrimX token space (4 srt + 64 VAE-latent
channels), used to normalize DiT inputs/outputs.

These are properties of the released 3DTopia-XL checkpoint's latent
distribution (reference configs/inference_dit.yml:64-65, applied at
inference.py:288-293 and :329-330). Registered by name so configs say
``latent_stats: primx_v1`` instead of carrying 136 literals.
"""

import numpy as np

# fmt: off
PRIMX_V1_MEAN = np.array([
    0.0442, -0.0029, -0.0425, -0.0043, -0.4086, -0.2906, -0.7002, -0.0852,
    -0.4446, -0.6896, -0.7344, -0.3524, -0.5488, -0.4313, -1.1715, -0.0875,
    -0.6131, -0.3924, -0.7335, -0.3749, 0.4658, -0.0236, 0.8362, 0.3388,
    0.0188, 0.5988, -0.1853, 1.1579, 0.6240, 0.0758, 0.9641, 0.6586,
    0.6260, 0.2384, 0.7798, 0.8297, -0.6543, -0.4441, -1.3887, -0.0393,
    -0.9008, -0.8616, -1.7434, -0.1328, -0.8119, -0.8225, -1.8533, -0.0444,
    -1.0510, -0.5158, -1.1907, -0.5265, 0.2832, 0.6037, 0.5981, 0.5461,
    0.4366, 0.4144, 0.7219, 0.5722, 0.5937, 0.5598, 0.9414, 0.7419,
    0.2102, 0.3388, 0.4501, 0.5166,
], dtype=np.float32)

PRIMX_V1_STD = np.array([
    0.0219, 0.3707, 0.3911, 0.3610, 0.7549, 0.7909, 0.9691, 0.9193,
    0.8218, 0.9389, 1.1785, 1.0254, 0.6376, 0.6568, 0.7892, 0.8468,
    0.8775, 0.7920, 0.9037, 0.9329, 0.9196, 1.1123, 1.3041, 1.0955,
    1.2727, 1.6565, 1.8502, 1.7006, 0.8973, 1.0408, 1.2034, 1.2703,
    1.0373, 1.0486, 1.0716, 0.9746, 0.7088, 0.8685, 1.0030, 0.9504,
    1.0410, 1.3033, 1.5368, 1.4386, 0.6142, 0.6887, 0.9085, 0.9903,
    1.0190, 0.9302, 1.0121, 0.9964, 1.1474, 1.2729, 1.4627, 1.1404,
    1.3713, 1.6692, 1.8424, 1.5047, 1.1356, 1.2369, 1.3554, 1.1848,
    1.1319, 1.0822, 1.1972, 0.9916,
], dtype=np.float32)
# fmt: on

STATS = {
    "primx_v1": (PRIMX_V1_MEAN, PRIMX_V1_STD),
}


def resolve_latent_stats(model_cfg):
    """Stats from a config's ``model`` node: a named ``latent_stats``
    wins; else the explicit ``latent_mean``/``latent_std`` lists. The
    single source of truth for token normalization — shared by inference
    (cli/infer.py) and dataset preparation (cli/prepare_data.py), which
    MUST agree."""
    stats = model_cfg.get("latent_stats")
    if stats is not None:
        return get_latent_stats(stats)
    return get_latent_stats(model_cfg.latent_mean, model_cfg.latent_std)


def get_latent_stats(name_or_lists, std=None):
    """Resolve latent stats from a registered name or explicit lists."""
    if isinstance(name_or_lists, str):
        if name_or_lists not in STATS:
            raise KeyError(f"unknown latent stats '{name_or_lists}'")
        return STATS[name_or_lists]
    mean = np.asarray(name_or_lists, dtype=np.float32)
    std = np.asarray(std, dtype=np.float32)
    return mean, std
