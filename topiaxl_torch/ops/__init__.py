"""Attention, fused LayerNorm-modulate and image ops (kernels + plain twins)."""
