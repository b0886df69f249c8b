"""Image conditioners (DINOv2)."""
