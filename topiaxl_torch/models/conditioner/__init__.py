"""Image conditioners (DINOv2, the render-then-encode wrapper, a
passthrough)."""
