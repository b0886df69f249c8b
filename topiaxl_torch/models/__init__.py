"""Models: DiT, VAE3D, PrimX field, conditioners, latent statistics."""
