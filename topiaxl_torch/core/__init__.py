"""Weight layout helpers."""
