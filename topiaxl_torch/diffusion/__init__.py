"""Diffusion schedules and DDIM sampling."""

from . import gaussian
from .schedule import (
    Diffusion,
    DiffusionTables,
    build_tables,
    create_diffusion,
    get_named_beta_schedule,
    space_timesteps,
)

__all__ = ["Diffusion", "DiffusionTables", "build_tables", "create_diffusion",
           "gaussian", "get_named_beta_schedule", "space_timesteps"]
