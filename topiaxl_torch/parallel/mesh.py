"""Meshes of ``torch.distributed`` ranks (counterpart of
``topiaxl/parallel/mesh.py``).

A ``Mesh`` lays the ranks of a process group out on named axes, as the
JAX package lays devices out on a ``jax.sharding.Mesh``:

* ``dp``   — data parallel (the batch);
* ``fsdp`` — parameters and optimizer state sharded (FSDP2 ``fully_shard``);
* ``sp``   — tokens sharded, self-attention over the K/V ring
  (``parallel/context.py``).

``make_mesh`` follows JAX's rules: one axis may be -1 (inferred), an
indivisible rank count raises, an explicit smaller mesh takes the first
ranks, and the default is every rank on ``dp``. The layout is a pure
function of the sizes and the world size; the process groups of each
axis (``group``) and the ``DeviceMesh`` that FSDP2 takes
(``device_mesh``) are made once the default process group exists, by
every rank in the same order.
"""

from __future__ import annotations

import logging
from typing import Mapping

import numpy as np
import torch
import torch.distributed as dist


def world() -> tuple[int, int]:
    """(rank, world size) of the default process group; (0, 1) without one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


class Mesh:
    """Ranks ``ranks`` (an integer array, one dimension per axis) under
    ``axis_names``; ``shape`` maps each name to its size, in order."""

    def __init__(self, names, ranks: np.ndarray):
        self.axis_names = tuple(names)
        self.ranks = np.asarray(ranks, np.int64)
        self.shape = dict(zip(self.axis_names, self.ranks.shape))
        self.size = int(self.ranks.size)
        self.rank = world()[0]
        where = np.argwhere(self.ranks == self.rank)
        # this rank's coordinates, None for a rank outside the mesh
        self.coords = (dict(zip(self.axis_names, map(int, where[0])))
                       if len(where) else None)
        self._groups: dict = {}
        self._device_meshes: dict = {}

    @property
    def index(self) -> int | None:
        """This rank's position in the mesh's flattened (row-major) order:
        its slice of a batch sharded over every axis."""
        if self.coords is None:
            return None
        return int(np.ravel_multi_index(
            tuple(self.coords[n] for n in self.axis_names), self.ranks.shape))

    def group(self, axis: str | None = None):
        """The process group of this rank's line along ``axis`` (every rank
        of the mesh with ``axis=None``); None where no communication is
        needed (a single process, or an axis of size 1). The first call per
        axis is collective over the whole default group."""
        if world()[1] == 1:
            return None
        key = axis or "*"
        if key not in self._groups:
            if axis is None:
                lines = [self.ranks.reshape(-1)]
            else:
                moved = np.moveaxis(self.ranks,
                                    self.axis_names.index(axis), -1)
                lines = list(moved.reshape(-1, moved.shape[-1]))
            mine = None
            for line in lines:    # every rank creates every group
                g = dist.new_group([int(r) for r in line])
                if self.rank in line:
                    mine = g
            self._groups[key] = mine
        if axis is not None and self.shape[axis] == 1:
            return None
        return self._groups[key]

    def device_mesh(self, device_type: str, axes: tuple[str, ...]):
        """A ``torch.distributed.device_mesh.DeviceMesh`` over ``axes`` (the
        others must have size 1), e.g. ("dp", "fsdp") for FSDP2's hybrid
        sharding. Collective."""
        from torch.distributed.device_mesh import DeviceMesh

        if any(self.shape[n] != 1 for n in self.axis_names if n not in axes):
            raise ValueError(f"mesh {self.shape}: axes outside {axes} must "
                             f"have size 1")
        key = (device_type, axes)
        if key not in self._device_meshes:
            ranks = np.transpose(
                self.ranks, [self.axis_names.index(n) for n in axes]
                + [i for i, n in enumerate(self.axis_names) if n not in axes])
            ranks = ranks.reshape([self.shape[n] for n in axes])
            self._device_meshes[key] = DeviceMesh(
                device_type, torch.as_tensor(ranks), mesh_dim_names=axes)
        return self._device_meshes[key]


def make_mesh(axes: Mapping[str, int] | None = None,
              world_size: int | None = None) -> Mesh:
    """A mesh from {axis: size} over ``world_size`` ranks (default: the
    default process group's). One axis may be -1 (inferred); the default
    is every rank on ``dp``."""
    n = world()[1] if world_size is None else int(world_size)
    axes = dict(axes or {"dp": -1})
    known = int(np.prod([s for s in axes.values() if s != -1]))
    names, sizes = [], []
    for name, size in axes.items():
        if size == -1:
            if n % known:
                raise ValueError(f"{n} devices not divisible by {known}")
            size = n // known
        names.append(name)
        sizes.append(int(size))
    total = int(np.prod(sizes))
    if total > n:
        raise ValueError(f"mesh {dict(zip(names, sizes))} > {n} devices")
    # an explicit smaller mesh uses the first `total` ranks
    return Mesh(names, np.arange(total).reshape(sizes))


def mesh_from_config(cfg, world_size: int | None = None) -> Mesh:
    """cfg like {'dp': -1} or {'dp': 2, 'fsdp': 2} (the ``train.mesh``
    node); None gives the default mesh."""
    if cfg is None:
        return make_mesh(world_size=world_size)
    return make_mesh(dict(cfg), world_size=world_size)


def init_distributed(device: torch.device) -> tuple[torch.device, bool]:
    """Join the default process group when launched by ``torchrun`` with
    more than one process (``WORLD_SIZE`` > 1 in the environment; its
    ``MASTER_ADDR``, ``MASTER_PORT`` and ``RANK`` give the rendezvous).
    A CUDA ``device`` becomes card ``LOCAL_RANK`` (modulo the cards
    there are), with NCCL where every local rank has a card of its own and
    gloo otherwise (NCCL refuses two ranks on one card); the CPU takes
    gloo. Returns (this rank's device, whether the group was created
    here); a single process, or a group that exists, is left as it is."""
    import os

    if int(os.environ.get("WORLD_SIZE", "1")) <= 1 or dist.is_initialized():
        return device, False
    backend = "gloo"
    if device.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", "0"))
        local_world = int(os.environ.get("LOCAL_WORLD_SIZE",
                                         os.environ["WORLD_SIZE"]))
        cards = torch.cuda.device_count()
        device = torch.device("cuda", local % cards)
        torch.cuda.set_device(device)
        if local_world <= cards:
            backend = "nccl"
    dist.init_process_group(backend)
    logging.getLogger("topiaxl_torch.parallel").info(
        "process group: rank %d of %d, %s, %s", dist.get_rank(),
        dist.get_world_size(), backend, device)
    return device, True


def refuse_unported(mesh: Mesh) -> None:
    """Raise for the axes whose parallelism the port does not have."""
    if mesh.shape.get("tp", 1) > 1 or "pp" in mesh.shape:
        raise NotImplementedError(
            f"mesh {mesh.shape}: tensor (tp > 1) and pipeline (pp) "
            f"parallelism are not ported to topiaxl_torch (ROADMAP queue 1 "
            f"#9); use dp and fsdp")
