"""Checkpoints of the whole training state with ``torch.save``
(counterpart of ``topiaxl/core/checkpoint.py``, which writes orbax
directories; those are not read here).

``CheckpointManager`` keeps ``step_<n>.pt`` files in one directory: the
newest ``max_to_keep`` survive, ``latest_step`` finds the newest, and a
file is written under a temporary name and renamed, so a run killed
mid-save leaves the previous checkpoint intact.

A checkpoint holds whole tensors whatever mesh wrote it (``TrainState.
state_dict`` gathers FSDP2 shards and tensor-parallel parts), so it
restores onto any other mesh (``sharded_restore``, the counterpart of
JAX's ``sharded_restore_template``): ``{dp: 4}`` into ``{dp: 1, fsdp: 2,
tp: 2}`` and back, bit for bit.
"""

from __future__ import annotations

import os
import re
from typing import Optional

import torch

_NAME = re.compile(r"^step_(\d+)\.pt$")


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        os.makedirs(self.directory, exist_ok=True)

    def path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:09d}.pt")

    def steps(self) -> list[int]:
        return sorted(int(m.group(1)) for f in os.listdir(self.directory)
                      if (m := _NAME.match(f)))

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: dict) -> str:
        """Write ``state`` (tensors go to the CPU) for ``step`` and drop the
        oldest files beyond ``max_to_keep``."""
        path = self.path(step)
        tmp = f"{path}.{os.getpid()}.tmp"
        torch.save(state, tmp)
        os.replace(tmp, path)
        for old in self.steps()[:-self.max_to_keep]:
            os.remove(self.path(old))
        return path

    def restore(self, step: Optional[int] = None, map_location="cpu") -> dict:
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        return torch.load(self.path(step), map_location=map_location,
                          weights_only=True)


def sharded_restore(path: str, state) -> None:
    """Load the checkpoint file at ``path`` into ``state`` (a
    ``pipelines/train.py:TrainState``) in place, laid out on the state's
    own mesh: each tensor-parallel parameter, Adam moment and EMA takes its
    ``tp`` part and each FSDP2 one its shard of that; step, optimizer count
    and sampler state as written."""
    state.load_state_dict(torch.load(path, map_location="cpu",
                                     weights_only=True))
