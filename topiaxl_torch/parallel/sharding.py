"""Tensor parallelism: parameter placement rules and the shards they make
(counterpart of ``topiaxl/parallel/sharding.py``).

The rules are JAX's, on the port's state_dict names and in torch's
``[out, in]`` weight layout: a spec gives each dim of a tensor a mesh
axis, or None. The Megatron pairing of JAX's rules holds: the
column-parallel projections (``qkv``, ``to_q``/``to_k``/``to_v``,
``fc1``) split their outputs (heads, hidden units) over ``tp``, the
row-parallel ones (``proj``, ``fc2``) their inputs, so each sublayer
needs one all-reduce (``models/layers.py``). JAX leaves the rest to
GSPMD; here ``shard_params`` slices each tensor to this rank's ``tp``
part and tells each sublayer its group, and ``gather_params`` puts the
whole tensors back (checkpoints are whole). The ``fsdp`` entries are
JAX's placement and are read by ``fit_spec`` only: the port's FSDP2
(``pipelines/train.py:shard_model``) shards dim 0 of every local tensor
over the ``("dp", "fsdp")`` sub-mesh of its ``tp`` coordinate.

One placement differs from JAX's because GSPMD is not there to
reshard: the fused ``qkv`` projection's rows are laid out ``[3, H,
hd]`` (q, k and v after each other), so a contiguous split of its rows
hands rank 0 all of q and half of k. Its rule is ``Split("tp", 3)``:
each of the three parts split by heads, rows ``(s * H + h) * hd + d``
for this rank's heads h.

A sublayer is split only whole: where ``tp`` does not divide a dim its
rules split (``fit_spec`` warns and replicates, as JAX's ``_fit_spec``
does) or its head count, or where its matmuls are W8A8 (JAX's rules
match float ``kernel`` leaves only; the int8 ``weight_q`` and
``weight_scale`` replicate), the sublayer computes replicated on every
rank. Every tensor outside the sublayers replicates.
"""

from __future__ import annotations

import logging
import re
from dataclasses import dataclass

import torch
import torch.distributed as dist

from .collectives import rank as group_rank, size as group_size

logger = logging.getLogger(__name__)


@dataclass(frozen=True)
class Split:
    """A dim split over ``axis`` within each of ``groups`` equal parts."""
    axis: str
    groups: int = 1


def dit_param_rules(tp_axis: str | None = "tp",
                    fsdp_axis: str | None = "fsdp"):
    """(regex, spec) rules for the DiT's state_dict, JAX's
    (``topiaxl/parallel/sharding.py:21-46``) with torch's ``[out, in]``
    weights: column-parallel projections split their output rows over
    ``tp``, row-parallel ones their input columns; adaLN and the token
    embedding take ``fsdp`` on their largest dim; everything else
    replicates."""
    tp, fs = tp_axis, fsdp_axis
    qkv = Split(tp, 3) if tp else None
    return [
        (r"\.qkv\.weight$", (qkv, fs)),
        (r"\.qkv\.bias$", (qkv,)),
        (r"\.to_[qkv]\.weight$", (tp, fs)),
        (r"\.to_[qkv]\.bias$", (tp,)),
        (r"\.proj\.weight$", (fs, tp)),
        (r"\.proj\.bias$", ()),
        (r"\.fc1\.weight$", (tp, fs)),
        (r"\.fc1\.bias$", (tp,)),
        (r"\.fc2\.weight$", (fs, tp)),
        (r"\.fc2\.bias$", ()),
        (r"adaLN_modulation\.\d+\.weight$", (None, fs)),
        (r"x_embedder\.weight$", (fs, None)),
        (r".*", ()),
    ]


def spec_for(name: str, rules) -> tuple:
    for pat, spec in rules:
        if re.search(pat, name):
            return spec
    return ()


def _axis(entry):
    return entry.axis if isinstance(entry, Split) else entry


def fit_spec(spec, shape, mesh, name: str = "?") -> tuple:
    """``spec`` fitted to a tensor of ``shape`` on ``mesh``, one entry per
    dim: axes the mesh lacks (or of size 1) drop quietly, a deliberate
    degenerate config; an axis that does not divide its dim drops with a
    warning (a silently replicated rule would hide a wrong rule from
    every test)."""
    out = []
    for i in range(len(shape)):
        entry = spec[i] if i < len(spec) else None
        ax = _axis(entry)
        parts = mesh.shape.get(ax, 1) if ax is not None else 1
        groups = entry.groups if isinstance(entry, Split) else 1
        if parts <= 1:
            out.append(None)
        elif shape[i] % (groups * parts):
            logger.warning(
                "sharding rule for %s: dim %d (size %d) not divisible by "
                "mesh axes %s (size %d); replicating that dim",
                name, i, shape[i], (ax,), parts * groups)
            out.append(None)
        else:
            out.append(entry)
    return tuple(out)


@dataclass(frozen=True)
class Placement:
    """Where a tensor's ``tp`` split lies: its dim, and the equal parts
    (``groups``) within which the dim is split."""
    dim: int
    groups: int = 1

    def shard(self, t: torch.Tensor, parts: int, r: int) -> torch.Tensor:
        g = t.unflatten(self.dim, (self.groups, -1))
        n = g.shape[self.dim + 1] // parts
        return g.narrow(self.dim + 1, r * n, n).flatten(
            self.dim, self.dim + 1).clone()

    def whole(self, t: torch.Tensor, group) -> torch.Tensor:
        """This rank's part written into zeros of the whole, summed over
        the group: exact (x + 0 = x)."""
        parts, r = group_size(group), group_rank(group)
        shape = list(t.shape)
        shape[self.dim] *= parts
        out = t.new_zeros(shape)
        g = out.unflatten(self.dim, (self.groups, -1))
        n = g.shape[self.dim + 1] // parts
        g.narrow(self.dim + 1, r * n, n).copy_(
            t.unflatten(self.dim, (self.groups, -1)))
        dist.all_reduce(out, group=group)
        return out


class TensorParallel:
    """A model's tensor-parallel layout: the ``tp`` group, and the
    placement of each split tensor (by state_dict name; the others
    replicate). ``shard`` and ``gather`` map any dict keyed by the
    model's names (its state_dict, Adam moments, EMA) between whole and
    this rank's tensors."""

    def __init__(self, group, placements: dict):
        self.group = group
        self.parts, self.rank = group_size(group), group_rank(group)
        self.placements = placements

    def shard(self, sd: dict) -> dict:
        return {n: (self.placements[n].shard(t, self.parts, self.rank)
                    if n in self.placements else t) for n, t in sd.items()}

    def gather(self, sd: dict) -> dict:
        """Whole tensors (collective over the ``tp`` group)."""
        return {n: (self.placements[n].whole(t, self.group)
                    if n in self.placements else t) for n, t in sd.items()}


def _sublayers(model):
    from ..models.layers import CrossAttention, Mlp, SelfAttention

    return [(n, m) for n, m in model.named_modules()
            if isinstance(m, (SelfAttention, CrossAttention, Mlp))]


def tp_placements(model, mesh, rules, axis: str = "tp") -> dict:
    """{state_dict name: Placement} of the tensors ``rules`` split over
    ``axis`` on ``mesh``, sublayer by sublayer: a sublayer whose rules do
    not fit, whose heads do not divide or whose matmuls are W8A8 is left
    out whole (replicated), with a warning."""
    from ..ops.int8 import QuantDense

    parts = mesh.shape.get(axis, 1)
    if parts <= 1:
        return {}
    out: dict = {}
    for prefix, sub in _sublayers(model):
        mine: dict = {}
        why, unfit = [], False
        for leaf, t in sub.state_dict().items():
            name = f"{prefix}.{leaf}"
            spec = spec_for(name, rules)
            fitted = fit_spec(spec, t.shape, mesh, name)
            split = [i for i, e in enumerate(fitted) if _axis(e) == axis]
            if not split and any(_axis(e) == axis for e in spec[:t.dim()]):
                unfit = True
                why.append(f"{name}'s rule does not fit {tuple(t.shape)}")
            for i in split:
                mine[name] = Placement(i, getattr(fitted[i], "groups", 1))
        heads = getattr(sub, "num_heads", parts)
        if heads % parts:
            why.append(f"{heads} heads do not divide over {axis}={parts}")
        if any(isinstance(m, QuantDense) for m in sub.modules()):
            why.append("its matmuls are W8A8")
        if why and (mine or unfit):
            logger.warning("tensor parallelism: %s replicated (%s)", prefix,
                           "; ".join(why))
        if mine and not why:
            out.update(mine)
    return out


def shard_params(model, mesh, rules, axis: str = "tp"):
    """Turn ``model`` (whole, the same weights on every rank) into this
    rank's tensor-parallel part, in place: each split tensor sliced per
    ``rules``, each split sublayer given the ``axis`` group, and the
    layout kept as ``model.tp_layout`` (a ``TensorParallel``). Its
    ``shard`` maps a whole state_dict to this rank's. Build the optimizer
    state after this (its moments and EMA follow the local tensors).
    Collective (the group's first use); returns ``model``."""
    placements = tp_placements(model, mesh, rules, axis)
    group = mesh.group(axis)
    layout = TensorParallel(group, placements)
    if placements:
        split = {n.rsplit(".", 1)[0] for n in placements}
        for prefix, sub in _sublayers(model):
            if any(s.startswith(prefix + ".") for s in split):
                sub.tp_group, sub.tp_parts = group, layout.parts
        with torch.no_grad():
            for n, p in model.named_parameters():
                if n in placements:
                    p.data = placements[n].shard(p.data, layout.parts,
                                                 layout.rank)
    model.tp_layout = layout
    return model


def _layouts(model) -> list:
    return [lay for lay in (getattr(model, "tp_layout", None),
                            getattr(model, "pp_layout", None))
            if lay is not None]


def gather_params(model, sd: dict | None = None) -> dict:
    """The whole tensors of ``sd`` (default: the model's state_dict), a
    dict keyed by the model's names in its tensor-parallel and pipeline
    layouts (``shard_params``, ``pipeline.shard_pp_params``): what a
    checkpoint holds. Collective over ``tp`` and ``pp``; a model in
    neither layout gives ``sd`` back."""
    sd = model.state_dict() if sd is None else sd
    for layout in _layouts(model):
        sd = layout.gather(sd)
    return sd


def scatter_params(model, sd: dict) -> dict:
    """This rank's part of a whole dict (a checkpoint's parameters,
    moments or EMA) in the model's layouts: the inverse of
    ``gather_params``, with no communication."""
    for layout in reversed(_layouts(model)):
        sd = layout.shard(sd)
    return sd


def batch_sharding(mesh, axis="dp"):
    """``place(x)``: this rank's rows of a batch ``x`` split over ``axis``
    (a name or a tuple of names; replicated over the others), rows
    ``[i * B / n, (i + 1) * B / n)`` for its position i of n."""
    i, n = mesh.split((axis,) if isinstance(axis, str) else axis)

    def place(x: torch.Tensor) -> torch.Tensor:
        if x.shape[0] % n:
            raise ValueError(f"batch {x.shape[0]} does not split over "
                             f"{axis} ({n})")
        b = x.shape[0] // n
        return x[i * b:(i + 1) * b]

    return place


def sequence_sharding(mesh, batch_axis: str = "dp", seq_axis: str = "sp"):
    """``place(x)``: this rank's part of a [B, N, ...] activation sharded
    over ``batch_axis`` (rows) and ``seq_axis`` (tokens), the layout of
    context parallelism (``parallel/context.py``)."""
    rows = batch_sharding(mesh, batch_axis)
    s, ns = mesh.split((seq_axis,))

    def place(x: torch.Tensor) -> torch.Tensor:
        x = rows(x)
        if x.shape[1] % ns:
            raise ValueError(f"{x.shape[1]} tokens do not split over "
                             f"{seq_axis} ({ns})")
        n = x.shape[1] // ns
        return x[:, s * n:(s + 1) * n]

    return place
