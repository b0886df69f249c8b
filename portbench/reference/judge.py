"""The numbers the checks compare, each a gap between what the program
produced and what the reference computes from the same inputs."""

from __future__ import annotations

import math

import torch


def rel_rms(got: torch.Tensor, ref: torch.Tensor) -> float:
    """||got - ref|| / ||ref|| over every element."""
    got, ref = got.double().to(ref.device), ref.double()
    return float((got - ref).norm() / ref.norm().clamp_min(1e-30))


def row_gap(got: torch.Tensor, ref: torch.Tensor) -> float:
    """The worst row of [rows, C]: ||got_row - ref_row|| over the RMS of
    the reference's row norms. One wrong row reads its own size here,
    where the gap over every element divides it by the square root of the
    rows."""
    got, ref = got.double().to(ref.device), ref.double()
    rms = ref.square().sum(1).mean().sqrt().clamp_min(1e-30)
    return float((got - ref).norm(dim=1).max() / rms)


def mean_gap(got: list, ref: list) -> float:
    """The gap of the mean over every row of every pair [rows, C], over
    the RMS of the reference's values: rounding that varies from row to
    row averages out of it; an error the rows share does not."""
    g = torch.cat([t.double().to(r.device) for t, r in zip(got, ref)])
    r = torch.cat([t.double() for t in ref])
    return float((g - r).mean(0).norm() / math.sqrt(r.shape[1])
                 / r.square().mean().sqrt().clamp_min(1e-30))


def rel_gap(got: float, ref: float) -> float:
    return abs(got - ref) / max(abs(ref), 1e-30)


def leaf_gaps(got: dict, ref: dict, keep=None,
              gaps: dict | None = None) -> tuple[float, str, float]:
    """(worst gap, its leaf, the median leaf's gap) between two per-leaf
    norms: |got - ref| over the reference's norm of that leaf or of the
    median leaf, whichever is larger; only the leaves in ``keep`` when
    given. ``gaps`` ({leaf: ||got - ref||}) takes the place of |got - ref|
    where given: the norm of the difference."""
    names = [k for k in ref if keep is None or k in keep]
    med = sorted(ref[k] for k in names)[len(names) // 2]
    each = {}
    for k in names:
        num = gaps[k] if gaps is not None else abs(got[k] - ref[k])
        g = num / max(ref[k], med, 1e-30)
        each[k] = g if math.isfinite(g) else math.inf
    at = max(each, key=each.get)
    return each[at], at, sorted(each.values())[len(each) // 2]


def diff_norms(got: dict, ref: dict) -> dict:
    """{leaf: ||got - ref||}, each leaf of ``got`` moved to ``ref``'s."""
    return {k: float((got[k].to(r.device).double() - r.double()).norm())
            for k, r in ref.items()}


def norms(tensors: dict, device=None) -> dict:
    """{leaf: ||tensor||}, each moved to ``device`` when given."""
    return {k: float(v.to(device or v.device).double().norm())
            for k, v in tensors.items()}
