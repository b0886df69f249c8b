"""Training losses (counterpart of ``topiaxl/pipelines/losses.py``).

PrimX fitting (a staged shape -> texture schedule with a primitive-volume
regulariser), VAE reconstruction (L1 / per-channel-group L1 or L2 /
FFT-domain) with KL, and a metrics flattener (reference
dva/losses.py:17-239). Each loss returns (total, loss_dict).

Payload tensors are NCDHW here, so the channel groups [0] = SDF, [1:4] =
RGB, [4:6] = roughness/metallic are slices of axis 1, where the JAX
package slices its channels-last last axis. The FFT loss flattens in the
JAX package's channels-last order, which defines its sequence.
"""

from __future__ import annotations

from typing import Mapping

import torch


def _gate(cond):
    """A stage gate as a multiplier: 1.0 or 0.0 (a float tensor when the
    iteration is a tensor)."""
    return cond.float() if isinstance(cond, torch.Tensor) else float(cond)


def vae_loss(gt, recon, posterior, weights: Mapping, kind: str = "l1"):
    """VAELoss / VAESepLoss / VAESepL2Loss / DCTLoss (dva/losses.py:17-100).

    gt / recon: [B, C, ...] payloads, channel groups on axis 1."""
    loss_dict = {}
    kl = posterior.kl().mean()
    loss_dict["loss_kl"] = kl

    if kind == "l1":
        rec = (gt - recon).abs().mean()
        loss_dict["loss_recon_l1"] = rec
        total = weights["recon"] * rec + weights["kl"] * kl
    elif kind in ("sep_l1", "sep_l2"):
        diff = (gt - recon).abs() if kind == "sep_l1" else (gt - recon) ** 2
        sdf = diff[:, 0:1].mean()
        rgb = diff[:, 1:4].mean()
        mat = diff[:, 4:6].mean()
        loss_dict.update(loss_sdf_l1=sdf, loss_rgb_l1=rgb, loss_mat_l1=mat)
        total = (weights["sdf"] * sdf + weights["rgb"] * rgb
                 + weights["mat"] * mat)
        if "kl" in weights:
            total = total + weights["kl"] * kl
    elif kind == "dct":
        # the sequence is the channels-last flattening, as in the JAX package
        B = gt.shape[0]
        fg = torch.fft.fft(torch.movedim(gt, 1, -1).reshape(B, -1))
        fr = torch.fft.fft(torch.movedim(recon, 1, -1).reshape(B, -1))
        rec = ((fg.real - fr.real).abs().mean()
               + (fg.imag - fr.imag).abs().mean()) / 2.0
        loss_dict["loss_recon_dct_l1"] = rec
        loss_dict["loss_recon_l1"] = (gt - recon).abs().mean()
        total = weights["recon"] * rec + weights["kl"] * kl
    else:
        raise ValueError(kind)

    loss_dict["loss_total"] = total
    return total, loss_dict


def primsdf_fit_loss(inputs: Mapping, preds: Mapping, weights: Mapping,
                     iteration, shape_opt_steps: int = 2000,
                     tex_opt_steps: int = 6000):
    """Staged PrimX fitting loss (dva/losses.py:102-148): SDF L1 (+ the
    prim volume regulariser) while ``iteration < shape_opt_steps``, then
    tex/mat L1 until ``tex_opt_steps``. The stages gate by multiplication,
    as in the JAX package, so every term is computed at every step."""
    it = iteration
    in_shape = _gate(it < shape_opt_steps)
    in_tex = _gate((it >= shape_opt_steps) & (it < tex_opt_steps))

    loss_dict = {}
    loss_sdf = (preds["sdf"] - inputs["sdf"]).abs().mean()
    loss_dict["loss_sdf_l1"] = loss_sdf
    total = in_shape * weights["sdf_l1"] * loss_sdf

    if "vol_sum" in weights:
        # prim_scale is 1/scale (normalised cube convention,
        # dva/losses.py:122-124)
        vol = (1.0 / preds["prim_scale"]).prod(dim=-1).sum(dim=-1).mean()
        loss_dict["loss_prim_vol_sum"] = vol
        total = total + in_shape * weights["vol_sum"] * vol

    loss_tex = (preds["tex"] - inputs["tex"]).abs().mean()
    loss_dict["loss_tex_l1"] = loss_tex
    total = total + in_tex * weights["rgb_l1"] * loss_tex
    if "mat_l1" in weights and "mat" in preds:
        loss_mat = (preds["mat"] - inputs["mat"]).abs().mean()
        loss_dict["loss_mat_l1"] = loss_mat
        total = total + in_tex * weights["mat_l1"] * loss_mat

    if "grad_l2" in weights and "grad" in preds:
        g = ((preds["grad"] - inputs["grad"]) ** 2).mean()
        loss_dict["loss_grad_l2"] = g
        total = total + weights["grad_l2"] * g

    loss_dict["loss_total"] = total
    return total, loss_dict


def process_losses(loss_dict: Mapping, reduce: bool = True) -> dict:
    """Metric flattener (dva/losses.py:230-239)."""
    out = {}
    for k, v in loss_dict.items():
        v = torch.as_tensor(v)
        out[k] = v.float().mean() if reduce else v
    return out
