"""Image -> PrimX -> textured GLB inference pipeline (counterpart of
``topiaxl/pipelines/infer.py``).

Stage 1: conditioning tokens -> DDIM (or DPM-Solver++, or ancestral)
chain with CFG over the DiT (cross-attention K/V projected once; on a
card the whole chain is one CUDA graph per key, replayed, as JAX jits
it: ``pipelines/chain_graph.py``) -> one batched VAE decode of all
primitives -> PrimX parameters.

Stage 2: noise filter, coarse-to-fine SDF grid on the device, then the
host stages (``topiaxl_torch.extract``, the port's copy of the JAX
package's: isosurface, cleanup, decimation, UV unwrap, rasterisation,
with their C++ parts in ``topiaxl_torch.native``), the texel bake on the
device, EDT inpaint and the GLB writer.

``serve_assets`` runs the two stages over many assets as a pipeline;
``generate_primx_sharded`` splits stage 1's asset batch over ranks.
"""

from __future__ import annotations

import logging
import os
import threading
import time

import numpy as np
import torch
import torch.nn.functional as F

from ..core.profiling import span
from ..diffusion import gaussian
from ..diffusion.schedule import Diffusion
from ..models import primx as primx_lib
from ..models.dit import DiT
from ..models.primx import PrimXParams
from ..models.vae3d import VAE3D
from . import chain_graph

log = logging.getLogger("topiaxl_torch.extract")


class EmptyIsosurfaceError(RuntimeError):
    """The SDF grid has no zero crossing: nothing to export."""


# ---------------------------------------------------------------------------
# Stage 1: denoise + decode
# ---------------------------------------------------------------------------

def _chain_inputs(dit: DiT, y: torch.Tensor, noise, generator, sampler):
    """The checked sampler and the initial noise, drawn from ``generator``
    when not given."""
    if sampler not in gaussian.SAMPLERS:
        raise ValueError(
            f"sampler={sampler!r}: expected one of {sorted(gaussian.SAMPLERS)}")
    if noise is None:
        noise = torch.randn((y.shape[0], dit.seq_length, dit.in_channels),
                            generator=generator, device=y.device,
                            dtype=torch.float32)
    return noise


@torch.inference_mode()
def sample_tokens(dit: DiT, diffusion: Diffusion, y: torch.Tensor,
                  cfg_scale: float = 6.0, noise: torch.Tensor | None = None,
                  generator: torch.Generator | None = None,
                  sampler: str = "ddim"):
    """The sampling chain: ``sampler`` 'ddim' (eta 0), 'dpm'
    (DPM-Solver++(2M)) or 'ancestral'; returns normalised tokens [B, N,
    C_in] (and the last x0 prediction). ``noise`` [B, N, C_in] is drawn
    from ``generator`` when not given; the ancestral chain draws its
    per-step noise from it too (on a card, a CUDA generator or None, the
    default one).

    On a CUDA card the chain, its K/V projection and null outputs
    included, replays one captured CUDA graph per key, as JAX runs its
    jitted ``sample_tokens`` (``chain_graph.sample``; the first call of a
    key runs eagerly and captures). On the CPU, and for a tensor-parallel
    or ring-attention DiT, it runs eagerly (``_sample_tokens_eager``)."""
    with span("sample_tokens"):
        if y.device.type == "cuda" and chain_graph.capturable(dit):
            noise = _chain_inputs(dit, y, noise, generator, sampler)
            return chain_graph.sample(dit, diffusion, y, noise, cfg_scale,
                                      sampler, generator)
        return _sample_tokens_eager(dit, diffusion, y, cfg_scale, noise,
                                    generator, sampler)


@torch.inference_mode()
def _sample_tokens_eager(dit: DiT, diffusion: Diffusion, y: torch.Tensor,
                         cfg_scale: float = 6.0,
                         noise: torch.Tensor | None = None,
                         generator: torch.Generator | None = None,
                         sampler: str = "ddim"):
    """``sample_tokens`` dispatched op by op on any device: what the graph
    captures, and what the checks hold it against."""
    noise = _chain_inputs(dit, y, noise, generator, sampler)
    return chain_graph.sample_chain(dit, diffusion, y, noise, cfg_scale,
                                    sampler, generator)


def denormalize_tokens(tokens, latent_mean, latent_std, latent_nf: float = 1.0):
    """Invert the per-channel token normalisation."""
    return tokens / latent_nf * latent_std[None, None, :] + latent_mean[None, None, :]


@torch.inference_mode()
def decode_primx(vae: VAE3D, recon_tokens: torch.Tensor, prim_shape: int = 8,
                 dim_feat: int = 6):
    """De-normalised tokens [B, N, 4 + L] -> (srt [B, N, 4], feat
    [B, N, C * S^3]): one VAE decode of every primitive of the batch, then
    the payload normalisation inverted (sdf / 5, rest (x + 1) / 2)."""
    with span("decode_primx"):
        B, N, _ = recon_tokens.shape
        srt = recon_tokens[..., 0:4]
        lat = recon_tokens[..., 4:]
        ls = round(lat.shape[-1] ** (1.0 / 3.0))
        # [BN, C, S, S, S]
        payload = vae.decode(lat.reshape(B * N, 1, ls, ls, ls))
        payload = torch.cat([payload[:, 0:1] / 5.0,
                             (payload[:, 1:] + 1.0) / 2.0], dim=1)
        return srt, payload.reshape(B, N, dim_feat * prim_shape**3)


def generate_primx(dit: DiT, vae: VAE3D, diffusion: Diffusion,
                   y: torch.Tensor, latent_mean, latent_std,
                   latent_nf: float = 1.0, cfg_scale: float = 6.0,
                   prim_shape: int = 8, dim_feat: int = 6,
                   noise: torch.Tensor | None = None,
                   generator: torch.Generator | None = None,
                   sampler: str = "ddim"):
    """Conditioning tokens [B, M, C] -> PrimXParams (a list when B > 1)."""
    with span("generate_primx"):
        out = sample_tokens(dit, diffusion, y, cfg_scale, noise, generator,
                            sampler)
        dev = out.sample.device
        recon = denormalize_tokens(
            out.sample, torch.as_tensor(latent_mean, device=dev),
            torch.as_tensor(latent_std, device=dev), latent_nf)
        srt, feat = decode_primx(vae, recon, prim_shape, dim_feat)
        params = [PrimXParams(srt[b], feat[b]) for b in range(y.shape[0])]
        return params[0] if len(params) == 1 else params


def generate_primx_sharded(dit: DiT, vae: VAE3D, diffusion: Diffusion,
                           y: torch.Tensor, latent_mean, latent_std, mesh,
                           latent_nf: float = 1.0, cfg_scale: float = 6.0,
                           prim_shape: int = 8, dim_feat: int = 6,
                           noise: torch.Tensor | None = None,
                           generator: torch.Generator | None = None,
                           param_rules=None):
    """``generate_primx`` with the asset batch split over the mesh's
    ``dp`` axis (its first other axis where it has none): every rank passes the
    whole batch y [B, M, C], the same models, and the initial noise for
    the whole batch ([B, N, C_in]) or a generator in the same state to
    draw it from, as ``generate_primx`` draws it; each rank denoises and
    decodes its B / dp assets on their rows of that noise. The results
    are gathered over ``dp``, so every rank returns what
    ``generate_primx`` returns for the batch. ``param_rules`` (e.g.
    ``parallel.dit_param_rules()``) serves a tensor-parallel copy of the
    DiT over the mesh's ``tp`` axis (``parallel/sharding.py:shard_params``:
    each rank holds its heads and MLP units, one all-reduce a sublayer);
    every ``tp`` rank of a ``dp`` slice denoises the same assets."""
    import copy

    from ..parallel.collectives import gather
    from ..parallel.sharding import batch_sharding, shard_params

    if param_rules is not None:
        dit = shard_params(copy.deepcopy(dit), mesh, param_rules)
    # the assets split over dp, else the first axis (not tp's, whose ranks
    # share their assets)
    axes = [a for a in mesh.axis_names if param_rules is None or a != "tp"]
    axis = "dp" if "dp" in mesh.shape or not axes else axes[0]
    if noise is None:
        noise = torch.randn((y.shape[0], dit.seq_length, dit.in_channels),
                            generator=generator, device=y.device,
                            dtype=torch.float32)
    place = batch_sharding(mesh, axis)
    out = generate_primx(dit, vae, diffusion, place(y), latent_mean,
                         latent_std, latent_nf, cfg_scale, prim_shape,
                         dim_feat, noise=place(noise))
    out = out if isinstance(out, list) else [out]
    B = y.shape[0]
    group = mesh.group(axis)
    srt = gather(torch.stack([p.srt for p in out]), group)
    feat = gather(torch.stack([p.feat for p in out]), group)
    params = [PrimXParams(srt[b], feat[b]) for b in range(B)]
    return params[0] if B == 1 else params


def save_primx(path: str, params: PrimXParams) -> None:
    """Persist stage-1 output (same keys as the JAX package's save_primx)."""
    np.savez(path, srt=params.srt.float().cpu().numpy(),
             feat=params.feat.float().cpu().numpy())


def load_primx(path: str, device="cuda") -> PrimXParams:
    """Read what either package's ``save_primx`` wrote, onto ``device``."""
    z = np.load(path)
    return PrimXParams(torch.from_numpy(z["srt"]).to(device),
                       torch.from_numpy(z["feat"]).to(device))


# ---------------------------------------------------------------------------
# Stage 2: extraction
# ---------------------------------------------------------------------------

@torch.inference_mode()
def noise_filter(params: PrimXParams) -> PrimXParams:
    """Prims whose nearest neighbour lies beyond the pair's combined scales
    are moved far away with ~zero scale (shapes stay static)."""
    pos = params.srt[:, 1:4]
    scale = params.srt[:, 0]
    n = pos.shape[0]
    d2 = ((pos[:, None, :] - pos[None, :, :]) ** 2).sum(-1)
    d = torch.sqrt(d2) + torch.eye(n, device=pos.device)
    min_dist, nn_idx = d.min(dim=1)
    keep = min_dist < scale + scale[nn_idx]
    far = torch.tensor([1e-6, 1e6, 1e6, 1e6], device=pos.device)
    srt = torch.where(keep[:, None], params.srt, far)
    return PrimXParams(srt, params.feat)


def _lattice(idx: torch.Tensor, res: int) -> torch.Tensor:
    """Flat (i, j, k) ids on a res^3 lattice over [-1, 1] -> points [P, 3]
    (the coordinates of ``np.linspace(-1, 1, res)``)."""
    lin = torch.from_numpy(np.linspace(-1.0, 1.0, res, dtype=np.float32))
    ijk = torch.stack([idx // (res * res), (idx // res) % res, idx % res], -1)
    return lin.to(idx.device)[ijk]


@torch.inference_mode()
def sdf_grid(params: PrimXParams, resolution: int = 256, chunk: int = 32768,
             prim_shape: int = 8, dim_feat: int = 6, top_k: int = 16,
             coarse: int = 64, band_sigma: float = 2.0,
             timings: dict | None = None) -> np.ndarray:
    """SDF on a resolution^3 lattice over [-1, 1], coarse-to-fine: a
    ``coarse`` lattice everywhere (with the uncovered-point fallback),
    trilinear upsample, then exact re-evaluation of the fine points whose
    coarse neighbourhood comes within ``band_sigma`` coarse cells of zero,
    the band widened by the field's local Lipschitz bound measured on the
    coarse lattice (see the JAX package's sdf_grid). Band values are
    exact f32."""
    dev = params.srt.device
    res = resolution
    kw = dict(chunk=chunk, dim_feat=dim_feat, prim_shape=prim_shape,
              top_k=top_k, outputs=("sdf",))
    t0 = time.perf_counter()

    def phase(name):
        nonlocal t0
        if timings is not None:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            timings[name] = round(time.perf_counter() - t0, 3)
        t0 = time.perf_counter()

    if coarse >= res:
        pts = _lattice(torch.arange(res**3, device=dev), res)
        sdf = primx_lib.query_chunked(params, pts, **kw)["sdf"]
        return sdf.reshape(res, res, res).cpu().numpy()

    pts_c = _lattice(torch.arange(coarse**3, device=dev), coarse)
    grid_c = primx_lib.query_chunked(params, pts_c, **kw)["sdf"].reshape(
        coarse, coarse, coarse)
    phase("coarse_query")
    grid = F.interpolate(grid_c[None, None], size=(res,) * 3,
                         mode="trilinear", align_corners=True)[0, 0]
    phase("upsample")

    # local Lipschitz bound in cell units: max |forward difference| per
    # coarse point, max-pooled over the 3^3 neighbourhood, floored at 1
    cell_c = 2.0 / (coarse - 1)
    lip = torch.zeros_like(grid_c)
    for ax in range(3):
        d = grid_c.diff(dim=ax).abs() / cell_c
        lo = [slice(None)] * 3
        hi = [slice(None)] * 3
        lo[ax] = slice(0, -1)
        hi[ax] = slice(1, None)
        lip[tuple(lo)] = torch.maximum(lip[tuple(lo)], d)
        lip[tuple(hi)] = torch.maximum(lip[tuple(hi)], d)
    lip = F.max_pool3d(lip[None, None], 3, 1, 1)[0, 0].clamp_min(1.0)
    min_abs = -F.max_pool3d(-grid_c.abs()[None, None], 3, 1, 1)[0, 0]
    band = min_abs < band_sigma * cell_c * lip

    # coarse lattice point owning each fine point: blocks of f when res is
    # a multiple of coarse, nearest otherwise
    if res % coarse == 0:
        cidx = torch.arange(res, device=dev) // (res // coarse)
    else:
        cidx = torch.round(torch.linspace(0, coarse - 1, res, device=dev)).long()
    band_f = band[cidx][:, cidx][:, :, cidx]
    idx = torch.nonzero(band_f.reshape(-1))[:, 0]
    if timings is not None:
        timings["band_points"] = int(idx.numel())
    phase("band_select")
    if idx.numel():
        sdf = primx_lib.query_chunked(params, _lattice(idx, res), **kw)["sdf"]
        grid.view(-1)[idx] = sdf[:, 0]
    phase("refine_query")
    return grid.cpu().numpy()


@torch.inference_mode()
def bake_query_u8(params: PrimXParams, pts: torch.Tensor, dim_feat: int = 6,
                  prim_shape: int = 8, top_k: int = 24) -> torch.Tensor:
    """Texel PBR query -> uint8 [P, 5] = (RGB | rough, metal), exact top-k
    24 and no fallback (texels lie on the surface, always covered)."""
    out = primx_lib.query(params, pts, dim_feat=dim_feat,
                          prim_shape=prim_shape, top_k=top_k,
                          with_fallback=False, outputs=("tex", "mat"))
    v = torch.cat([out["tex"], out["mat"]], dim=-1)
    return torch.round(v.clamp(0.0, 1.0) * 255.0).to(torch.uint8)


@torch.inference_mode()
def extract_glb(params: PrimXParams, output_dir: str, mc_resolution: int = 256,
                decimate: int = 100000, texture_size: int = 1024,
                batch_size: int = 8192, prim_shape: int = 8, dim_feat: int = 6,
                fast_unwrap: bool = True, remesh: bool = False,
                inpaint_pad: int = 32, pos_scale: float = 0.85, ssaa: int = 1,
                timings_out: dict | None = None) -> str:
    """PrimX -> ``pbr_mesh.glb`` (+ ``texture.jpg`` and
    ``roughness_metallic.jpg``) in ``output_dir``; returns the GLB path.
    The bake is inpainted ``inpaint_pad`` texels beyond the charts. Raises
    EmptyIsosurfaceError when the field has no surface."""
    import cv2

    from topiaxl_torch.extract import (
        box_projection_uv_unwrap,
        clean_mesh,
        compute_vertex_normal,
        decimate_mesh,
        extract_isosurface,
        nearest_inpaint,
        quality_uv_unwrap,
        rasterize_uv_atlas,
        write_glb,
    )

    dev = params.srt.device
    t_last = time.perf_counter()

    def tick(stage):
        nonlocal t_last
        now = time.perf_counter()
        log.info("%s: %.2fs", stage, now - t_last)
        if timings_out is not None:
            key = stage.split(" ")[0]
            timings_out[key] = round(timings_out.get(key, 0.0) + now - t_last, 3)
        t_last = now

    os.makedirs(output_dir, exist_ok=True)
    srt = params.srt.clone()
    srt[:, 1:4] *= pos_scale
    params = noise_filter(PrimXParams(srt, params.feat))

    sdf_tm: dict = {}
    grid = sdf_grid(params, mc_resolution, chunk=max(batch_size, 32768),
                    prim_shape=prim_shape, dim_feat=dim_feat, timings=sdf_tm)
    if timings_out is not None:
        timings_out["sdf_grid_phases"] = sdf_tm
    tick("sdf_grid")
    verts, faces = extract_isosurface(grid)
    tick(f"isosurface ({len(faces)} faces)")
    if len(faces) == 0:
        raise EmptyIsosurfaceError("empty isosurface: nothing to export")
    verts, faces = clean_mesh(verts, faces, min_f=8, min_d=5)
    tick("clean_mesh")
    if decimate > 0 and len(faces) > decimate:
        verts, faces = decimate_mesh(verts, faces, decimate, remesh=remesh)
    tick(f"decimate ({len(faces)} faces)")

    vn = compute_vertex_normal(verts, faces)
    rs = texture_size * max(int(ssaa), 1)
    pad_uv = max(5.0 / texture_size, 0.004)
    unwrap = box_projection_uv_unwrap if fast_unwrap else quality_uv_unwrap
    uv, uv_idx = unwrap(verts, vn, faces, pad_uv)
    tick("uv_unwrap")
    xyz_map, mask = rasterize_uv_atlas(uv[uv_idx], verts[faces], rs, rs)
    tick("rasterize")

    tex_idx = np.nonzero(mask.reshape(-1))[0]
    pts = torch.from_numpy(
        np.ascontiguousarray(xyz_map.reshape(-1, 3)[tex_idx], np.float32)).to(dev)
    if timings_out is not None:
        timings_out["bake_texels"] = int(len(tex_idx))
    texmat = torch.cat([
        bake_query_u8(params, pts[i:i + batch_size], dim_feat=dim_feat,
                      prim_shape=prim_shape)
        for i in range(0, pts.shape[0], batch_size)]).cpu().numpy()
    full = np.zeros((rs * rs, 5), np.float32)
    full[tex_idx] = texmat.astype(np.float32) / 255.0
    tex = full[:, 0:3].reshape(rs, rs, 3)
    mat = full[:, 3:5].reshape(rs, rs, 2)
    # [H, W, 6] = R G B 0 rough metal (the reference's layout)
    feats = np.concatenate([tex, np.zeros_like(tex[..., :1]), mat], axis=-1)
    feats[~mask] = 0.0
    tick("bake_queries")
    feats = nearest_inpaint(feats, mask, pad_width=inpaint_pad)
    tick("inpaint")
    if rs != texture_size:
        feats = cv2.resize(feats, (texture_size, texture_size),
                           interpolation=cv2.INTER_AREA)
    albedo, mr = feats[..., 0:3], feats[..., 3:6]

    def write_jpgs():
        cv2.imwrite(os.path.join(output_dir, "texture.jpg"),
                    (albedo[..., ::-1] * 255).clip(0, 255).astype(np.uint8))
        cv2.imwrite(os.path.join(output_dir, "roughness_metallic.jpg"),
                    (mr[..., ::-1] * 255).clip(0, 255).astype(np.uint8))

    jpg_thread = threading.Thread(target=write_jpgs)
    jpg_thread.start()
    glb_path = os.path.join(output_dir, "pbr_mesh.glb")
    try:
        write_glb(glb_path, verts, faces, uv, uv_idx, albedo, mr, vn=vn)
    finally:
        jpg_thread.join()
    tick("write_glb")
    return glb_path


# ---------------------------------------------------------------------------
# Multi-asset serving
# ---------------------------------------------------------------------------

def serve_assets(dit: DiT, vae: VAE3D, diffusion: Diffusion, ys, output_dirs,
                 latent_mean, latent_std, latent_nf: float = 1.0,
                 cfg_scale: float = 6.0, prim_shape: int = 8,
                 dim_feat: int = 6, sampler: str = "ddim",
                 stage1_batch: int = 1, extract_workers: int = 2,
                 generator: torch.Generator | None = None,
                 **extract_kw) -> list:
    """Serve many assets as a two-stage pipeline: stage 1 (chain and
    decode) of the next group runs on this thread while ``extract_workers``
    host threads run ``extract_glb`` on the assets before it; returns the
    GLB paths in input order (a worker's exception is raised here).

    ``ys`` are conditioning tokens [1, M, C], one per entry of
    ``output_dirs``. ``stage1_batch`` assets share one chain at that batch
    (each with its own noise); each group's noise is drawn from
    ``generator`` in group order, so a serial loop of ``generate_primx``
    calls on the same generator state makes the same assets.
    ``extract_kw`` goes to ``extract_glb``.

    The workers enqueue their device work on the same default stream as
    the chain, which orders it; what overlaps is the host's share of
    stage 2 (isosurface, cleanup, decimation, unwrap, inpaint, GLB
    writing, in numpy, cv2 and C++ that release the GIL) with the chain.
    On a card each chain replays the graph its key captured at its first
    group (``sample_tokens``), so this thread holds the interpreter for a
    replay, not for the chain's launches; a group of another size (the
    last) captures its own, in ``thread_local`` mode beside the workers.
    """
    from concurrent.futures import ThreadPoolExecutor

    ys, output_dirs = list(ys), list(output_dirs)
    if len(ys) != len(output_dirs):
        raise ValueError(f"{len(ys)} conditionings for {len(output_dirs)} "
                         f"output directories")
    b = max(1, int(stage1_batch))
    with ThreadPoolExecutor(max_workers=max(1, extract_workers)) as pool:
        futures = []
        for start in range(0, len(ys), b):
            group = ys[start:start + b]
            params = generate_primx(
                dit, vae, diffusion, torch.cat(group, dim=0), latent_mean,
                latent_std, latent_nf, cfg_scale, prim_shape, dim_feat,
                generator=generator, sampler=sampler)
            if len(group) == 1:
                params = [params]
            for j, p in enumerate(params):
                futures.append(pool.submit(
                    extract_glb, p, output_dirs[start + j],
                    prim_shape=prim_shape, dim_feat=dim_feat, **extract_kw))
        return [f.result() for f in futures]
