"""UV-space and 3D geometry utilities (counterpart of
``topiaxl/render/geom.py``): face and vertex normals, TBN frames,
axis-angle <-> rotation matrix, rotation interpolation, UV barycentric
index images (+ inpaint), values_to_uv / sample_uv and multi-camera
point projection. Off the serving path; dense tensor ops throughout.
"""

from __future__ import annotations

import numpy as np
import torch


def _unit(x: torch.Tensor, eps: float) -> torch.Tensor:
    return x / torch.linalg.norm(x, dim=-1, keepdim=True).clamp_min(eps)


def _corners(v: torch.Tensor, vi: torch.Tensor):
    return (v[..., vi[:, 0], :], v[..., vi[:, 1], :], v[..., vi[:, 2], :])


# ---------------------------------------------------------------------------
# normals / frames
# ---------------------------------------------------------------------------

def face_normals(v: torch.Tensor, vi: torch.Tensor, eps: float = 1e-5):
    """[B, V, 3], [F, 3] -> [B, F, 3] unit face normals."""
    p0, p1, p2 = _corners(v, vi)
    return _unit(torch.cross(p1 - p0, p2 - p0, dim=-1), eps)


def vert_normals(v: torch.Tensor, vi: torch.Tensor, eps: float = 1e-5):
    """Area-weighted vertex normals; v [B, V, 3] or [V, 3]."""
    squeeze = v.dim() == 2
    if squeeze:
        v = v[None]
    p0, p1, p2 = _corners(v, vi)
    fn = torch.cross(p1 - p0, p2 - p0, dim=-1)                # [B, F, 3]
    vn = torch.zeros_like(v)
    for c in range(3):
        vn.index_add_(1, vi[:, c], fn)
    vn = _unit(vn, eps)
    return vn[0] if squeeze else vn


def compute_view_cos(verts, faces, camera_pos):
    """Cosine between each face's normal and its direction to the camera."""
    fn = face_normals(verts[None] if verts.dim() == 2 else verts, faces)
    center = torch.stack(_corners(verts, faces)).mean(dim=0)
    d = _unit(camera_pos - center, 1e-9)
    return (fn * d).sum(dim=-1)


def compute_tbn(geom, vt, vi, vti):
    """Per-face tangent, bitangent and normal from positions and UVs;
    geom [B, V, 3] or [V, 3]."""
    squeeze = geom.dim() == 2
    if squeeze:
        geom = geom[None]
    p0, p1, p2 = _corners(geom, vi)
    t0, t1, t2 = vt[vti[:, 0]], vt[vti[:, 1]], vt[vti[:, 2]]
    e1, e2 = p1 - p0, p2 - p0
    u1, u2 = (t1 - t0)[None], (t2 - t0)[None]
    det = u1[..., 0] * u2[..., 1] - u1[..., 1] * u2[..., 0]
    det = torch.where(det.abs() < 1e-12, 1e-12, det)
    inv = 1.0 / det
    tangent = (e1 * u2[..., 1:2] - e2 * u1[..., 1:2]) * inv[..., None]
    bitangent = (e2 * u1[..., 0:1] - e1 * u2[..., 0:1]) * inv[..., None]
    normal = torch.cross(e1, e2, dim=-1)
    tangent, normal = _unit(tangent, 1e-9), _unit(normal, 1e-9)
    # orthogonalise b against t and n, keeping its handedness
    nxt = torch.cross(normal, tangent, dim=-1)
    bitangent = _unit(nxt, 1e-9) * torch.sign(
        (bitangent * nxt).sum(dim=-1))[..., None]
    if squeeze:
        return tangent[0], bitangent[0], normal[0]
    return tangent, bitangent, normal


# ---------------------------------------------------------------------------
# rotations
# ---------------------------------------------------------------------------

def axisangle_to_matrix(rvec: torch.Tensor) -> torch.Tensor:
    """Rodrigues: [..., 3] -> [..., 3, 3]."""
    theta = torch.linalg.norm(rvec, dim=-1, keepdim=True)
    axis = rvec / theta.clamp_min(1e-12)
    x, y, z = axis[..., 0], axis[..., 1], axis[..., 2]
    zero = torch.zeros_like(x)
    K = torch.stack([torch.stack([zero, -z, y], -1),
                     torch.stack([z, zero, -x], -1),
                     torch.stack([-y, x, zero], -1)], -2)
    t = theta[..., None]
    eye = torch.eye(3, dtype=rvec.dtype, device=rvec.device).expand(K.shape)
    return eye + torch.sin(t) * K + (1.0 - torch.cos(t)) * (K @ K)


def matrix_to_axisangle(r: torch.Tensor):
    """[..., 3, 3] -> (axis [..., 3], angle [..., 1])."""
    trace = r[..., 0, 0] + r[..., 1, 1] + r[..., 2, 2]
    theta = torch.arccos(((trace - 1.0) / 2.0).clamp(-1.0, 1.0))[..., None]
    vec = 0.5 * torch.stack([r[..., 2, 1] - r[..., 1, 2],
                             r[..., 0, 2] - r[..., 2, 0],
                             r[..., 1, 0] - r[..., 0, 1]], -1)
    return vec / torch.sin(theta).clamp_min(1e-9), theta


def rotation_interp(r0: torch.Tensor, r1: torch.Tensor, alpha: float):
    """Geodesic interpolation from r0 (alpha 0) to r1 (alpha 1)."""
    axis, theta = matrix_to_axisangle(r1 @ r0.transpose(-1, -2))
    return axisangle_to_matrix(axis * theta * alpha) @ r0


# ---------------------------------------------------------------------------
# UV-space machinery
# ---------------------------------------------------------------------------

def make_uv_barys(vt: np.ndarray, vti: np.ndarray, size: int):
    """Rasterise the UV atlas into per-texel face index [H, W] int32 (-1
    where empty) and barycentrics [H, W, 3] (numpy, host)."""
    from ..extract.rasterize import rasterize_uv_atlas

    F = len(vti)
    uvc = np.asarray(vt, np.float32)[np.asarray(vti, np.int64)]
    # attributes (face id, bary0, bary1); bary2 = 1 - b0 - b1
    attr = np.zeros((F, 3, 3), np.float32)
    attr[:, :, 0] = np.arange(F, dtype=np.float32)[:, None]
    attr[:, 0, 1] = 1.0
    attr[:, 1, 2] = 1.0
    out, mask = rasterize_uv_atlas(uvc, attr, size, size)
    index_img = np.where(mask, np.round(out[..., 0]).astype(np.int32), -1)
    b0, b1 = out[..., 1], out[..., 2]
    bary = np.stack([b0, b1, 1.0 - b0 - b1], -1).astype(np.float32)
    bary[~mask] = 0.0
    return index_img, bary


def index_image_impaint(index_img: np.ndarray, bary_img=None,
                        distance_threshold: int = 100):
    """Fill empty texels within ``distance_threshold`` with their nearest
    covered texel's index (and barycentrics), by an exact EDT."""
    from scipy import ndimage

    mask = index_img >= 0
    dist, (iy, ix) = ndimage.distance_transform_edt(~mask,
                                                    return_indices=True)
    take = (~mask) & (dist <= distance_threshold)
    out = index_img.copy()
    out[take] = index_img[iy[take], ix[take]]
    if bary_img is None:
        return out
    bout = bary_img.copy()
    bout[take] = bary_img[iy[take], ix[take]]
    return out, bout


def values_to_uv(values: torch.Tensor, index_img, bary_img,
                 faces: torch.Tensor) -> torch.Tensor:
    """Splat per-vertex values [V, C] into UV space [H, W, C] through the
    barycentric maps (0 where no face)."""
    index_img = torch.as_tensor(index_img, device=values.device)
    bary = torch.as_tensor(bary_img, device=values.device)
    tri = faces[index_img.clamp_min(0).long()]                # [H, W, 3]
    out = (values[tri] * bary[..., None]).sum(dim=-2)
    return torch.where(index_img[..., None] >= 0, out, 0.0)


def make_postex(v, index_img, bary_img, faces):
    """Per-texel 3D positions: the vertices splatted through the maps."""
    return values_to_uv(torch.as_tensor(v), index_img, bary_img,
                        torch.as_tensor(faces))


def sample_uv(img: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Bilinear read of a texture [H, W, C] at uv [N, 2] in [0, 1]
    (texel centres at (i + 0.5) / size, as the rasteriser's)."""
    H, W, _ = img.shape
    x = uv[:, 0] * W - 0.5
    y = uv[:, 1] * H - 0.5
    x0 = x.floor().clamp(0, W - 1).long()
    y0 = y.floor().clamp(0, H - 1).long()
    x1 = (x0 + 1).clamp(max=W - 1)
    y1 = (y0 + 1).clamp(max=H - 1)
    fx = (x - x0).clamp(0.0, 1.0)[:, None]
    fy = (y - y0).clamp(0.0, 1.0)[:, None]
    return ((img[y0, x0] * (1 - fx) + img[y0, x1] * fx) * (1 - fy)
            + (img[y1, x0] * (1 - fx) + img[y1, x1] * fx) * fy)


# ---------------------------------------------------------------------------
# cameras
# ---------------------------------------------------------------------------

def project_points_multi(p: torch.Tensor, Rt: torch.Tensor, K: torch.Tensor,
                         normalize: bool = False, size=None):
    """Project world points [B, N, 3] through C cameras (Rt [C, 3, 4],
    K [C, 3, 3]) -> pixels [B, C, N, 2] and depth [B, C, N]; with
    ``normalize`` and ``size`` (H, W), pixels in [-1, 1]."""
    cam = (torch.einsum("cij,bnj->bcni", Rt[:, :, :3], p)
           + Rt[None, :, None, :, 3])
    depth = cam[..., 2]
    proj = torch.einsum("cij,bcnj->bcni", K, cam)
    pix = proj[..., :2] / proj[..., 2:3].clamp_min(1e-9)
    if normalize and size is not None:
        wh = torch.tensor([size[1], size[0]], dtype=torch.float32,
                          device=p.device)
        pix = 2.0 * pix / wh - 1.0
    return pix, depth
