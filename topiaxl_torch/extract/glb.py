"""Binary glTF (GLB) writer — dependency-free (struct + json).

Replaces the reference's pygltflib-based exporter (utils/mesh.py:690-875):
one mesh primitive with POSITION / TEXCOORD_0 / indices, a
pbrMetallicRoughness material with a baseColor texture and a
metallicRoughness texture (G=roughness, B=metallic, matching the
reference's [_, rough, metal] texel packing, inference.py:191).

Texture coordinate convention: the texture bake (extract/rasterize)
writes texel row r at v=(r+0.5)/H, i.e. v grows with image row — the
same direction glTF expects (origin top-left), so UVs pass through
unmodified.
"""

from __future__ import annotations

import json
import struct
from typing import Optional

import numpy as np

_GLB_MAGIC = 0x46546C67
_CHUNK_JSON = 0x4E4F534A
_CHUNK_BIN = 0x004E4942

_FLOAT = 5126
_UINT = 5125


def _pad(b: bytes, align: int, fill: bytes) -> bytes:
    rem = (-len(b)) % align
    return b + fill * rem


def _png_bytes(img: np.ndarray) -> bytes:
    """Encode [H, W, 3] uint8 RGB as PNG."""
    import cv2

    ok, buf = cv2.imencode(".png", img[..., ::-1])  # cv2 wants BGR
    if not ok:
        raise RuntimeError("PNG encoding failed")
    return buf.tobytes()


def align_to_uv(v: np.ndarray, f: np.ndarray, vt: np.ndarray, ft: np.ndarray):
    """Duplicate positions so each (position, uv) corner pair becomes one
    glTF vertex (the reference's align_v_to_vt, utils/mesh.py:623-656).
    Also returns the source vertex index per output vertex so per-vertex
    attributes (normals) can follow the duplication."""
    fr = f.reshape(-1).astype(np.int64)
    ftr = ft.reshape(-1).astype(np.int64)
    nvt = len(vt)
    # fast path (all unwraps in this repo): every uv vertex references
    # exactly one position, so the (pos, uv) pairs ARE the used uv
    # vertices — an O(n) scatter instead of a sort-based unique
    pos_of_uv = np.full(nvt, -1, np.int64)
    pos_of_uv[ftr] = fr
    if (pos_of_uv[ftr] == fr).all():
        used = pos_of_uv >= 0
        if used.all():
            src = pos_of_uv
            new_f = ftr
        else:  # compact away unreferenced uv vertices
            remap = np.cumsum(used) - 1
            src = pos_of_uv[used]
            vt = vt[used]
            new_f = remap[ftr]
        return (v[src].astype(np.float32),
                new_f.reshape(-1, 3).astype(np.uint32),
                vt.astype(np.float32), src)
    # general case: unique (pos, uv) pairs via a packed int64 key (a
    # single-key sort — np.unique(axis=0) lexsorts a void view, ~20x
    # slower at typical corner counts)
    key = fr * nvt + ftr
    uniq, inv = np.unique(key, return_inverse=True)
    src = uniq // nvt
    new_v = v[src]
    new_vt = vt[uniq % nvt]
    new_f = inv.reshape(-1, 3)
    return (new_v.astype(np.float32), new_f.astype(np.uint32),
            new_vt.astype(np.float32), src)


def write_glb(
    path: str,
    v: np.ndarray,
    f: np.ndarray,
    vt: Optional[np.ndarray] = None,
    ft: Optional[np.ndarray] = None,
    albedo: Optional[np.ndarray] = None,
    metallic_roughness: Optional[np.ndarray] = None,
    vn: Optional[np.ndarray] = None,
    name: str = "topiaxl",
) -> None:
    """Write a textured (or bare) mesh as .glb.

    v [V,3] f32; f [F,3] int; vt [Vt,2] in [0,1]; ft [F,3] int;
    albedo / metallic_roughness: [H,W,3] float in [0,1] or uint8;
    vn [V,3] vertex normals (carried through like the reference's Mesh
    vn, utils/mesh.py:21-46,559).
    """
    v = np.asarray(v, np.float32)
    f = np.asarray(f, np.int64)
    if vn is not None:
        vn = np.asarray(vn, np.float32)
    has_uv = vt is not None and ft is not None
    if has_uv:
        v, f, vt, src = align_to_uv(v, f, np.asarray(vt, np.float32),
                                    np.asarray(ft, np.int64))
        if vn is not None:
            vn = vn[src]
    else:
        f = f.astype(np.uint32)

    bin_parts: list[bytes] = []
    buffer_views = []
    accessors = []

    def add_view(data: bytes, target: Optional[int] = None) -> int:
        offset = sum(len(p) for p in bin_parts)
        bin_parts.append(_pad(data, 4, b"\x00"))
        view = {"buffer": 0, "byteOffset": offset, "byteLength": len(data)}
        if target is not None:
            view["target"] = target
        buffer_views.append(view)
        return len(buffer_views) - 1

    def add_accessor(view: int, ctype: int, count: int, type_: str,
                     vmin=None, vmax=None) -> int:
        acc = {
            "bufferView": view,
            "componentType": ctype,
            "count": count,
            "type": type_,
        }
        if vmin is not None:
            acc["min"] = vmin
            acc["max"] = vmax
        accessors.append(acc)
        return len(accessors) - 1

    idx_view = add_view(f.astype(np.uint32).tobytes(), target=34963)
    idx_acc = add_accessor(idx_view, _UINT, int(f.size), "SCALAR")

    pos_view = add_view(v.tobytes(), target=34962)
    pos_acc = add_accessor(
        pos_view, _FLOAT, len(v), "VEC3",
        vmin=[float(x) for x in v.min(0)], vmax=[float(x) for x in v.max(0)],
    )

    attributes = {"POSITION": pos_acc}
    if vn is not None:
        n = vn / np.maximum(np.linalg.norm(vn, axis=1, keepdims=True), 1e-12)
        nrm_view = add_view(n.astype(np.float32).tobytes(), target=34962)
        attributes["NORMAL"] = add_accessor(nrm_view, _FLOAT, len(n), "VEC3")
    if has_uv:
        uv_view = add_view(vt.astype(np.float32).tobytes(), target=34962)
        attributes["TEXCOORD_0"] = add_accessor(uv_view, _FLOAT, len(vt), "VEC2")

    images = []
    textures = []
    samplers = []
    material: dict = {
        "name": "pbr",
        "pbrMetallicRoughness": {},
        "doubleSided": True,
    }

    def to_u8(img):
        img = np.asarray(img)
        if img.dtype != np.uint8:
            img = np.clip(img * 255.0, 0, 255).astype(np.uint8)
        if img.ndim == 2:
            img = np.repeat(img[..., None], 3, axis=-1)
        return img

    if albedo is not None:
        png = _png_bytes(to_u8(albedo))
        img_view = add_view(png)
        images.append({"bufferView": img_view, "mimeType": "image/png"})
        samplers.append({"magFilter": 9729, "minFilter": 9987,
                         "wrapS": 10497, "wrapT": 10497})
        textures.append({"sampler": 0, "source": len(images) - 1})
        material["pbrMetallicRoughness"]["baseColorTexture"] = {
            "index": len(textures) - 1
        }
    if metallic_roughness is not None:
        png = _png_bytes(to_u8(metallic_roughness))
        img_view = add_view(png)
        images.append({"bufferView": img_view, "mimeType": "image/png"})
        if not samplers:
            samplers.append({"magFilter": 9729, "minFilter": 9987,
                             "wrapS": 10497, "wrapT": 10497})
        textures.append({"sampler": 0, "source": len(images) - 1})
        material["pbrMetallicRoughness"]["metallicRoughnessTexture"] = {
            "index": len(textures) - 1
        }
        material["pbrMetallicRoughness"]["metallicFactor"] = 1.0
        material["pbrMetallicRoughness"]["roughnessFactor"] = 1.0
    if albedo is None and metallic_roughness is None:
        material["pbrMetallicRoughness"] = {
            "baseColorFactor": [0.8, 0.8, 0.8, 1.0],
            "metallicFactor": 0.0,
            "roughnessFactor": 0.9,
        }

    primitive = {"attributes": attributes, "indices": idx_acc, "material": 0}

    bin_blob = b"".join(bin_parts)
    gltf = {
        "asset": {"version": "2.0", "generator": "topiaxl"},
        "scene": 0,
        "scenes": [{"nodes": [0]}],
        "nodes": [{"mesh": 0, "name": name}],
        "meshes": [{"primitives": [primitive]}],
        "materials": [material],
        "buffers": [{"byteLength": len(bin_blob)}],
        "bufferViews": buffer_views,
        "accessors": accessors,
    }
    if images:
        gltf["images"] = images
        gltf["textures"] = textures
        gltf["samplers"] = samplers

    json_blob = _pad(json.dumps(gltf, separators=(",", ":")).encode(), 4, b" ")
    total = 12 + 8 + len(json_blob) + 8 + len(bin_blob)
    with open(path, "wb") as fh:
        fh.write(struct.pack("<III", _GLB_MAGIC, 2, total))
        fh.write(struct.pack("<II", len(json_blob), _CHUNK_JSON))
        fh.write(json_blob)
        fh.write(struct.pack("<II", len(bin_blob), _CHUNK_BIN))
        fh.write(bin_blob)


def read_glb(path: str):
    """Minimal GLB reader (validation / tests): returns (gltf dict, bin)."""
    with open(path, "rb") as fh:
        data = fh.read()
    magic, version, total = struct.unpack_from("<III", data, 0)
    assert magic == _GLB_MAGIC and version == 2 and total == len(data)
    jlen, jtype = struct.unpack_from("<II", data, 12)
    assert jtype == _CHUNK_JSON
    gltf = json.loads(data[20:20 + jlen])
    off = 20 + jlen
    blen, btype = struct.unpack_from("<II", data, off)
    assert btype == _CHUNK_BIN
    bin_blob = data[off + 8: off + 8 + blen]
    return gltf, bin_blob
