"""Native (C++) host stages of the extraction pipeline, loaded via ctypes.

A copy of ``topiaxl/native`` for the port, which imports nothing of the
JAX package. The seven sources beside this file are compiled with
``g++`` into one shared library at the first call, never at import. The
library lands in ``build/topiaxl_torch_native/<hash>/`` at the root of
the checkout the package runs from, or, for an installed copy, under the
user's cache (``$XDG_CACHE_HOME`` or ``~/.cache``, then
``topiaxl_torch/native/<hash>/``); the hash covers the sources and the
flags, so an edited source rebuilds. Nothing is written beside the
sources. A failed build raises; the callers in ``topiaxl_torch.extract``
catch it where they have a numpy implementation to fall back on.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

from ..ops._cuda import build_root as _build_root

_DIR = Path(__file__).resolve().parent
_LOCK = threading.Lock()
_LIB = None

_SOURCES = ["qem.cpp", "mt.cpp", "mc.cpp", "raster.cpp", "remesh.cpp",
            "charts.cpp", "edt.cpp"]
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
LIB_NAME = "libtopiaxl_torch_native.so"


def build_root() -> Path:
    """``build/topiaxl_torch_native`` in a checkout, else the per-user
    cache (the kernels' rule, ``ops/_cuda.py:build_root``)."""
    return _build_root("native")


def build_dir() -> Path:
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    for name in _SOURCES:
        h.update(name.encode())
        h.update((_DIR / name).read_bytes())
    return build_root() / h.hexdigest()[:16]


def build() -> Path:
    """Compile the library if this source hash has none yet; returns its
    path. Raises if ``g++`` fails."""
    out_dir = build_dir()
    lib_path = out_dir / LIB_NAME
    if lib_path.exists():
        return lib_path
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f"{LIB_NAME}.{os.getpid()}.tmp"
    cmd = ["g++", *GXX_FLAGS, *(str(_DIR / s) for s in _SOURCES),
           "-o", str(tmp)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed ({proc.returncode}): {' '.join(cmd)}"
                           f"\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib_path)
    return lib_path


def loaded_path() -> Path | None:
    """The path of the loaded library, or None before the first call."""
    return None if _LIB is None else Path(_LIB._name)


def _load() -> ctypes.CDLL:
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return _LIB
        lib = ctypes.CDLL(str(build()))
        lib.qem_decimate.restype = ctypes.c_int
        lib.qem_decimate.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ]
        lib.mt_extract.restype = ctypes.c_int
        lib.mt_extract.argtypes = [
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_float,
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ]
        lib.mc_extract.restype = ctypes.c_int
        lib.mc_extract.argtypes = list(lib.mt_extract.argtypes)
        lib.raster_uv.restype = None
        lib.raster_uv.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_uint8),
        ]
        lib.chart_segment.restype = ctypes.c_int
        lib.chart_segment.argtypes = [
            ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64, ctypes.c_float, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64),
        ]
        lib.edt_index.restype = ctypes.c_int
        lib.edt_index.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ]
        lib.isotropic_remesh.restype = ctypes.c_int
        lib.isotropic_remesh.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
            ctypes.c_float, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_float), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ]
        _LIB = lib
        return lib


def qem_decimate(verts: np.ndarray, faces: np.ndarray, target: int):
    """Quadric edge-collapse decimation to <= target faces."""
    lib = _load()
    v = np.ascontiguousarray(verts, np.float32)
    f = np.ascontiguousarray(faces, np.int64)
    out_v = np.empty_like(v)
    out_f = np.empty_like(f)
    nv_out = ctypes.c_int64(0)
    nf_out = ctypes.c_int64(0)
    rc = lib.qem_decimate(
        v.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), len(v),
        f.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), len(f),
        int(target),
        out_v.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ctypes.byref(nv_out),
        out_f.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ctypes.byref(nf_out),
    )
    if rc != 0:
        raise RuntimeError(f"qem_decimate failed rc={rc}")
    return (out_v[: nv_out.value].copy(), out_f[: nf_out.value].copy())


def _iso_extract(fn_name: str, grid: np.ndarray, iso: float,
                 est_tris: int | None):
    lib = _load()
    fn = getattr(lib, fn_name)
    g = np.ascontiguousarray(grid, np.float32)
    R0, R1, R2 = g.shape
    if est_tris is None:
        est_tris = max(int(4 * R0 * R1), 1 << 16) * 16
    cap_f = est_tris
    cap_v = est_tris  # welded verts < tris in practice
    for _ in range(4):
        out_v = np.empty((cap_v, 3), np.float32)
        out_f = np.empty((cap_f, 3), np.int64)
        nv = ctypes.c_int64(0)
        nf = ctypes.c_int64(0)
        rc = fn(
            g.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            R0, R1, R2, ctypes.c_float(iso),
            out_v.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), cap_v,
            out_f.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), cap_f,
            ctypes.byref(nv), ctypes.byref(nf),
        )
        if rc == 0:
            return (out_v[: nv.value].copy(), out_f[: nf.value].copy())
        cap_v = max(nv.value, cap_v * 2)
        cap_f = max(nf.value, cap_f * 2)
    raise RuntimeError(f"{fn_name} capacity negotiation failed")


def marching_tetrahedra(grid: np.ndarray, iso: float = 0.0,
                        est_tris: int | None = None):
    """Native MT isosurface; returns (verts [V,3] index coords, faces)."""
    return _iso_extract("mt_extract", grid, iso, est_tris)


def marching_cubes(grid: np.ndarray, iso: float = 0.0,
                   est_tris: int | None = None):
    """Native table-based marching cubes (reference-compatible geometry:
    same edge-crossing vertices as PyMCubes, inference.py:119)."""
    return _iso_extract("mc_extract", grid, iso, est_tris)


def raster_uv(uv_corners: np.ndarray, attr_corners: np.ndarray,
              height: int, width: int):
    """Native UV-atlas rasterization: (attr_map [H,W,A] f32, mask [H,W])."""
    lib = _load()
    uv = np.ascontiguousarray(uv_corners, np.float32)
    attr = np.ascontiguousarray(attr_corners, np.float32)
    F = uv.shape[0]
    A = attr.shape[-1]
    out = np.zeros((height * width, A), np.float32)
    cov = np.zeros(height * width, np.uint8)
    lib.raster_uv(
        uv.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        attr.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        F, A, height, width,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        cov.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
    )
    return out.reshape(height, width, A), cov.reshape(height, width).astype(bool)


def chart_segment(face_normals: np.ndarray, indptr: np.ndarray,
                  indices: np.ndarray, cos_t: float,
                  max_faces: int) -> np.ndarray:
    """Normal-cone region-growing chart labels (same traversal as the
    Python spec in extract/lscm.py:segment_charts). Returns [F] int64."""
    lib = _load()
    fn = np.ascontiguousarray(face_normals, np.float32)
    ip = np.ascontiguousarray(indptr, np.int64)
    ix = np.ascontiguousarray(indices, np.int64)
    F = len(fn)
    labels = np.empty(F, np.int64)
    rc = lib.chart_segment(
        fn.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ip.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ix.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        F, float(cos_t), int(max_faces),
        labels.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )
    if rc != 0:
        raise RuntimeError(f"chart_segment failed rc={rc}")
    return labels


def edt_index(sites: np.ndarray):
    """Exact squared EDT + nearest-site flat indices for a bool [H, W]
    site mask. Returns (d2 int32 [H, W], idx int32 [H, W])."""
    lib = _load()
    s = np.ascontiguousarray(sites, np.uint8)
    H, W = s.shape
    d2 = np.empty((H, W), np.int32)
    idx = np.empty((H, W), np.int32)
    rc = lib.edt_index(
        s.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), H, W,
        d2.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    if rc != 0:
        raise RuntimeError("edt_index: empty site mask")
    return d2, idx


def isotropic_remesh(verts: np.ndarray, faces: np.ndarray,
                     target_len: float, iterations: int = 3):
    """Isotropic explicit remeshing (native); returns (verts, faces)."""
    lib = _load()
    v = np.ascontiguousarray(verts, np.float32)
    f = np.ascontiguousarray(faces, np.int64)
    cap_v = max(len(v) * 4, 1 << 14)
    cap_f = max(len(f) * 4, 1 << 14)
    for _ in range(4):
        out_v = np.empty((cap_v, 3), np.float32)
        out_f = np.empty((cap_f, 3), np.int64)
        nv = ctypes.c_int64(0)
        nf = ctypes.c_int64(0)
        rc = lib.isotropic_remesh(
            v.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), len(v),
            f.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), len(f),
            ctypes.c_float(target_len), int(iterations),
            out_v.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), cap_v,
            out_f.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), cap_f,
            ctypes.byref(nv), ctypes.byref(nf),
        )
        if rc == 0:
            return (out_v[: nv.value].copy(), out_f[: nf.value].copy())
        cap_v = max(nv.value, cap_v * 2)
        cap_f = max(nf.value, cap_f * 2)
    raise RuntimeError("isotropic_remesh capacity negotiation failed")
