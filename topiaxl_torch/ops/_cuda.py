"""Build, load and count the port's hand-written CUDA kernels.

The sources in ``topiaxl_torch/csrc/*.cu`` are compiled with ``nvcc``
for ``sm_90a``, one ``nvcc`` per source, all started together, and
linked into one shared library with a plain C interface, loaded with
``ctypes`` (no PyTorch headers, so a build takes seconds). The library
lands in ``build/topiaxl_torch_kernels/<hash>/`` at the root of the
checkout the package runs from, or, for an installed copy, under the
user's cache (``$XDG_CACHE_HOME`` or ``~/.cache``, then
``topiaxl_torch/kernels/<hash>/``). The hash covers the sources, the
headers they share (``csrc/*.cuh``) and the flags; the compiler's output
(``-Xptxas -v``: registers, shared memory, spills) is kept beside it in
``build.log``. The build happens at the first kernel launch, never at
import. A failed build raises.

Every wrapper adds one to ``launches[<kernel>]`` where it launches its
kernel and nowhere else, so a run can show that its main path went
through the kernels (``reset_launch_counts`` zeroes them).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LIB_NAME = "libtopiaxl_torch_kernels.so"

launches = {"flash_attn_fwd": 0, "flash_attn_bwd": 0, "flash_attn_bwd_dq": 0,
            "flash_attn_bwd_dkv": 0, "ln_modulate": 0,
            "ln_modulate_residual": 0}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
# q, k, v, o, dout, lse, dq, dk, dv; B, H, Sq, Sk, D; 15 strides; scale;
# stream (csrc/flash_attn_bwd.cu)
_BWD = [_P] * 9 + [_I] * 5 + [_L] * 15 + [_F, _P]
_SIGNATURES = {
    "topiaxl_flash_attn_fwd": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                               _L, _L, _L, _L, _L, _L, _L, _L, _L, _L, _L, _L,
                               _F, _P],
    "topiaxl_flash_attn_bwd": _BWD,
    "topiaxl_flash_attn_bwd_dq": _BWD,
    "topiaxl_flash_attn_bwd_dkv": _BWD,
    "topiaxl_ln_modulate": [_P, _P, _P, _P, _I, _I, _I, _L, _L, _F, _P],
    "topiaxl_ln_modulate_residual": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                                     _L, _L, _L, _F, _P],
}


def reset_launch_counts() -> None:
    for name in launches:
        launches[name] = 0


def count_launch(name: str) -> None:
    launches[name] += 1


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def headers() -> list[Path]:
    return sorted(CSRC.glob("*.cuh"))


def build_root(kind: str = "kernels") -> Path:
    """``build/topiaxl_torch_<kind>`` in a checkout (``pyproject.toml``
    beside the package), else ``topiaxl_torch/<kind>`` in a per-user
    cache directory. ``kind`` is ``kernels`` here, ``native`` for the
    host stages' C++ library (``topiaxl_torch.native``)."""
    checkout = Path(__file__).resolve().parents[2]
    if (checkout / "pyproject.toml").is_file():
        return checkout / "build" / f"topiaxl_torch_{kind}"
    cache = os.environ.get("XDG_CACHE_HOME") or os.path.join(
        os.path.expanduser("~"), ".cache")
    return Path(cache) / "topiaxl_torch" / kind


def build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources() + headers():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return build_root() / h.hexdigest()[:16]


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([os.path.join(home, "bin", "nvcc")] if home else []) + [
            "/usr/local/cuda/bin/nvcc"]:
        if os.path.exists(cand):
            return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    return found


def build() -> Path:
    """Compile the kernels if this source hash has no library yet;
    returns the library's path."""
    out_dir = build_dir()
    lib_path = out_dir / LIB_NAME
    if lib_path.exists():
        return lib_path
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc, tag = _nvcc(), f"{os.getpid()}.tmp"
    objs = [out_dir / f"{src.stem}.{tag}.o" for src in sources()]
    cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
            for src, obj in zip(sources(), objs)]
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    outs = [proc.communicate()[0] for proc in procs]
    tmp = out_dir / f"{LIB_NAME}.{tag}"
    link = [nvcc, "-shared", "-o", str(tmp), *map(str, objs)]
    failed = [(cmd, proc.returncode, out)
              for cmd, proc, out in zip(cmds, procs, outs) if proc.returncode]
    if not failed:
        proc = subprocess.run(link, capture_output=True, text=True)
        outs.append(proc.stdout + proc.stderr)
        if proc.returncode:
            failed.append((link, proc.returncode, outs[-1]))
    (out_dir / "build.log").write_text("".join(
        " ".join(cmd) + "\n" + out for cmd, out in zip(cmds + [link], outs)))
    for obj in objs:
        obj.unlink(missing_ok=True)
    if failed:
        cmd, rc, out = failed[0]
        raise RuntimeError(f"nvcc failed ({rc}): {' '.join(cmd)}\n{out}")
    os.replace(tmp, lib_path)
    return lib_path


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def check(rc: int, name: str) -> None:
    """Raise if a kernel launch returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error {rc}")


def stream_of(t) -> int:
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream
