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
import. A failed build raises. The sources: the flash forward
(``flash_attn_fwd.cu``), the single-pass backward and the two-pass pair
(``flash_attn_bwd_sm90.cu``, ``flash_attn_bwd.cu``), the LN + modulate
kernels (``ln_modulate.cu``), the tensor-core probes (``mma_probe.cu``),
the QK norm (``qk_rmsnorm.cu``) and the trainers' clip + AdamW + EMA
update, one launch over every parameter (``adamw_ema.cu``,
``ops/adamw_ema.py``).

Every wrapper adds one to ``launches[<kernel>]`` where it launches its
kernel and nowhere else, so a run can show that its main path went
through the kernels (``reset_launch_counts`` zeroes them). Two kernels
also count their launches by tags: the flash forward by its tile layout
in ``fwd_layouts`` (``ops/flash_attention.py:fwd_tile_layout``: a
flagship chain's 1,400 launches at head dim 72 under ``"split"``) and by
its loop in ``fwd_loops`` (``ops/flash_attention.py:fwd_loop``: the same
1,400 under ``"overlapped"``, as a flow training step's 48 at head dim
64), the single-pass flash backward by its loop in ``bwd_loops``
(``ops/flash_attention.py:bwd_loop``: a flagship training step's 56
launches at head dim 72 under ``"overlapped"``). A count is
one call of a kernel's C entry point: one ``flash_attn_bwd`` at head dim
256 starts two kernels, a delta pass and then the single pass
(``csrc/flash_attn_bwd_sm90.cu``), and counts once. A CUDA graph
replays its kernels without running the wrappers, so what captures a
graph tallies the launches its own thread makes during the capture
(``tally``, where a tag counts as ``"<kernel>.<tag>"``), takes them
back and adds them at each replay (``add_launches``;
``pipelines/chain_graph.py``).

Every wrapper launches on ``stream_of(t)``, the current stream of its
tensors' card: inside a capture that is the capture stream, so the
kernels are captured with the rest of the graph. Their tensor maps are
encoded on the host and passed by value, so a captured launch keeps the
addresses it was captured with: the graph's buffers and pool must stay
where they are, as they do.
"""

from __future__ import annotations

import collections
import contextlib
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
            "ln_modulate_residual": 0, "mma_rate_loop": 0,
            "dot_form_chain": 0, "dot_form_accum": 0, "qk_rmsnorm": 0,
            "qk_rmsnorm_bwd": 0, "qk_rmsnorm_rms": 0,
            "qk_rmsnorm_rms_bwd": 0, "adamw_ema": 0}
# flash forward launches by tile layout and by loop, single-pass flash
# backward launches by loop, beside ``launches``
fwd_layouts = {"split": 0, "swizzled": 0}
fwd_loops = {"overlapped": 0, "pingpong": 0}
bwd_loops = {"overlapped": 0, "serial": 0}
# a tagged kernel's tables, one for each of its tags, in the order
# ``count_launch`` takes them
_TAGS = {"flash_attn_fwd": (fwd_layouts, fwd_loops),
         "flash_attn_bwd": (bwd_loops,)}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
# the launches of a thread inside ``tally``
_tallies = threading.local()

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
_D = ctypes.c_double
# q, k, v, o, dout, lse, delta, dq, dk, dv; B, H, Sq, Sk, D; 15 strides;
# scale; stream (csrc/flash_attn_bwd.cu, csrc/flash_attn_bwd_sm90.cu)
_BWD = [_P] * 10 + [_I] * 5 + [_L] * 15 + [_F, _P]
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
    # a, b, out, workspace; int8, ta, tb, coef, M, N, K, L, out_t, splits;
    # stream (csrc/mma_probe.cu)
    "topiaxl_mma_probe": [_P] * 4 + [_I] * 10 + [_P],
    # int8, ta, tb, coef, N
    "topiaxl_mma_probe_occupancy": [_I] * 5,
    # x, gamma, y; B, N, H, D; 3 strides of x; scale; stream
    # (csrc/qk_rmsnorm.cu; the l2 form, then the rms form)
    "topiaxl_qk_rmsnorm": [_P] * 3 + [_I] * 4 + [_L] * 3 + [_F, _P],
    "topiaxl_qk_rmsnorm_rms": [_P] * 3 + [_I] * 4 + [_L] * 3 + [_F, _P],
    # B, N, H, D, SMs
    "topiaxl_qk_rmsnorm_bwd_blocks": [_I] * 5,
    # x, dy, gamma, dx, dgamma partials; blocks, B, N, H, D; 3 strides of
    # x; scale; stream
    "topiaxl_qk_rmsnorm_bwd": [_P] * 5 + [_I] * 5 + [_L] * 3 + [_F, _P],
    "topiaxl_qk_rmsnorm_rms_bwd": [_P] * 5 + [_I] * 5 + [_L] * 3 + [_F, _P],
    # tensor table, work items; items; gscale; lr, c1, c2; b1, b2; eps,
    # wd; decay; stream (csrc/adamw_ema.cu)
    "topiaxl_adamw_ema": [_P] * 2 + [_I, _P] + [_F] * 3 + [_D] * 2
                         + [_F] * 2 + [_D, _P],
}


def reset_launch_counts() -> None:
    for table in (launches, fwd_layouts, fwd_loops, bwd_loops):
        for name in table:
            table[name] = 0


def count_launch(name: str, *tags: str) -> None:
    """One launch of kernel ``name``; the flash forward also names its tile
    layout and its loop, counted in ``fwd_layouts`` and ``fwd_loops``, the
    single-pass flash backward its loop, counted in ``bwd_loops``."""
    launches[name] += 1
    for table, tag in zip(_TAGS.get(name, ()), tags):
        table[tag] += 1
    counts = getattr(_tallies, "counts", None)
    if counts is not None:
        counts[name] += 1
        for tag in tags:
            counts[f"{name}.{tag}"] += 1


@contextlib.contextmanager
def tally():
    """A Counter of the launches this thread makes inside the block
    (those of other threads are not in it)."""
    _tallies.counts = counts = collections.Counter()
    try:
        yield counts
    finally:
        _tallies.counts = None


def add_launches(counts: dict) -> None:
    """Add ``counts`` (name, or ``"<kernel>.<tag>"``, -> launches,
    negative to take back)."""
    for key, n in counts.items():
        name, _, tag = key.partition(".")
        if tag:
            next(t for t in _TAGS[name] if tag in t)[tag] += n
        else:
            launches[key] += n


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


def on_device(t):
    """Context in which a launch runs on ``t``'s card: the kernels launch
    on the current device, which on a multi-card host need not be the
    tensors'."""
    import torch

    return torch.cuda.device(t.device)
