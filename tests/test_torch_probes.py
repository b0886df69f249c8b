"""The plain versions of the port's three probe kernels
(``topiaxl_torch/benchmarks``) against the TPU kernels they replace, run
in Pallas interpret mode on the CPU at small shapes (inputs from numpy
seeds). The benchmark files are not edited: ``exp_dot_forms``' chain
length is set on the module object, and ``microbench_pallas_int8.py``,
which runs its benchmark when imported, gives up only its ``loop_kernel``
(taken out with ``ast`` and run with small M, N, L). On a CPU tensor the
wrappers themselves take the plain versions. Bars: int8 exact, bf16
within 1e-5 of max|JAX| (f32 sums in another order)."""

import ast
import functools
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from test_torch_models import torch_threads  # noqa: F401
from topiaxl_torch.benchmarks import exp_dot_forms as edf
from topiaxl_torch.benchmarks import microbench_int8 as mbi

ROOT = pathlib.Path(__file__).resolve().parents[1]
REL_BAR = 1e-5


def _rel(got, ref):
    ref = np.asarray(ref, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - ref).max()
                 / np.abs(ref).max())


def _bf16(shape, seed):
    """N(0, 1) rounded to bf16, as a JAX array and a torch tensor."""
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    j = jnp.asarray(x, jnp.bfloat16)
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).bfloat16()


def _loop_kernel(m, n, iters):
    """``loop_kernel`` of ``benchmarks/microbench_pallas_int8.py`` with its
    globals M, N, L set to small values."""
    path = ROOT / "benchmarks" / "microbench_pallas_int8.py"
    tree = ast.parse(path.read_text())
    fn = next(node for node in tree.body
              if isinstance(node, ast.FunctionDef) and node.name == "loop_kernel")
    ns = {"jax": jax, "jnp": jnp, "M": m, "N": n, "L": iters}
    exec(compile(ast.Module(body=[fn], type_ignores=[]), str(path), "exec"), ns)
    return ns["loop_kernel"]


@pytest.mark.parametrize("iters", [7, 8])
@pytest.mark.parametrize("int8", [True, False])
def test_rate_loop_plain_matches_tpu_kernel(int8, iters):
    m, k, n = 16, 32, 16
    kernel = _loop_kernel(m, n, iters)
    acc = jnp.int32 if int8 else jnp.float32
    rng = np.random.default_rng(iters)
    if int8:
        a_np = rng.integers(-127, 127, (m, k)).astype(np.int8)
        b_np = rng.integers(-127, 127, (k, n)).astype(np.int8)
        a, b = jnp.asarray(a_np), jnp.asarray(b_np)
        ta, tb = torch.from_numpy(a_np), torch.from_numpy(b_np)
    else:
        (a, ta), (b, tb) = _bf16((m, k), iters), _bf16((k, n), iters + 1)
    ref = np.asarray(pl.pallas_call(
        functools.partial(kernel, acc_dtype=acc),
        out_shape=jax.ShapeDtypeStruct((m, n), acc), interpret=True)(a, b))
    got = mbi.mma_rate_loop(ta, tb, iters)      # CPU tensors: the plain version
    assert got.dtype == (torch.int32 if int8 else torch.float32)
    assert np.abs(ref).max() > 0
    if int8:
        np.testing.assert_array_equal(got.numpy(), ref)
    else:
        assert _rel(got.numpy(), ref) <= REL_BAR


FORMS = [((16, 32), (24, 32), (1, 1)),    # q k^T
         ((32, 16), (32, 24), (0, 0)),    # contraction on rows
         ((16, 32), (32, 24), (1, 0)),    # standard
         ((8, 32), (16, 32), (1, 1))]     # transposed output


@pytest.mark.parametrize("form", FORMS)
def test_chain_plain_matches_tpu_kernel(form, monkeypatch):
    from benchmarks import exp_dot_forms as tpu

    a_shape, b_shape, dn = form
    monkeypatch.setattr(tpu, "N_ITER", 5)
    (a, ta), (b, tb) = _bf16(a_shape, 1), _bf16(b_shape, 2)
    out_shape = (a_shape[1 - dn[0]], b_shape[1 - dn[1]])
    ref = np.asarray(pl.pallas_call(
        functools.partial(tpu._loop_kernel, dn=((dn[0],), (dn[1],)),
                          out_shape=out_shape),
        out_shape=jax.ShapeDtypeStruct(out_shape, jnp.float32),
        interpret=True)(a, b))
    got = edf.dot_form_chain(ta, tb, dn, 5)
    assert got.shape == out_shape
    assert _rel(got.numpy(), ref) <= REL_BAR


@pytest.mark.parametrize("form", FORMS)
def test_accum_plain_matches_tpu_kernel(form):
    from benchmarks import exp_dot_forms2 as tpu

    a_shape, b_shape, dn = form
    (a, ta), (b, tb) = _bf16(a_shape, 3), _bf16(b_shape, 4)
    out_shape = (a_shape[1 - dn[0]], b_shape[1 - dn[1]])
    ref = np.asarray(pl.pallas_call(
        functools.partial(tpu._kernel, dn=((dn[0],), (dn[1],))),
        grid=(3,),
        in_specs=[pl.BlockSpec(a_shape, lambda i: (0, 0)),
                  pl.BlockSpec(b_shape, lambda i: (0, 0))],
        out_specs=pl.BlockSpec(out_shape, lambda i: (0, 0)),
        out_shape=jax.ShapeDtypeStruct(out_shape, jnp.float32),
        interpret=True)(a, b))
    got = edf.dot_form_accum(ta, tb, dn, 3)
    assert got.shape == out_shape
    assert _rel(got.numpy(), ref) <= REL_BAR


def test_probe_forms_are_the_tpu_probes():
    """The port's form tables are the TPU scripts' shapes and contractions."""
    from benchmarks import exp_dot_forms as tpu8

    assert (tpu8.BQ, tpu8.SK, tpu8.N_ITER) == (512, 1024, edf.N_ITER)
    assert [f[0] for f in edf.CHAIN_FORMS] == ["qk_lane", "qk_sub", "pv_std",
                                               "pv_lane", "ref"]
    tree = ast.parse((ROOT / "benchmarks" / "microbench_pallas_int8.py")
                     .read_text())
    consts = {}
    for node in tree.body:
        if isinstance(node, ast.Assign) and isinstance(
                node.value, (ast.Constant, ast.Tuple)):
            names = node.targets[0]
            names = names.elts if isinstance(names, ast.Tuple) else [names]
            value = ast.literal_eval(node.value)
            values = value if isinstance(value, tuple) else [value]
            consts.update((n.id, v) for n, v in zip(names, values))
    assert (mbi.M, mbi.K, mbi.N, mbi.L) == tuple(consts[c] for c in "MKNL")
    for label, a_shape, b_shape, dn in edf.CHAIN_FORMS + edf.ACCUM_FORMS:
        ca, cb = dn
        assert a_shape[ca] == b_shape[cb], label


# the probe path's launches: (what, M, N, K, element bytes, products); the
# dot forms as ``exp_dot_forms._launch`` hands them to the kernel (an
# output of 72 or 80 rows computed as its transpose)
def _probe_launches():
    out = []
    for table, iters in ((edf.CHAIN_FORMS, edf.N_ITER),
                         (edf.ACCUM_FORMS, edf.G_LO),
                         (edf.ACCUM_FORMS, edf.G_HI)):
        for label, a_shape, b_shape, (ca, cb) in table:
            X, Y, K = a_shape[1 - ca], b_shape[1 - cb], a_shape[ca]
            M, N = (X, Y) if X % 128 == 0 else (Y, X)
            out.append((f"{label} x{iters}", M, N, K, 2, iters))
    for m in (mbi.M, mbi.M_FULL):
        for elem in (1, 2):
            out.append((f"rate {elem}B M={m}", m, mbi.N, mbi.K, elem, mbi.L))
    return out


@pytest.mark.parametrize("what,M,N,K,elem,iters", _probe_launches())
def test_split_plan_fills_the_card(what, M, N, K, elem, iters):
    """On 132 block slots (one block per SM of an H100) every launch of the
    probe path keeps at least 95% of the slots of its waves busy, at most
    four waves, each block with at least ``MIN_PRODUCTS`` products unless
    the tile has fewer."""
    from topiaxl_torch import benchmarks as B

    slots = 132
    tiles, work = B.tiles_and_work(M, N, K, elem, iters)
    s = B.pick_splits(tiles, work, slots)
    waves = -(-tiles * s // slots)
    assert 1 <= s and waves <= B.MAX_WAVES
    assert s == 1 or work // s >= B.MIN_PRODUCTS
    assert tiles * work / (waves * slots * -(-work // s)) >= 0.95, (tiles, s)


def test_split_plan_edges():
    """The rate loop's 264 tiles (two per SM) keep one block a tile; the
    4-tile dot forms spread over the card; no work, one split; a tile with
    few products keeps ``MIN_PRODUCTS`` a block."""
    from topiaxl_torch import benchmarks as B

    assert B.pick_splits(*B.tiles_and_work(mbi.M_FULL, 1024, 1024, 1, 256),
                         132) == 1
    tiles, work = B.tiles_and_work(512, 128, 2048, 2, edf.G_LO)
    assert tiles == 4 and tiles * B.pick_splits(tiles, work, 132) == 132
    assert B.tiles_and_work(512, 72, 2048, 2, 1) == (4, 16)
    assert B.tiles_and_work(128, 128, 400, 2, 3) == (1, 12)   # a K tail
    assert B.pick_splits(4, 0, 132) == 1
    assert B.pick_splits(1, 56, 132) == 56 // B.MIN_PRODUCTS
    assert B.pick_splits(1, 5, 132) == 1
