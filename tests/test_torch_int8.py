"""The port's W8A8 serving path (``topiaxl_torch.ops.int8``, the DiT's
``quant``, the CLI's ``model.generator.quant``) against the JAX package's
(``topiaxl.ops.int8``) on the CPU, f32, inputs from numpy seeds.

Bars: int8 codes equal, scales within 1 f32 ulp; int32 accumulations
equal and outputs within 1e-6 relative (the same f32 operations in the
same order); the quantized tiny DiT within rel RMS 1e-3 of JAX's
quantized forward (an activation code can flip at a rounding boundary
between the two runtimes' f32 activations), and within JAX's own 2e-2
of the float forward."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_models import randomize_, tiny_dit, torch_threads  # noqa: F401
from test_torch_pipeline import _tiny_config
from topiaxl.ops import int8 as jint8
from topiaxl_torch.core import weights
from topiaxl_torch.ops import int8


def rel_rms(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.sqrt(np.mean((a - b) ** 2) / np.mean(b ** 2)))


def _jax_acc(x, q):
    """JAX's int32 accumulation inside ``int8_matmul`` (its first lines)."""
    x32 = jnp.asarray(x, jnp.float32)
    s = jnp.maximum(jnp.max(jnp.abs(x32), axis=-1, keepdims=True) / 127.0,
                    1e-12)
    xq = jnp.clip(jnp.round(x32 / s), -127, 127).astype(jnp.int8)
    return np.asarray(jax.lax.dot_general(
        xq, q, (((x.ndim - 1,), (0,)), ((), ())),
        preferred_element_type=jnp.int32))


def test_quantize_weight_matches_jax():
    rng = np.random.default_rng(0)
    w = (rng.standard_normal((64, 48)) * 0.3).astype(np.float32)   # [in, out]
    w[:, 5] = 0.0                      # a zero channel takes the 1e-12 floor
    q_ref, s_ref = jint8.quantize_weight(jnp.asarray(w))
    q, s = int8.quantize_weight(torch.from_numpy(w.T.copy()))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert q.shape == (48, 64) and s.shape == (48,)
    np.testing.assert_array_equal(q.numpy(), np.asarray(q_ref).T)
    np.testing.assert_array_max_ulp(s.numpy(), np.asarray(s_ref), maxulp=1)


@pytest.mark.parametrize("rows", [1, 8, 40])   # 1 and 8 go through the padding
def test_int8_matmul_matches_jax(rows):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((rows, 3, 96)).astype(np.float32)
    w = (rng.standard_normal((96, 48)) * 0.1).astype(np.float32)
    q_ref, s_ref = jint8.quantize_weight(jnp.asarray(w))
    ref = np.asarray(jint8.int8_matmul(jnp.asarray(x), q_ref, s_ref,
                                       out_dtype=jnp.float32))
    w_q = torch.from_numpy(np.asarray(q_ref).T.copy())
    w_s = torch.from_numpy(np.array(s_ref))
    xq, _ = int8.quantize_activations(torch.from_numpy(x))
    acc = int8.int_mm(xq, w_q)
    assert acc.dtype == torch.int32
    np.testing.assert_array_equal(acc.numpy().reshape(rows, 3, 48),
                                  _jax_acc(x, q_ref))
    got = int8.int8_matmul(torch.from_numpy(x), w_q, w_s, torch.float32)
    assert got.shape == (rows, 3, 48)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=0)


def test_quant_dense_matches_jax():
    import flax.linen as nn

    rng = np.random.default_rng(2)
    x = rng.standard_normal((4, 6, 32)).astype(np.float32)
    kernel = (rng.standard_normal((32, 16)) / np.sqrt(32)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(16)).astype(np.float32)
    p = {"params": {"kernel": jnp.asarray(kernel), "bias": jnp.asarray(bias)}}
    qd = jint8.QuantDense(16, dtype=jnp.float32)
    tpl = jax.eval_shape(qd.init, jax.random.PRNGKey(0), jnp.asarray(x))
    qp = jint8.quantize_params_like(p, tpl)
    ref = np.asarray(qd.apply(qp, jnp.asarray(x)))
    dense = np.asarray(nn.Dense(16).apply(p, jnp.asarray(x)))

    port = int8.QuantDense(32, 16, dtype=torch.float32)
    port.to_empty(device="cpu")
    port.load_state_dict(int8.quantize_state_dict_like(
        {"weight": torch.from_numpy(kernel.T.copy()),
         "bias": torch.from_numpy(bias)}, port))
    np.testing.assert_array_equal(port.weight_q.numpy(),
                                  np.asarray(qp["params"]["kernel_q"]).T)
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-7)
    assert rel_rms(got, dense) < 2e-2


def test_quantized_dit_matches_jax():
    """A depth-2, hidden-64 DiT: JAX's quantized params carried across by
    ``dit_from_jax``; ``forward`` and ``forward_with_cfg_kv`` against
    JAX's, and both against the float forward."""
    from topiaxl.models import DiT as JaxDiT
    from topiaxl.models import quantize_dit_params
    from topiaxl_torch.models.dit import DiT, quantize_dit_state_dict
    from topiaxl_torch.ops.int8 import QuantDense

    cfg = dict(seq_length=16, in_channels=68, condition_channels=8,
               hidden_size=64, depth=2, num_heads=4)
    fdit, params = tiny_dit(seed=20, depth=2, hidden=64, heads=4, seq=16,
                            cond=8)
    jd = JaxDiT(attn_proj_bias=True, dtype=jnp.float32, **cfg)
    rng = np.random.default_rng(21)
    x = rng.standard_normal((1, 16, 68)).astype(np.float32)
    y = rng.standard_normal((1, 5, 8)).astype(np.float32)
    t = np.array([3], np.int32)
    out_f = np.asarray(jd.apply(params, jnp.asarray(x), jnp.asarray(t),
                                jnp.asarray(y)))

    qp = quantize_dit_params(jd, params)
    qjd = jd.clone(quant=True)
    ref = np.asarray(qjd.apply(qp, jnp.asarray(x), jnp.asarray(t),
                               jnp.asarray(y)))
    null = qp["params"]["null_cond_embedding"]
    y_pair = jnp.concatenate(
        [jnp.asarray(y), jnp.broadcast_to(null[None, None, :], y.shape)], 0)
    kvs = qjd.apply(qp, y_pair, method=JaxDiT.precompute_kv)
    ref_cfg = np.asarray(qjd.apply(qp, jnp.asarray(x), jnp.asarray(t), kvs,
                                   4.0, method=JaxDiT.forward_with_cfg_kv))
    out_f_cfg = np.asarray(jd.apply(
        params, jnp.asarray(x), jnp.asarray(t),
        jd.apply(params, y_pair, method=JaxDiT.precompute_kv), 4.0,
        method=JaxDiT.forward_with_cfg_kv))

    qdit = DiT(quant=True, dtype=torch.float32, **cfg)
    sd = weights.dit_from_jax(jax.tree.map(np.asarray, qp))
    qdit.load_state_dict(sd)
    # the port's own quantization of the float weights gives the same codes
    own = quantize_dit_state_dict(qdit, fdit.state_dict())
    assert sorted(own) == sorted(sd)
    for k in own:
        if k.endswith("weight_q"):
            assert torch.equal(own[k], sd[k]), k
    blk = qdit.blocks[0]
    for m in (blk.mlp.fc1, blk.mlp.fc2, blk.attn.qkv, blk.attn.proj,
              blk.crossattn.to_q, blk.crossattn.proj):
        assert isinstance(m, QuantDense)
    for m in (blk.crossattn.to_k, blk.crossattn.to_v, blk.adaLN_modulation[1],
              qdit.x_embedder, qdit.final_layer.linear):
        assert isinstance(m, torch.nn.Linear)

    with torch.no_grad():
        got = qdit(torch.from_numpy(x), torch.from_numpy(t).long(),
                   torch.from_numpy(y)).numpy()
        y_t = torch.from_numpy(np.asarray(y_pair))
        got_cfg = qdit.forward_with_cfg_kv(
            torch.from_numpy(x), torch.from_numpy(t).long(),
            qdit.precompute_kv(y_t), 4.0).numpy()
    assert rel_rms(ref, out_f) > 1e-4        # quantization really happened
    assert rel_rms(got, ref) < 1e-3
    assert rel_rms(got_cfg, ref_cfg) < 1e-3
    assert rel_rms(got, out_f) < 2e-2
    assert rel_rms(ref, out_f) < 2e-2
    assert rel_rms(got_cfg, out_f_cfg) < 2e-2
    assert got_cfg.shape == (1, 16, 136) and np.isfinite(got_cfg).all()


def test_forward_with_cfg_kv_matches_fast_path():
    """Stacked [cond; null] K/V and the fast path's null vectors give the
    same guided step (the float DiT)."""
    dit, _ = tiny_dit(seed=22, depth=2, hidden=64, heads=4, seq=16, cond=8)
    rng = np.random.default_rng(23)
    x = torch.from_numpy(rng.standard_normal((2, 16, 68)).astype(np.float32))
    y = torch.from_numpy(rng.standard_normal((2, 5, 8)).astype(np.float32))
    t = torch.tensor([7, 300])
    with torch.no_grad():
        null = dit.null_cond_embedding[None, None, :].expand_as(y)
        pair = dit.forward_with_cfg_kv(
            x, t, dit.precompute_kv(torch.cat([y, null], 0)), 3.0)
        fast = dit.forward_with_cfg_fast(x, t, dit.precompute_kv(y),
                                         dit.precompute_null_out(), 3.0)
    np.testing.assert_allclose(pair.numpy(), fast.numpy(), atol=1e-5, rtol=0)


def _image(img_dir):
    import cv2

    os.makedirs(img_dir)
    img = np.zeros((64, 64, 3), np.uint8)
    cv2.circle(img, (32, 32), 20, (200, 180, 160), -1)
    cv2.imwrite(str(img_dir / "blob.png"), img)


def test_cli_honours_generator_quant(tmp_path):
    from topiaxl_torch.cli.infer import build_models, main
    from topiaxl_torch.core.config import load_config
    from topiaxl_torch.ops.int8 import QuantDense

    img_dir = tmp_path / "imgs"
    _image(img_dir)
    cfg_path = str(_tiny_config(tmp_path, img_dir))
    cfg = load_config(cfg_path, overrides=["model.generator.quant=true"])
    dit, _, _ = build_models(cfg, torch.device("cpu"),
                             torch.Generator().manual_seed(0))
    for blk in dit.blocks:
        for m in (blk.mlp.fc1, blk.mlp.fc2, blk.attn.qkv, blk.attn.proj,
                  blk.crossattn.to_q, blk.crossattn.proj):
            assert isinstance(m, QuantDense)
        assert not isinstance(blk.crossattn.to_k, QuantDense)
        assert not isinstance(blk.crossattn.to_v, QuantDense)

    # a randomised checkpoint: the random init's zero adaLN and final layer
    # would make every block the identity and the W8A8 run equal the float
    fdit, _, _ = build_models(load_config(cfg_path), torch.device("cpu"),
                              torch.Generator().manual_seed(0))
    ckpt = tmp_path / "dit.pt"
    torch.save({"ema": randomize_(fdit, seed=24)}, ckpt)
    tokens = {}
    for tag, extra in (("float", []), ("int8", ["model.generator.quant=true"])):
        args = [cfg_path, "inference.export_glb=false", f"checkpoint_path={ckpt}",
                f"output_dir={tmp_path}/runs/{tag}"] + extra
        assert main(args) == 0
        z = np.load(tmp_path / "runs" / tag / "inference_folder" / "blob"
                    / "denoised.npz")
        tokens[tag] = np.concatenate([z["srt"].ravel(), z["feat"].ravel()])
    assert np.isfinite(tokens["int8"]).all()
    assert np.abs(tokens["int8"] - tokens["float"]).max() > 0
    assert rel_rms(tokens["int8"], tokens["float"]) < 0.5
