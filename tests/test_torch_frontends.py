"""The frontend archs' layers in the PyTorch port against the JAX reference
on the CPU.

Same numpy inputs and the same params (the reference's init, converted
with numpy) through both, float32 at 2e-5 unless a test says otherwise:

* ``layer_norm`` (float32 statistics; bf16 in, bf16 out at 3e-2);
* the projector (layer norm, fc1, tanh-gelu, fc2), and its grads against
  ``jax.grad`` at 2e-5 of each leaf's largest entry;
* learned positions (the ``pos`` rows added at the given positions);
* ``cross_attn_apply`` (GQA, biases, a memory of a ragged length), and
  the grads of its params, its queries and its memory against
  ``jax.grad``;
* K3's plain version in its non-causal mode, ``Skv != S`` (one query, a
  ragged key count, more queries than keys), against the reference's
  Pallas kernel in interpret mode with ``causal=False`` and its
  ``mha_ref``, f32 at 2e-5 and bf16 at 3e-2 (a bf16-rounded output), and
  its dq, dk, dv against ``jax.grad`` of ``mha_ref``.

The Hopper kernel's non-causal mode is held against the plain version on
a card by ``tests/test_torch_gpu.py`` and ``chip_smoke.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import tiny_cfg
from repro.kernels.flash_attn.kernel import flash_attention_pallas
from repro.kernels.flash_attn.ref import mha_ref as jax_mha_ref
from repro.models.layers import attention as JA
from repro.models.layers import embeddings as JE
from repro.models.layers import frontends as JF
from repro.models.layers import norms as JN
from repro_torch.configs.base import ModelConfig as TModelConfig
from repro_torch.kernels.flash_attn import ops, ref
from repro_torch.models.layers import attention as A
from repro_torch.models.layers import embeddings as E
from repro_torch.models.layers import frontends as F
from repro_torch.models.layers import norms as N

torch.set_num_threads(1)
TOL = dict(atol=2e-5, rtol=2e-5)
GRAD_RTOL = 2e-5


def _port_cfg(cfg):
    return TModelConfig(**{f.name: getattr(cfg, f.name)
                           for f in dataclasses.fields(cfg)
                           if f.name not in ("moe", "mamba", "xlstm")})


def _t(a):
    return torch.from_numpy(np.array(a))


def _tree_t(tree):
    return jax.tree.map(lambda a: _t(a).requires_grad_(), tree)


def _close_rel(got, want, what):
    """|got - want| within GRAD_RTOL of want's largest entry."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(np.abs(want).max(), 1e-12)
    err = np.abs(got - want).max()
    assert err <= GRAD_RTOL * scale, (what, err, scale)


def _frontend_cfg(**kw):
    return tiny_cfg(frontend="audio", frontend_dim=24, num_prefix_tokens=13,
                    **kw)


# --------------------------------------------------------------------------
# layer norm, projector, learned positions
# --------------------------------------------------------------------------


def test_layer_norm():
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((2, 5, 24)) * 3 + 1.5).astype(np.float32)
    p = {"scale": rng.standard_normal(24).astype(np.float32),
         "bias": rng.standard_normal(24).astype(np.float32)}
    jp = jax.tree.map(jnp.asarray, p)
    tp = jax.tree.map(_t, p)
    want = JN.layer_norm_apply(jp, jnp.asarray(x))
    got = N.layer_norm_apply(tp, _t(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    init = N.layer_norm_init(24)
    ref_init = JN.layer_norm_init(24)
    for k in ("scale", "bias"):
        np.testing.assert_array_equal(init[k].numpy(),
                                      np.asarray(ref_init[k]))
    # bf16 in, bf16 out, statistics in f32
    got16 = N.layer_norm_apply(tp, _t(x).bfloat16())
    want16 = JN.layer_norm_apply(jp, jnp.asarray(x).astype(jnp.bfloat16))
    assert got16.dtype == torch.bfloat16
    np.testing.assert_allclose(got16.float().numpy(),
                               np.asarray(want16.astype(jnp.float32)),
                               atol=3e-2, rtol=1e-2)


def test_projector_and_its_grads():
    cfg = _frontend_cfg()
    p = jax.tree.map(np.asarray, JF.projector_init(jax.random.PRNGKey(0),
                                                   cfg))
    rng = np.random.default_rng(1)
    p["norm"]["bias"] = rng.standard_normal(24).astype(np.float32)
    emb = (0.5 * rng.standard_normal((2, 13, 24))).astype(np.float32)
    ct = rng.standard_normal((2, 13, cfg.d_model)).astype(np.float32)

    def jloss(params):
        out = JF.projector_apply(params, jnp.asarray(emb), cfg)
        return jnp.sum(out * ct), out

    (_, want), jg = jax.value_and_grad(jloss, has_aux=True)(
        jax.tree.map(jnp.asarray, p))
    tp = _tree_t(p)
    got = F.projector_apply(tp, _t(emb), _port_cfg(cfg))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    got.backward(_t(ct))
    for path, g in (("norm/scale", jg["norm"]["scale"]),
                    ("norm/bias", jg["norm"]["bias"]),
                    ("fc1", jg["fc1"]), ("fc2", jg["fc2"])):
        node = tp
        for k in path.split("/"):
            node = node[k]
        _close_rel(node.grad.numpy(), g, path)
    # the port's init: the reference's shapes and dtypes
    ti = F.projector_init(torch.Generator(), _port_cfg(cfg))
    assert jax.tree.map(lambda a: a.shape, jax.tree.map(np.asarray, p)) == \
        jax.tree.map(lambda a: tuple(a.shape), ti)


def test_learned_positions():
    cfg = _frontend_cfg(pos_embed="learned", max_position=40)
    rng = np.random.default_rng(2)
    tok = rng.standard_normal((cfg.vocab_size, cfg.d_model)).astype(
        np.float32)
    pos = rng.standard_normal((40, cfg.d_model)).astype(np.float32)
    ids = rng.integers(0, cfg.vocab_size, (2, 7))
    positions = np.arange(3, 10)[None, :]
    want = JE.embedding_apply({"tok": jnp.asarray(tok),
                               "pos": jnp.asarray(pos)}, jnp.asarray(ids),
                              cfg, positions=jnp.asarray(positions))
    got = E.embedding_apply({"tok": _t(tok), "pos": _t(pos)}, _t(ids),
                            _port_cfg(cfg), positions=_t(positions))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    ti = E.embedding_init(torch.Generator(), _port_cfg(cfg))
    assert tuple(ti["pos"].shape) == (40, cfg.d_model)
    with pytest.raises(ValueError, match="positions"):
        E.embedding_apply({"tok": _t(tok), "pos": _t(pos)}, _t(ids),
                          _port_cfg(cfg))


# --------------------------------------------------------------------------
# cross-attention
# --------------------------------------------------------------------------


@pytest.mark.parametrize("S", [1, 9])
def test_cross_attn_apply_and_grads(S):
    """One decode query or a prompt's 9 against a memory of 13 rows (GQA
    2:1, biases, a q/k norm in the config that cross-attention leaves
    out): the output, and the grads of the params, x and the memory."""
    cfg = _frontend_cfg(qkv_bias=True, qk_norm=True)
    p = jax.tree.map(np.asarray, JA.attn_init(jax.random.PRNGKey(0), cfg,
                                              cross=True))
    assert "q_norm" not in p
    rng = np.random.default_rng(3)
    for b in ("bq", "bk", "bv"):
        p[b] = rng.standard_normal(p[b].shape).astype(np.float32)
    x = rng.standard_normal((2, S, cfg.d_model)).astype(np.float32)
    mem = rng.standard_normal((2, 13, cfg.d_model)).astype(np.float32)
    ct = rng.standard_normal((2, S, cfg.d_model)).astype(np.float32)

    def jloss(params, x, mem):
        out = JA.cross_attn_apply(params, x, mem, cfg)
        return jnp.sum(out * ct), out

    (_, want), jg = jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                       has_aux=True)(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x), jnp.asarray(mem))
    tp, tx, tm = _tree_t(p), _t(x).requires_grad_(), _t(mem).requires_grad_()
    got = A.cross_attn_apply(tp, tx, tm, _port_cfg(cfg))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    got.backward(_t(ct))
    for k in p:
        if k == "bk":
            # zero in exact arithmetic (a key bias adds one constant to
            # each query's scores, which the softmax ignores): both sides
            # hold rounding noise, held at wk's gradient's scale
            scale = np.abs(np.asarray(jg[0]["wk"])).max()
            assert np.abs(tp[k].grad.numpy()).max() <= GRAD_RTOL * scale
            assert np.abs(np.asarray(jg[0][k])).max() <= GRAD_RTOL * scale
            continue
        _close_rel(tp[k].grad.numpy(), jg[0][k], k)
    _close_rel(tx.grad.numpy(), jg[1], "x")
    _close_rel(tm.grad.numpy(), jg[2], "memory")
    ti = A.attn_init(torch.Generator(), _port_cfg(cfg), cross=True)
    assert set(ti) == set(p)


# --------------------------------------------------------------------------
# K3's plain version, non-causal over Skv != S keys
# --------------------------------------------------------------------------

# (B, S, Skv, H, KV, hd, qb, kb): one query on a ragged memory (a decode
# step's cross-attention), a prompt on a ragged memory across two key
# blocks, more queries than keys, GQA
NONCAUSAL = [(2, 1, 37, 2, 2, 16, 16, 16),
             (1, 9, 150, 2, 1, 16, 16, 64),
             (1, 70, 13, 1, 1, 8, 32, 16),
             (2, 16, 40, 4, 2, 32, 16, 16)]
DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 3e-2)}


def _qkv(B, S, Skv, H, KV, hd, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, S, H, hd)).astype(np.float32),
            rng.standard_normal((B, Skv, KV, hd)).astype(np.float32),
            rng.standard_normal((B, Skv, KV, hd)).astype(np.float32))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", NONCAUSAL)
def test_noncausal_plain_matches_pallas_and_mha_ref(case, dtype):
    B, S, Skv, H, KV, hd, qb, kb = case
    jdt, tdt, tol = DTYPES[dtype]
    q, k, v = _qkv(B, S, Skv, H, KV, hd, seed=sum(case))
    reps = H // KV
    kr, vr = (np.repeat(a, reps, axis=2) for a in (k, v))
    # the reference's layouts: (BH, S, hd) with kv repeated to H heads
    flat = lambda a: jnp.asarray(a).astype(jdt).transpose(0, 2, 1, 3) \
        .reshape(-1, a.shape[1], hd)                                # noqa
    pallas = flash_attention_pallas(flat(q), flat(kr), flat(vr),
                                    causal=False, qb=qb, kb=kb,
                                    interpret=True)
    pallas = np.asarray(pallas.astype(jnp.float32)).reshape(
        B, H, S, hd).transpose(0, 2, 1, 3)
    want = np.asarray(jax_mha_ref(*(jnp.asarray(a).astype(jdt)
                                    for a in (q, kr, vr)),
                                  causal=False).astype(jnp.float32))
    before = ops.LAUNCHES
    got = ops.flash_attention(*(_t(a).to(tdt) for a in (q, k, v)),
                              causal=False)
    assert ops.LAUNCHES == before             # a CPU tensor launches nothing
    assert got.dtype == tdt and got.shape == (B, S, H, hd)
    got = got.float().numpy()
    np.testing.assert_allclose(got, pallas, atol=tol, rtol=tol)
    np.testing.assert_allclose(got, want, atol=tol, rtol=tol)
    np.testing.assert_allclose(
        ref.mha_ref(*(_t(a) for a in (q, k, v)), causal=False).numpy(),
        np.asarray(jax_mha_ref(*(jnp.asarray(a) for a in (q, kr, vr)),
                               causal=False)), **TOL)


@pytest.mark.parametrize("case", NONCAUSAL)
def test_noncausal_plain_grads_match_jax_grad(case):
    B, S, Skv, H, KV, hd, _, _ = case
    q, k, v = _qkv(B, S, Skv, H, KV, hd, seed=sum(case) + 1)
    ct = np.random.default_rng(sum(case)).standard_normal(
        (B, S, H, hd)).astype(np.float32)
    reps = H // KV

    def jloss(q, k, v):
        out = jax_mha_ref(q, jnp.repeat(k, reps, axis=2),
                          jnp.repeat(v, reps, axis=2), causal=False)
        return jnp.sum(out * ct)

    jg = jax.grad(jloss, argnums=(0, 1, 2))(*(jnp.asarray(a)
                                              for a in (q, k, v)))
    tq, tk, tv = (_t(a).requires_grad_() for a in (q, k, v))
    out = ops.flash_attention(tq, tk, tv, causal=False)
    out.backward(_t(ct))
    for name, g, w in (("dq", tq.grad, jg[0]), ("dk", tk.grad, jg[1]),
                       ("dv", tv.grad, jg[2])):
        _close_rel(g.numpy(), w, name)
