"""The PyTorch port's model against the JAX reference on the CPU.

Same numpy inputs and the same params (converted by
``repro_torch.convert``) through both; float32 throughout, tolerance
2e-5 unless a test says otherwise (sums in another order). Covers the
layers (norms, rope, embeddings, mlp, attention), the configs, and
``forward`` / ``forward_prefill_cached`` (logits and every cache leaf) /
``decode_step`` on the tiny, ring-window and reduced-qwen configs, the
reduced MoE archs (qwen3-moe, dbrx; also ``server_forward``'s router
loss), the reduced gemma3, granite and h2o-danube (the windowed ones
on a prompt past the reduced window of 64), the reduced jamba (mamba
with attention and MoE: every cache leaf, ``conv`` and ``h`` as well as
``k`` and ``v``) and the reduced frontend archs (whisper: learned
positions and cross-attention over a projected audio memory; internvl2:
a projected image prefix before the text, whose cached prefill both
packages refuse), plus prefill == decode inside the port.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import tiny_cfg, tiny_mamba_cfg
from repro import configs as jcfgs
from repro.models import transformer as JT
from repro.models.layers import attention as JA
from repro.models.layers import embeddings as JE
from repro.models.layers import mlp as JM
from repro.models.layers import norms as JN
from repro.models.layers import rope as JR
from repro_torch import configs as tcfgs
from repro_torch import convert
from repro_torch.configs.base import MambaConfig as TMambaConfig
from repro_torch.configs.base import ModelConfig as TModelConfig
from repro_torch.configs.base import MoEConfig as TMoEConfig
from repro_torch.models import transformer as T
from repro_torch.models.layers import attention as A
from repro_torch.models.layers import embeddings as E
from repro_torch.models.layers import mlp as M
from repro_torch.models.layers import norms as N
from repro_torch.models.layers import rope as R

torch.set_num_threads(1)
TOL = dict(atol=2e-5, rtol=2e-5)


def _port_cfg(cfg):
    """The port's ModelConfig with the reference config's fields."""
    moe = cfg.moe and TMoEConfig(**dataclasses.asdict(cfg.moe))
    mamba = cfg.mamba and TMambaConfig(**dataclasses.asdict(cfg.mamba))
    return TModelConfig(**{f.name: getattr(cfg, f.name)
                           for f in dataclasses.fields(cfg)
                           if f.name not in ("moe", "mamba", "xlstm")},
                        moe=moe, mamba=mamba)


def _f32(cfg):
    return dataclasses.replace(cfg, dtype="float32", param_dtype="float32")


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _cache_from_reference(tree, cfg):
    """A reference decode cache {'client', 'prologue', 'groups'} -> the
    port's {'blk{l}': {leaf: tensor}}."""
    layers = convert.per_layer(tree["client"], tree["prologue"],
                               tree["groups"], cfg)
    return {f"blk{l}": {n: convert.to_tensor(a) for n, a in layers[l].items()}
            for l in range(cfg.num_layers)}


def _reduced(arch):
    return lambda: _f32(jcfgs.get_config(arch).reduced())


CONFIGS = {
    "tiny": tiny_cfg,
    "ring": lambda: tiny_cfg(window_pattern=(4,)),
    "qwen-reduced": _reduced("qwen1.5-0.5b"),
    "qwen3-moe-reduced": _reduced("qwen3-moe-30b-a3b"),
    "dbrx-reduced": _reduced("dbrx-132b"),
    "gemma3-reduced": _reduced("gemma3-12b"),
    "granite-reduced": _reduced("granite-3-8b"),
    "danube-reduced": _reduced("h2o-danube-3-4b"),
    "jamba-reduced": _reduced("jamba-1.5-large-398b"),
    "whisper-reduced": _reduced("whisper-tiny"),
    "internvl2-reduced": _reduced("internvl2-26b"),
}
MOE = ("qwen3-moe-reduced", "dbrx-reduced", "jamba-reduced")
# (prompt, cache length) where the default's 10 and 16 are not enough: a
# prompt past the reduced window of 64, so the ring cache wraps
PROMPTS = {"gemma3-reduced": (70, 80), "danube-reduced": (70, 80)}


# --------------------------------------------------------------------------
# configs
# --------------------------------------------------------------------------


def test_registry_and_reduced_dims_match_reference():
    assert tcfgs.list_configs() == jcfgs.list_configs()
    for name in jcfgs.list_configs():
        for j, t in ((jcfgs.get_config(name), tcfgs.get_config(name)),
                     (jcfgs.get_config(name).reduced(),
                      tcfgs.get_config(name).reduced())):
            assert dataclasses.asdict(t) == dataclasses.asdict(j), name
            assert t.group_size == j.group_size
    cfg = tcfgs.get_config("qwen1.5-0.5b")
    assert (cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
            cfg.head_dim, cfg.d_ff, cfg.vocab_size, cfg.qkv_bias,
            cfg.rope_theta) == (24, 1024, 16, 16, 64, 2816, 151936, True,
                                1e6)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_layout_matches_reference(name):
    cfg = CONFIGS[name]()
    assert T._layout(_port_cfg(cfg)) == JT._layout(cfg)


# --------------------------------------------------------------------------
# layers
# --------------------------------------------------------------------------


def test_rms_norm():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 32), np.float32) * 3
    scale = rng.standard_normal(32).astype(np.float32)
    want = JN.rms_norm_apply({"scale": jnp.asarray(scale)}, jnp.asarray(x),
                             1e-6)
    got = N.rms_norm_apply({"scale": _t(scale)}, _t(x), 1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # bf16 in, bf16 out, statistics in f32
    got16 = N.rms_norm_apply({"scale": _t(scale)}, _t(x).bfloat16(), 1e-6)
    want16 = JN.rms_norm_apply({"scale": jnp.asarray(scale)},
                               jnp.asarray(x).astype(jnp.bfloat16), 1e-6)
    assert got16.dtype == torch.bfloat16
    np.testing.assert_allclose(got16.float().numpy(),
                               np.asarray(want16.astype(jnp.float32)),
                               atol=3e-2, rtol=1e-2)


@pytest.mark.parametrize("per_row", [False, True])
def test_rope(per_row):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 6, 2, 16), np.float32)
    pos = (rng.integers(0, 50, (3, 6)) if per_row else np.arange(6)) \
        .astype(np.int32)
    want = JR.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6)
    got = R.apply_rope(_t(x), _t(pos), 1e6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_embeddings_and_head():
    cfg = tiny_cfg()
    rng = np.random.default_rng(2)
    tok = rng.standard_normal((cfg.vocab_size, cfg.d_model), np.float32)
    out = rng.standard_normal((cfg.d_model, cfg.vocab_size), np.float32)
    ids = rng.integers(0, cfg.vocab_size, (2, 7))
    x = JE.embedding_apply({"tok": jnp.asarray(tok)}, jnp.asarray(ids), cfg)
    y = E.embedding_apply({"tok": _t(tok)}, _t(ids), _port_cfg(cfg))
    np.testing.assert_array_equal(y.numpy(), np.asarray(x))
    np.testing.assert_allclose(
        E.head_apply({"out": _t(out)}, y, cfg).numpy(),
        np.asarray(JE.head_apply({"out": jnp.asarray(out)}, x, cfg)), **TOL)


def test_mlp():
    cfg = tiny_cfg()
    p = _np(JM.mlp_init(jax.random.PRNGKey(0), cfg))
    x = np.random.default_rng(3).standard_normal((2, 5, cfg.d_model),
                                                 np.float32)
    want = JM.mlp_apply(p, jnp.asarray(x), cfg)
    got = M.mlp_apply(jax.tree.map(_t, p), _t(x), _port_cfg(cfg))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("window", [None, 3])
@pytest.mark.parametrize("qk_norm", [False, True])
def test_attn_apply_and_decode(window, qk_norm):
    cfg = tiny_cfg(qkv_bias=True, qk_norm=qk_norm)
    pcfg = _port_cfg(cfg)
    p = _np(JA.attn_init(jax.random.PRNGKey(0), cfg))
    p["bq"] = np.random.default_rng(9).standard_normal(p["bq"].shape) \
        .astype(np.float32)
    tp = jax.tree.map(_t, p)
    rng = np.random.default_rng(4)
    B, S = 2, 9
    x = rng.standard_normal((B, S, cfg.d_model), np.float32)
    pos = jnp.arange(S)
    y, (k, v) = JA.attn_apply(p, jnp.asarray(x), cfg, positions=pos,
                              window=window, return_kv=True)
    ty, (tk, tv) = A.attn_apply(tp, _t(x), pcfg, positions=torch.arange(S),
                                window=window, return_kv=True)
    for a, b in ((ty, y), (tk, k), (tv, v)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)

    # decode: each row at its own position, against the reference at B=1
    cache = rng.standard_normal((B, 12, cfg.num_kv_heads, cfg.head_dim),
                                np.float32)
    xt = rng.standard_normal((B, 1, cfg.d_model), np.float32)
    idx = np.array([4, 11])
    tcache = {"k": _t(cache).clone(), "v": _t(cache * 2).clone()}
    ty, tcache = A.attn_decode(tp, _t(xt), tcache, _t(idx), pcfg,
                               window=window)
    for b in range(B):
        jc = {"k": jnp.asarray(cache[b:b + 1]),
              "v": jnp.asarray(cache[b:b + 1] * 2)}
        jy, jc = JA.attn_decode(p, jnp.asarray(xt[b:b + 1]), jc,
                                jnp.int32(idx[b]), cfg, window=window)
        np.testing.assert_allclose(ty[b:b + 1].numpy(), np.asarray(jy), **TOL)
        for name in ("k", "v"):
            np.testing.assert_allclose(tcache[name][b:b + 1].numpy(),
                                       np.asarray(jc[name]), **TOL)


def test_unported_mixers_raise():
    """Every block of the repo's archs builds: whisper's cross-attention
    (with its learned positions and projector), internvl2's projector and
    mamba; a mixer the port lacks is refused at the block."""
    whisper = _port_cfg(jcfgs.get_config("whisper-tiny").reduced())
    params = T.init_params(torch.Generator(), whisper)
    blk = params["server"]["blocks"]["blk1"]
    assert set(blk) == {"norm1", "mixer", "norm_cross", "cross", "norm2",
                        "ffn"}
    assert "q_norm" not in blk["cross"]
    assert set(params["client"]["projector"]) == {"norm", "fc1", "fc2"}
    assert params["client"]["embed"]["pos"].shape == (whisper.max_position,
                                                      whisper.d_model)
    vlm = _port_cfg(jcfgs.get_config("internvl2-26b").reduced())
    assert "projector" in T.init_params(torch.Generator(), vlm)["client"]
    params = T.init_params(torch.Generator(), _port_cfg(tiny_mamba_cfg()))
    assert set(params["client"]["blocks"]["blk0"]["mixer"]) >= {"A_log", "D"}
    with pytest.raises(NotImplementedError, match="mixers"):
        T.init_params(torch.Generator(), _port_cfg(tiny_cfg(
            mixer_pattern=("rwkv",))))


# --------------------------------------------------------------------------
# whole model: forward, fused prefill (+cache), decode
# --------------------------------------------------------------------------


def _setup(name, B=2, P=10, seed=0):
    cfg = CONFIGS[name]()
    params = JT.init_params(jax.random.PRNGKey(seed), cfg)
    prompts = np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, P))
    tparams = convert.params_from_reference(_np(params), _port_cfg(cfg))
    return cfg, params, tparams, prompts


def _frontend_inputs(cfg, B, seed=0):
    """The stub encoder's output a frontend arch's batch carries, drawn
    with numpy (normal x 0.1): {'memory_emb'} (audio), {'prefix_emb'}
    (vision) or {} (text)."""
    key = {"audio": "memory_emb", "vision": "prefix_emb"}.get(cfg.frontend)
    if key is None:
        return {}
    rng = np.random.default_rng([seed, 7])
    return {key: (0.1 * rng.standard_normal(
        (B, cfg.num_prefix_tokens, cfg.frontend_dim))).astype(np.float32)}


def _assert_caches_close(got, want):
    """Every layer's every cache leaf (attention's k, v; mamba's conv, h)
    within TOL."""
    assert got.keys() == want.keys()
    for layer in want:
        assert got[layer].keys() == want[layer].keys(), layer
        for leaf, a in want[layer].items():
            np.testing.assert_allclose(got[layer][leaf].numpy(), a.numpy(),
                                       err_msg=f"{layer}/{leaf}", **TOL)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_forward_prefill_decode_match_reference(name):
    P, max_len = PROMPTS.get(name, (10, 16))
    cfg, params, tparams, prompts = _setup(name, P=P)
    pcfg = _port_cfg(cfg)
    B = prompts.shape[0]
    extra = _frontend_inputs(cfg, B)
    jbatch = {"tokens": jnp.asarray(prompts),
              **{k: jnp.asarray(v) for k, v in extra.items()}}
    tbatch = {"tokens": _t(prompts), **{k: _t(v) for k, v in extra.items()}}

    want, want_aux = jax.jit(JT.forward, static_argnums=2,
                             static_argnames="remat")(
        params, jbatch, cfg, remat=False)
    got = T.forward(tparams, tbatch, pcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # the split halves: the server's router loss (the client's dropped)
    acts = T.client_forward(tparams["client"], tbatch, pcfg)
    assert ("memory" in acts) == (cfg.frontend == "audio")
    got, aux = T.server_forward(tparams["server"], acts, pcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(aux.numpy(), np.asarray(want_aux), **TOL)
    assert (float(aux) > 0) == (name in MOE)

    if cfg.frontend == "vision":
        # both packages refuse a cached prefill behind an image prefix;
        # decode runs on the text alone from empty caches
        with pytest.raises(NotImplementedError, match="vision"):
            JT.forward_prefill_cached(params, jbatch, cfg, max_len)
        with pytest.raises(NotImplementedError, match="vision"):
            T.forward_prefill_cached(tparams, tbatch, pcfg, max_len)
        jcache = JT.init_decode_cache(cfg, B, max_len)
        tcache = T.init_decode_cache(pcfg, B, max_len)
        P = 0
    else:
        jl, jcache = jax.jit(JT.forward_prefill_cached,
                             static_argnums=(2, 3))(params, jbatch, cfg,
                                                    max_len)
        tl, tcache = T.forward_prefill_cached(tparams, tbatch, pcfg, max_len)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        _assert_caches_close(tcache, _cache_from_reference(_np(jcache), pcfg))

    # three decode steps from the prefilled caches, shared index (an
    # audio arch's memory re-projected each step)
    nxt = np.random.default_rng(1).integers(0, cfg.vocab_size, (B, 3))
    decode = jax.jit(JT.decode_step, static_argnums=4)
    for i in range(3):
        jl, jcache = decode(params,
                            {**jbatch, "tokens": jnp.asarray(nxt[:, i:i + 1])},
                            jcache, jnp.int32(P + i), cfg)
        tl, tcache = T.decode_step(tparams,
                                   {**tbatch, "tokens": _t(nxt[:, i:i + 1])},
                                   tcache, P + i, pcfg)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    _assert_caches_close(tcache, _cache_from_reference(_np(jcache), pcfg))


@pytest.mark.parametrize("name", ["tiny", "ring", "jamba-reduced",
                                  "whisper-reduced"])
def test_prefill_matches_decode_in_port(name):
    """The fused prefill (flash path; mamba's chunked scan) == the
    token-by-token decode loop (dense-attend path; the one-step
    recurrence; whisper's cross-attention over the same memory in both),
    logits and every cache leaf."""
    cfg, _, tparams, prompts = _setup(name, P=9)
    pcfg = _port_cfg(cfg)
    B, P, max_len = prompts.shape + (16,)
    ttoks = _t(prompts)
    extra = {k: _t(v) for k, v in _frontend_inputs(cfg, B).items()}
    logits_f, cache_f = T.forward_prefill_cached(
        tparams, {"tokens": ttoks, **extra}, pcfg, max_len)
    cache = T.init_decode_cache(pcfg, B, max_len)
    for i in range(P):
        lg, cache = T.decode_step(tparams,
                                  {"tokens": ttoks[:, i:i + 1], **extra},
                                  cache, i, pcfg)
    np.testing.assert_allclose(logits_f.numpy(), lg.numpy(), **TOL)
    _assert_caches_close(cache_f, cache)


def test_per_row_decode_matches_single_rows():
    """A batched decode with per-row positions == each row alone: what
    the engine's one-call slot step relies on."""
    cfg, _, tparams, prompts = _setup("ring", B=3, P=6)
    pcfg = _port_cfg(cfg)
    idx = torch.tensor([2, 5, 7])
    gen = np.random.default_rng(5)
    cache = T.init_decode_cache(pcfg, 3, 8)
    for layer in cache.values():
        for leaf in ("k", "v"):
            layer[leaf].copy_(torch.from_numpy(
                gen.standard_normal(layer[leaf].shape).astype(np.float32)))
    solo = [{l: {n: c[n][b:b + 1].clone() for n in c} for l, c in cache.items()}
            for b in range(3)]
    tok = _t(prompts[:, :1])
    lg, cache = T.decode_step(tparams, {"tokens": tok}, cache, idx, pcfg)
    for b in range(3):
        lb, cb = T.decode_step(tparams, {"tokens": tok[b:b + 1]}, solo[b],
                               int(idx[b]), pcfg)
        np.testing.assert_allclose(lg[b:b + 1].numpy(), lb.numpy(), **TOL)
        _assert_caches_close(
            {l: {n: t[b:b + 1] for n, t in c.items()}
             for l, c in cache.items()}, cb)
