"""The xLSTM layers of the PyTorch port against the reference's.

On ``tests/helpers.py:tiny_xlstm_cfg`` with the reference's parameters
converted: the depthwise causal convolution (with and without the
previous inputs), the mLSTM block's full-sequence pass, fused prefill
with its decode cache, per-step decode and ``mlstm_step``, and the same
for sLSTM; then ``convert.params_from_reference`` on xlstm-1.3b's own
layout (48 layers, groups of 8, split 2, prologue layers 2-7, 5 scan
groups) at narrow widths, through the whole model's logits. Float32
throughout: a layer within 2e-5 (sums in another order; the reference
shrinks the mLSTM chunk to 1 for an odd length, where the port masks the
ragged chunk), the 48-layer logits within 2e-3 (of logits up to 3).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import tiny_xlstm_cfg
from repro.configs import get_config
from repro.models import transformer as JT
from repro.models.layers import mamba as jmamba
from repro.models.layers import xlstm as jxlstm
from repro_torch import convert
from repro_torch.configs.base import ModelConfig as TModelConfig
from repro_torch.configs.base import XLSTMConfig as TXLSTMConfig
from repro_torch.models import transformer as T
from repro_torch.models.layers import mamba, xlstm

torch.set_num_threads(1)
TOL = dict(rtol=2e-5, atol=2e-5)


def _port_cfg(cfg):
    """The port's ModelConfig with the reference config's fields."""
    fields = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)
              if f.name not in ("moe", "mamba", "xlstm")}
    return TModelConfig(**fields, xlstm=TXLSTMConfig(
        **dataclasses.asdict(cfg.xlstm)))


def _tree(params):
    return convert._map(lambda a: convert.to_tensor(np.asarray(a)), params)


def _close(got, want, tol=TOL):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for key in want:
            _close(got[key], want[key], tol)
    else:
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   **tol)


def _x(seed, B, S, d):
    return np.random.default_rng(seed).standard_normal((B, S, d), np.float32)


@pytest.mark.parametrize("with_prev", [False, True])
def test_causal_conv(with_prev):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 7, 12), np.float32)
    w = rng.standard_normal((4, 12), np.float32)
    b = rng.standard_normal((12,), np.float32)
    prev = rng.standard_normal((2, 3, 12), np.float32) if with_prev else None
    want_y, want_tail = jmamba._causal_conv(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
        prev=None if prev is None else jnp.asarray(prev))
    got_y, got_tail = mamba._causal_conv(
        torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b),
        prev=None if prev is None else torch.from_numpy(prev))
    _close(got_y, want_y)
    _close(got_tail, want_tail)


@pytest.mark.parametrize("S", [16, 13])
def test_mlstm_block(S):
    cfg = tiny_xlstm_cfg()
    pcfg = _port_cfg(cfg)
    jp = jxlstm.mlstm_init(jax.random.PRNGKey(0), cfg)
    tp = _tree(jp)
    x = _x(S, 2, S, cfg.d_model)
    _close(xlstm.mlstm_apply(tp, torch.from_numpy(x), pcfg),
           jxlstm.mlstm_apply(jp, jnp.asarray(x), cfg))
    jy, jcache = jxlstm.mlstm_prefill(jp, jnp.asarray(x), cfg, jnp.float32)
    ty, tcache = xlstm.mlstm_prefill(tp, torch.from_numpy(x), pcfg,
                                     torch.float32)
    _close(ty, jy)
    _close(tcache, jcache)
    # three decode steps continue from the prefill cache
    nxt = _x(S + 1, 2, 3, cfg.d_model)
    for t in range(3):
        jy, jcache = jxlstm.mlstm_decode(jp, jnp.asarray(nxt[:, t:t + 1]),
                                         jcache, cfg)
        ty, tcache = xlstm.mlstm_decode(tp, torch.from_numpy(nxt[:, t:t + 1]),
                                        tcache, pcfg)
        _close(ty, jy)
        _close(tcache, jcache)
    assert xlstm.mlstm_init_cache(pcfg, 2, torch.float32)["C"].shape == \
        jxlstm.mlstm_init_cache(cfg, 2, jnp.float32)["C"].shape


def test_mlstm_step():
    rng = np.random.default_rng(1)
    B, H, hd = 2, 3, 8
    q, k, v = (rng.standard_normal((B, H, hd), np.float32) for _ in range(3))
    i_raw, f_raw, m = (rng.standard_normal((B, H), np.float32)
                       for _ in range(3))
    f_log = np.array(jax.nn.log_sigmoid(f_raw))
    C = rng.standard_normal((B, H, hd, hd), np.float32)
    n = rng.standard_normal((B, H, hd), np.float32)
    args = (q, k, v, i_raw, f_log)
    jh, jstate = jxlstm.mlstm_step(*map(jnp.asarray, args),
                                   tuple(map(jnp.asarray, (C, n, m))))
    th, tstate = xlstm.mlstm_step(*map(torch.from_numpy, args),
                                  tuple(map(torch.from_numpy, (C, n, m))))
    _close(th, jh)
    for got, want in zip(tstate, jstate):
        _close(got, want)


def test_slstm_block():
    cfg = tiny_xlstm_cfg()
    pcfg = _port_cfg(cfg)
    jp = jxlstm.slstm_init(jax.random.PRNGKey(1), cfg)
    tp = _tree(jp)
    x = _x(3, 2, 11, cfg.d_model)
    _close(xlstm.slstm_apply(tp, torch.from_numpy(x), pcfg),
           jxlstm.slstm_apply(jp, jnp.asarray(x), cfg))
    jy, jcache = jxlstm.slstm_prefill(jp, jnp.asarray(x), cfg)
    ty, tcache = xlstm.slstm_prefill(tp, torch.from_numpy(x), pcfg)
    _close(ty, jy)
    _close(tcache, jcache)
    nxt = _x(4, 2, 3, cfg.d_model)
    for t in range(3):
        jy, jcache = jxlstm.slstm_decode(jp, jnp.asarray(nxt[:, t:t + 1]),
                                         jcache, cfg)
        ty, tcache = xlstm.slstm_decode(tp, torch.from_numpy(nxt[:, t:t + 1]),
                                        tcache, pcfg)
        _close(ty, jy)
        _close(tcache, jcache)
    # one cell from a nonzero state
    rng = np.random.default_rng(5)
    d = cfg.d_model
    gx = rng.standard_normal((2, 4 * d), np.float32)
    state = tuple(rng.standard_normal((2, d), np.float32) for _ in range(4))
    want = jxlstm.slstm_cell(jnp.asarray(gx), tuple(map(jnp.asarray, state)),
                             jp["r_gates"])
    got = xlstm.slstm_cell(torch.from_numpy(gx),
                           tuple(map(torch.from_numpy, state)),
                           tp["r_gates"])
    for g, w in zip(got, want):
        _close(g, w)


def test_convert_xlstm_layout():
    """xlstm-1.3b's 48-layer pattern at narrow widths: the converted
    params put every layer where its spec says, and the whole model's
    logits match the reference's."""
    cfg = get_config("xlstm-1.3b").reduced(num_layers=48, d_model=32,
                                           vocab_size=64)
    pcfg = _port_cfg(cfg)
    assert JT._layout(cfg) == ([0, 1], [2, 3, 4, 5, 6, 7], 8, 5)
    assert T._layout(pcfg) == JT._layout(cfg)
    jp = JT.init_params(jax.random.PRNGKey(0), cfg)
    tp = convert.params_from_reference(jax.tree.map(np.asarray, jp), pcfg)
    mixers = [pcfg.block_spec(l).mixer for l in range(48)]
    assert mixers.count("mlstm") == 42 and mixers.count("slstm") == 6
    for l, spec, p in T._layers(tp, pcfg):
        assert ("r_gates" in p["mixer"]) == (spec.mixer == "slstm"), l
        assert "ffn" not in p
    # layer 11 is the 4th block (an sLSTM) of scan group 0, layer 43 the
    # 4th of group 4
    groups = jp["server"]["groups"]
    for l, g in ((11, 0), (43, 4)):
        np.testing.assert_array_equal(
            tp["server"]["blocks"][f"blk{l}"]["mixer"]["r_gates"].numpy(),
            np.asarray(groups["blk3"]["mixer"]["r_gates"][g]))
    toks = np.random.default_rng(0).integers(0, 64, (1, 9))
    want, _ = JT.forward(jp, {"tokens": jnp.asarray(toks)}, cfg, remat=False)
    got = T.forward(tp, {"tokens": torch.as_tensor(toks)}, pcfg)
    # 48 random layers amplify float32 rounding: the reference's own
    # forward and token-by-token decode differ by 7.4e-4 on this model
    _close(got, want, dict(rtol=0, atol=2e-3))
