"""The port's mamba mixer against the JAX reference on the CPU.

The same numpy inputs and params (the reference's, converted) through
``repro.models.layers.mamba`` and ``repro_torch.models.layers.mamba``,
float32, on the reduced jamba-1.5-large-398b (d_model 256, d_inner 512,
d_state 16) and ``tests/helpers.py:tiny_mamba_cfg``: the init's leaf
shapes and dtypes (float32 SSM leaves under a bf16 ``param_dtype``);
``mamba_apply`` and ``mamba_prefill`` (y, the conv tail, the final state)
below one chunk, at one chunk, with a ragged last chunk and past two
chunks, within ``TOL``; the chunked scan against a per-step loop in
float64; three decode steps from the prefill cache; and autograd of
``mamba_apply`` against ``jax.grad`` of the reference's.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import tiny_mamba_cfg
from repro.configs import get_config
from repro.models.layers import mamba as JMB
from repro_torch.configs.base import MambaConfig as TMambaConfig
from repro_torch.configs.base import ModelConfig as TModelConfig
from repro_torch.models.layers import mamba as MB

torch.set_num_threads(1)
TOL = dict(atol=2e-5, rtol=2e-5)
GRAD_RTOL = 1e-5
SCAN_ATOL = 1e-6

CONFIGS = {
    "jamba-reduced": lambda: get_config("jamba-1.5-large-398b").reduced(),
    "tiny": tiny_mamba_cfg,
}


def _port_cfg(cfg):
    return TModelConfig(**{f.name: getattr(cfg, f.name)
                           for f in dataclasses.fields(cfg)
                           if f.name not in ("moe", "mamba", "xlstm")},
                        mamba=TMambaConfig(**dataclasses.asdict(cfg.mamba)))


# the reference's functions compiled once a shape (its op-by-op dispatch
# would cost most of this file's time)
_init = jax.jit(JMB.mamba_init, static_argnums=1)
_prefill = jax.jit(JMB.mamba_prefill, static_argnums=(2, 3))
_decode = jax.jit(JMB.mamba_decode, static_argnums=3)


@functools.lru_cache(maxsize=None)
def _reference_params(name):
    cfg = CONFIGS[name]()
    return cfg, jax.tree.map(np.asarray, _init(jax.random.PRNGKey(0), cfg))


def _setup(name):
    cfg, params = _reference_params(name)
    return cfg, params, {k: torch.tensor(v) for k, v in params.items()}


def _x(cfg, B, S, seed=1):
    return np.random.default_rng(seed).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)


@pytest.mark.parametrize("name", list(CONFIGS))
@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_init_leaves_match_reference(name, param_dtype):
    cfg = dataclasses.replace(CONFIGS[name](), param_dtype=param_dtype)
    want = jax.eval_shape(functools.partial(JMB.mamba_init, cfg=cfg),
                          jax.random.PRNGKey(0))
    gen = torch.Generator()
    gen.manual_seed(0)
    got = MB.mamba_init(gen, _port_cfg(cfg))
    assert got.keys() == want.keys()
    for k, a in want.items():
        assert tuple(got[k].shape) == a.shape, k
        assert str(got[k].dtype)[6:] == str(a.dtype), k
    for k in ("conv_w", "conv_b", "dt_proj", "dt_bias", "A_log", "D"):
        assert got[k].dtype == torch.float32, k
    # the reference's fixed leaves (A_log to the ulp: two libraries' log);
    # dt_bias the inverse softplus of a dt in [1e-3, 1e-1]
    di, N = want["A_log"].shape
    fixed = {"conv_b": np.zeros(di), "D": np.ones(di),
             "A_log": np.log(np.broadcast_to(np.arange(1, N + 1), (di, N)))}
    for k, a in fixed.items():
        np.testing.assert_allclose(got[k].numpy(), a, rtol=1e-7, atol=0)
    dt = torch.nn.functional.softplus(got["dt_bias"])
    assert 1e-3 * (1 - 1e-5) <= dt.min() and dt.max() <= 0.1 * (1 + 1e-5)


@pytest.mark.parametrize("name", list(CONFIGS))
@pytest.mark.parametrize("S", [10, 64, 77, 130])
def test_apply_and_prefill_match_reference(name, S):
    cfg, params, tparams = _setup(name)
    pcfg = _port_cfg(cfg)
    x = _x(cfg, 2, S)
    # the reference's apply is its prefill's math without the cache
    jy, jcache = _prefill(params, jnp.asarray(x), cfg, jnp.float32)
    got = MB.mamba_apply(tparams, torch.from_numpy(x), pcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(jy), **TOL)
    ty, tcache = MB.mamba_prefill(tparams, torch.from_numpy(x), pcfg,
                                  torch.float32)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    assert tcache.keys() == jcache.keys() == {"conv", "h"}
    for k in tcache:
        assert tcache[k].dtype == torch.float32
        np.testing.assert_allclose(tcache[k].numpy(), np.asarray(jcache[k]),
                                   err_msg=k, **TOL)


def test_scan_matches_per_step_loop_in_float64():
    """The chunked doubling scan (a ragged third chunk, a nonzero start)
    against h_t = exp(dt_t A) h_{t-1} + u_t B_t stepped one token at a
    time, y_t = h_t . C_t, all in float64; decays down to exp(-16 x 2)."""
    rng = np.random.default_rng(0)
    B, S, di, N = 2, 150, 6, 5
    f64 = lambda *shape: torch.from_numpy(rng.standard_normal(shape))
    dt = torch.from_numpy(rng.uniform(1e-3, 2.0, (B, S, di)))
    A = -torch.arange(1, N + 1, dtype=torch.float64).expand(di, N) \
        * torch.from_numpy(rng.uniform(0.5, 3.2, (di, 1)))
    u, Bm, Cm, h0 = f64(B, S, di), f64(B, S, N), f64(B, S, N), f64(B, di, N)
    y, h = MB._scan_chunked(dt, A, u, Bm, Cm, h0)
    want, hh = [], h0
    for t in range(S):
        hh = torch.exp(dt[:, t, :, None] * A) * hh \
            + u[:, t, :, None] * Bm[:, t, None, :]
        want.append((hh * Cm[:, t, None, :]).sum(-1))
    assert y.dtype == torch.float64
    np.testing.assert_allclose(y.numpy(), torch.stack(want, 1).numpy(),
                               rtol=0, atol=SCAN_ATOL)
    np.testing.assert_allclose(h.numpy(), hh.numpy(), rtol=0,
                               atol=SCAN_ATOL)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_decode_from_prefill_matches_reference(name):
    cfg, params, tparams = _setup(name)
    pcfg = _port_cfg(cfg)
    x = _x(cfg, 2, 13)
    steps = _x(cfg, 2, 3, seed=2)
    _, jcache = _prefill(params, jnp.asarray(x), cfg, jnp.float32)
    _, tcache = MB.mamba_prefill(tparams, torch.from_numpy(x), pcfg,
                                 torch.float32)
    for i in range(3):
        jy, jcache = _decode(params, jnp.asarray(steps[:, i:i + 1]), jcache,
                             cfg)
        ty, tcache = MB.mamba_decode(tparams,
                                     torch.from_numpy(steps[:, i:i + 1]),
                                     tcache, pcfg)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
        for k in ("conv", "h"):
            np.testing.assert_allclose(tcache[k].numpy(),
                                       np.asarray(jcache[k]),
                                       err_msg=f"step {i} {k}", **TOL)
    # a fresh cache is the zero state the full-sequence pass starts from
    fresh = MB.init_cache(pcfg, 2, torch.bfloat16)
    assert fresh["conv"].dtype == torch.bfloat16
    assert fresh["h"].dtype == torch.float32
    assert not any(t.any() for t in fresh.values())


@pytest.mark.parametrize("name", list(CONFIGS))
def test_grad_matches_jax_grad(name):
    """Autograd of the port's ``mamba_apply`` (through the chunked scan,
    77 tokens: a ragged second chunk) against ``jax.grad`` of the
    reference's, every param leaf and x within 1e-5 of its largest
    entry."""
    cfg, params, _ = _setup(name)
    pcfg = _port_cfg(cfg)
    x = _x(cfg, 2, 77)
    w = np.random.default_rng(3).standard_normal(x.shape).astype(np.float32)

    def jloss(p, x):
        return (JMB.mamba_apply(p, x, cfg) * w).sum()

    want = jax.jit(jax.grad(jloss, argnums=(0, 1)))(
        jax.tree.map(jnp.asarray, params), jnp.asarray(x))
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    tx = torch.tensor(x, requires_grad=True)
    (MB.mamba_apply(tp, tx, pcfg) * torch.from_numpy(w)).sum().backward()
    pairs = [(k, tp[k].grad, want[0][k]) for k in params] + [
        ("x", tx.grad, want[1])]
    for k, got, ref in pairs:
        ref = np.asarray(ref)
        err = np.abs(got.numpy() - ref).max() / np.abs(ref).max()
        assert err <= GRAD_RTOL, f"{k}: {err}"
