"""The port's MoE FFN against the JAX reference on the CPU.

The same numpy inputs and params through ``repro.models.layers.moe`` and
``repro_torch.models.layers.moe``, float32. ``y`` must agree within 1e-5
of its largest entry (sums in another order) and the router loss within
1e-6: ample capacity, a tight one (the same (token, k) pairs dropped),
the serving prefill's dropless capacity (short, and long enough that the
port reads the exact slab size back from the device), a (4, 1, d) decode
batch and a router skewed onto one expert (ties among the rest, broken
toward the lower expert id as ``jax.lax.top_k`` does). The port also
matches ``tests/test_moe.py``'s brute force with ample capacity.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import tiny_moe_cfg
from repro.models.layers import moe as JM
from repro_torch.configs.base import ModelConfig as TModelConfig
from repro_torch.configs.base import MoEConfig as TMoEConfig
from repro_torch.models import blocks as TB
from repro_torch.models.layers import moe as M
from test_moe import _brute_force

torch.set_num_threads(1)
Y_RTOL, AUX_ATOL = 1e-5, 1e-6


def _port_cfg(cfg):
    return TModelConfig(**{f.name: getattr(cfg, f.name)
                           for f in dataclasses.fields(cfg)
                           if f.name not in ("moe", "mamba", "xlstm")},
                        moe=TMoEConfig(**dataclasses.asdict(cfg.moe)))


def _with_cf(cfg, cf):
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cf))


def _params(cfg, seed=0):
    return jax.tree.map(np.asarray, JM.moe_init(jax.random.PRNGKey(seed), cfg))


def _skewed(params, cfg, x):
    """Every token onto expert 0 (the reference test's skew): a router of
    100 x eye and inputs 10 on the first feature."""
    params = dict(params, router=(np.eye(cfg.d_model, cfg.moe.num_experts)
                                  * 100).astype(np.float32))
    x0 = np.zeros_like(x)
    x0[..., 0] = 10.0
    return params, x0


# (capacity factor, or 'dropless' for the serving prefill's; x shape;
#  skewed router)
CASES = {
    "ample": (2.0, (2, 16), False),
    "tight": (0.25, (1, 32), False),
    "dropless": ("dropless", (2, 16), False),
    "dropless-long": ("dropless", (1, 160), False),
    "decode": (None, (4, 1), False),
    "skewed": (2.0, (2, 64), True),
}


def _run(case):
    cf, lead, skew = CASES[case]
    cfg = tiny_moe_cfg()
    if cf == "dropless":
        pcfg = TB._dropless(_port_cfg(cfg))
        cfg = _with_cf(cfg, float(cfg.moe.num_experts))
        assert pcfg.moe.capacity_factor == cfg.moe.capacity_factor
    else:
        cfg = _with_cf(cfg, cf) if cf is not None else cfg
        pcfg = _port_cfg(cfg)
    params = _params(cfg)
    x = np.random.default_rng(1).standard_normal(
        lead + (cfg.d_model,)).astype(np.float32)
    if skew:
        params, x = _skewed(params, cfg, x)
    want_y, want_aux = JM.moe_apply(params, jnp.asarray(x), cfg)
    got_y, got_aux = M.moe_apply(
        {k: torch.from_numpy(v.copy()) for k, v in params.items()},
        torch.from_numpy(x), pcfg)
    return cfg, params, x, np.asarray(want_y), float(want_aux), \
        got_y.numpy(), float(got_aux)


@pytest.mark.parametrize("case", list(CASES))
def test_moe_apply_matches_reference(case):
    cfg, params, x, want_y, want_aux, got_y, got_aux = _run(case)
    assert got_y.shape == x.shape
    scale = np.abs(want_y).max()
    assert scale > 0
    np.testing.assert_allclose(got_y, want_y, rtol=0,
                               atol=Y_RTOL * scale)
    assert abs(got_aux - want_aux) <= AUX_ATOL
    if case == "tight":
        # capacity 0.25 drops pairs: the brute force (nothing dropped)
        # differs, and the port dropped the same ones as the reference
        ample = np.asarray(_brute_force(params, jnp.asarray(x), cfg))
        assert np.abs(ample - want_y).max() > 1e-2 * scale
        dropped_rows = np.abs(ample - want_y).max(-1) > 1e-4 * scale
        assert dropped_rows.any()
        np.testing.assert_array_equal(
            np.abs(ample - got_y).max(-1) > 1e-4 * scale, dropped_rows)
    if case == "skewed":
        assert got_aux > cfg.moe.router_aux_weight


def test_moe_matches_brute_force_with_ample_capacity():
    cfg = tiny_moe_cfg()
    params = _params(cfg)
    x = np.asarray(jax.random.normal(jax.random.PRNGKey(1),
                                     (2, 16, cfg.d_model)))
    want = np.asarray(_brute_force(params, jnp.asarray(x), cfg))
    got, aux = M.moe_apply(
        {k: torch.from_numpy(v.copy()) for k, v in params.items()},
        torch.from_numpy(x.copy()), _port_cfg(cfg))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)
    assert np.isfinite(float(aux))


def test_moe_init_shapes_and_dtypes():
    cfg = dataclasses.replace(_port_cfg(tiny_moe_cfg()),
                              param_dtype="bfloat16")
    gen = torch.Generator()
    gen.manual_seed(0)
    p = M.moe_init(gen, cfg)
    d, E, f = cfg.d_model, cfg.moe.num_experts, cfg.moe.d_expert
    assert {k: (tuple(v.shape), v.dtype) for k, v in p.items()} == {
        "router": ((d, E), torch.float32),
        "gate": ((E, d, f), torch.bfloat16),
        "up": ((E, d, f), torch.bfloat16),
        "down": ((E, f, d), torch.bfloat16)}
    # capacity: the reference's formula, at least one
    for n in (1, 7, 32):
        assert M.capacity(n, cfg.moe) == JM.capacity(n, tiny_moe_cfg().moe)
