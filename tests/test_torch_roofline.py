"""The port's roofline layer (``repro_torch.perf.roofline``) and shape
specs (``repro_torch.launch.input_specs``) against the JAX package's.

Full-size param counts equal the reference's for every assigned arch
(the port's per-layer tree against the reference's stacked one, each with
its own axes); prefill and decode batch and cache specs give the
reference's shapes and dtypes; ``roofline_terms`` and ``model_flops`` are
the reference's formulas at the H100's constants; the collective
accounting and the kernels' work follow their stated conventions.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ASSIGNED_ARCHS, INPUT_SHAPES
from repro.configs import get_config as ref_config
from repro.configs import get_shape as ref_shape
from repro.launch import input_specs as ref_ispec
from repro.perf import roofline as ref_roofline
from repro_torch.configs import get_config, get_shape
from repro_torch.kernels.flash_attn import ops as fops
from repro_torch.kernels.lace import ops as lops
from repro_torch.kernels.mlstm import ops as mops
from repro_torch.launch import input_specs as ispec
from repro_torch.models import transformer as T
from repro_torch.perf import roofline

JAX_DTYPES = {jnp.dtype(jnp.float32): torch.float32,
              jnp.dtype(jnp.bfloat16): torch.bfloat16,
              jnp.dtype(jnp.int32): torch.int32}


def _ref_cache_leaves(rcache):
    out = []
    for key, sub in rcache.items():
        for x in jax.tree.leaves(sub):
            dt = JAX_DTYPES[jnp.dtype(x.dtype)]
            if key == "groups":
                out += [(tuple(x.shape[1:]), dt)] * x.shape[0]
            else:
                out.append((tuple(x.shape), dt))
    return sorted(out, key=str)


def _moe_kw(cfg):
    return dict(top_k=cfg.moe.top_k if cfg.moe else 0,
                num_experts=cfg.moe.num_experts if cfg.moe else 0)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree]


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_param_counts_equal_reference(arch):
    cfg = get_config(arch)
    for C in (0, 16):
        shapes, axes = ispec.param_specs(cfg, C)
        got = roofline.count_params(shapes, axes, **_moe_kw(cfg))
        want = ref_roofline.count_params(
            *ref_ispec.param_specs(ref_config(arch), C), **_moe_kw(cfg))
        assert got["total"] == want["total"]
        assert got["active"] == pytest.approx(want["active"], rel=1e-12)
    # the axes tree matches the port's param tree leaf for leaf
    assert len(_leaves(T.param_axes(cfg))) == len(_leaves(shapes))
    for s, a in zip(_leaves(shapes), _leaves(axes)):
        assert len(s.shape) == len(a)


@pytest.mark.parametrize("arch", ASSIGNED_ARCHS)
def test_serving_specs_equal_reference(arch):
    cfg, rcfg = get_config(arch), ref_config(arch)

    def same(got, want):
        assert sorted(got) == sorted(want)
        for k in want:
            assert tuple(got[k].shape) == tuple(want[k].shape), k
            assert got[k].dtype == JAX_DTYPES[jnp.dtype(want[k].dtype)], k

    for name in INPUT_SHAPES:
        shape, rshape = get_shape(name), ref_shape(name)
        got, axes = ispec.prefill_batch_specs(cfg, shape)
        want, raxes = ref_ispec.prefill_batch_specs(rcfg, rshape)
        same(got, want)
        assert axes == raxes
        got, axes, cache, cache_axes = ispec.decode_batch_specs(cfg, shape)
        want, raxes, rcache, _ = ref_ispec.decode_batch_specs(rcfg, rshape)
        same(got, want)
        assert axes == raxes
        # the reference stacks its scanned groups' caches (G, ...) where
        # the port keeps one per layer: the same leaves, regrouped
        mine = [(tuple(c.shape), c.dtype) for c in _leaves(cache)]
        assert sorted(mine, key=str) == _ref_cache_leaves(rcache)
        assert len(_leaves(cache_axes)) == len(_leaves(cache))


def test_roofline_terms_and_model_flops_are_the_reference_formulas(
        monkeypatch):
    for name, value in (("PEAK_FLOPS", roofline.PEAK_FLOPS),
                        ("HBM_BW", roofline.HBM_BW),
                        ("ICI_BW", roofline.LINK_BW)):
        monkeypatch.setattr(ref_roofline, name, value)
    rng = np.random.default_rng(0)
    for flops, hbm, coll, low in rng.uniform(1e9, 1e16, (20, 4)):
        assert roofline.roofline_terms(flops, hbm, coll, low) == \
            ref_roofline.roofline_terms(flops, hbm, coll, low)
    for mode in ("train", "serve"):
        assert roofline.model_flops(619570176, 8192, mode) == \
            ref_roofline.model_flops(619570176, 8192, mode)
    assert (roofline.PEAK_FLOPS, roofline.PEAK_BY_KIND["tf32"],
            roofline.PEAK_BY_KIND["f32"], roofline.HBM_BW,
            roofline.HBM_BYTES, roofline.LINK_BW) == (
        989e12, 495e12, 67e12, 3.35e12, 80e9, 450e9)


def test_collective_accounting():
    calls = [dict(op="all-reduce", group="all", shape=(10,),
                  dtype="torch.float32", bytes=40, site="a.py:1 f"),
             dict(op="all-reduce", group="all", shape=(10,),
                  dtype="torch.float32", bytes=40, site="a.py:1 f"),
             dict(op="all-gather", group="client", shape=(6, 2),
                  dtype="torch.bfloat16", bytes=24, site="b.py:2 g"),
             dict(op="reduce-scatter", group="inner", shape=(8,),
                  dtype="torch.float32", bytes=32, site="c.py:3 h")]
    c = roofline.collectives_from_calls(calls)
    assert c["all-reduce"] == {"count": 2, "bytes": 2 * 2 * 40}
    assert c["all-gather"] == {"count": 1, "bytes": 24}
    assert c["reduce-scatter"] == {"count": 1, "bytes": 32}
    assert c["total_bytes"] == 160 + 24 + 32 and c["loop_aware"] is True
    rows, total = roofline.collective_breakdown(calls, top=2)
    assert total == 216 and rows[0][0] == 160 and rows[0][-1] == 2
    assert len(rows) == 2


def test_kernel_work_counts():
    # K3: the scored pairs of a window against the mask's count
    for S, window, causal, Skv in ((9, None, True, None), (9, 4, True, None),
                                   (5, None, False, 7), (3, 8, True, None)):
        q = torch.arange(S)[:, None]
        k = torch.arange(Skv or S)[None, :]
        mask = torch.ones(S, Skv or S, dtype=torch.bool)
        if causal:
            mask &= k <= q
        if window is not None:
            mask &= (q - k) < window
        assert fops.scored_pairs(S, window, Skv, causal) == int(mask.sum())
    w = fops.work(2, 9, 4, 2, 16, torch.bfloat16, window=4)
    assert w.flops == {"bf16": 4 * 16 * 30 * 4 * 2}
    assert w.bytes == 2 * (2 * 9 * 4 * 16 + 2 * 9 * 2 * 16) * 2
    # K1 / K2 at the training width: 1 and 4 passes of 2 M d V
    M, d, V = 8192, 1024, 151936
    k1 = lops.work("K1", M, d, V, torch.bfloat16, torch.float32,
                   table_rows=5, id_arrays=1)
    k2 = lops.work("K2", M, d, V, torch.bfloat16, torch.float32,
                   table_rows=5, id_arrays=1)
    assert k1.total_flops == 2 * M * d * V
    assert k2.total_flops == 4 * 2 * M * d * V
    assert k2.bytes - k1.bytes == 4 * (2 * M * d + d * V)
    k5 = lops.work("K5", M, d, V, torch.bfloat16, torch.bfloat16,
                   table_rows=4, id_arrays=1, want_dw=False)
    # z = feats W in bf16 x bf16, df = g W^T with g in float32
    assert k5.flops == {"bf16": 2 * M * d * V, "tf32": 2 * M * d * V}
    # K6 forward from the zero state: one chunk of L tokens, B H = 1
    L, dk, dv = 64, 8, 4
    f = mops.work(1, L, 1, dk, dv, torch.float32, chunk=L)
    assert f.flops == {"tf32": 2 * L * (dk * dv + dk)
                       + L * (L + 1) * (dk + dv)}
    b = mops.work(1, L, 1, dk, dv, torch.bfloat16, chunk=L, backward=True)
    assert set(b.flops) == {"bf16", "tf32"}
    bound, by = roofline.work_bound(k2)
    assert by == "operations" and bound == pytest.approx(
        4 * 2 * M * d * V / 495e12)
