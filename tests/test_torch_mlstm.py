"""K6, the chunkwise mLSTM, in the PyTorch port.

* the plain chunkwise version (what a CPU tensor gets) and the port's
  step-by-step oracle against the reference's ``mlstm_ref`` and its
  Pallas kernel in interpret mode, over the reference's shape sweep plus
  S < L, S a multiple of L and an odd S (where the reference's chunk falls
  to L = 1 and the port masks a ragged last chunk instead);
* the batched wrapper against the reference's ``mlstm_chunkwise``;
* h and the final (C, n, m) against the reference's
  ``xlstm.mlstm_chunk``, from zero and from a nonzero state;
* the device rule: a CPU tensor launches nothing, other devices raise;
* bf16 q, k, v (what the served bf16 model passes, uncast): the plain
  version and the model's mLSTM layer give bitwise what their float32
  copies give, with h in float32, and the port matches the reference on
  the float32-cast values.

Float32 throughout (bf16 inputs beside their float32 copies). The
chunkwise form sums in another order than the
step-by-step recurrence: h within 2e-4 (the reference's own tolerance
for its kernel against ``mlstm_ref``); the port against the reference's
same function within 2e-5. The Hopper kernel itself is held against the
plain version on a card by ``tests/test_torch_gpu.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.mlstm.kernel import mlstm_chunk_pallas
from repro.kernels.mlstm.ops import mlstm_chunkwise as jax_mlstm_chunkwise
from repro.kernels.mlstm.ref import mlstm_ref as jax_mlstm_ref
from repro.models.layers import xlstm as jxlstm
from repro_torch.kernels.mlstm import kernel, ops, ref

torch.set_num_threads(1)
ORACLE_TOL = dict(rtol=2e-4, atol=2e-4)
SAME_TOL = dict(rtol=2e-5, atol=2e-5)

MLSTM_SHAPES = [
    # (S, dk, dv, chunk): the reference's sweep (tests/test_kernels.py) ...
    (64, 16, 16, 16),
    (96, 8, 24, 32),
    (128, 32, 32, 64),
    (60, 16, 16, 64),
    # ... then S < L, S a multiple of L, an odd S (ragged last chunk)
    (5, 8, 8, 8),
    (24, 8, 16, 8),
    (13, 16, 8, 8),
]


def _inputs(seed, shape, dk, dv):
    """q, k, v, i_raw, f_log over ``shape`` (leading axes), numpy f32."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal(shape + (dk,), np.float32) * 0.3
    k = rng.standard_normal(shape + (dk,), np.float32) * 0.3
    v = rng.standard_normal(shape + (dv,), np.float32)
    i_raw = rng.standard_normal(shape, np.float32)
    f_log = np.asarray(jax.nn.log_sigmoid(
        rng.standard_normal(shape, np.float32) + 2.0))
    return q, k, v, i_raw, f_log


def _t(*arrays):
    return tuple(torch.from_numpy(np.array(a)) for a in arrays)


@pytest.mark.parametrize("S,dk,dv,chunk", MLSTM_SHAPES)
def test_plain_matches_reference_oracle_and_kernel(S, dk, dv, chunk):
    q, k, v, i_raw, f_log = _inputs(S + dk, (S,), dk, dv)
    want = np.asarray(jax_mlstm_ref(*map(jnp.asarray,
                                         (q, k, v, i_raw, f_log))))
    pallas = np.asarray(mlstm_chunk_pallas(
        *map(jnp.asarray, (q, k, v, i_raw, f_log)), chunk=chunk,
        interpret=True))
    tq, tk, tv, ti, tf = _t(q, k, v, i_raw, f_log)
    h, _ = ref.mlstm_chunk_plain(tq[None, :, None], tk[None, :, None],
                                 tv[None, :, None], ti[None, :, None],
                                 tf[None, :, None], chunk=chunk)
    assert h.shape == (1, S, 1, dv) and h.dtype == torch.float32
    np.testing.assert_allclose(h[0, :, 0].numpy(), want, **ORACLE_TOL)
    np.testing.assert_allclose(h[0, :, 0].numpy(), pallas, **ORACLE_TOL)
    np.testing.assert_allclose(ref.mlstm_ref(tq, tk, tv, ti, tf).numpy(),
                               want, **SAME_TOL)


@pytest.mark.parametrize("S,chunk", [(32, 16), (29, 8)])
def test_wrapper_matches_reference_batched_heads(S, chunk):
    B, H, hd = 2, 3, 8
    q, k, v, i_raw, f_log = _inputs(7, (B, S, H), hd, hd)
    want = np.asarray(jax_mlstm_chunkwise(
        *map(jnp.asarray, (q, k, v, i_raw, f_log)), chunk=chunk,
        interpret=True))
    before = ops.LAUNCHES
    h, (C, n, m) = ops.mlstm_chunkwise(*_t(q, k, v, i_raw, f_log),
                                       chunk=chunk)
    assert ops.LAUNCHES == before          # a CPU tensor launches nothing
    assert (C.shape, n.shape, m.shape) == ((B, H, hd, hd), (B, H, hd),
                                           (B, H))
    np.testing.assert_allclose(h.numpy(), want, **ORACLE_TOL)


@pytest.mark.parametrize("S,chunk,zero", [(24, 8, True), (13, 8, True),
                                          (13, 8, False), (5, 64, False)])
def test_final_state_matches_reference_mlstm_chunk(S, chunk, zero):
    """h and (C, n, m) against ``xlstm.mlstm_chunk`` (which shrinks the
    chunk to 1 for S = 13; the port masks the ragged chunk)."""
    B, H, hd = 2, 2, 16
    q, k, v, i_raw, f_log = _inputs(S, (B, S, H), hd, hd)
    rng = np.random.default_rng(S + 100)
    state = (np.zeros((B, H, hd, hd), np.float32),
             np.zeros((B, H, hd), np.float32), np.zeros((B, H), np.float32))
    if not zero:
        state = (rng.standard_normal(state[0].shape, np.float32),
                 rng.standard_normal(state[1].shape, np.float32),
                 rng.standard_normal(state[2].shape, np.float32))
    jh, jstate = jxlstm.mlstm_chunk(
        *map(jnp.asarray, (q, k, v, i_raw, f_log)),
        tuple(map(jnp.asarray, state)), chunk)
    h, tstate = ops.mlstm_chunkwise(*_t(q, k, v, i_raw, f_log), _t(*state),
                                    chunk=chunk)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), **SAME_TOL)
    for got, want in zip(tstate, jstate):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **SAME_TOL)


def test_device_rule():
    q, k, v, i_raw, f_log = _t(*_inputs(0, (1, 8, 1), 8, 8))
    with pytest.raises(ValueError, match="CPU or CUDA"):
        ops.mlstm_chunkwise(q.to("meta"), k, v, i_raw, f_log)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernel.mlstm_chunk_cuda(q, k, v, i_raw, f_log)
    # the plain version keeps q's dtype for h, and computes in float32
    h, (C, _, _) = ops.mlstm_chunkwise(q.double(), k, v, i_raw, f_log)
    assert h.dtype == torch.float64 and C.dtype == torch.float32


@pytest.mark.parametrize("S,chunk", [(24, 8), (13, 8), (70, 64)])
def test_bf16_operands_are_their_float32_copies(S, chunk):
    """bf16 q, k, v (what the served bf16 model passes): the plain version
    gives bitwise the h and final state of their float32 copies, with h in
    float32, and matches the reference's ``xlstm.mlstm_chunk`` on the
    float32-cast values within SAME_TOL."""
    B, H, hd = 2, 2, 16
    q, k, v, i_raw, f_log = _inputs(S + 3, (B, S, H), hd, hd)
    tq, tk, tv, ti, tf = _t(q, k, v, i_raw, f_log)
    qb, kb, vb = (x.bfloat16() for x in (tq, tk, tv))
    h, state = ops.mlstm_chunkwise(qb, kb, vb, ti, tf, chunk=chunk)
    h32, state32 = ops.mlstm_chunkwise(qb.float(), kb.float(), vb.float(),
                                       ti, tf, chunk=chunk)
    assert h.dtype == torch.float32
    assert torch.equal(h, h32)
    for a, b in zip(state, state32):
        assert torch.equal(a, b)
    zero = (np.zeros((B, H, hd, hd), np.float32),
            np.zeros((B, H, hd), np.float32), np.zeros((B, H), np.float32))
    jh, jstate = jxlstm.mlstm_chunk(
        *map(jnp.asarray, (qb.float().numpy(), kb.float().numpy(),
                           vb.float().numpy(), i_raw, f_log)),
        tuple(map(jnp.asarray, zero)), chunk)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), **SAME_TOL)
    for got, want in zip(state, jstate):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **SAME_TOL)


def test_bf16_model_passes_qkv_uncast(monkeypatch):
    """xlstm.py's ``mlstm_apply`` and ``mlstm_prefill`` in bf16 hand q, k, v
    to ``mlstm_chunkwise`` in bf16, uncast; casting them to float32 first
    (the route before) gives bitwise the same output and cache."""
    from repro_torch.configs import get_config
    from repro_torch.models.layers import xlstm

    cfg = dataclasses.replace(get_config("xlstm-1.3b").reduced(),
                              dtype="bfloat16", param_dtype="bfloat16")
    params = xlstm.mlstm_init(torch.Generator().manual_seed(4), cfg)
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (2, 77, cfg.d_model), np.float32)).bfloat16()
    seen = []
    plain = ops.mlstm_chunkwise

    def recorded(q, k, v, *args, **kw):
        seen.append((q.dtype, k.dtype, v.dtype))
        return plain(q, k, v, *args, **kw)

    def cast_first(q, k, v, *args, **kw):
        return plain(q.float(), k.float(), v.float(), *args, **kw)

    runs = []
    for fn in (recorded, cast_first):
        monkeypatch.setattr(xlstm.mlstm_ops, "mlstm_chunkwise", fn)
        with torch.no_grad():
            runs.append((xlstm.mlstm_apply(params, x, cfg),
                         xlstm.mlstm_prefill(params, x, cfg, torch.bfloat16)))
    assert seen == [(torch.bfloat16,) * 3] * 2
    (y, (yp, cache)), (y32, (yp32, cache32)) = runs
    assert y.dtype == torch.bfloat16
    assert torch.equal(y, y32) and torch.equal(yp, yp32)
    assert set(cache) == set(cache32)
    for key in cache:
        assert torch.equal(cache[key], cache32[key]), key
