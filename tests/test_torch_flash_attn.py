"""K3 flash attention in the PyTorch port.

* the plain version (what a CPU tensor gets) against the reference's
  Pallas kernel in interpret mode and against its ``mha_ref``, over the
  reference's own shape sweep (padded S, windows, block > seq), f32 at
  2e-5 and bf16 at 3e-2 (bf16-rounded output);
* the GQA wrapper against the reference's ``flash_attention`` wrapper;
* the device rule: a CPU tensor launches nothing, other devices raise.

The Hopper kernel itself is held against the plain version on a card by
``tests/test_torch_gpu.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attn.kernel import flash_attention_pallas
from repro.kernels.flash_attn.ops import flash_attention as jax_flash_attention
from repro.kernels.flash_attn.ref import mha_ref as jax_mha_ref
from repro_torch.kernels.flash_attn import kernel, ops

torch.set_num_threads(1)

FLASH_SHAPES = [
    # (B, S, H, hd, qb, kb, window), as in tests/test_kernels.py
    (1, 128, 2, 16, 64, 64, None),
    (2, 200, 3, 32, 64, 64, None),     # padded seq
    (2, 256, 2, 16, 64, 64, 32),       # window smaller than seq
    (1, 96, 1, 8, 32, 32, 7),          # odd window
    (1, 64, 2, 16, 128, 128, None),    # block bigger than seq
]
DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 3e-2)}


def _qkv(seed, B, S, H, KV, hd):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, S, H, hd), np.float32),
            rng.standard_normal((B, S, KV, hd), np.float32),
            rng.standard_normal((B, S, KV, hd), np.float32))


def _bhsd(x):
    B, S, H, hd = x.shape
    return x.transpose(0, 2, 1, 3).reshape(B * H, S, hd)


@pytest.mark.parametrize("B,S,H,hd,qb,kb,window", FLASH_SHAPES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_plain_matches_pallas_and_mha_ref(B, S, H, hd, qb, kb, window,
                                          dtype):
    jdt, tdt, tol = DTYPES[dtype]
    q, k, v = _qkv(S + (window or 0), B, S, H, H, hd)
    jq, jk, jv = (jnp.asarray(x).astype(jdt) for x in (q, k, v))
    pallas = flash_attention_pallas(_bhsd(jq), _bhsd(jk), _bhsd(jv),
                                    causal=True, window=window, qb=qb, kb=kb,
                                    interpret=True)
    pallas = np.asarray(pallas.astype(jnp.float32)).reshape(
        B, H, S, hd).transpose(0, 2, 1, 3)
    want = np.asarray(jax_mha_ref(*(x.astype(jnp.float32)
                                    for x in (jq, jk, jv)),
                                  causal=True, window=window))

    before = ops.LAUNCHES
    got = ops.flash_attention(*(torch.from_numpy(x).to(tdt)
                                for x in (q, k, v)),
                              causal=True, window=window)
    assert ops.LAUNCHES == before          # a CPU tensor launches nothing
    assert got.dtype == tdt and got.shape == (B, S, H, hd)
    got = got.float().numpy()
    np.testing.assert_allclose(got, pallas, atol=tol, rtol=tol)
    np.testing.assert_allclose(got, want, atol=tol, rtol=tol)


@pytest.mark.parametrize("window", [None, 5])
def test_gqa_wrapper_matches_reference(window):
    B, S, H, KV, hd = 2, 64, 4, 2, 16
    q, k, v = _qkv(0, B, S, H, KV, hd)
    want = np.asarray(jax_flash_attention(
        *(jnp.asarray(x) for x in (q, k, v)), causal=True, window=window,
        interpret=True))
    got = ops.flash_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                              causal=True, window=window).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)


def test_other_devices_raise():
    q, k, v = (torch.from_numpy(x) for x in _qkv(0, 1, 8, 2, 2, 8))
    with pytest.raises(ValueError, match="CPU or CUDA"):
        ops.flash_attention(q.to("meta"), k.to("meta"), v.to("meta"))
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernel.flash_attention_cuda(q, k, v)
