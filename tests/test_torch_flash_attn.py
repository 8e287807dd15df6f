"""K3 flash attention in the PyTorch port.

* the plain version (what a CPU tensor gets) against the reference's
  Pallas kernel in interpret mode and against its ``mha_ref``, over the
  reference's own shape sweep (padded S, windows, block > seq), f32 at
  2e-5 and bf16 at 3e-2 (bf16-rounded output);
* the GQA wrapper against the reference's ``flash_attention`` wrapper;
* the device rule: a CPU tensor launches nothing, other devices raise;
* gradients: on a CPU tensor the output carries a ``grad_fn``, and dq,
  dk, dv of the plain version match ``jax.grad`` of the reference's
  ``mha_ref`` (GQA and windows included), f32 at 2e-5 of the largest
  entry.

The Hopper kernel itself is held against the plain version on a card by
``tests/test_torch_gpu.py``.
"""
import jax
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
    # meta tensors get the shape function; a mix of devices raises
    with pytest.raises(ValueError, match="CPU or CUDA"):
        ops.flash_attention(q.to("meta"), k, v.to("meta"))
    out = ops.flash_attention(q.to("meta"), k.to("meta"), v.to("meta"))
    assert out.device.type == "meta" and out.shape == q.shape
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernel.flash_attention_cuda(q, k, v)


def test_output_carries_grad_fn():
    q, k, v = (torch.from_numpy(x).requires_grad_()
               for x in _qkv(0, 1, 8, 2, 2, 8))
    out = ops.flash_attention(q, k, v, causal=True)
    assert out.grad_fn is not None
    out.sum().backward()
    assert all(t.grad is not None for t in (q, k, v))
    with torch.no_grad():
        assert ops.flash_attention(q, k, v).grad_fn is None


@pytest.mark.parametrize("B,S,H,KV,hd,window", [
    (2, 40, 4, 4, 16, None),
    (1, 33, 4, 2, 8, None),       # GQA
    (2, 48, 2, 1, 16, 7),         # GQA + window
])
def test_gradients_match_reference(B, S, H, KV, hd, window):
    q, k, v = _qkv(S + H, B, S, H, KV, hd)
    g = np.random.default_rng(7).standard_normal((B, S, H, hd)).astype(
        np.float32)

    def jloss(q, k, v):
        reps = H // KV
        kk, vv = (jnp.repeat(x, reps, axis=2) for x in (k, v))
        out = jax_mha_ref(q, kk, vv, causal=True, window=window)
        return jnp.sum(out * g)

    want = jax.grad(jloss, argnums=(0, 1, 2))(*(jnp.asarray(x)
                                                for x in (q, k, v)))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = ops.flash_attention(tq, tk, tv, causal=True, window=window)
    got = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(g))
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b,
                                   atol=2e-5 * np.abs(b).max(), err_msg=name)


@pytest.mark.parametrize("make,want", [
    (lambda: torch.zeros((2, 33, 4, 64), dtype=torch.bfloat16), True),
    # q, k, v as head slices of one fused projection
    (lambda: torch.zeros((2, 33, 8, 64), dtype=torch.bfloat16)[:, :, 4:6],
     True),
    # a length-1 axis's stride is never read
    (lambda: torch.zeros((1, 40, 2, 8), dtype=torch.bfloat16)
     .as_strided((1, 40, 2, 8), (3, 16, 8, 1)), True),
    # a start 2 bytes past a 16-byte boundary
    (lambda: torch.zeros(4 * 64 + 8, dtype=torch.bfloat16)[1:4 * 64 + 1]
     .view(1, 4, 1, 64), False),
    # a row stride of 68 elements
    (lambda: torch.zeros((1, 4, 2, 68), dtype=torch.bfloat16)[..., :64],
     False),
    # a head slice that starts 4 elements into the row
    (lambda: torch.zeros((1, 4, 2, 68), dtype=torch.bfloat16)
     .view(1, 4, 136)[..., 4:132].view(1, 4, 2, 64), False),
])
def test_bf16_alignment_rule(make, want):
    """The 16-byte rule the bf16 kernels' cp.async copies need, decided on
    the tensor's start and strides alone (so the CPU can hold it)."""
    t = make()
    assert kernel.aligned(t) is want
