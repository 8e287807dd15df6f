"""The port's CUDA kernels against their plain versions, on a card.

Marked ``gpu``: without a CUDA device every test skips (the kernels have
no CPU mode). Imports only torch and the port, so it runs on a machine
without JAX:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attn import ops, ref


def _qkv(seed, B, S, H, KV, hd, dtype):
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.standard_normal(shape, np.float32))
                 .to("cuda", dtype)
                 for shape in ((B, S, H, hd), (B, S, KV, hd), (B, S, KV, hd)))


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,H,KV,hd,window,dtype", [
    (1, 128, 16, 16, 64, None, torch.bfloat16),
    (1, 777, 16, 16, 64, None, torch.float32),
    (1, 333, 16, 2, 64, None, torch.bfloat16),      # GQA
    (1, 1024, 16, 16, 64, 256, torch.bfloat16),     # sliding window
    (2, 200, 3, 3, 32, 7, torch.bfloat16),          # odd window, ragged S
    (2, 96, 2, 1, 16, None, torch.bfloat16),
    (1, 64, 2, 2, 8, None, torch.bfloat16),         # hd 8: CUDA-core body
    (2, 200, 3, 3, 16, 7, torch.float32),
])
def test_flash_kernel_matches_plain(B, S, H, KV, hd, window, dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    # bf16: the output is rounded to bf16; f32: sums in another order
    tol = {torch.float32: 1e-4, torch.bfloat16: 3e-2}[dtype]
    q, k, v = _qkv(S + hd, B, S, H, KV, hd, dtype)
    before = ops.LAUNCHES
    got = ops.flash_attention(q, k, v, causal=True, window=window)
    torch.cuda.synchronize()
    assert ops.LAUNCHES == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    want = ref.mha_ref(q, k, v, causal=True, window=window)
    err = (got.float() - want.float()).abs().max().item()
    assert err <= tol, err
