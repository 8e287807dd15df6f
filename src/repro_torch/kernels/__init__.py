"""Hand-written Hopper kernels, one subpackage each.

* flash_attn -- causal / sliding-window attention, forward and backward
  (CUDA C++)
* lace -- the logit-adjusted cross-entropy of the split boundary: the
  fused dual-prior forward (K1) and backward (K2), and the single-prior
  forward (K4) and backward (K5) of the dual boundary (CUDA C++)
* mlstm -- the chunkwise mLSTM forward of xLSTM (K6, CUDA C++), with the
  initial and final (C, n, m) state

Each subpackage: kernel.py (the launcher of the compiled kernel),
ops.py (the wrapper the model calls: the plain version on a CPU tensor,
the kernel on a CUDA tensor, with a launch count), ref.py (the plain
PyTorch version). Sources live in ``csrc/`` and are built by
:mod:`repro_torch.kernels.build`.
"""
