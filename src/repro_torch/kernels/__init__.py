"""Hand-written Hopper kernels, one subpackage each.

* flash_attn -- causal / sliding-window attention, forward and backward
  (CUDA C++)
* lace -- the fused dual-prior logit-adjusted cross-entropy of the split
  boundary, forward (K1) and backward (K2) (CUDA C++)

Each subpackage: kernel.py (the launcher of the compiled kernel),
ops.py (the wrapper the model calls: the plain version on a CPU tensor,
the kernel on a CUDA tensor, with a launch count), ref.py (the plain
PyTorch version). Sources live in ``csrc/`` and are built by
:mod:`repro_torch.kernels.build`.
"""
