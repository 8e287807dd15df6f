from repro_torch.kernels.lace import kernel, ops, ref  # noqa: F401
