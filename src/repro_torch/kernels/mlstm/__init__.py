from repro_torch.kernels.mlstm import kernel, ops, ref  # noqa: F401
