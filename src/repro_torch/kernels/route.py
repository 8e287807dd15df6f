"""Which implementation a kernel call site runs, from its tensors' device.

  ==================  ===============================================
  inputs              what runs
  ==================  ===============================================
  CPU tensors         the kernel's plain version
  CUDA tensors        the kernel, or an exception
  ``meta`` tensors    the kernel's shape function: outputs (and, through
                      its autograd function, gradients) on ``meta`` with
                      the kernel's shapes and dtypes; no launch is
                      counted
  anything else, or   raises
  a mix of devices
  ==================  ===============================================
"""
from __future__ import annotations


def device_kind(what: str, tensors) -> str:
    """``"cpu"``, ``"cuda"`` or ``"meta"``: the one device type of
    ``tensors`` (None entries skipped); raises on any other or a mix."""
    kinds = {t.device.type for t in tensors if t is not None}
    if len(kinds) == 1 and kinds <= {"cpu", "cuda", "meta"}:
        return kinds.pop()
    raise ValueError(f"{what} takes CPU or CUDA (or meta) tensors on one "
                     f"device, got {sorted(kinds)}")
