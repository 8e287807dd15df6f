"""SCALA in PyTorch: the serving path of :mod:`repro` ported to CUDA.

The package mirrors ``src/repro/`` path for path and imports nothing of
it. Entry points run on ``cuda`` unless the caller passes
``device="cpu"``; on a CUDA tensor every kernel wrapper launches its
hand-written kernel or raises, on a CPU tensor it runs the kernel's
plain PyTorch version.
"""
