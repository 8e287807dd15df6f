"""The PyTorch port stands alone: no ``jax`` and nothing of ``repro``.

Every ``repro_torch`` module imports in a fresh interpreter in which
``jax`` cannot be imported, and leaves no ``jax`` or ``repro`` module
loaded; and no source line of the port or of ``chip_smoke.py`` imports
either.
"""
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")
PORT = os.path.join(SRC, "repro_torch")

_PROBE = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None          # any import of jax now raises
import repro_torch
names = ["repro_torch"] + [m.name for m in pkgutil.walk_packages(
    repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(n for n, m in sys.modules.items() if m is not None and (
    n == "jax" or n.startswith("jax.") or n == "repro" or
    n.startswith("repro.")))
print(len(names), "modules;", "loaded:", bad)
assert not bad, bad
"""


def test_every_module_imports_without_jax():
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run([sys.executable, "-c", _PROBE], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert int(out.stdout.split()[0]) >= 20, out.stdout


_FORBIDDEN = re.compile(
    r"^\s*(import\s+(jax|repro)\b(?!_torch)|from\s+(jax|repro)(\.|\s))",
    re.MULTILINE)


def _sources():
    for d, _, files in os.walk(PORT):
        for f in files:
            if f.endswith((".py", ".cu", ".cuh")):
                yield os.path.join(d, f)
    yield os.path.join(ROOT, "chip_smoke.py")


def test_no_source_imports_jax_or_repro():
    offenders = []
    for path in _sources():
        with open(path) as f:
            for m in _FORBIDDEN.finditer(f.read()):
                offenders.append(f"{os.path.relpath(path, ROOT)}: "
                                 f"{m.group(0).strip()}")
    assert not offenders, offenders
    assert _FORBIDDEN.search("import jax.numpy as jnp")
    assert _FORBIDDEN.search("from repro.models import blocks")
    assert not _FORBIDDEN.search("from repro_torch.models import blocks")
