"""The port's dry run (``repro_torch.launch.dryrun``) on reduced archs.

Each (arch, mode) is traced on ``meta`` and then run on CPU tensors of the
same shapes under the same counting mode: FLOPs, bytes and the kernels'
charged work are exactly equal (the kernel call sites charge their work
whichever implementation runs), the argument bytes equal the CPU
tensors', the outputs' shapes and dtypes equal, and no kernel launch is
counted. The recording grid's collectives for a ``(data=2, model=1)``
``lace_dp`` step equal ``Grid.stats`` of the same step over gloo on two
CPU ranks (``tests/torch_dryrun_worker.py``).
"""
import os
import subprocess
import sys

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import InputShape
from repro_torch.kernels.flash_attn import ops as fops
from repro_torch.kernels.lace import ops as lops
from repro_torch.kernels.mlstm import ops as mops
from repro_torch.launch.dryrun import (build_step, count_step, dryrun_one,
                                      realize)
from repro_torch.sharding.grid import RecordingGrid
from repro_torch.tree import leaves

ROOT = os.path.join(os.path.dirname(__file__), "..")
WORKER = os.path.join(os.path.dirname(__file__), "torch_dryrun_worker.py")
ARCHS = ("qwen1.5-0.5b", "qwen3-moe-30b-a3b", "xlstm-1.3b", "whisper-tiny")
SHAPES = {"train": InputShape("t", 16, 2, "train"),
          "prefill": InputShape("p", 24, 2, "prefill"),
          "decode": InputShape("d", 32, 2, "decode")}
# one period of xLSTM's 7:1 pattern at half the reduced width (its plain
# chunkwise backward dominates the CPU side)
OVERRIDES = {"xlstm-1.3b": dict(num_layers=8, d_model=128, head_dim=32)}
KEYS = {"arch", "shape", "mesh", "status", "mode", "sharding_profile",
        "tokens", "chips", "flops_per_device", "bytes_per_device",
        "collectives", "memory", "fits_hbm", "roofline", "params_total",
        "params_active", "model_flops_global", "model_flops_per_device",
        "useful_flops_ratio", "trace_s", "layout", "peaks"}


def _launches():
    return (fops.LAUNCHES, fops.LAUNCHES_BWD, lops.LAUNCHES_FWD,
            lops.LAUNCHES_BWD, lops.LAUNCHES_FWD1, lops.LAUNCHES_BWD1,
            mops.LAUNCHES, mops.LAUNCHES_BWD)


def _shapes(out):
    return [(tuple(t.shape), t.dtype) for t in leaves(out)
            if isinstance(t, torch.Tensor)]


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mode", sorted(SHAPES))
def test_meta_counts_equal_cpu_counts(arch, mode):
    cfg = get_config(arch).reduced(**OVERRIDES.get(arch, {}))
    shape = SHAPES[mode]
    before = _launches()
    rec = dryrun_one(arch, shape.name, cfg=cfg, shape=shape, num_clients=2)
    assert rec["status"] == "ok", rec.get("traceback")
    assert KEYS <= set(rec) and rec["layout"] == "replica"
    mem = rec["memory"]
    assert set(mem) == {"argument_bytes", "output_bytes", "temp_bytes",
                        "peak_bytes"}
    assert mem["peak_bytes"] >= mem["argument_bytes"] > 0
    step, args, _, cfg = build_step(arch, shape.name, cfg=cfg, shape=shape,
                                    num_clients=2)
    meta_out, meta = count_step(step, args)
    real = realize(args, cfg.vocab_size)
    cpu_out, cpu = count_step(step, real)
    assert meta["flops"] == cpu["flops"] == rec["flops_per_device"]
    assert meta["bytes"] == cpu["bytes"] == rec["bytes_per_device"]
    assert meta["kernels"] == cpu["kernels"]
    assert meta["memory"]["argument_bytes"] == sum(
        t.nbytes for t in leaves(real)) == mem["argument_bytes"]
    assert _shapes(meta_out) == _shapes(cpu_out)
    assert all(t.device.type == "meta" for t in leaves(meta_out)
               if isinstance(t, torch.Tensor))
    assert _launches() == before
    # a kernel was charged on every path that has one (decode attends
    # outside the kernels, but for whisper's cross-attention)
    assert bool(meta["kernels"]) == (mode != "decode"
                                     or arch == "whisper-tiny")


def test_meta_and_cpu_mix_raises():
    q = torch.zeros(1, 8, 2, 16)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        fops.flash_attention(q.to("meta"), q, q.to("meta"))
    x = torch.zeros(1, 8, 2, 16)
    gates = torch.zeros(1, 8, 2)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        mops.mlstm_chunkwise(x.to("meta"), x, x, gates, gates)


def test_recording_grid_takes_meta_only():
    grid = RecordingGrid(("data", "model"), (2, 1))
    t = torch.zeros(3, device="meta")
    assert grid.all_reduce(t, "client") is t
    assert grid.all_gather(t, "client").shape == (6,)
    assert [c["op"] for c in grid.calls] == ["all-reduce", "all-gather"]
    assert grid.stats["client"] == {"calls": 2, "bytes": 3 * 4 + 6 * 4}
    with pytest.raises(ValueError, match="meta"):
        grid.all_reduce(torch.zeros(3))


def test_recording_grid_log_equals_gloo_stats(tmp_path):
    """The lace_dp step of reduced qwen1.5-0.5b on a (data=2, model=1)
    grid: the recording grid's calls and bytes per group against the
    stats of the same step over gloo on two CPU ranks."""
    out = tmp_path / "stats.pt"
    init = f"file://{tmp_path / 'rendezvous'}"
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, WORKER, str(r), "2", init, str(out)], cwd=ROOT,
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(2)]
    try:
        errs = [p.communicate(timeout=300)[1] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"rank {r}: {errs[r][-3000:]}"
    gloo = torch.load(out, weights_only=False)
    grid = RecordingGrid(("data", "model"), (2, 1))
    cfg = get_config("qwen1.5-0.5b").reduced()
    step, args, meta, _ = build_step("qwen1.5-0.5b", "t", grid, cfg=cfg,
                                     shape=SHAPES["train"], num_clients=2)
    count_step(step, args)
    assert meta["layout"] == "lace_dp 2x1"
    assert grid.stats == gloo and sum(
        s["calls"] for s in gloo.values()) == len(grid.calls) > 0
