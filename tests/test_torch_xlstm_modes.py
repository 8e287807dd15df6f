"""Every training mode of the PyTorch port accepts xlstm-1.3b.

None of masked, sparse, async, the dual boundary, the bf16 policy or
rounds per call is arch-specific: each runs the reduced xlstm-1.3b
through the training CLI on the CPU for two rounds (events) with finite
losses. Their numbers against the reference are the other test files'
(``test_torch_xlstm_train.py`` for xLSTM's step and round).
"""
import re

import numpy as np
import pytest
import torch

from repro_torch.launch import train

torch.set_num_threads(1)
FLAGS = ["--arch", "xlstm-1.3b", "--reduced", "--device", "cpu", "--rounds",
         "2", "--clients", "4", "--local-iters", "1", "--seq", "16",
         "--server-batch", "4", "--docs-per-client", "2"]
LINE = re.compile(r"^(round|event) +\d+ loss_s=([\d.]+) loss_c=([\d.]+)")


@pytest.mark.parametrize("extra", [
    ["--participation", "uniform:0.5"],
    ["--participation", "uniform:0.5", "--slot-gather"],
    ["--async", "--cohort", "2", "--delay-spec", "lognormal:1:1.5"],
    ["--participation", "0.5", "--boundary", "dual"],
    ["--participation", "0.5", "--precision", "bf16"],
    ["--participation", "0.5", "--rounds-per-call", "2"],
], ids=["masked", "sparse", "async", "dual", "bf16", "rounds_per_call"])
def test_mode_trains_xlstm(extra, capsys):
    history = train.main(FLAGS + extra).history
    lines = [m for m in map(LINE.match, capsys.readouterr().out.splitlines())
             if m]
    assert len(history) == len(lines) == 2
    for m in history:
        assert np.isfinite(m["loss_server"]) and np.isfinite(m["loss_client"])
