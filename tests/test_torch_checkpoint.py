"""The port's checkpoint (CPU): ``repro_torch.checkpoint`` save / restore,
``Trainer.save`` / ``resume``, the training CLI's checkpoint flags and
serving from the port's own checkpoints.

* Round trip, a missing directory, the atomic write, the fallback from a
  torn newest file, a pinned corrupt step (the assertions of
  ``test_optim_ckpt.py`` and ``test_faults.py``); a broadcast slot leaf
  restored as the same broadcast, a bfloat16 leaf bit for bit.
* Resumed == uninterrupted, bitwise in every leaf and in the history:
  SCALA on the ``lace`` backend (reduced qwen1.5-0.5b) and on ``logits``
  (AlexNet), feddyn, splitfed_v1 and sfl_localloss; a torn pair is
  skipped.
* The port resumes a directory that the JAX ``Trainer.save`` wrote (the
  same keys; conv weights and the transformer layout converted): its
  next round within 1e-4 of the reference's (SCALA's losses relative;
  a baseline's update, of its largest entry).
* The CLI: ``--state-dir`` + ``--resume`` prints the uninterrupted run's
  losses; ``--checkpoint-dir`` and ``--state-dir`` files serve the
  trained global model (slot 0 merged with the server half), and a
  torn newest file raises instead of falling back, as the reference's
  serving restore does.
"""
import os
import zipfile

import jax
import numpy as np
import pytest
import torch

from repro import api as japi
from repro.configs.base import ScalaConfig as JScala
from repro_torch import api, checkpoint as C, convert
from repro_torch.checkpoint.checkpoint import flatten_with_paths
from repro_torch.configs import ScalaConfig
from repro_torch.launch import train
from repro_torch.models import transformer as T
from repro_torch.tree import leaves, tree_map

torch.set_num_threads(1)


def _equal_trees(a, b, what):
    fa, fb = flatten_with_paths(a), flatten_with_paths(b)
    assert fa.keys() == fb.keys(), what
    for key, x in fa.items():
        y = fb[key]
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and x.shape == y.shape, (what, key)
            assert torch.equal(x, y), (what, key)
        else:
            assert x == y, (what, key, x, y)


def test_checkpoint_roundtrip(tmp_path):
    tree = {"a": torch.arange(6.0).reshape(2, 3),
            "b": {"c": torch.tensor([1, 2, 3], dtype=torch.int32)},
            "d": (torch.zeros(4), torch.ones(2)), "step": 5}
    d = str(tmp_path / "ckpt")
    C.save(d, 3, tree)
    C.save(d, 7, tree_map(lambda a: a + 1, tree))
    assert C.latest_step(d) == 7 and C.all_steps(d) == [3, 7]
    _equal_trees(C.restore(d, tree, step=3), tree, "step 3")
    r7 = C.restore(d, tree)
    assert torch.equal(r7["a"], tree["a"] + 1) and r7["step"] == 6
    assert isinstance(r7["d"], tuple)


def test_checkpoint_missing_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        C.restore(str(tmp_path / "none"), {"a": torch.zeros(1)})


def test_checkpoint_keeps_slots_and_bf16(tmp_path):
    base = torch.arange(12.0).reshape(3, 4)
    tree = {"client": base[None].expand(5, 3, 4),
            "half": torch.randn(7, dtype=torch.float32).to(torch.bfloat16),
            "own": torch.randn(2, 3)}
    path = C.save(str(tmp_path), 0, tree)
    with np.load(path) as data:
        assert data["client"].shape == (3, 4)             # stored once
        assert C.PORT_KEY in data.files
    got = C.restore(str(tmp_path), tree)
    _equal_trees(got, tree, "restored")
    assert got["client"].stride(0) == 0                     # a broadcast
    assert got["own"].stride() == tree["own"].stride()
    with pytest.raises(AssertionError):
        C.restore(str(tmp_path), dict(tree, own=torch.zeros(3, 3)))


def test_checkpoint_atomic_and_corrupt_fallback(tmp_path):
    tree = {"a": torch.arange(6.0).reshape(2, 3), "b": {"c": torch.ones(4)}}
    d = str(tmp_path)
    C.save(d, 1, tree)
    C.save(d, 2, tree_map(lambda a: a * 2, tree))
    assert C.all_steps(d) == [1, 2]
    # no stray temp files after an atomic save
    assert not [f for f in os.listdir(d) if ".tmp" in f]

    # torn write: truncate the latest -> restore falls back to step 1
    with open(os.path.join(d, "ckpt_00000002.npz"), "r+b") as f:
        f.truncate(10)
    with pytest.warns(UserWarning, match="unreadable"):
        got = C.restore(d, tree)
    _equal_trees(got, tree, "fallback restore")
    # an explicitly pinned corrupt step raises instead of substituting
    with pytest.raises(C.CORRUPT_ERRORS):
        C.restore(d, tree, step=2)


def _image_spec(method, rounds=3, **sc):
    kw = dict(num_clients=4, participation=0.5, local_iters=2,
              server_batch=16, lr=0.05)
    kw.update(sc)
    return api.ExperimentSpec(
        arch="alexnet-cifar", width=0.125, method=method, rounds=rounds,
        seed=1, scala=ScalaConfig(**kw),
        execution=api.ExecutionSpec(mode="subset", backend="logits"),
        data=api.DataSpec(kind="image_synthetic", n_train=120, n_test=30,
                          alpha=2))


def _lace_spec(rounds=3):
    return api.ExperimentSpec(
        arch="qwen1.5-0.5b", reduced=True, method="scala", rounds=rounds,
        seed=2, scala=ScalaConfig(num_clients=6, participation=0.5,
                                  local_iters=2, server_batch=4, lr=0.01),
        execution=api.ExecutionSpec(mode="subset", backend="lace"),
        data=api.DataSpec(kind="lm_synthetic", seq=16, docs_per_client=3))


@pytest.mark.parametrize("case", ["scala-lace", "scala-logits", "feddyn",
                                  "splitfed_v1", "sfl_localloss"])
def test_resume_is_bitwise(case, tmp_path):
    spec = (_lace_spec() if case == "scala-lace"
            else _image_spec(case.split("-")[0]))
    straight = api.Trainer(spec, device="cpu")
    straight.run(3)
    first = api.Trainer(spec, device="cpu")
    first.run(2)
    first.save(str(tmp_path))
    resumed = api.Trainer(spec, device="cpu")
    assert resumed.resume(str(tmp_path)) == 2
    resumed.run(1)
    _equal_trees(resumed.state, straight.state, case)
    assert resumed.history == straight.history
    assert resumed.round == straight.round == 3


def test_trainer_resume_skips_torn_pair(tmp_path):
    d = str(tmp_path)
    spec = _image_spec("feddyn")
    t = api.Trainer(spec, device="cpu")
    t.run(1)
    t.save(d)
    state1 = flatten_with_paths(t.state)
    t.run(1)
    t.save(d)
    # a crash mid-save of the newest checkpoint: npz there, meta torn
    with open(os.path.join(d, "meta_00000002.json"), "w") as f:
        f.write('{"round": 2, "hist')
    fresh = api.Trainer(spec, device="cpu")
    assert fresh.resume(d) == 1
    got = flatten_with_paths(fresh.state)
    assert all(torch.equal(got[k], v) for k, v in state1.items())
    with pytest.raises(ValueError):
        api.Trainer(spec, device="cpu").resume(d, step=2)
    with pytest.raises(FileNotFoundError):
        fresh.resume(str(tmp_path / "empty"))


def _jax_spec(tspec):
    """The reference's spec of a port spec (same JSON)."""
    d = tspec.to_dict()
    return japi.ExperimentSpec.from_dict(dict(
        d, scala=JScala(**d["scala"]),
        execution=dict(d["execution"], unroll=0)))


@pytest.mark.parametrize("method", ["scala-logits", "scala-lace", "feddyn",
                                    "sfl_localloss"])
def test_resume_from_reference_checkpoint(method, tmp_path):
    tspec = (_lace_spec() if method == "scala-lace"
             else _image_spec(method.split("-")[0]))
    jspec = _jax_spec(tspec)
    tj = japi.Trainer(jspec)
    tj.run(1)
    tj.save(str(tmp_path))
    before = jax.tree.map(np.asarray, tj.state)
    tt = api.Trainer(tspec, device="cpu")
    assert tt.resume(str(tmp_path)) == 1
    assert tt.history == tj.history
    (want,), (got,) = tj.run(1)[1:], tt.run(1)[1:]
    if tspec.method == "scala":
        assert set(got) == set(want)
        for key in ("loss_server", "loss_client"):
            assert abs(got[key] - want[key]) <= 1e-4 * abs(want[key]), (
                key, got, want)
        return
    assert got == want == {}
    after = jax.tree.map(np.asarray, tj.state)
    port = lambda st: (leaves(convert.baseline_state_from_reference(
        st.inner, method)) + (leaves(convert.baseline_state_from_reference(
            st.fed, method)) if st.fed else []))
    new, old = port(after), port(before)
    mine = leaves(tt.state.inner) + leaves(tt.state.fed)
    for a, b, b0 in zip(mine, new, old):
        upd = (b - b0).abs().max().item()
        assert (a - b).abs().max().item() <= 1e-4 * upd, method


def test_reference_and_port_keys_agree(tmp_path):
    """The port's paths are the reference's: a Trainer.save of the same
    experiment holds the same keys (the port adds its format key and a
    slot count per once-stored client leaf)."""
    for method in ("feddyn", "sfl_localloss", "scala"):
        tspec = _image_spec(method)
        jspec = _jax_spec(tspec)
        japi.Trainer(jspec).save(str(tmp_path / "j" / method))
        api.Trainer(tspec, device="cpu").save(str(tmp_path / "t" / method))
        keys = [set(np.load(str(tmp_path / side / method /
                                "ckpt_00000000.npz")).files)
                for side in ("j", "t")]
        port = {k for k in keys[1] if k != C.PORT_KEY
                and not k.endswith("@slots")}
        assert keys[0] == port, (method, keys[0] ^ port)


FLAGS = ["--arch", "qwen1.5-0.5b", "--reduced", "--device", "cpu",
         "--clients", "8", "--participation", "0.25", "--local-iters", "2",
         "--seq", "16", "--server-batch", "4", "--docs-per-client", "3"]


def _round_lines(capsys):
    return [line.split(" (")[0] for line in capsys.readouterr().out.
            splitlines() if line.startswith("round")]


def test_train_cli_state_dir_and_resume(tmp_path, capsys):
    state_dir = str(tmp_path / "state")
    train.main(FLAGS + ["--rounds", "3"])
    want = _round_lines(capsys)
    train.main(FLAGS + ["--rounds", "2", "--state-dir", state_dir])
    first = _round_lines(capsys)
    trainer = train.main(FLAGS + ["--rounds", "3", "--state-dir", state_dir,
                                  "--resume"])
    assert first + _round_lines(capsys) == want
    assert trainer.round == 3 and C.all_steps(state_dir) == [1, 2, 3]
    with pytest.raises(SystemExit, match="--state-dir"):
        train.main(FLAGS + ["--resume"])


def test_serving_from_port_checkpoints(tmp_path, capsys):
    params_dir, state_dir = str(tmp_path / "params"), str(tmp_path / "state")
    trainer = train.main(FLAGS + ["--rounds", "2", "--checkpoint-dir",
                                  params_dir, "--state-dir", state_dir])
    capsys.readouterr()
    cfg = trainer.spec.model_config()
    p = trainer.state.inner.params
    want = {"client": tree_map(lambda a: a[0], p["client"]),
            "server": p["server"]}
    for directory, step in ((params_dir, None), (state_dir, None),
                            (params_dir, 0)):
        got = api.restore_global_params(cfg, directory, step, device="cpu")
        if step == 0:
            continue
        _equal_trees(got, want, directory)
    # the served model runs on the restored params
    spec = api.ServeSpec(arch="qwen1.5-0.5b", reduced=True, device="cpu",
                         checkpoint_dir=state_dir, slots=1, max_len=16)
    tokens = torch.tensor([[1, 2, 3, 4]])
    torch.testing.assert_close(
        api.build_serve(spec).predict({"tokens": tokens}),
        T.forward(want, {"tokens": tokens}, cfg), rtol=0, atol=0)
    # a torn newest file raises, as the reference's serving restore does
    with open(C.checkpoint_path(params_dir, 1), "r+b") as f:
        f.truncate(10)
    with pytest.raises(zipfile.BadZipFile):
        api.restore_global_params(cfg, params_dir, device="cpu")
