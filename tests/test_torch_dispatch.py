"""The dispatch knobs on the port against the reference's contract
(``tests/test_dispatch.py``), on the CPU.

(a) ``rounds_per_call = R``: one call of R rounds equals R calls of one
    round bit for bit (params, optimizer state, federation state, the last
    round's metrics) in the subset, masked, sparse and async modes; also
    the remainder chunk (a leading axis shorter than R), the Trainer's 5
    rounds at R = 2 (2 + 2 + 1, the host streams included), and any
    ``unroll``. The fused fedavg and splitfed_v1 baselines run and
    evaluate.
(b) Donation: ``donate=False`` leaves the state passed to ``step``
    bitwise intact; with ``donate=True`` the round's heavy leaves reuse
    the input's storage, but for the ones named here that the round must
    rebuild; two ``init()``s share no storage; donate on == off bitwise,
    with server FedAdam and with guards over a faulted round.
(c) ``precision="bf16"``: master params and grads stay float32; the
    engine's loss within 0.05 of float32 and the Trainer's within 0.1
    (the reference's bars), its loss going down; the head gradient equals
    its own bf16 rounding (the LACE ops' float32 dW is rounded once, as
    the reference's ops return a bf16 head's cotangent); the bf16 LACE
    plain ops read the bf16 head's float32 copy; the port's bf16 step
    against the reference's bf16 step from the same params.
(d) The spec fields round-trip through JSON and the metadata; bad values
    raise at spec time.
(e) The LACE chunk padding of ``test_dispatch.py`` on the port's
    ``_pick_chunk`` and padded chunks, held to the reference's oracle.

End to end: one ``repro.launch.train --dump-config`` JSON with
``--rounds-per-call 2 --precision bf16`` through both drivers at reduced
width, from the same params.
"""
import json
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro import checkpoint as jckpt
from repro.core import engine as jengine
from repro.core.scala import alexnet_split_model as j_alexnet_split
from repro.kernels.lace.ref import lace_ref
from repro.launch import train as jtrain
from repro.models import alexnet as JA
from repro_torch import api, convert
from repro_torch.checkpoint.checkpoint import flatten_with_paths
from repro_torch.configs import ScalaConfig
from repro_torch.core import engine
from repro_torch.core.scala import alexnet_split_model
from repro_torch.kernels.lace import ops as lace_ops
from repro_torch.tree import leaves

torch.set_num_threads(1)
MODES = ("subset", "masked", "sparse", "async")


def _spec(mode="masked", rpc=1, donate=True, precision="f32", rounds=4,
          **over):
    fed_spec = (api.FedSpec(participation="uniform:0.5")
                if mode in ("masked", "sparse") else api.FedSpec())
    kw = dict(
        arch="alexnet-cifar", width=0.125, method="scala", rounds=rounds,
        seed=0,
        scala=ScalaConfig(num_clients=4, participation=0.5, local_iters=2,
                          server_batch=16, lr=0.05),
        optim=api.OptimSpec(name="momentum"),
        fed=fed_spec,
        execution=api.ExecutionSpec(mode=mode, unroll=0, rounds_per_call=rpc,
                                    donate=donate, precision=precision),
        data=api.DataSpec(kind="image_synthetic", n_train=300,
                          num_classes=10, alpha=2))
    kw.update(over)
    return api.ExperimentSpec(**kw)


def _round_batches(C, R=None, T=2, Bk=5, seed=3):
    rng = np.random.default_rng(seed)
    sh = (R, T, C, Bk) if R else (T, C, Bk)
    return {"x": torch.from_numpy(rng.standard_normal(sh + (32, 32, 3),
                                                      dtype=np.float32)),
            "labels": torch.from_numpy(rng.integers(0, 10, sh)),
            "weights": torch.ones(sh, dtype=torch.float32)}


def _bits(x):
    return x.contiguous().reshape(-1).view(torch.uint8)


def _assert_bitwise(a, b):
    fa, fb = flatten_with_paths(a), flatten_with_paths(b)
    assert fa.keys() == fb.keys()
    for k, x in fa.items():
        y = fb[k]
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and x.shape == y.shape, k
            assert torch.equal(_bits(x), _bits(y)), k
        else:
            assert np.array_equal(np.asarray(x), np.asarray(y)), k


def _snapshot(tree):
    return {k: (v.clone() if isinstance(v, torch.Tensor) else
                np.array(v, copy=True))
            for k, v in flatten_with_paths(tree).items()}


def _cpu(**kw):
    return dict(device="cpu", **kw)


# ---------------------------------------------------------------------------
# (a) R rounds a call == R calls, bitwise
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", MODES)
def test_fused_rounds_bit_identical_to_sequential(mode):
    R = 3
    p1 = api.build(_spec(mode, rpc=1), **_cpu())
    pR = api.build(_spec(mode, rpc=R), **_cpu())
    C = _spec(mode).slots
    b = _round_batches(C, R)
    sizes = torch.full((C,), 5.0)

    state = p1.init()
    for r in range(R):
        state, m1 = p1.step(state, {k: v[r] for k, v in b.items()}, sizes)
    stateR, mR = pR.step(pR.init(), b, sizes.expand(R, C))
    _assert_bitwise(state.inner, stateR.inner)
    _assert_bitwise(state.fed, stateR.fed)
    # the chunk's metrics stacked (R, ...): its last round's are the last
    # sequential round's
    assert set(mR) == set(m1)
    _assert_bitwise(m1, {k: v[-1] for k, v in mR.items()})


@pytest.mark.parametrize("mode", MODES)
def test_fused_remainder_chunk_bit_identical(mode):
    """A leading axis shorter than rounds_per_call (the Trainer's
    remainder chunk) is the same code."""
    pR = api.build(_spec(mode, rpc=4), **_cpu())
    p1 = api.build(_spec(mode, rpc=1), **_cpu())
    C = _spec(mode).slots
    b = _round_batches(C, 1)
    sizes = torch.full((C,), 5.0)
    state, m1 = p1.step(p1.init(), {k: v[0] for k, v in b.items()}, sizes)
    stateR, mR = pR.step(pR.init(), b, sizes[None])
    _assert_bitwise(state.inner.params, stateR.inner.params)
    _assert_bitwise(m1, {k: v[0] for k, v in mR.items()})


@pytest.mark.parametrize("mode", MODES)
def test_trainer_chunking_bit_identical(mode):
    """5 rounds at rounds_per_call=2 (chunks 2 + 2 + 1) == 5 rounds one
    by one: the same history and final params, the host batch streams
    included."""
    t1 = api.Trainer(_spec(mode, rpc=1, rounds=5), device="cpu")
    h1 = t1.run()
    t2 = api.Trainer(_spec(mode, rpc=2, rounds=5), device="cpu")
    seen = []
    h2 = t2.run(on_round=lambda i, m, dt: seen.append((i, m)))
    assert len(h1) == len(h2) == 5 and t1.round == t2.round == 5
    assert [i for i, _ in seen] == list(range(5))
    assert all(m is h for (_, m), h in zip(seen, h2))
    for a, b in zip(h1, h2):
        assert a == b
    _assert_bitwise(t1.state.inner.params, t2.state.inner.params)
    _assert_bitwise(t1.state.fed, t2.state.fed)


def test_unroll_changes_nothing():
    """An eager chunk has no trace to unroll: any ``unroll`` gives the
    same bits."""
    C, R = _spec("masked").slots, 2
    b, sizes = _round_batches(C, R), torch.full((R, C), 5.0)
    outs = []
    for unroll in (-1, 0, 1):
        spec = _spec("masked", rpc=R, execution=api.ExecutionSpec(
            mode="masked", unroll=unroll, rounds_per_call=R))
        p = api.build(spec, device="cpu")
        outs.append(p.step(p.init(), b, sizes))
    for state, m in outs[1:]:
        _assert_bitwise(outs[0][0].inner, state.inner)
        _assert_bitwise(outs[0][1], m)


@pytest.mark.parametrize("method", ("fedavg", "splitfed_v1"))
def test_fused_baseline_methods_run(method):
    """The fused step carries the baselines' empty metrics and their
    client-major transpose (axes 1, 2 of the chunk), bitwise as the
    unfused rounds."""
    spec = lambda rpc: _spec("subset", rpc=rpc, rounds=3,           # noqa
                             method=method, fed=api.FedSpec(),
                             optim=api.OptimSpec())
    t = api.Trainer(spec(2), device="cpu")
    t.run()
    assert t.round == 3 and t.history == [{}, {}, {}]
    assert np.isfinite(t.evaluate()["acc"])
    t1 = api.Trainer(spec(1), device="cpu")
    t1.run()
    _assert_bitwise(t1.state.inner, t.state.inner)


def test_save_resume_at_a_chunk_boundary_is_bitwise(tmp_path):
    """4 rounds at 2 a call against 2, ``save``, a fresh Trainer,
    ``resume`` and 2 more: the same state and history, bit for bit."""
    spec = _spec("masked", rpc=2, rounds=4)
    straight = api.Trainer(spec, device="cpu")
    straight.run()
    first = api.Trainer(spec, device="cpu")
    first.run(2)
    first.save(str(tmp_path))
    resumed = api.Trainer(spec, device="cpu")
    assert resumed.resume(str(tmp_path)) == 2
    resumed.run(2)
    assert resumed.history == straight.history
    _assert_bitwise(resumed.state, straight.state)


def test_dispatch_and_round_loop_legs_run():
    """The table runner's dispatch and round-loop legs at a tiny size:
    every grid entry timed, the round runner on the Python loop's
    params."""
    from repro_torch.benchmarks.dispatch import (bench_baseline_hoist,
                                                 bench_dispatch)
    from repro_torch.benchmarks.round_loop import bench_round_loop

    res = bench_dispatch(rounds=2, modes=("masked", "async"), rpcs=(1, 2),
                         donates=(True,), device="cpu")
    for entry in res["modes"].values():
        assert len(entry) == 5 and entry["fused_speedup"] > 0
    hoist = bench_baseline_hoist(rounds=2, rpc=2, device="cpu")
    assert hoist["hoisted"]["rounds_per_sec"] > 0
    loop = bench_round_loop(rounds=1, C=2, Bk=2, T=2, device="cpu")
    assert loop["round_runner"]["max_param_drift"] <= 1e-6
    assert loop["python_loop"]["steps_per_sec"] > 0


# ---------------------------------------------------------------------------
# (b) donation
# ---------------------------------------------------------------------------


def _ptr(t):
    return t.untyped_storage().data_ptr()


@pytest.mark.parametrize("mode", ("masked", "sparse", "async"))
def test_donate_off_keeps_state_intact(mode):
    spec = _spec(mode, donate=False)
    program = api.build(spec, device="cpu")
    state = program.init()
    before = _snapshot(state)
    program.step(state, _round_batches(spec.slots),
                 torch.full((spec.slots,), 5.0))
    _assert_bitwise(before, _snapshot(state))


def test_donated_masked_round_reuses_the_input_storage():
    """Masked, momentum, carry: the server half and both moment stacks
    are written in place from the first local step on. The client half
    is rebuilt: FedAvg's mean is one new half broadcast over the slots
    (a round starts from such a broadcast, which no slot may write)."""
    spec = _spec("masked")
    program = api.build(spec, device="cpu")
    state = program.init()
    s_in = state.inner
    heavy = {"server": leaves(s_in.params["server"]),
             "moments": leaves(s_in.opt_state)}
    ptrs = {k: [_ptr(a) for a in v] for k, v in heavy.items()}
    out, _ = program.step(state, _round_batches(spec.slots),
                          torch.full((spec.slots,), 5.0))
    assert [_ptr(a) for a in leaves(out.inner.params["server"])] \
        == ptrs["server"]
    assert [_ptr(a) for a in leaves(out.inner.opt_state)] == ptrs["moments"]
    rebuilt = leaves(out.inner.params["client"])
    assert all(a.stride(0) == 0 for a in rebuilt)


def test_donated_async_event_reuses_the_input_storage():
    """Dense async, momentum: the snapshot stack and the client moment
    stack take the cohort's rows in place. Rebuilt: the global client
    half (the staleness-weighted mix, broadcast over the slots) and the
    server half, whose first local step in an event stays functional (the
    event's callers keep the state they pass unless they say
    otherwise)."""
    spec = _spec("async")
    program = api.build(spec, device="cpu")
    state = program.init()
    snap = [_ptr(a) for a in leaves(state.fed.client_params)]
    mom = [_ptr(a) for a in leaves(state.inner.opt_state["client"])]
    out, _ = program.step(state, _round_batches(spec.slots),
                          torch.full((spec.slots,), 5.0))
    assert [_ptr(a) for a in leaves(out.fed.client_params)] == snap
    assert [_ptr(a) for a in leaves(out.inner.opt_state["client"])] == mom


@pytest.mark.parametrize("mode", ("masked", "async"))
def test_init_returns_fresh_storage(mode):
    """Two init()s share no storage: a donated step on the first leaves
    the second intact."""
    spec = _spec(mode)
    program = api.build(spec, device="cpu")
    s1, s2 = program.init(), program.init()
    p1 = {_ptr(a) for a in flatten_with_paths(s1).values()
          if isinstance(a, torch.Tensor) and a.numel()}
    p2 = {_ptr(a) for a in flatten_with_paths(s2).values()
          if isinstance(a, torch.Tensor) and a.numel()}
    assert not p1 & p2
    before = _snapshot(s2)
    program.step(s1, _round_batches(spec.slots),
                 torch.full((spec.slots,), 5.0))
    _assert_bitwise(before, _snapshot(s2))


DONATE_CASES = {
    # server FedAdam: its delta reads the start's server half, copied
    # before a donated round's first step
    "masked-fedadam": dict(mode="masked", server_optimizer="fedadam"),
    "sparse-fedadam": dict(mode="sparse", server_optimizer="fedadam"),
    # guards with NaN corruptions: the screen, the survivor re-run and the
    # clip read the whole start state
    "masked-guards": dict(mode="masked", faults="corrupt:0.5:nan",
                          guards="nonfinite,clip:10"),
    "async-guards": dict(mode="async", faults="corrupt:0.9:nan",
                         guards="nonfinite"),
}


@pytest.mark.parametrize("case", list(DONATE_CASES))
def test_donate_on_equals_off(case):
    kw = dict(DONATE_CASES[case])
    mode = kw.pop("mode")
    so = kw.pop("server_optimizer", None)
    fed = dict(participation="uniform:0.5" if mode != "async" else None,
               **kw)
    runs = []
    for donate in (True, False):
        ex = dict(mode=mode, donate=donate, rounds_per_call=2)
        if so:
            ex["server_optimizer"] = api.OptimSpec.parse(so, default_lr=1e-3)
        t = api.Trainer(_spec(mode, rounds=3, fed=api.FedSpec(**fed),
                              execution=api.ExecutionSpec(**ex)),
                        device="cpu")
        t.run()
        runs.append(t)
    a, b = runs
    assert a.history == b.history
    if "guards" in kw:
        assert sum(h["guard_rejected"] for h in a.history) > 0
    _assert_bitwise(a.state.inner, b.state.inner)
    _assert_bitwise(a.state.fed, b.state.fed)


# ---------------------------------------------------------------------------
# (c) the bf16 compute policy
# ---------------------------------------------------------------------------


def test_bf16_master_params_stay_f32():
    spec = _spec("masked", precision="bf16")
    program = api.build(spec, device="cpu")
    state = program.init()
    assert all(a.dtype == torch.float32 for a in leaves(state.inner.params))
    out, metrics = program.step(state, _round_batches(spec.slots),
                                torch.full((spec.slots,), 5.0))
    assert all(a.dtype == torch.float32 for a in leaves(out.inner.params))
    assert all(a.dtype == torch.float32 for a in leaves(out.inner.opt_state))
    assert np.isfinite(float(metrics["loss_server"]))


def _alexnet_step_inputs(C=3, seed=0):
    from repro_torch.core.split import stack_client_params
    from repro_torch.models import alexnet as A

    gen = torch.Generator("cpu")
    gen.manual_seed(seed)
    wc, ws = A.split_params(A.init_params(gen, num_classes=10, width=0.125),
                            "s2")
    params = {"client": stack_client_params(wc, C), "server": ws}
    rng = np.random.default_rng(1)
    batch = {"x": torch.from_numpy(rng.standard_normal(
        (C, 4, 32, 32, 3), dtype=np.float32)),
        "labels": torch.from_numpy(rng.integers(0, 10, (C, 4)))}
    return params, batch


def test_bf16_engine_grads_f32_and_close_to_f32():
    params, batch = _alexnet_step_inputs()
    model = alexnet_split_model("s2", num_classes=10)
    sc = ScalaConfig(num_clients=3, participation=1.0, local_iters=1,
                     lr=0.05)
    g32, m32 = engine.split_step_grads(model, params, batch, sc,
                                       backend="logits")
    g16, m16 = engine.split_step_grads(model, params, batch, sc,
                                       backend="logits", precision="bf16")
    assert all(a.dtype == torch.float32 for a in leaves(g16))
    assert abs(float(m16["loss_server"]) - float(m32["loss_server"])) < 0.05


def test_bf16_trainer_converges_close_to_f32():
    hf = api.Trainer(_spec("masked", rpc=2, rounds=4), device="cpu").run()
    hb = api.Trainer(_spec("masked", rpc=2, rounds=4, precision="bf16"),
                     device="cpu").run()
    for a, b in zip(hf, hb):
        assert abs(a["loss_server"] - b["loss_server"]) < 0.1
    assert hb[-1]["loss_server"] < hb[0]["loss_server"] + 0.05


def _qwen_reduced():
    import dataclasses

    from repro_torch.configs import get_config

    return dataclasses.replace(get_config("qwen1.5-0.5b").reduced(),
                               vocab_size=97)


def _lm_step_inputs(cfg, C=2, S=12, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (C, 2, S + 1))
    weights = np.ones((C, 2, S), np.float32)
    weights[-1, -1] = 0.0
    return {"tokens": toks[..., :-1].astype(np.int32),
            "labels": toks[..., 1:].astype(np.int32), "weights": weights}


@pytest.mark.parametrize("boundary", ("fused", "dual"))
def test_bf16_head_gradient_is_its_own_bf16_rounding(boundary):
    """Trap 1: the LACE boundary gets a bf16 head, so its gradient is
    rounded to bf16 once, then upcast and added to the trunk's zero."""
    from repro_torch.core.scala import transformer_split_model
    from repro_torch.models import transformer as Tm

    cfg = _qwen_reduced()
    gen = torch.Generator("cpu")
    gen.manual_seed(0)
    full = Tm.init_params(gen, cfg)
    params = engine.init_scala_params(gen, lambda g: full["client"],
                                      lambda g: full["server"], 2)
    batch = {k: torch.from_numpy(v) for k, v in _lm_step_inputs(cfg).items()}
    g, m = engine.split_step_grads(
        transformer_split_model(cfg), params, batch,
        ScalaConfig(num_clients=2), boundary=boundary, precision="bf16")
    head = g["server"]["head"]["out"]
    assert head.dtype == torch.float32 and float(head.abs().max()) > 0
    assert torch.equal(head, head.to(torch.bfloat16).float())
    assert all(a.dtype == torch.float32 for a in leaves(g))
    assert np.isfinite(float(m["loss_server"]))


def test_lace_plain_reads_the_bf16_head_as_f32():
    """The bf16-W entry of the plain LACE ops: the values and feature
    cotangents of the bf16 head's float32 copy, and that copy's dW
    rounded to bf16."""
    rng = np.random.default_rng(0)
    G, N, d, V = 2, 9, 8, 13
    feats = torch.from_numpy(rng.standard_normal((G, N, d), np.float32)
                             ).to(torch.bfloat16)
    w16 = torch.from_numpy(rng.standard_normal((d, V), np.float32)
                           ).to(torch.bfloat16)
    labels = torch.from_numpy(rng.integers(0, V, (G, N)))
    prior = torch.softmax(torch.from_numpy(
        rng.standard_normal((G, V), np.float32)), -1)
    ids = torch.arange(G)
    args = (labels, prior[:1], None, prior, ids, None, 1.0, 1e-8, 4)
    got = lace_ops.lace2_grads(feats, w16, *args)
    want = lace_ops.lace2_grads(feats, w16.float(), *args)
    assert got[4].dtype == torch.bfloat16
    for a, b in zip(got[:4], want[:4]):
        assert torch.equal(a, b)
    assert torch.equal(got[4], want[4].to(torch.bfloat16))


def test_bf16_step_matches_the_reference_bf16_step():
    """AlexNet (logits) from the reference's init, one split step under
    bf16 in both packages: the losses within 1e-5 relative (both reduce in
    float32 over logits that agree), every weight's gradient within 1e-2
    of its largest entry and every bias's within 1e-1: a bias gradient
    sums a bf16 cotangent over every position, and the two libraries
    round that sum at different places (measured: weights 3.6e-3, biases
    4.9e-2, of the largest entry)."""
    C = 3
    model_j = j_alexnet_split("s2", num_classes=10)
    full = JA.init_params(jax.random.PRNGKey(0), num_classes=10, width=0.125)
    wc, ws = JA.split_params(full, "s2")
    params_j = {"client": jax.tree.map(
        lambda a: jnp.broadcast_to(a[None], (C,) + a.shape), wc),
        "server": ws}
    rng = np.random.default_rng(1)
    x = rng.standard_normal((C, 4, 32, 32, 3), dtype=np.float32)
    y = rng.integers(0, 10, (C, 4)).astype(np.int32)
    from repro.configs import ScalaConfig as JScala

    sc = dict(num_clients=C, participation=1.0, local_iters=1, lr=0.05)
    gj, mj = jengine.split_step_grads(
        model_j, params_j, {"x": jnp.asarray(x), "labels": jnp.asarray(y)},
        JScala(**sc), precision="bf16")
    pt = {"client": convert.alexnet_params_from_reference(
        jax.tree.map(np.asarray, params_j["client"])),
        "server": convert.alexnet_params_from_reference(
            jax.tree.map(np.asarray, params_j["server"]))}
    gt, mt = engine.split_step_grads(
        alexnet_split_model("s2", num_classes=10), pt,
        {"x": torch.from_numpy(x), "labels": torch.from_numpy(y)},
        ScalaConfig(**sc), backend="logits", precision="bf16")
    for key in ("loss_server", "loss_client"):
        a, b = float(mt[key]), float(mj[key])
        assert abs(a - b) <= 1e-5 * abs(b), (key, a, b)
    want = {"client": convert.alexnet_params_from_reference(
        jax.tree.map(np.asarray, gj["client"])),
        "server": convert.alexnet_params_from_reference(
            jax.tree.map(np.asarray, gj["server"]))}
    fg, fw = flatten_with_paths(gt), flatten_with_paths(want)
    assert fg.keys() == fw.keys()
    for k in fg:
        a, b = fg[k].double(), fw[k].double()
        assert a.dtype == b.dtype and a.shape == b.shape, k
        scale = max(float(b.abs().max()), 1e-6)
        rtol = 1e-1 if k.endswith("/b") else 1e-2
        assert float((a - b).abs().max()) <= rtol * scale, k


# ---------------------------------------------------------------------------
# (d) the spec fields
# ---------------------------------------------------------------------------


def test_dispatch_fields_roundtrip_spec_json_and_metadata():
    spec = _spec("sparse", rpc=16, donate=False, precision="bf16")
    back = api.ExperimentSpec.from_dict(json.loads(json.dumps(
        spec.to_dict())))
    assert back == spec
    assert (back.execution.precision, back.execution.rounds_per_call,
            back.execution.donate) == ("bf16", 16, False)
    meta = api.build(back.validate(), device="cpu").metadata
    assert (meta["precision"], meta["rounds_per_call"], meta["donate"]) \
        == ("bf16", 16, False)
    # the reference reads the same JSON to the same fields
    jspec = japi.ExperimentSpec.from_dict(json.loads(json.dumps(
        spec.to_dict())))
    assert jspec.execution.rounds_per_call == 16


def test_bad_dispatch_values_raise_at_spec_time():
    with pytest.raises(ValueError, match="precision"):
        api.ExecutionSpec(precision="fp8")
    with pytest.raises(ValueError, match="rounds_per_call"):
        api.ExecutionSpec(rounds_per_call=0)
    with pytest.raises(ValueError, match="precision"):
        engine.cast_to_compute(None, "tf32")
    paged = _spec("async", fed=api.FedSpec(),
                  execution=api.ExecutionSpec(
                      mode="async", snapshots="delta", opt_paging="host",
                      rounds_per_call=2),
                  optim=api.OptimSpec(name="momentum"))
    with pytest.raises(ValueError, match="rounds_per_call"):
        paged.validate()


# ---------------------------------------------------------------------------
# (e) LACE chunk padding
# ---------------------------------------------------------------------------


def test_pick_chunk_no_longer_degrades_on_primes():
    assert lace_ops._pick_chunk(13, 4) == 4
    assert lace_ops._pick_chunk(97, 32) == 32
    assert lace_ops._pick_chunk(16, 4) == 4
    assert lace_ops._pick_chunk(3, 8) == 3


@pytest.mark.parametrize("N,chunk", ((13, 4), (7, 8), (30, 7)))
def test_lace_padded_chunks_match_oracle(N, chunk):
    """The port's padded-chunk loss and grads against the reference's
    unchunked oracle: loss and df within 1e-5, dW within 1e-4."""
    G, d, V = 3, 8, 17
    rng = np.random.default_rng(N)
    feats = rng.standard_normal((G, N, d), dtype=np.float32)
    W = (0.1 * rng.standard_normal((d, V))).astype(np.float32)
    labels = rng.integers(0, V, (G, N)).astype(np.int32)
    w = (rng.uniform(size=(G, N)) + 0.1).astype(np.float32)
    prior = np.array(jax.nn.softmax(rng.standard_normal((G, V)), -1),
                     np.float32)
    ref, (rf, rw) = jax.value_and_grad(
        lambda f, wh: lace_ref(
            f.reshape(-1, d), wh, jnp.asarray(labels).reshape(-1),
            prior_rows=jnp.asarray(prior),
            prior_ids=jnp.repeat(jnp.arange(G), N),
            weights=jnp.asarray(w).reshape(-1)), argnums=(0, 1))(
        jnp.asarray(feats), jnp.asarray(W))
    f_t = torch.from_numpy(feats).requires_grad_()
    w_t = torch.from_numpy(W).requires_grad_()
    got = lace_ops.lace_loss(f_t, w_t, torch.from_numpy(labels),
                             torch.from_numpy(prior), torch.arange(G),
                             torch.from_numpy(w), 1.0, 1e-8, chunk)
    gf, gw = torch.autograd.grad(got, (f_t, w_t))
    np.testing.assert_allclose(got.item(), float(ref), atol=1e-5)
    np.testing.assert_allclose(gf.numpy(), np.asarray(rf), atol=1e-5)
    np.testing.assert_allclose(gw.numpy(), np.asarray(rw), atol=1e-4)


def test_lace_padded_no_weights_matches_oracle():
    G, N, d, V = 2, 11, 8, 13
    rng = np.random.default_rng(0)
    feats = rng.standard_normal((G, N, d), dtype=np.float32)
    W = (0.1 * rng.standard_normal((d, V))).astype(np.float32)
    labels = rng.integers(0, V, (G, N)).astype(np.int32)
    got = lace_ops.lace_loss(torch.from_numpy(feats), torch.from_numpy(W),
                             torch.from_numpy(labels), None, None, None,
                             1.0, 1e-8, 4)
    ref = lace_ref(jnp.asarray(feats).reshape(-1, d), jnp.asarray(W),
                   jnp.asarray(labels).reshape(-1))
    np.testing.assert_allclose(float(got), float(ref), atol=1e-5)


# ---------------------------------------------------------------------------
# end to end: one JSON through both drivers
# ---------------------------------------------------------------------------

FLAGS = ["--arch", "qwen1.5-0.5b", "--reduced", "--rounds", "3",
         "--clients", "4", "--participation", "0.5", "--local-iters", "2",
         "--seq", "16", "--server-batch", "4", "--docs-per-client", "4",
         "--lr", "0.05", "--rounds-per-call", "2", "--precision", "bf16"]
LINE = re.compile(r"^round +(\d+) loss_s=([\d.]+) loss_c=([\d.]+) \(")


def test_bf16_chunked_config_through_both_clis(tmp_path, capsys):
    """The reference's ``--dump-config`` of a bf16 run at 2 rounds a call
    (chunks 2 + 1) runs unchanged through the port's driver from the same
    params: the per-round losses within 1e-3 relative (bf16 activations
    and a bf16 head rounded at different places by the two packages, the
    gap growing round by round: measured 1.2e-4 at round 2), one loss
    line a round."""
    cfg_path = str(tmp_path / "run.json")
    jtrain.main(FLAGS + ["--dump-config", cfg_path])
    spec = japi.ExperimentSpec.from_json(open(cfg_path).read())
    assert (spec.execution.precision, spec.execution.rounds_per_call) \
        == ("bf16", 2)
    params = japi.build(spec).init().inner.params
    npz = jckpt.save(str(tmp_path / "init"), 0, params)
    capsys.readouterr()
    want = jtrain.main(["--config", cfg_path]).history
    capsys.readouterr()
    got = train_main(["--config", cfg_path, "--device", "cpu",
                      "--init-params", npz]).history
    out = capsys.readouterr().out
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        for key in ("loss_server", "loss_client"):
            assert abs(g[key] - w[key]) <= 1e-3 * abs(w[key]), (key, g, w)
    lines = [LINE.match(l) for l in out.splitlines() if l.startswith("round")]
    assert [int(m.group(1)) for m in lines] == [0, 1, 2]


def train_main(argv):
    from repro_torch.launch import train

    return train.main(argv)
