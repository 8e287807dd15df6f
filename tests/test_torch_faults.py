"""The port's fault injection and guarded aggregation on the CPU.

* Against the JAX package: the spec grammars (accepted and refused with
  the reference's messages), ``screen`` on the same updates (``accept``
  equal, norms and the running median within 1e-6 relative, an even
  count of accepted norms among the cases: the mean of the two middle
  ones, as ``jnp.nanmedian``), two masked rounds of reduced
  qwen1.5-0.5b (``lace``), two sparse rounds and three async events (a
  deadline, ``stall``) of AlexNet width 0.125 (``logits``), with
  ``drop`` and ``corrupt:nan`` under the guards,
  the reference's masks (its scheduler's, its faults', its delays: each
  recomputed from the key splits its round or event makes) injected
  into the port through recorded models: losses within 1e-4 relative,
  every leaf within 1e-4 of its largest entry, the rejections equal.
* Within the port, the contracts of ``tests/test_faults.py``: guards on
  at zero faults == guards off bitwise (masked and sparse x ``logits``
  and ``lace``; async dense and delta), a rejected client's guarded
  round == the clean round whose scheduler mask is the survivors,
  bitwise (nan and inf), chaos stays finite and learns, clipping bounds
  the drift of ``noise`` corruption, stall with a deadline advances, the
  subset / paged / ``lace_dp`` refusals, ``Trainer`` resume bitwise with
  the fault stream and the guard median; the fault stream apart from
  the scheduler's; the spec, build, CLI and table-runner layers.
"""
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro import fed as jfed
from repro.configs.base import ScalaConfig as JScala
from repro.core import engine as jengine
from repro.fed import faults as jfaults
from repro.fed import guards as jguards
from repro.optim import optimizers as jopt
from repro_torch import api, convert, fed
from repro_torch.checkpoint.checkpoint import flatten_with_paths
from repro_torch.configs.base import ScalaConfig
from repro_torch.core import engine
from repro_torch.core.split import stack_client_params
from repro_torch.fed import faults as tfaults
from repro_torch.fed import guards as tguards
from repro_torch.launch import train
from repro_torch.optim import optimizers
from repro_torch.tree import leaves
from test_torch_fed import _close, _close_tree, _np, _setup, _t

torch.set_num_threads(1)
LEAF_RTOL, LOSS_RTOL = 1e-4, 1e-4


def _chip_smoke():
    path = os.path.join(os.path.dirname(__file__), "..", "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_recorded = _chip_smoke().recorded_scheduler


def _bits_equal(a, b, what):
    """Every leaf (of nested dicts, tuples and dataclasses) bit for bit."""
    fa, fb = flatten_with_paths(a), flatten_with_paths(b)
    assert fa.keys() == fb.keys(), what
    for k, x in fa.items():
        y = fb[k]
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and torch.equal(x, y), (what, k)
        else:
            assert np.array_equal(np.asarray(x), np.asarray(y)), (what, k)


def _fixed_scheduler(mask, subset_size):
    """A stateless scheduler emitting ``mask`` every round, with the
    static gather size ``subset_size``."""
    mask = np.asarray(mask, np.float32)
    return fed.ParticipationScheduler(
        name="fixed", num_clients=mask.shape[0], stateful=False,
        init=lambda seed: (), sample=lambda s: (mask.copy(), s),
        subset_size=subset_size)


# --------------------------------------------------------------------------
# spec grammars: the reference's cases and messages
# --------------------------------------------------------------------------


FAULT_SPECS = ["drop:0.1,corrupt:0.05:nan,stall:0.02",
               "corrupt:0.2:noise:3.5,stall:0.1:50", "drop:0", "", "drop",
               "drop:2", "corrupt:0.1:huh", "stall:0.1:0.5", "explode:0.1",
               "corrupt:0.1:inf", "stall:0.3", "corrupt:1:noise:1:2"]
GUARD_SPECS = ["nonfinite,clip:10.0:0.25", "nonfinite", "clip:5", "",
               "clip:0", "clip:-1", "median", "nonfinite:1",
               "clip:2:0", "clip:2:1.5", "clip:1:2:3"]


@pytest.mark.parametrize("spec", FAULT_SPECS)
def test_fault_spec_grammar_as_reference(spec):
    try:
        want = jfaults.make_faults(spec)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            tfaults.make_faults(spec)
        assert str(got.value) == str(e)
        return
    got = tfaults.make_faults(spec)
    for f in ("drop", "corrupt", "corrupt_mode", "noise_scale", "stall",
              "stall_factor", "spec", "any_faults"):
        assert getattr(got, f) == getattr(want, f), f


@pytest.mark.parametrize("spec", GUARD_SPECS)
def test_guard_spec_grammar_as_reference(spec):
    try:
        want = jguards.make_guards(spec)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            tguards.make_guards(spec)
        assert str(got.value) == str(e)
        return
    got = tguards.make_guards(spec)
    for f in ("nonfinite", "clip", "beta", "spec", "stateful"):
        assert getattr(got, f) == getattr(want, f), f


def test_spec_passthrough_and_package_exports():
    fm, gp = fed.make_faults("drop:0.1"), fed.make_guards("nonfinite")
    assert fed.make_faults(fm) is fm and fed.make_faults(None) is None
    assert fed.make_guards(gp) is gp and fed.make_guards(None) is None
    assert fed.CORRUPT_MODES == jfed.CORRUPT_MODES
    assert isinstance(fm, fed.FaultModel) and isinstance(gp,
                                                         fed.GuardPolicy)


# --------------------------------------------------------------------------
# the fault stream
# --------------------------------------------------------------------------


def test_fault_stream_keyed_and_apart_from_the_scheduler():
    fm = tfaults.make_faults("drop:0.5,corrupt:0.5,stall:0.5")
    a = fm.draw(3, 2, 64)
    assert list(a) == ["drop", "corrupt", "stall"]
    assert all(m.dtype == np.float32 and m.shape == (64,) for m in a.values())
    for k, v in fm.draw(3, 2, 64).items():
        np.testing.assert_array_equal(v, a[k])
    assert not np.array_equal(a["drop"], fm.draw(3, 3, 64)["drop"])
    assert not np.array_equal(a["drop"], fm.draw(4, 2, 64)["drop"])
    # the stream [seed, 0x5FA17, count] draws all three masks in order
    rng = np.random.default_rng([3, 0x5FA17, 2])
    for k in ("drop", "corrupt", "stall"):
        np.testing.assert_array_equal(a[k], rng.random(64) < 0.5)
    # ... and not the scheduler's / the delays' [seed, count]
    same = np.random.default_rng([3, 2]).random(64) < 0.5
    assert not np.array_equal(a["drop"], same)
    part = fed.uniform(64, 0.5)
    m0, _ = part.sample(torch.tensor([3, 2]))
    assert not np.array_equal(1.0 - a["drop"], m0)
    # a zero probability never fires, and changing one leaves the others
    fm0 = tfaults.make_faults("drop:0,corrupt:0.5,stall:0.5")
    b = fm0.draw(3, 2, 64)
    assert b["drop"].sum() == 0
    np.testing.assert_array_equal(b["corrupt"], a["corrupt"])
    np.testing.assert_array_equal(b["stall"], a["stall"])


def test_recorded_fault_model_replays_masks():
    rec = tfaults.recorded([{"corrupt": [0, 1, 0]}, {"drop": [1, 0, 0]}])
    assert rec.corrupt == 1.0 and rec.drop == 1.0 and rec.stall == 0.0
    m = rec.draw(99, 1, 3)
    np.testing.assert_array_equal(m["drop"], [1, 0, 0])
    np.testing.assert_array_equal(m["corrupt"], [0, 0, 0])
    with pytest.raises(ValueError, match="shape"):
        rec.draw(0, 0, 4)
    with pytest.raises(ValueError, match="corrupt mode"):
        tfaults.recorded([{"drop": [1]}], corrupt_mode="zero")


@pytest.mark.parametrize("mode", ["nan", "inf", "noise"])
def test_corrupt_update_rewrites_only_firing_rows(mode):
    fm = tfaults.make_faults(f"corrupt:0.5:{mode}" + (":2.0" if mode ==
                                                      "noise" else ""))
    tree = {"a": torch.randn(4, 3, 2), "b": {"c": torch.randn(4, 5)}}
    before = {k: v.clone() for k, v in [("a", tree["a"]),
                                        ("c", tree["b"]["c"])]}
    mask = np.array([0, 1, 0, 1], np.float32)
    tfaults.corrupt_update(fm, 7, 3, tree, mask)
    for key, leaf in (("a", tree["a"]), ("c", tree["b"]["c"])):
        for r in (0, 2):
            assert torch.equal(leaf[r], before[key][r])
        for r in (1, 3):
            if mode == "nan":
                assert torch.isnan(leaf[r]).all()
            elif mode == "inf":
                assert torch.isinf(leaf[r]).all()
            else:
                assert torch.isfinite(leaf[r]).all()
                assert not torch.equal(leaf[r], before[key][r])
    if mode == "noise":
        # the noise is the host stream [seed, tag, count, leaf index]'s
        rng = np.random.default_rng([7, 0x5FA17, 3, 1])
        want = before["c"][[1, 3]] + torch.from_numpy(
            np.float32(2.0) * rng.standard_normal((2, 5), dtype=np.float32))
        assert torch.equal(tree["b"]["c"][[1, 3]], want)


# --------------------------------------------------------------------------
# guards: the screen against the reference's
# --------------------------------------------------------------------------


SCREEN_CASES = {
    # name: (mask, the rows made non-finite, per-row scale, state med, n)
    "even_accepted": ([1, 1, 1, 1], [], [1, 2, 4, 10], 0.0, 0),
    "odd_with_nan": ([1, 1, 1, 1, 1], [2], [1, 2, 1, 4, 10], 3.0, 2),
    "inf_and_absent": ([1, 0, 1, 1, 1, 1], [3], [1, 5, 2, 1, 4, 100], 2.0, 1),
    "nobody": ([0, 0, 0], [], [1, 2, 3], 1.5, 4),
    "all_rejected": ([1, 1], [0, 1], [1, 1], 2.5, 3),
}


@pytest.mark.parametrize("case", sorted(SCREEN_CASES))
@pytest.mark.parametrize("spec", ["nonfinite", "nonfinite,clip:1.5:0.3",
                                  "clip:2"])
def test_screen_matches_reference(case, spec):
    mask, bad, scale, med, n = SCREEN_CASES[case]
    C = len(mask)
    rng = np.random.default_rng(C + len(bad))
    start = {"w": rng.standard_normal((C, 6, 3)).astype(np.float32),
             "b": rng.standard_normal((C, 4)).astype(np.float32)}
    sc = np.asarray(scale, np.float32)
    trained = {k: v + sc.reshape((-1,) + (1,) * (v.ndim - 1))
               * rng.standard_normal(v.shape).astype(np.float32)
               for k, v in start.items()}
    for i, r in enumerate(bad):
        trained["w"][r, 0, 0] = np.nan if i % 2 == 0 else np.inf
    m = np.asarray(mask, np.float32)
    jp, tp = jguards.make_guards(spec), tguards.make_guards(spec)
    jstate = ({"med": jnp.float32(med), "n": jnp.int32(n)}
              if jp.stateful else ())
    tstate = ({"med": torch.tensor(med, dtype=torch.float32),
               "n": torch.tensor(n, dtype=torch.int32)} if tp.stateful
              else ())
    delta = jax.tree.map(lambda a, b: jnp.asarray(a) - jnp.asarray(b),
                         trained, start)
    ja, jf, jn, js = jguards.screen(jp, delta, jnp.asarray(m), jstate)
    ta, tf, tn, ts = tguards.screen(
        tp, {k: _t(v) for k, v in trained.items()},
        {k: _t(v) for k, v in start.items()}, _t(m), tstate)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_allclose(tn.numpy(), np.asarray(jn), rtol=1e-6)
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=1e-6)
    if tp.stateful:
        np.testing.assert_allclose(ts["med"].numpy(), np.asarray(js["med"]),
                                   rtol=1e-6)
        assert int(ts["n"]) == int(js["n"])
    else:
        assert ts == ()
    # the chunked reads (rows and column blocks) give the same screen
    old = tguards.CHUNK_BYTES
    tguards.CHUNK_BYTES = 32
    try:
        tb = tguards.screen(tp, {k: _t(v) for k, v in trained.items()},
                            {k: _t(v) for k, v in start.items()}, _t(m),
                            tstate)
    finally:
        tguards.CHUNK_BYTES = old
    assert torch.equal(tb[0], ta)
    np.testing.assert_allclose(tb[2].numpy(), tn.numpy(), rtol=1e-6)


def test_median_of_an_even_count_is_the_mean_of_the_middle_two():
    """torch.nanmedian would give the lower middle value (2.0)."""
    norms = torch.tensor([1.0, 2.0, float("nan"), 4.0, 10.0])
    part = torch.tensor([1.0, 1.0, 1.0, 1.0, 1.0])
    got = tguards._median_even_mean(norms, part)
    assert float(got) == 3.0 == float(jnp.nanmedian(jnp.asarray(
        norms.numpy())))
    assert float(torch.nanmedian(norms)) == 2.0
    assert torch.isnan(tguards._median_even_mean(norms, torch.zeros(5)))


def test_screen_reads_only_the_given_rows_and_clip_is_bitwise_at_one():
    rng = np.random.default_rng(0)
    start = {"w": _t(rng.standard_normal((5, 3)).astype(np.float32))}
    trained = {"w": start["w"].clone()}
    trained["w"][[1, 3]] += 1.0
    trained["w"][4] = float("nan")               # outside the rows read
    gp = tguards.make_guards("nonfinite")
    acc, _, norms, _ = tguards.screen(gp, trained, start, torch.ones(5),
                                      (), rows=np.array([1, 3]))
    np.testing.assert_array_equal(acc.numpy(), np.ones(5))
    assert norms[0] == norms[2] == norms[4] == 0 and norms[1] > 0
    # apply_clip at factor 1 leaves the trained params bit for bit; below
    # 1 it is the reference's clip, bit for bit
    tr = {"w": _t(rng.standard_normal((3, 4)).astype(np.float32))}
    st = {"w": _t(rng.standard_normal((3, 4)).astype(np.float32))}
    want = tr["w"].clone()
    tguards.apply_clip(st, tr, np.ones(3, np.float32))
    assert torch.equal(tr["w"], want)
    f = np.array([1.0, 0.25, 1.0], np.float32)
    jout = jguards.apply_clip({"w": jnp.asarray(st["w"].numpy())},
                              {"w": jnp.asarray(want.numpy())},
                              jnp.asarray(f))
    tguards.apply_clip(st, tr, f)
    np.testing.assert_array_equal(tr["w"].numpy(), np.asarray(jout["w"]))
    # the reference's norm and finiteness helpers on a delta tree
    delta = {"a": rng.standard_normal((3, 5)).astype(np.float32),
             "b": rng.standard_normal((3, 2, 2)).astype(np.float32)}
    delta["b"][1, 0, 1] = np.inf
    jd = jax.tree.map(jnp.asarray, delta)
    td = {k: _t(v) for k, v in delta.items()}
    np.testing.assert_allclose(tguards.update_norms(td).numpy(),
                               np.asarray(jguards.update_norms(jd)),
                               rtol=1e-6)
    np.testing.assert_array_equal(tguards.finite_rows(td).numpy(),
                                  np.asarray(jguards.finite_rows(jd)))


def test_init_fed_state_with_faults_and_guards():
    fs = fed.init_fed_state(5, fed.weighted(), num_clients=4,
                            faults="drop:0.1", guards="nonfinite,clip:2")
    assert fs["faults"].tolist() == [5, 0]
    assert fs["faults"].dtype == torch.int64
    assert float(fs["guard"]["med"]) == 0.0 and int(fs["guard"]["n"]) == 0
    fs = fed.init_fed_state(5, guards="nonfinite")
    assert fs["guard"] == () and "faults" not in fs
    with pytest.raises(ValueError, match="unknown fault clause"):
        fed.init_fed_state(0, faults="explode:1")


# --------------------------------------------------------------------------
# the round and the event against the reference, its masks injected
# --------------------------------------------------------------------------


def _ref_sync_fault_masks(key, fm, C, rounds):
    """The fault masks the reference's round draws: fault_key =
    fold_in(key, 0x5FA17), then per round split -> (next, ev), split(ev)
    -> (masks, corrupt)."""
    fk = jax.random.fold_in(key, 0x5FA17)
    out = []
    for _ in range(rounds):
        fk, k_ev = jax.random.split(fk)
        k_masks, _ = jax.random.split(k_ev)
        out.append({k: np.asarray(v) for k, v in
                    jfaults.sample_fault_masks(fm, k_masks, C).items()})
    return out


SYNC_FAULTS = "drop:0.2,corrupt:0.4:nan"


@pytest.mark.parametrize("arch,mode", [("qwen", "masked"),
                                       ("alexnet", "sparse")])
def test_faulted_round_matches_reference_with_injected_masks(arch, mode):
    C, rounds = 4, 2
    (jm, tm), pcfg, params, batches, sizes = _setup(arch, C=C)
    key = jax.random.PRNGKey(12)
    jpart, jagg, tagg = jfed.uniform(C, 0.75), jfed.weighted(), fed.weighted()
    guards = "nonfinite,clip:10"
    jfs = jfed.init_fed_state(key, jagg, jpart, faults=SYNC_FAULTS,
                              guards=guards)
    masks, sched = [], jfs["sched"]
    for _ in range(rounds):
        m, sched = jpart.sample(sched)
        masks.append(np.asarray(m))
    fmasks = _ref_sync_fault_masks(key, jfaults.make_faults(SYNC_FAULTS), C,
                                   rounds)
    gather = mode == "sparse"
    kw = dict(backend="lace" if arch == "qwen" else "logits",
              slot_gather=gather, guards=guards)
    jround = jax.jit(jengine.make_round_runner(
        jm, JScala(num_clients=C, lr=0.05), optimizer=jopt.momentum(0.9),
        aggregator=jagg, participation=jpart, faults=SYNC_FAULTS,
        unroll=True, **kw))
    tpart = _recorded(masks)
    tround = engine.make_round_runner(
        tm, ScalaConfig(num_clients=C, lr=0.05),
        optimizer=optimizers.momentum(0.9), aggregator=tagg,
        participation=tpart, faults=tfaults.recorded(fmasks), **kw)
    js = jengine.init_train_state(jax.tree.map(jnp.asarray, params),
                                  jopt.momentum(0.9))
    ts = convert.train_state_from_reference(_np(js), pcfg)
    tfs = fed.init_fed_state(0, tagg, tpart, faults=tfaults.recorded(fmasks),
                             guards=guards)
    jb = jax.tree.map(jnp.asarray, batches)
    tb = {k: _t(v) for k, v in batches.items()}
    rejected = 0.0
    for r in range(rounds):
        js, jfs, jmet = jround(js, jb, jnp.asarray(sizes), jfs)
        ts, tfs, tmet = tround(ts, tb, _t(sizes), tfs)
        assert tmet["guard_rejected"] == float(jmet["guard_rejected"])
        np.testing.assert_array_equal(tmet["guard_accept"].numpy(),
                                      np.asarray(jmet["guard_accept"]))
        rejected += tmet["guard_rejected"]
        for k in ("loss_server", "loss_client"):
            _close(tmet[k], jmet[k], f"round {r} {k}", rtol=LOSS_RTOL)
        np.testing.assert_allclose(tmet["guard_norm"].numpy(),
                                   np.asarray(jmet["guard_norm"]),
                                   rtol=1e-4)
    assert rejected >= 1, "the injected corruption rejected nobody"
    assert sum(m["drop"].sum() for m in fmasks) >= 1
    want = convert.train_state_from_reference(_np(js), pcfg)
    _close_tree(ts.params, want.params, "params", rtol=LEAF_RTOL)
    _close_tree(ts.opt_state, want.opt_state, "opt state", rtol=LEAF_RTOL)
    np.testing.assert_allclose(tfs["guard"]["med"].numpy(),
                               np.asarray(jfs["guard"]["med"]), rtol=1e-4)
    assert int(tfs["guard"]["n"]) == int(jfs["guard"]["n"])
    assert tfs["faults"].tolist() == [0, rounds]
    assert all(bool(torch.isfinite(a).all()) for a in leaves(ts.params))


def test_faulted_events_match_reference_with_injected_masks():
    K, cohort, events = 4, 2, 3
    from test_torch_async import _setup as _async_setup

    (jm, tm), pcfg, wc, ws, batches, sizes = _async_setup("alexnet", K=K)
    spec, guards = "drop:0.2,corrupt:0.5:nan,stall:0.3:5", "nonfinite"
    jdm = jfed.make_delays("lognormal:1:1")
    jo, to = jopt.momentum(0.9), optimizers.momentum(0.9)
    jparams = {"client": jax.tree.map(
        lambda a: jnp.broadcast_to(a[None], (K,) + a.shape), wc),
        "server": jax.tree.map(jnp.asarray, ws)}
    kw = dict(backend="logits", cohort=cohort, num_clients=K, deadline=1.5,
              guards=guards)
    jrun = jax.jit(jfed.make_async_runner(
        jm, JScala(num_clients=K, lr=0.05), delays=jdm, optimizer=jo,
        faults=spec, unroll=True, **kw))
    js = jengine.init_train_state(jparams, jo)
    jaf = jfed.init_async_state(jax.random.PRNGKey(28), jparams["client"],
                                jdm, num_clients=K, guards=guards)
    ts = convert.train_state_from_reference(_np(js), pcfg)
    taf = convert.async_state_from_reference(_np(jaf), pcfg, seed=0)
    jb, jsz = jax.tree.map(jnp.asarray, batches), jnp.asarray(sizes)
    fm = jfaults.make_faults(spec)
    delays, fmasks, jmets = [np.asarray(jaf.finish_time)], [], []
    for _ in range(events):
        # the event's key splits: (ev, rest) -> ev: (masks, corrupt);
        # the delays come from the key left after the fault split
        k_ev, rest = jax.random.split(jaf.key)
        k_masks, _ = jax.random.split(k_ev)
        fmasks.append({k: np.asarray(v) for k, v in
                       jfaults.sample_fault_masks(fm, k_masks,
                                                  cohort).items()})
        delays.append(np.asarray(jdm.sample(jax.random.split(rest)[0],
                                            (cohort,))))
        js, jaf, m = jrun(js, jaf, jb, jsz)
        jmets.append(_np(m))
    trun = fed.make_async_runner(
        tm, ScalaConfig(num_clients=K, lr=0.05),
        delays=fed.delays.recorded(delays), optimizer=to,
        faults=tfaults.recorded(fmasks, stall_factor=5.0), **kw)
    tb = {k: _t(v) for k, v in batches.items()}
    rejected = 0.0
    for e in range(events):
        ts, taf, m = trun(ts, taf, tb, _t(sizes))
        want = jmets[e]
        for key in ("loss_server", "loss_client"):
            _close(m[key], want[key], f"event {e} {key}", rtol=LOSS_RTOL)
        assert m["guard_rejected"] == float(want["guard_rejected"])
        assert m["deadline_missed"] == float(want["deadline_missed"])
        assert m["t_event"] == want["t_event"]
        rejected += m["guard_rejected"]
    assert rejected >= 1
    assert sum(f["stall"].sum() for f in fmasks) >= 1
    np.testing.assert_array_equal(taf.version, np.asarray(jaf.version))
    np.testing.assert_array_equal(taf.finish_time,
                                  np.asarray(jaf.finish_time))
    np.testing.assert_array_equal(taf.retries, np.asarray(jaf.retries))
    want = convert.async_state_from_reference(_np(jaf), pcfg, seed=0)
    _close_tree(taf.client_params, want.client_params, "snapshots")
    want = convert.train_state_from_reference(_np(js), pcfg)
    _close_tree(ts.params, want.params, "params")
    _close_tree(ts.opt_state, want.opt_state, "optimizer state")


# --------------------------------------------------------------------------
# the port's own contracts on a linear split net
# --------------------------------------------------------------------------


K = 6


def _linear_model(num_classes=3):
    def client_fwd(wc, batch):
        return {"x": batch["x"] @ wc["w"]}

    def server_fwd(ws, acts):
        return acts["x"] @ ws["w"], torch.zeros(())

    def server_trunk(ws, acts):          # features == acts; the head is ws
        return acts["x"], torch.zeros(())

    def head_grad_merge(d_ws, g_w):
        return {"w": d_ws["w"] + g_w.to(d_ws["w"].dtype)}

    return engine.SplitModel(client_fwd=client_fwd, server_fwd=server_fwd,
                             num_classes=num_classes,
                             server_trunk=server_trunk,
                             head_weight=lambda ws: ws["w"],
                             head_grad_merge=head_grad_merge)


MODEL = _linear_model()
SC = ScalaConfig(num_clients=K, participation=1.0, local_iters=2, lr=0.05)


def _params(slots=K, seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"client": stack_client_params(
        {"w": torch.randn(4, 3, generator=g)}, slots),
        "server": {"w": torch.randn(3, 3, generator=g)}}


def _batches(seed=1, T=2, C=K, Bk=4):
    g = torch.Generator().manual_seed(seed)
    return {"x": torch.randn(T, C, Bk, 4, generator=g),
            "labels": torch.randint(0, 3, (T, C, Bk), generator=g)}


SIZES = torch.arange(1.0, K + 1.0)
RB = _batches()


@pytest.mark.parametrize("backend", ["logits", "lace"])
@pytest.mark.parametrize("sparse", [False, True], ids=["masked", "sparse"])
def test_guarded_zero_fault_bitwise_sync(backend, sparse):
    opt = optimizers.momentum(beta=0.9)
    part, agg = fed.uniform(K, 0.5), fed.weighted()
    kw = dict(backend=backend, optimizer=opt, aggregator=agg,
              participation=part, slot_gather=sparse)
    plain = engine.make_round_runner(MODEL, SC, **kw)
    guarded = engine.make_round_runner(MODEL, SC, guards="nonfinite,clip:1e6",
                                       **kw)
    st_p = st_g = engine.init_train_state(_params(), opt)
    fs_p = fed.init_fed_state(5, agg, part)
    fs_g = fed.init_fed_state(5, agg, part, guards="nonfinite,clip:1e6")
    for _ in range(3):
        st_p, fs_p, m_p = plain(st_p, RB, SIZES, fs_p)
        st_g, fs_g, m_g = guarded(st_g, RB, SIZES, fs_g)
        assert m_g["guard_rejected"] == 0.0
    _bits_equal(st_p.params, st_g.params, "params")
    _bits_equal(st_p.opt_state, st_g.opt_state, "opt_state")
    assert torch.equal(fs_p["sched"], fs_g["sched"])
    for k in m_p:
        assert torch.equal(m_p[k], m_g[k]), k
    assert float(fs_g["guard"]["med"]) > 0 and int(fs_g["guard"]["n"]) == 3


@pytest.mark.parametrize("backend", ["logits", "lace"])
@pytest.mark.parametrize("snapshots", ["dense", "delta"])
def test_guarded_zero_fault_bitwise_async(backend, snapshots):
    dm = fed.make_delays("lognormal:1:1")
    opt = optimizers.sgd() if snapshots == "delta" else \
        optimizers.momentum(beta=0.9)
    slots = 1 if snapshots == "delta" else K
    kw = dict(backend=backend, optimizer=opt, delays=dm, cohort=2,
              snapshots=snapshots, ring_size=3, num_clients=K)
    plain = fed.make_async_runner(MODEL, SC, **kw)
    guarded = fed.make_async_runner(MODEL, SC, guards="nonfinite", **kw)
    p = _params(slots)
    st_p, st_g = (engine.init_train_state(p, opt) for _ in range(2))
    af_p, af_g = (fed.init_async_state(7, p["client"], dm,
                                       snapshots=snapshots, ring_size=3,
                                       num_clients=K, guards=g)
                  for g in (None, "nonfinite"))
    for _ in range(4):
        st_p, af_p, m_p = plain(st_p, af_p, RB, SIZES)
        st_g, af_g, m_g = guarded(st_g, af_g, RB, SIZES)
        assert m_g["guard_rejected"] == 0.0
    _bits_equal(st_p.params, st_g.params, "params")
    _bits_equal(st_p.opt_state, st_g.opt_state, "opt_state")
    _bits_equal((af_p.client_params, af_p.ring, af_p.finish_time,
                 af_p.version, af_p.ring_versions),
                (af_g.client_params, af_g.ring, af_g.finish_time,
                 af_g.version, af_g.ring_versions), "async state")
    assert af_p.server_version == af_g.server_version == 4
    for k in m_p:
        _bits_equal(m_p[k], m_g[k], f"metric {k}")


@pytest.mark.parametrize("mode", ["nan", "inf"])
def test_corruption_rejected_and_priors_match_survivor_reference(mode):
    """The SCALA-specific bar: the guarded faulty round equals a clean
    round whose participation mask is the survivors, bit for bit."""
    opt = optimizers.momentum(beta=0.9)
    spec = f"corrupt:0.5:{mode}"
    faulty = engine.make_round_runner(
        MODEL, SC, backend="lace", optimizer=opt, aggregator=fed.weighted(),
        faults=spec, guards="nonfinite")
    st0 = engine.init_train_state(_params(), opt)
    fs = fed.init_fed_state(3, fed.weighted(), num_clients=K, faults=spec,
                            guards="nonfinite")
    st_f, fs_f, m_f = faulty(st0, RB, SIZES, fs)
    accept = m_f["guard_accept"].numpy()
    assert m_f["guard_rejected"] >= 1
    assert m_f["guard_rejected"] == K - accept.sum()
    assert all(bool(torch.isfinite(a).all()) for a in leaves(st_f.params))
    part = _recorded([accept])
    ref = engine.make_round_runner(
        MODEL, SC, backend="lace", optimizer=opt, aggregator=fed.weighted(),
        participation=part)
    st_r, _, m_r = ref(st0, RB, SIZES, fed.init_fed_state(3, fed.weighted(),
                                                          part))
    _bits_equal(st_f.params, st_r.params, "survivor-masked params")
    assert torch.equal(m_f["loss_server"], m_r["loss_server"])


def test_sparse_rejection_reruns_over_the_survivors():
    """Sparse: a rejected participant's slot leaves the gather's mask;
    the re-run equals the clean sparse round with faults on and the
    survivors as the scheduler's mask (the fill slots masked out)."""
    opt = optimizers.sgd()
    part = _fixed_scheduler([1, 1, 1, 1, 0, 0], 4)
    rec = tfaults.recorded([{"corrupt": [0, 1, 0, 0, 0, 0]}])
    runner = engine.make_round_runner(
        MODEL, SC, backend="logits", optimizer=opt,
        aggregator=fed.weighted(), participation=part, slot_gather=True,
        faults=rec, guards="nonfinite")
    st0 = engine.init_train_state(_params(), opt)
    st, _, m = runner(st0, RB, SIZES, fed.init_fed_state(0, fed.weighted(),
                                                         part, faults=rec,
                                                         guards="nonfinite"))
    assert m["guard_rejected"] == 1.0
    np.testing.assert_array_equal(m["guard_accept"].numpy(),
                                  [1, 0, 1, 1, 1, 1])
    clean = tfaults.recorded([{"drop": [0] * 6}])
    sur = _fixed_scheduler([1, 0, 1, 1, 0, 0], 4)
    ref = engine.make_round_runner(
        MODEL, SC, backend="logits", optimizer=opt,
        aggregator=fed.weighted(), participation=sur, slot_gather=True,
        faults=clean)
    st_r, _, m_r = ref(st0, RB, SIZES, fed.init_fed_state(
        0, fed.weighted(), sur, faults=clean))
    _bits_equal(st.params, st_r.params, "params")
    assert torch.equal(m["loss_server"], m_r["loss_server"])


def test_chaos_training_stays_finite_and_learns():
    opt = optimizers.momentum(beta=0.9)
    spec = "drop:0.1,corrupt:0.1:nan"
    runner = engine.make_round_runner(
        MODEL, SC, backend="lace", optimizer=opt, aggregator=fed.weighted(),
        faults=spec, guards="nonfinite")
    st = engine.init_train_state(_params(), opt)
    fs = fed.init_fed_state(11, fed.weighted(), num_clients=K, faults=spec,
                            guards="nonfinite")
    losses, rejected = [], 0.0
    for r in range(8):
        st, fs, m = runner(st, _batches(seed=100 + r), SIZES, fs)
        losses.append(float(m["loss_server"]))
        rejected += m["guard_rejected"]
        assert all(bool(torch.isfinite(a).all()) for a in leaves(st.params))
    assert rejected >= 1 and all(np.isfinite(losses))
    assert losses[-1] < losses[0]


def test_clip_guard_bounds_update_norm():
    spec = "corrupt:0.2:noise:1000.0"

    def run(guards):
        opt = optimizers.sgd()
        runner = engine.make_round_runner(
            MODEL, SC, backend="lace", optimizer=opt,
            aggregator=fed.weighted(), faults=spec, guards=guards)
        st = engine.init_train_state(_params(), opt)
        fs = fed.init_fed_state(13, fed.weighted(), num_clients=K,
                                faults=spec, guards=guards)
        before = [a.clone() for a in leaves(st.params)]
        for _ in range(3):
            st, fs, _ = runner(st, RB, SIZES, fs)
        drift = float(sum(((a - b) ** 2).sum()
                          for a, b in zip(leaves(st.params), before)) ** 0.5)
        return drift, fs

    drift_plain, _ = run(None)
    drift_clip, fs = run("nonfinite,clip:2.0")
    assert drift_clip < drift_plain / 100.0, (drift_clip, drift_plain)
    assert float(fs["guard"]["med"]) > 0.0


def test_stall_fault_with_deadline_schedule_advances():
    dm = fed.make_delays("lognormal:1:1")
    opt = optimizers.sgd()
    runner = fed.make_async_runner(
        MODEL, SC, backend="lace", optimizer=opt, delays=dm, cohort=2,
        num_clients=K, deadline=5.0, faults="stall:0.5:100",
        guards="nonfinite")
    p = _params()
    st = engine.init_train_state(p, opt)
    af = fed.init_async_state(23, p["client"], dm, guards="nonfinite")
    stalls = 0
    for _ in range(4):
        stalls += tfaults.make_faults("stall:0.5:100").draw(
            af.seed, af.server_version, 2)["stall"].sum()
        st, af, m = runner(st, af, RB, SIZES)
    assert stalls >= 1
    assert af.server_version == 4 and m["t_event"] < 1e4
    assert af.finish_time.max() > 50           # a stalled client straggles
    assert all(bool(torch.isfinite(a).all()) for a in leaves(st.params))


def test_runner_errors_and_refusals():
    dm = fed.make_delays("zero")
    with pytest.raises(ValueError, match="lace_dp"):
        fed.make_async_runner(MODEL, SC, delays=dm, cohort=2,
                              backend="lace_dp", guards="nonfinite")
    with pytest.raises(ValueError, match="paged"):
        fed.make_async_runner(MODEL, SC, delays=dm, cohort=2,
                              snapshots="delta", paged_opt=True,
                              faults="drop:0.1")
    with pytest.raises(ValueError, match="aggregate"):
        engine.make_round_runner(MODEL, SC, aggregate=False,
                                 guards="nonfinite")
    st = engine.init_train_state(_params(), optimizers.sgd())
    for kw, match in ((dict(faults="drop:0.1"), "fed_state"),
                      (dict(guards="clip:2"), "stateful")):
        with pytest.raises(ValueError, match=match):
            engine.make_round_runner(MODEL, SC, **kw)(st, RB, SIZES)
    runner = engine.make_round_runner(MODEL, SC, guards="clip:2")
    with pytest.raises(ValueError, match="guard"):
        runner(st, RB, SIZES, fed.init_fed_state(0, num_clients=K))
    runner = engine.make_round_runner(MODEL, SC, faults="drop:0.1")
    with pytest.raises(ValueError, match="faults"):
        runner(st, RB, SIZES, fed.init_fed_state(0, num_clients=K))
    ev = fed.make_async_runner(MODEL, SC, delays=dm, cohort=2,
                               guards="clip:2")
    with pytest.raises(ValueError, match="guard"):
        ev(st, fed.init_async_state(0, _params()["client"], dm), RB, SIZES)


# --------------------------------------------------------------------------
# spec, build, Trainer, CLI and the table runner
# --------------------------------------------------------------------------


def _image_spec(**over):
    kw = dict(
        arch="alexnet-cifar", method="scala", rounds=4, seed=0, width=0.125,
        scala=ScalaConfig(num_clients=4, participation=0.5, local_iters=2,
                          server_batch=24, lr=0.05),
        data=api.DataSpec(kind="image_synthetic", n_train=200, alpha=2))
    kw.update(over)
    return api.ExperimentSpec(**kw)


def _jax_spec(spec):
    return japi.ExperimentSpec.from_json(spec.to_json())


@pytest.mark.parametrize("fd,ex,match", [
    (dict(faults="drop:0.1"), dict(mode="subset"), "subset"),
    (dict(guards="nonfinite"), dict(mode="subset"), "subset"),
    (dict(faults="drop:0.1", opt_state_policy="carry"),
     dict(mode="async", snapshots="delta", opt_paging="host"),
     "opt_paging"),
    (dict(faults="drop:0.1"), dict(mode="masked"), None),
    (dict(participation="uniform:0.5", guards="nonfinite,clip:5"),
     dict(mode="sparse"), None),
    (dict(faults="corrupt:0.2:inf", guards="nonfinite"),
     dict(mode="async", snapshots="delta", deadline=2.0), None),
])
def test_validate_fault_rules_match_reference(fd, ex, match):
    spec = _image_spec(fed=api.FedSpec(**fd),
                       execution=api.ExecutionSpec(**ex))
    if match is None:
        assert spec.validate() is spec
        assert _jax_spec(spec).validate() is not None
        return
    with pytest.raises(ValueError) as got:
        spec.validate()
    with pytest.raises(ValueError) as want:
        _jax_spec(spec).validate()
    assert str(got.value) == str(want.value)
    assert match in str(got.value)
    with pytest.raises(ValueError, match="unknown fault clause"):
        api.FedSpec(faults="explode:0.1")


def test_trainer_resume_bitwise_sync_masked(tmp_path):
    kw = dict(fed=api.FedSpec(faults="drop:0.2,corrupt:0.3:nan",
                              guards="nonfinite,clip:10"),
              execution=api.ExecutionSpec(mode="masked"))
    straight = api.Trainer(_image_spec(**kw), device="cpu")
    straight.run(4)
    assert "guard_rejected" in straight.history[0]
    assert sum(h["guard_rejected"] for h in straight.history) >= 1
    first = api.Trainer(_image_spec(**kw), device="cpu")
    first.run(3)
    first.save(str(tmp_path))
    resumed = api.Trainer(_image_spec(**kw), device="cpu")
    assert resumed.resume(str(tmp_path)) == 3
    resumed.run(1)
    _bits_equal(resumed.state, straight.state, "full program state")
    assert resumed.state.fed["faults"].tolist() == \
        straight.state.fed["faults"].tolist()
    assert resumed.history == straight.history


def test_trainer_resume_bitwise_async_delta_chaos(tmp_path):
    def mk():
        return _image_spec(
            fed=api.FedSpec(faults="drop:0.2,corrupt:0.3:nan",
                            guards="nonfinite,clip:10.0"),
            execution=api.ExecutionSpec(mode="async", snapshots="delta",
                                        ring_size=2, cohort=2, deadline=5.0,
                                        backoff=2.0))

    straight = api.Trainer(mk(), device="cpu")
    straight.run(4)
    first = api.Trainer(mk(), device="cpu")
    first.run(2)
    first.save(str(tmp_path))
    resumed = api.Trainer(mk(), device="cpu")
    assert resumed.resume(str(tmp_path)) == 2
    resumed.run(2)
    _bits_equal(resumed.state, straight.state, "full program state")
    assert int(resumed.state.fed.guard["n"]) > 0
    assert resumed.history == straight.history


def test_build_threads_faults_and_guards():
    spec = _image_spec(fed=api.FedSpec(faults="drop:0.1",
                                       guards="nonfinite"),
                       execution=api.ExecutionSpec(mode="masked"))
    prog = api.build(spec, device="cpu")
    st = prog.init()
    from repro_torch.api.build import fed_seed

    assert prog.metadata["thread_fed"]
    assert st.fed["faults"].tolist() == [fed_seed(spec), 0]
    assert st.fed["guard"] == ()
    spec = _image_spec(fed=api.FedSpec(guards="nonfinite"),
                       execution=api.ExecutionSpec(mode="masked"))
    assert not api.build(spec, device="cpu").metadata["thread_fed"]
    spec = _image_spec(fed=api.FedSpec(guards="clip:3"),
                       execution=api.ExecutionSpec(mode="async", cohort=2))
    st = api.build(spec, device="cpu").init()
    assert set(st.fed.guard) == {"med", "n"}


CLI = ["--arch", "qwen1.5-0.5b", "--reduced", "--device", "cpu",
       "--clients", "4", "--local-iters", "2", "--seq", "16",
       "--server-batch", "8", "--docs-per-client", "3", "--rounds", "2"]


@pytest.mark.parametrize("extra", [
    ["--participation", "uniform:0.5"],
    ["--participation", "uniform:0.5", "--slot-gather"],
    ["--async", "--cohort", "2", "--deadline", "2.0", "--optimizer",
     "momentum"],
    ["--async", "--cohort", "2", "--snapshots", "delta", "--ring-size",
     "4"],
], ids=["masked", "sparse", "async-dense", "async-delta"])
def test_cli_runs_faults_and_guards(extra, capsys):
    trainer = train.main(CLI + extra + [
        "--faults", "drop:0.1,corrupt:0.5:nan", "--guards",
        "nonfinite,clip:10"])
    out = capsys.readouterr().out
    assert out.rstrip().endswith("done")
    assert "faults: drop:0.1,corrupt:0.5:nan" in out
    h = trainer.history
    assert len(h) == 2 and all("guard_rejected" in m for m in h)
    assert all(np.isfinite(m["loss_server"]) for m in h)
    assert all(bool(torch.isfinite(a).all())
               for a in leaves(trainer.state.inner.params))


def test_faults_table_leg(tmp_path):
    from repro_torch.benchmarks import run as table_run

    res = table_run.main(["--table", "faults", "--device", "cpu", "--quick",
                          "--out", str(tmp_path / "f.json")])
    assert set(res["modes"]) == {"masked", "async"}
    for row in res["modes"].values():
        assert row["unguarded_s_per_round"] > 0
        for g in ("nonfinite", "nonfinite,clip:10.0"):
            assert row[g]["guard_overhead"] > 0
    assert res["chaos"]["finite"] and res["device"]["platform"] == "cpu"
    assert os.path.exists(tmp_path / "f.json")
