"""The port's event scheduling on the CPU: the arrival pop, the host-paged
moments, the spec plumbing (the assertions of ``tests/test_arrival.py``).

* The pop (``repro_torch.fed.arrival_cohort``, host numpy) against the
  reference's (``repro.fed.arrival_cohort``) on the same numpy inputs:
  ``idx``, ``mask`` and ``t_event`` exactly, for ``sort`` and ``topk``, on
  random schedules (tie-free and tie-heavy, with and without versions)
  and on the tie cases; and ``topk`` == ``sort`` bit for bit within the
  port, at the pop and over whole event sequences.
* The host-paged store: delta + carry + momentum through
  :class:`repro_torch.fed.HostOptPager` follows dense + carry bit for
  bit, with one device slot of moments and all K rows in host numpy.
* ``ExecutionSpec`` / ``validate``: the reference's errors on the same
  specs; the sharded pop needs a grid (``build(spec, mesh=)``; its
  parity is ``tests/test_torch_dp_pop.py``'s).

Left out: the reference's mesh-sharded pop and the sharded schedule
scalars (a forced 4-device mesh), its 10k-client paged run (``slow``),
and the dirichlet / ``slot_gather_indices`` rewrites, whose port tests
are ``tests/test_torch_fed.py``'s.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import api as japi
from repro import fed as jfed
from repro.configs.base import ScalaConfig as JScala
from repro_torch import api, fed
from repro_torch.configs import ScalaConfig
from repro_torch.core import engine
from repro_torch.core.scala import alexnet_split_model
from repro_torch.core.split import stack_client_params
from repro_torch.models import alexnet as A
from repro_torch.optim import optimizers
from repro_torch.tree import leaves

torch.set_num_threads(1)


def _random_schedule(rng, K):
    """The reference test's schedule kinds: all zeros, one constant,
    lognormal, integer-valued (maximal ties); versions up to 2^30 or
    none."""
    kind = rng.integers(4)
    if kind == 0:
        ft = np.zeros(K, np.float32)
    elif kind == 1:
        ft = np.full(K, float(rng.integers(1, 5)), np.float32)
    elif kind == 2:
        ft = rng.lognormal(0.0, 1.0, K).astype(np.float32)
    else:
        ft = rng.integers(0, 3, K).astype(np.float32)
    v = (rng.integers(0, rng.choice([4, 1 << 20, 1 << 30]), K).astype(
        np.int32) if rng.integers(2) else None)
    return ft, v


def _same_pop(port, ref):
    for a, b in zip(port, ref):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert port[0].dtype == np.int64 and port[1].dtype == np.float32
    assert isinstance(port[2], np.float32)


@pytest.mark.parametrize("method", ["sort", "topk"])
def test_pop_matches_reference_randomized(method):
    rng = np.random.default_rng(0)
    for K, cohort in [(7, 1), (7, 3), (7, 7), (16, 4), (16, 11)]:
        for _ in range(8):
            ft, v = _random_schedule(rng, K)
            ref = jfed.arrival_cohort(jnp.asarray(ft), cohort,
                                      None if v is None else jnp.asarray(v),
                                      method=method)
            _same_pop(fed.arrival_cohort(ft, cohort, v, method=method), ref)


TIE_CASES = [
    # finish-time tie -> lowest version (FIFO), then lowest slot id
    (np.array([1.0, 1.0, 1.0, 2.0], np.float32),
     np.array([5, 3, 3, 0], np.int32), 2, [1, 2]),
    # negative versions (never produced by the runtime) still order
    (np.zeros(3, np.float32), np.array([1, -2, 0], np.int32), 1, [1]),
    # the two t=1.0 finishers, by slot id; ascending ids
    (np.array([3.0, 1.0, 2.0, 1.0], np.float32), None, 2, [1, 3]),
    (np.array([3.0, 1.0, 2.0, 1.0], np.float32), None, 3, [1, 2, 3]),
    (np.array([1.0, 1.0, 1.0, 2.0], np.float32),
     np.array([5, 3, 4, 0], np.int32), 2, [1, 2]),
]


@pytest.mark.parametrize("method", ["sort", "topk"])
@pytest.mark.parametrize("case", range(len(TIE_CASES)))
def test_pop_tie_cases_match_reference(method, case):
    ft, v, cohort, want = TIE_CASES[case]
    port = fed.arrival_cohort(ft, cohort, v, method=method)
    np.testing.assert_array_equal(port[0], want)
    ref = jfed.arrival_cohort(jnp.asarray(ft), cohort,
                              None if v is None else jnp.asarray(v),
                              method=method)
    _same_pop(port, ref)


def test_topk_pop_bit_identical_to_sort_at_scale():
    rng = np.random.default_rng(1)
    for K, cohort in [(1000, 8), (4096, 64), (20_000, 1)]:
        for ft in (rng.lognormal(0, 1, K).astype(np.float32),
                   rng.integers(0, 2, K).astype(np.float32)):
            v = rng.integers(0, 50, K).astype(np.int32)
            a = fed.arrival_cohort(ft, cohort, v, method="sort")
            b = fed.arrival_cohort(ft, cohort, v, method="topk")
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)


def test_arrival_cohort_rejects_unknown_method():
    with pytest.raises(ValueError, match="arrival"):
        fed.arrival_cohort(np.zeros(4, np.float32), 2, method="bogus")
    # the sharded pop is its own function, and it needs the grid
    with pytest.raises(ValueError, match="sharded_arrival_cohort"):
        fed.arrival_cohort(np.zeros(4, np.float32), 2, method="topk:sharded")
    with pytest.raises(ValueError, match="mesh"):
        fed.make_arrival_pop(2, "topk:sharded")


def _alexnet(K, seed=0, width=0.0625):
    gen = torch.Generator().manual_seed(seed)
    wc, ws = A.split_params(A.init_params(gen, num_classes=10, width=width),
                            "s2")
    return (alexnet_split_model("s2", num_classes=10), wc, ws)


def _round_batches(seed, T=2, C=4, Bk=4):
    rng = np.random.default_rng(seed)
    return {"x": torch.from_numpy(rng.standard_normal(
        (T, C, Bk, 32, 32, 3)).astype(np.float32)),
        "labels": torch.from_numpy(rng.integers(0, 10, (T, C, Bk))),
        "weights": torch.ones((T, C, Bk))}


@pytest.mark.parametrize("delay_spec", ["zero", "constant:2",
                                        "lognormal:1:1"])
def test_topk_runner_event_sequence_matches_sort(delay_spec):
    """Whole event sequences (masks, versions, finish times, params)
    bit-identical between arrival 'sort' and 'topk'."""
    K, cohort = 8, 3
    dm = fed.make_delays(delay_spec)
    model, wc, ws = _alexnet(K, seed=5)
    traces = {}
    for arr in ("sort", "topk"):
        event = fed.make_async_runner(model, ScalaConfig(lr=0.05), delays=dm,
                                      cohort=cohort, arrival=arr)
        params = {"client": stack_client_params(wc, K), "server": ws}
        state = engine.init_train_state(params, optimizers.sgd())
        afed = fed.init_async_state(6, params["client"], dm)
        seq = []
        for e in range(6):
            state, afed, m = event(state, afed, _round_batches(e, C=K))
            seq.append((m["arrival_mask"], afed.version.copy(),
                        afed.finish_time.copy()))
        seq.append(tuple(a.numpy() for a in leaves(state.params)))
        traces[arr] = seq
    for a, b in zip(traces["sort"], traces["topk"]):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


def test_paged_delta_carry_matches_dense_carry_momentum():
    """delta + carry + momentum through the host pager follows dense +
    carry bit for bit (within the ring), with a one-slot device moment
    stack and every client's moments in host numpy."""
    K, cohort, ring = 8, 3, 64
    dm = fed.make_delays("lognormal:1:1")
    sc = ScalaConfig(lr=0.05)
    mom = optimizers.momentum(0.9)
    model, wc, ws = _alexnet(K, seed=9)
    r_dense = fed.make_async_runner(model, sc, delays=dm, cohort=cohort,
                                    optimizer=mom, opt_state_policy="carry")
    pd = {"client": stack_client_params(wc, K), "server": ws}
    st_d = engine.init_train_state(pd, mom)
    af_d = fed.init_async_state(10, pd["client"], dm)
    r_paged = fed.make_async_runner(
        model, sc, delays=dm, cohort=cohort, optimizer=mom,
        opt_state_policy="carry", snapshots="delta", ring_size=ring,
        num_clients=K, paged_opt=True)
    pop = fed.make_arrival_pop(cohort, "topk")
    pp = {"client": stack_client_params(wc, 1), "server": ws}
    st_p = engine.init_train_state(pp, mom)
    af_p = fed.init_async_state(10, pp["client"], dm, snapshots="delta",
                                ring_size=ring, num_clients=K)
    pager = fed.HostOptPager(mom, wc, K)
    assert pager.nbytes() == K * sum(a.numel() * 4 for a in leaves(wc))
    with pytest.raises(ValueError, match="cohort_opt"):
        r_paged(st_p, af_p, _round_batches(0, C=K))
    for e in range(6):
        rb = _round_batches(e, C=K)
        st_d, af_d, _ = r_dense(st_d, af_d, rb)
        idx = pop(af_p.finish_time, af_p.version)[0]
        st_p, af_p, _, new_co = r_paged(st_p, af_p, rb, None,
                                        pager.gather(idx))
        pager.scatter(idx, new_co)
    for a, b in zip(leaves(st_d.params["client"]),
                    leaves(st_p.params["client"])):
        assert torch.equal(a[0], b[0])
    for a, b in zip(leaves(st_d.params["server"]),
                    leaves(st_p.params["server"])):
        assert torch.equal(a, b)
    # the carried moments themselves: every slot's dense row equals its
    # host row
    for d, h in zip(leaves(st_d.opt_state["client"]),
                    leaves(pager._store)):
        np.testing.assert_array_equal(d.numpy(), h)
    for leaf in leaves(st_p.opt_state["client"]):
        assert leaf.shape[0] == 1
    for leaf in leaves(pager._store):
        assert isinstance(leaf, np.ndarray) and leaf.shape[0] == K
    pager.reset()
    assert all(not a.any() for a in leaves(pager._store))


def test_pager_adamw_rows_and_roundtrip():
    """AdamW's moments and its per-client step count page in and out by
    row; the other rows stay as they were."""
    from repro_torch.tree import tree_map

    _, wc, _ = _alexnet(4)
    pager = fed.HostOptPager(optimizers.adamw(), wc, 5)
    assert pager._store["count"].shape == (5,)
    assert pager._store["count"].dtype == np.int32
    idx = np.array([1, 3])
    rows = pager.gather(idx)
    assert rows["count"].shape == (2,)
    rows = {"mu": tree_map(lambda a: torch.full_like(a, 2.0), rows["mu"]),
            "nu": tree_map(torch.ones_like, rows["nu"]),
            "count": torch.tensor([4, 7], dtype=torch.int32)}
    pager.scatter(idx, rows)
    np.testing.assert_array_equal(pager._store["count"], [0, 4, 0, 7, 0])
    for a in leaves(pager._store["mu"]):
        assert (a[idx] == 2.0).all() and (a[[0, 2, 4]] == 0.0).all()
    back = pager.gather(idx)
    assert all(torch.equal(a, torch.ones_like(a))
               for a in leaves(back["nu"]))
    assert pager.seconds["page_in"] > 0 and pager.seconds["page_out"] > 0


def test_paged_requires_delta_carry():
    model, _, _ = _alexnet(4)
    dm = fed.make_delays("zero")
    with pytest.raises(ValueError, match="paged_opt"):
        fed.make_async_runner(model, ScalaConfig(), delays=dm, cohort=2,
                              paged_opt=True, snapshots="dense")
    with pytest.raises(ValueError, match="paged_opt"):
        fed.make_async_runner(model, ScalaConfig(), delays=dm, cohort=2,
                              paged_opt=True, snapshots="delta",
                              opt_state_policy="reset")


def _specs(ex_kw):
    """The same spec in both packages."""
    kw = dict(method="scala", arch="alexnet-cifar")
    port = api.ExperimentSpec(
        scala=ScalaConfig(num_clients=8), optim=api.OptimSpec(
            name="momentum"), fed=api.FedSpec(opt_state_policy="carry"),
        execution=api.ExecutionSpec(**ex_kw),
        data=api.DataSpec(kind="image_synthetic", alpha=2), **kw)
    ref = japi.ExperimentSpec(
        scala=JScala(num_clients=8), optim=japi.OptimSpec(name="momentum"),
        fed=japi.FedSpec(opt_state_policy="carry"),
        execution=japi.ExecutionSpec(**ex_kw),
        data=japi.DataSpec(kind="image_synthetic", alpha=2), **kw)
    return port, ref


@pytest.mark.parametrize("ex_kw,match", [
    (dict(mode="masked", arrival="topk"), "mode 'async' only"),
    (dict(mode="async", opt_paging="host"), "snapshots='delta'"),
    (dict(mode="async", snapshots="delta", opt_paging="host",
          rounds_per_call=2), "rounds_per_call"),
    (dict(mode="async", snapshots="delta"), "cannot carry"),
    (dict(mode="async", snapshots="delta", opt_paging="host"), None),
    (dict(mode="async", arrival="topk"), None),
])
def test_spec_validation_arrival_and_paging(ex_kw, match):
    port, ref = _specs(ex_kw)
    if match is None:
        assert port.validate() is port
        ref.validate()
        return
    with pytest.raises(ValueError, match=match):
        port.validate()
    with pytest.raises(ValueError, match=match):
        ref.validate()


def test_spec_structural_checks_and_the_sharded_pop():
    with pytest.raises(ValueError, match="unknown arrival"):
        api.ExecutionSpec(arrival="bogus")
    with pytest.raises(ValueError, match="unknown opt_paging"):
        api.ExecutionSpec(opt_paging="device")
    port, ref = _specs(dict(mode="async", arrival="topk:sharded"))
    ref.validate()            # both build it with a mesh, and only so
    assert port.validate() is port
    with pytest.raises(ValueError, match="needs build\\(spec, mesh=\\)"):
        api.build(port, device="cpu")
