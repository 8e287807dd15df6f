"""The sharded schedule pieces of the port's multi-device path, on the CPU.

* ``fed.sharded_arrival_cohort`` (``arrival="topk:sharded"``): over 1, 2
  and 4 client shards, with cohorts that do and do not divide by them,
  on schedules full of ties (equal finish times, equal versions), its
  (idx, mask, t_event) is bitwise the single pop's (``arrival_cohort``,
  both methods) -- the mask as each shard's block.
* ``DelayModel.sample_sharded``: every shard's block is bitwise its slice
  of the unsharded draw, for every delay model.
* ``Aggregator.shard_local`` (``fedavg``, ``weighted``, ``hierarchical``):
  each shard's raw weights, masked and renormalized over all shards,
  are the flat ``client_weights`` (the reference's
  ``tests/test_fed.py:692-726``); the stateful and prior-aware
  aggregators have none.

The shards run as threads of one process: a stand-in for the grid's
client group gathers (and sums) through a barrier, so the pop and the
weights see exactly the collectives they make on a real grid (which
``tests/test_torch_dp.py`` runs over gloo).
"""
import threading

import numpy as np
import pytest
import torch

from repro_torch import fed
from repro_torch.fed import delays as D

torch.set_num_threads(1)


class ThreadGrid:
    """One shard's view of a client group whose ranks are threads."""

    def __init__(self, shared, index):
        self.shared, self.client_index = shared, index
        self.n_client_shards = shared["n"]

    def _exchange(self, value):
        sh = self.shared
        sh["slots"][self.client_index] = value
        sh["barrier"].wait()
        out = list(sh["slots"])
        sh["barrier"].wait()
        return out

    def all_gather_host(self, a, group="client"):
        return np.concatenate(self._exchange(np.asarray(a)))

    def sum(self, t):
        return sum(self._exchange(t))


def _run_shards(n, fn):
    """``fn(grid)`` on n threads, one per shard; their results in order."""
    shared = {"n": n, "slots": [None] * n, "barrier": threading.Barrier(n)}
    out, errs = [None] * n, []

    def run(i):
        try:
            out[i] = fn(ThreadGrid(shared, i))
        except BaseException as e:                 # noqa: BLE001
            errs.append(e)
            shared["barrier"].abort()

    threads = [threading.Thread(target=run, args=(i,)) for i in range(n)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(60)
    if errs:
        raise errs[0]
    return out


def _schedule(seed, K, kind):
    rng = np.random.default_rng(seed)
    if kind == "ties":          # few distinct times and versions
        ft = rng.integers(0, 3, K).astype(np.float32)
        v = rng.integers(0, 2, K).astype(np.int32)
    elif kind == "zero":        # every client at once: slot order decides
        ft = np.zeros(K, np.float32)
        v = np.zeros(K, np.int32)
    else:
        ft = rng.lognormal(0.0, 1.0, K).astype(np.float32)
        v = rng.integers(0, 5, K).astype(np.int32)
    return ft, v


@pytest.mark.parametrize("n_shards", [1, 2, 4])
@pytest.mark.parametrize("cohort", [1, 3, 4, 7, 16])
@pytest.mark.parametrize("kind", ["ties", "zero", "spread"])
def test_sharded_pop_is_the_single_pop(n_shards, cohort, kind):
    K = 16
    ft, v = _schedule(cohort * 31 + n_shards, K, kind)
    idx, mask, t_event = fed.arrival_cohort(ft, cohort, v, method="sort")
    idx_t, mask_t, t_t = fed.arrival_cohort(ft, cohort, v, method="topk")
    np.testing.assert_array_equal(idx, idx_t)
    k = K // n_shards
    res = _run_shards(n_shards, lambda g: fed.sharded_arrival_cohort(
        ft[g.client_index * k:(g.client_index + 1) * k], cohort,
        v[g.client_index * k:(g.client_index + 1) * k], mesh=g))
    for i, (idx_s, mask_s, t_s) in enumerate(res):
        np.testing.assert_array_equal(idx_s, idx)
        assert idx_s.dtype == idx.dtype
        np.testing.assert_array_equal(mask_s, mask[i * k:(i + 1) * k])
        assert t_s == t_event and t_s.dtype == np.float32


def test_sharded_pop_through_make_arrival_pop_and_errors():
    ft, v = _schedule(0, 8, "ties")
    res = _run_shards(2, lambda g: fed.make_arrival_pop(
        3, "topk:sharded", mesh=g)(ft[g.client_index * 4:][:4],
                                   v[g.client_index * 4:][:4]))
    np.testing.assert_array_equal(res[0][0], fed.arrival_cohort(
        ft, 3, v)[0])
    with pytest.raises(ValueError, match="mesh"):
        fed.make_arrival_pop(3, "topk:sharded")
    with pytest.raises(ValueError, match="exceeds"):
        _run_shards(2, lambda g: fed.sharded_arrival_cohort(
            ft[:4], 9, v[:4], mesh=g))


@pytest.mark.parametrize("spec", ["zero", "constant:2", "uniform:0.5:3",
                                  "lognormal:1:1.5"])
@pytest.mark.parametrize("n_shards", [1, 2, 4])
def test_sample_sharded_is_the_slice_of_the_draw(spec, n_shards):
    dm = D.make_delays(spec)
    K = 12
    for version in (0, 5):
        full = dm.draw(7, version, (K,))
        blocks = [dm.sample_sharded(7, version, K, n_shards, s)
                  for s in range(n_shards)]
        np.testing.assert_array_equal(np.concatenate(blocks), full)
        assert all(b.dtype == np.float32 for b in blocks)
    with pytest.raises(ValueError, match="split"):
        dm.sample_sharded(7, 0, 10, 4, 0)


def test_sample_sharded_recorded_model():
    table = [np.arange(8, dtype=np.float32), np.ones(4, np.float32)]
    dm = D.recorded(table)
    np.testing.assert_array_equal(dm.sample_sharded(0, 0, 8, 2, 1),
                                  table[0][4:])
    np.testing.assert_array_equal(dm.sample_sharded(0, 1, 4, 4, 3),
                                  table[1][3:])


@pytest.mark.parametrize("spec", ["fedavg", "weighted", "hierarchical:4"])
def test_shard_local_decomposition_matches_flat_weights(spec):
    agg = fed.make_aggregator(spec)
    C = 8
    mask = torch.tensor([1, 0, 1, 1, 0, 1, 1, 1], dtype=torch.float32)
    sizes = torch.arange(2.0, 10.0)
    w_flat, _ = agg.client_weights(
        fed.AggContext(num_clients=C, mask=mask, data_sizes=sizes), ())
    for n in (1, 2, 4):
        k = C // n
        blocks = _run_shards(n, lambda g: agg.shard_local(
            mask[g.client_index * k:(g.client_index + 1) * k],
            sizes[g.client_index * k:(g.client_index + 1) * k],
            g.sum if n > 1 else None, n))
        raw = torch.cat(blocks) * mask
        np.testing.assert_allclose((raw / raw.sum()).numpy(),
                                   w_flat.numpy(), atol=1e-6)
    with pytest.raises(ValueError, match="divide"):
        fed.hierarchical(2).shard_local(mask[:2], sizes[:2], None,
                                        n_shards=4)


def test_shard_local_absent_on_stateful_and_prior_aggregators():
    assert fed.bias_compensated().shard_local is None
    assert fed.staleness_weighted().shard_local is None
    for name in ("fedavg", "weighted", "hierarchical:2"):
        assert fed.make_aggregator(name).shard_local is not None
