"""One rank of the port's ``lace_dp`` checks over gloo on the CPU.

Run by ``tests/test_torch_dp.py``, one process a rank:

    python tests/torch_dp_worker.py JOB RANK WORLD INIT_URL INPUTS OUT

``INPUTS`` is a ``torch.save`` of the test's payload (the port's config
fields, converted params, numpy batches, sizes, masks); rank 0 writes the
job's results to ``OUT``. The worker imports torch and the port, never
JAX. Jobs: ``grid4`` (a ``(data=2, model=2)`` grid: the step fused and
dual, the full, masked and sparse rounds, the async events, the dp ops,
the sharded pop and a single-program event that pops with it),
``grid1`` (a one-rank grid against the no-grid calls).
"""
from __future__ import annotations

import dataclasses
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch import fed  # noqa: E402
from repro_torch.configs.base import (InputShape, ModelConfig,  # noqa: E402
                                      ScalaConfig)
from repro_torch.core import engine  # noqa: E402
from repro_torch.core.scala import transformer_split_model  # noqa: E402
from repro_torch.kernels.lace import ops  # noqa: E402
from repro_torch.launch.input_specs import train_batch_specs  # noqa: E402
from repro_torch.optim import optimizers  # noqa: E402
from repro_torch.sharding import Grid, tree_specs  # noqa: E402
from repro_torch.tree import leaves, tree_map  # noqa: E402

CE_CHUNK = 8


def recorded(masks, shards=1):
    """A scheduler that hands out ``masks`` in order."""
    def sample(state):
        return np.array(masks[int(state)], np.float32), state + 1

    return fed.ParticipationScheduler(
        name="recorded", num_clients=len(masks[0]),
        init=lambda seed: torch.tensor(0), sample=sample,
        subset_size=int(masks[0].sum()), shards=shards)


def full_state(grid, st):
    """A local TrainState's params with the client shards gathered."""
    return {"client": grid.gather_clients(st.params["client"]),
            "server": st.params["server"]}


def scalars(metrics):
    return {k: float(metrics[k]) for k in ("loss_server", "loss_client")}


class Job:
    def __init__(self, payload, grid):
        self.p = payload
        self.grid = grid
        self.cfg = ModelConfig(**payload["cfg"])
        self.model = transformer_split_model(self.cfg)
        C, T, Bk, S = payload["dims"]
        self.C, self.T = C, T
        shapes, axes = train_batch_specs(
            self.cfg, InputShape("t", S, C * Bk, "train"), C)
        self.specs = tree_specs(axes, shapes, grid)
        self.batches = {k: torch.from_numpy(v)
                        for k, v in payload["batches"].items()}
        self.sizes = torch.from_numpy(payload["sizes"])
        self.sc = ScalaConfig(num_clients=C, lr=0.05,
                              grad_reduce_dtype=None)

    def state(self, params=None, opt=None, local=True):
        params = self.p["params"] if params is None else params
        params = tree_map(torch.clone, params)
        if local:
            params = {"client": self.grid.local_clients(params["client"]),
                      "server": params["server"]}
        return engine.init_train_state(params, opt or optimizers.sgd())

    def step(self, boundary):
        step = engine.make_split_step(
            self.model, self.sc, backend="lace_dp", boundary=boundary,
            ce_chunk=CE_CHUNK, mesh=self.grid, batch_specs=self.specs)
        st, m = step(self.state(), {k: v[0] for k, v in
                                    self.batches.items()})
        return {"params": full_state(self.grid, st), **scalars(m)}

    def round(self, sc=None, **kw):
        rnd = engine.make_round_runner(
            self.model, sc or self.sc, backend="lace_dp", ce_chunk=CE_CHUNK,
            mesh=self.grid, batch_specs=self.specs, **kw)
        st = self.state()
        fs = (fed.init_fed_state(0, kw.get("aggregator"),
                                 kw.get("participation"),
                                 faults=kw.get("faults"),
                                 guards=kw.get("guards"))
              if "participation" in kw else None)
        out = []
        for _ in range(len(self.p["masks"]) if fs is not None else 1):
            if fs is None:
                st, m = rnd(st, self.batches, self.sizes)
            else:
                st, fs, m = rnd(st, self.batches, self.sizes, fs)
            out.append(dict(scalars(m), **{
                k: m[k] for k in ("guard_accept", "guard_rejected")
                if k in m}))
        return {"params": full_state(self.grid, st), "metrics": out}

    def async_events(self, snapshots, cohort, events, one_global=False):
        """``events`` zero-delay events; ``one_global``: every slot starts
        from slot 0's client half (the delta layout's one global half;
        delta always does)."""
        dm = fed.make_delays("zero")
        slots = 1 if snapshots == "delta" else self.C
        params = self.p["params"]
        if one_global or snapshots == "delta":
            params = {"client": tree_map(
                lambda a: a[:1].expand((slots,) + a.shape[1:]).clone(),
                params["client"]), "server": params["server"]}
        st = self.state(params, local=snapshots == "dense")
        client = st.params["client"]
        af = fed.init_async_state(3, client, dm, snapshots=snapshots,
                                  ring_size=4, num_clients=self.C,
                                  mesh=self.grid)
        ev = fed.make_async_runner(
            self.model, self.sc, backend="lace_dp", ce_chunk=CE_CHUNK,
            delays=dm, cohort=cohort, snapshots=snapshots, ring_size=4,
            num_clients=self.C, mesh=self.grid, batch_specs=self.specs)
        out = []
        for _ in range(events):
            st, af, m = ev(st, af, self.batches, self.sizes)
            out.append({**scalars(m), "t": float(m["t_event"]),
                        "stale": float(m["staleness_mean"])})
        row0 = tree_map(lambda a: a[:1], st.params["client"])
        return {"params": {"client": (row0 if slots == 1 else
                                      self.grid.gather_clients(
                                          st.params["client"])),
                           "server": st.params["server"]},
                "metrics": out,
                "version": self.grid.all_gather_host(af.version),
                "server_version": af.server_version}

    def ops(self):
        """The dp ops on this rank's block of a global boundary against
        nothing (rank 0 returns the gathered gradients)."""
        g = self.p["boundary"]
        grid = self.grid
        spec = ("data", "model")
        f = grid.shard(torch.from_numpy(g["feats"]), spec).clone()
        lab = grid.shard(torch.from_numpy(g["labels"]), spec)
        wt = grid.shard(torch.from_numpy(g["weights"]), spec)
        pk = grid.shard(torch.from_numpy(g["p_k"]), ("data",))
        ids = torch.arange(pk.shape[0])
        w = torch.from_numpy(g["w_head"])
        fg = f.clone().requires_grad_()
        wg = w.clone().requires_grad_()
        loss = ops.lace_loss_dp(fg, wg, lab, pk, ids, wt, 1.0, 1e-8, 8,
                                grid=grid)
        loss.backward()
        ps = torch.from_numpy(g["p_s"])[None]
        out2 = ops.lace2_grads_dp(f, w, lab, ps, None, pk, ids, wt, 1.0,
                                  1e-8, 8, grid=grid)

        def full(t):  # (G_l, N_l, d) blocks back to (G, N, d)
            t = grid.all_gather(t.contiguous(), "inner").reshape(
                grid.inner_size, *t.shape)
            t = torch.cat(list(t), 1)
            return grid.gather_clients(t)

        return {"lace_loss_dp": {"loss": float(loss), "df": full(fg.grad),
                                 "dw": wg.grad},
                "lace2_grads_dp": {"loss_s": float(out2[0]),
                                   "loss_k": float(out2[1]),
                                   "df_s": full(out2[2]),
                                   "df_k": full(out2[3]), "dw": out2[4]}}


def sharded_pop(job):
    """The sharded pop over the grid's two client shards against the
    single pop, on tie-heavy schedules (every rank draws the same)."""
    grid, rng, same = job.grid, np.random.default_rng(3), True
    for cohort in (1, 3, 5, 8):
        ft = rng.integers(0, 3, 8).astype(np.float32)
        v = rng.integers(0, 2, 8).astype(np.int32)
        want = fed.arrival_cohort(ft, cohort, v, method="topk")
        cs = grid.client_slice(8)
        got = fed.sharded_arrival_cohort(ft[cs], cohort, v[cs], mesh=grid)
        same &= (np.array_equal(got[0], want[0])
                 and np.array_equal(got[1], want[1][cs])
                 and got[2] == want[2])
    return bool(same)


def sharded_event(job, **robust):
    """Three lognormal-delay events of the single-program ``lace`` event
    with ``arrival="topk:sharded"`` (the schedule split over the grid)
    and with ``"topk"`` (``robust``: a deadline, faults, guards): (max
    |param difference|, the metrics of each)."""
    dm = fed.make_delays("lognormal:1:1.5")
    out = []
    for arrival, mesh in (("topk", None), ("topk:sharded", job.grid)):
        st = job.state(local=False)
        af = fed.init_async_state(4, st.params["client"], dm,
                                  num_clients=job.C, mesh=mesh,
                                  guards=robust.get("guards"))
        ev = fed.make_async_runner(
            job.model, job.sc, backend="lace", ce_chunk=CE_CHUNK, delays=dm,
            cohort=3, arrival=arrival, mesh=mesh, **robust)
        losses = []
        for _ in range(3):
            st, af, m = ev(st, af, job.batches, job.sizes)
            losses.append((float(m["loss_server"]), float(m["t_event"]),
                           float(m["staleness_mean"]),
                           float(m.get("deadline_missed", -1)),
                           float(m.get("guard_rejected", -1))))
        out.append((st.params, losses))
    diff = max(float((a - b).abs().max()) for a, b in zip(
        leaves(out[0][0]), leaves(out[1][0])))
    return {"diff": diff, "losses": [out[0][1], out[1][1]]}


def grid4(job):
    p = job.p
    res = {"step_fused": job.step("fused"), "step_dual": job.step("dual"),
           "round": job.round()}
    res["masked"] = job.round(
        aggregator=fed.bias_compensated(),
        participation=recorded(p["masks"]))
    res["sparse"] = job.round(
        aggregator=fed.weighted(),
        participation=recorded(p["masks_sharded"], shards=2),
        slot_gather=True)
    res["bf16_wire"] = job.round(sc=dataclasses.replace(
        job.sc, grad_reduce_dtype="bfloat16"))
    res["async"] = job.async_events("dense", job.C, 2)
    res["async_dense"] = job.async_events("dense", 2, 3, one_global=True)
    res["async_delta"] = job.async_events("delta", 2, 3)
    res["ops"] = job.ops()
    res["stats"] = job.grid.stats
    res["sharded_pop"] = sharded_pop(job)
    res["sharded_event"] = sharded_event(job)
    res["sharded_event_robust"] = sharded_event(
        job, deadline=0.05, faults="drop:0.2,stall:0.3", guards="nonfinite")
    res["masked_robust"] = job.round(
        aggregator=fed.bias_compensated(),
        participation=recorded(p["masks"]), **p["robust"])
    return res


def grid1(job):
    return {"round": job.round(), "ops": job.ops()}


def main():
    name, rank, world, init, inputs, out = sys.argv[1:]
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=int(rank),
                            world_size=int(world))
    try:
        payload = torch.load(inputs, weights_only=False)
        shape = (2, 2) if name == "grid4" else (1, 1)
        job = Job(payload, Grid(("data", "model"), shape))
        res = {"grid4": grid4, "grid1": grid1}[name](job)
        if int(rank) == 0:
            torch.save(res, out)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
