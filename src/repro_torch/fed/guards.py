"""Guarded aggregation: per-client update screening before FedAvg.

One poisoned client update (NaN / Inf, or a huge-norm outlier) would
otherwise go straight into the eq. 10 average and destroy the global
model. The reference's guards (``repro.fed.guards``) screen each
client's *update* (the trained client half minus the round-start one)
and shrink the effective cohort:

- **non-finite rejection**: any NaN / Inf entry rejects the client;
- **norm clipping**: the update's global L2 norm is clipped against a
  multiple of a running median of accepted norms (an EMA, its state
  ``{"med", "n"}`` threaded through the fed state).

The SCALA-specific part lives in the callers
(:func:`repro_torch.core.engine.make_round_runner`,
:func:`repro_torch.fed.runtime.make_async_runner`): a rejected client is
not merely given weight zero; the round's local phase runs again over
the survivors, so the eq. 14/15 priors and logit adjustments are those
of a round the rejected client never joined.

Spec grammar (comma-joined clauses)::

    nonfinite           # reject NaN/Inf updates
    clip:TAU[:BETA]     # clip norms above TAU x running median;
                        # BETA = median EMA rate (default 0.5)

Non-finite rejection with zero faults injected is a bitwise no-op, and
so is clipping where it does not trigger (:func:`apply_clip`, in place
on the round's own stack).

**Memory.** The screen never builds the reference's whole float32 delta
tree (16 slots of qwen1.5-0.5b's embedding alone would be 10 GB): it
reads each leaf's rows in chunks of at most :data:`CHUNK_BYTES` of
float32 temporaries and keeps per-row squared sums and finiteness.

**The median.** ``jnp.nanmedian`` averages the two middle values of an
even count, where ``torch.nanmedian`` returns the lower one; the screen
takes ``0.5 * lo + 0.5 * hi`` of the sorted accepted norms itself, on the
device, as the reference's linear quantile does.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import numpy as np
import torch

from repro_torch.tree import leaves, tree_map

#: the screen's float32 temporaries per chunk of rows.
CHUNK_BYTES = 1 << 28


@dataclasses.dataclass(frozen=True)
class GuardPolicy:
    nonfinite: bool = True
    clip: float = 0.0   # multiple of the running median; 0 disables
    beta: float = 0.5   # EMA rate for the running median
    spec: str = "nonfinite"

    @property
    def stateful(self) -> bool:
        return self.clip > 0


def make_guards(spec) -> Optional[GuardPolicy]:
    """Parse a guard spec string (see the module docstring for the
    grammar). ``None`` and already-parsed :class:`GuardPolicy`s pass
    through."""
    if spec is None or isinstance(spec, GuardPolicy):
        return spec
    kw = {"spec": spec, "nonfinite": False}
    saw_any = False
    for clause in str(spec).split(","):
        clause = clause.strip()
        if not clause:
            continue
        saw_any = True
        parts = clause.split(":")
        name = parts[0].strip().lower()
        if name == "nonfinite":
            if len(parts) != 1:
                raise ValueError(f"nonfinite clause takes no args: {clause!r}")
            kw["nonfinite"] = True
        elif name == "clip":
            if len(parts) < 2 or len(parts) > 3:
                raise ValueError(f"clip clause is clip:TAU[:BETA]: {clause!r}")
            kw["clip"] = float(parts[1])
            if len(parts) == 3:
                kw["beta"] = float(parts[2])
        else:
            raise ValueError(
                f"unknown guard clause {name!r} (want nonfinite/clip)")
    if not saw_any:
        raise ValueError(f"empty guard spec: {spec!r}")
    gp = GuardPolicy(**kw)
    if gp.clip < 0:
        raise ValueError("clip multiple must be >= 0")
    if not 0.0 < gp.beta <= 1.0:
        raise ValueError("median EMA rate must be in (0, 1]")
    if not gp.nonfinite and gp.clip == 0:
        raise ValueError(f"guard spec enables nothing: {spec!r}")
    return gp


def init_state(device="cpu"):
    """Running-median state for norm clipping (``{"med", "n"}``)."""
    return {"med": torch.zeros((), dtype=torch.float32, device=device),
            "n": torch.zeros((), dtype=torch.int32, device=device)}


def row_stats(trained, start, rows=None, n=None) -> Tuple[torch.Tensor,
                                                         torch.Tensor]:
    """(squared L2 norm (C,) float32, finite (C,) bool) of each row of the
    update ``trained - start`` (two (C, ...)-stacked trees), summed over
    every leaf, reading chunks of rows (:data:`CHUNK_BYTES`).

    ``rows`` (host ints): only these rows are read, the others'
    update is taken as exactly zero (finite, norm 0), as a sparse round's
    slots outside the gather are; ``n`` is then the row count C."""
    lv_t, lv_s = leaves(trained), leaves(start)
    device = lv_t[0].device
    C = lv_t[0].shape[0] if n is None else n
    sq = torch.zeros((C,), dtype=torch.float32, device=device)
    bad = torch.zeros((C,), dtype=torch.float32, device=device)
    host_ids = (list(range(C)) if rows is None
                else np.asarray(rows).astype(np.int64).tolist())
    ids = (None if rows is None else
           torch.tensor(host_ids, dtype=torch.int64, device=device))
    chunk = CHUNK_BYTES // 4                    # float32 elements
    for a, b in zip(lv_t, lv_s):
        a2, b2 = a.reshape(a.shape[0], -1), b.reshape(b.shape[0], -1)
        width = max(1, a2.shape[1])
        if width <= chunk:
            # small rows: a block of whole rows at a time
            step = chunk // width
            for lo in range(0, len(host_ids), step):
                if ids is None:
                    # every row: a block is a view, not a gathered copy
                    r = slice(lo, lo + step)
                    x, y = a2[r], b2[r]
                else:
                    r = ids[lo:lo + step]
                    x, y = a2.index_select(0, r), b2.index_select(0, r)
                d = x.float() - y.float()
                bad[r] += (~torch.isfinite(d)).any(1).float()
                sq[r] += d.square_().sum(1)
                del d, x, y
            continue
        # a row above the chunk (qwen's embedding, 622 MB): column blocks
        for i in host_ids:
            for c0 in range(0, width, chunk):
                d = a2[i, c0:c0 + chunk].float() - \
                    b2[i, c0:c0 + chunk].float()
                bad[i] += (~torch.isfinite(d)).any().float()
                sq[i] += d.square_().sum()
                del d
    return sq, bad == 0


def update_norms(delta_tree) -> torch.Tensor:
    """Global L2 norm of each client's update: (C,) float32 over every
    leaf of a (C, ...)-stacked delta tree."""
    zero = tree_map(torch.zeros_like, delta_tree)
    return torch.sqrt(row_stats(delta_tree, zero)[0])


def finite_rows(delta_tree) -> torch.Tensor:
    """(C,) float32 0/1: 1 where every entry of the row is finite."""
    zero = tree_map(torch.zeros_like, delta_tree)
    return row_stats(delta_tree, zero)[1].float()


def _median_even_mean(norms, part):
    """The median of ``norms`` where ``part`` > 0, the two middle values
    averaged for an even count (``jnp.nanmedian``), NaN norms ignored;
    NaN when there are none."""
    vals = torch.where(part > 0, norms, torch.full_like(norms, float("nan")))
    srt = torch.sort(vals).values            # NaN sorts last
    count = (~torch.isnan(vals)).sum()
    lo = ((count - 1).clamp(min=0) // 2).reshape(1)
    hi = (count // 2).clamp(max=norms.numel() - 1).reshape(1)
    med = 0.5 * srt.gather(0, lo) + 0.5 * srt.gather(0, hi)
    return torch.where(count > 0, med[0],
                       torch.full_like(med[0], float("nan")))


def screen(policy: GuardPolicy, trained, start, mask, state, rows=None,
           grid=None) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                               Any]:
    """Screen per-client updates ``trained - start`` (two (C, ...)-stacked
    client halves; ``rows``: see :func:`row_stats`). On a
    :class:`repro_torch.sharding.Grid` the trees hold this rank's client
    shard and ``mask`` all C slots: the rows' squared norms and
    finiteness are all_gathered over the client shards, and the rest runs
    on the (C,) vectors alike on every rank.

    ``mask``: (C,) 0/1 participation (a tensor on the trees' device; only
    participants are screened); ``state``: :func:`init_state`'s dict, or
    ``()`` when clipping is off.

    Returns ``(accept, clip_factor, norms, new_state)``: ``accept`` (C,)
    0/1 (non-participants are accepted: they carry no update),
    ``clip_factor`` (C,) in (0, 1] (1 where clipping is off or does not
    trigger), ``norms`` (C,) update L2 norms, and the advanced median
    state (``()`` in, ``()`` out). All on the device: nothing waits for
    it here.
    """
    m = mask.float()
    shards = 1 if grid is None else grid.n_client_shards
    sq, fin = row_stats(trained, start, rows, m.numel() // shards)
    if grid is not None:
        sq = grid.all_gather(sq, "client")
        fin = grid.all_gather(fin.float(), "client") > 0
    norms = torch.sqrt(sq)
    accept = (torch.where(m > 0, fin.float(), torch.ones_like(m))
              if policy.nonfinite else torch.ones_like(m))
    factor = torch.ones_like(norms)
    new_state = state
    if policy.clip > 0:
        if state == ():
            raise ValueError(
                "guard clip needs a running-median state -- seed it via "
                "init_fed_state(..., guards=...) / init_async_state(..., "
                "guards=...)")
        part = m * accept  # participating, finite
        ev_med = _median_even_mean(norms, part)
        have = part.sum() > 0
        ev_med = torch.where(torch.isfinite(ev_med), ev_med, state["med"])
        first = state["n"] == 0
        med = torch.where(
            have,
            torch.where(first, ev_med,
                        (1.0 - policy.beta) * state["med"]
                        + policy.beta * ev_med),
            state["med"])
        new_state = {"med": med,
                     "n": state["n"] + have.to(torch.int32)}
        limit = policy.clip * med
        trig = (part > 0) & (med > 0) & (norms > limit)
        factor = torch.where(trig, limit / torch.clamp(norms, min=1e-30),
                             torch.ones_like(norms))
    return accept, factor, norms, new_state


@dataclasses.dataclass
class Screened:
    """What :func:`guarded` decided for a round or an event."""
    accept: torch.Tensor    # (C,) 0/1 of the first pass, on the device
    norms: torch.Tensor     # (C,) the first pass's update norms
    accept_np: np.ndarray   # ``accept`` on the host
    factor_np: np.ndarray   # (C,) clip factors of the final updates
    survivors: np.ndarray   # (C,) participants x accepted: the mask to
                            # aggregate over
    rejected: float         # participants rejected
    state: Any              # the advanced median state (or ``()``)

    @property
    def metrics(self):
        return {"guard_accept": self.accept, "guard_norm": self.norms,
                "guard_rejected": self.rejected}

    def apply_(self, start, trained, rows=slice(None)):
        """Clip, then zero the rejected rows of, ``trained`` in place
        (the round's own stack; a full-width round has no room for a
        second one); ``rows``: the slots the trees hold (a rank's client
        shard). Returns ``trained``."""
        apply_clip(start, trained, self.factor_np[rows])
        return zero_rows_(trained, self.accept_np[rows])


def guarded(policy: GuardPolicy, guard_state, start, mask_np, n, run_local,
            grid=None):
    """The guarded local phase, one policy for the sync round
    (:func:`repro_torch.core.engine.make_round_runner`) and the async
    event (:func:`repro_torch.fed.runtime.make_async_runner`).

    ``run_local(m_np, again)`` runs the local phase from the round's
    start under the (n,) host mask ``m_np`` (None: every row; ``again``:
    the survivor re-run) and returns ``(state, metrics, rows)``, ``rows``
    as in :func:`row_stats`; ``start`` is the round-start client half the
    updates are taken against, ``mask_np`` the participants.

    The first pass is screened over the participants and its accept and
    clip vectors come to the host in one copy. If anyone is rejected,
    the first pass is dropped (a second 16-slot stack would not fit) and
    the phase runs again over the survivors, so that the eq. 14/15
    priors and logit adjustments are those of a round the rejected
    clients never joined; the clip factors then come from the final
    updates against the pre-round median, and the median state keeps
    the first pass's norms. With nothing rejected the survivors equal
    the participants bit for bit. ``grid``: the trees are a rank's client
    shard of the ``n`` slots (:func:`screen`).

    Returns ``(state, metrics, rows, Screened)``."""
    state, metrics, rows = run_local(mask_np, False)
    base_np = (mask_np if mask_np is not None
               else np.ones((n,), np.float32))
    device = leaves(start)[0].device
    accept, factor, norms, new_state = screen(
        policy, state.params["client"], start,
        torch.from_numpy(base_np).to(device), guard_state, rows=rows,
        grid=grid)
    accept_np, factor_np = torch.stack([accept, factor]).cpu().numpy()
    survivors = base_np * accept_np
    rejected = float(base_np.sum() - survivors.sum())
    if rejected > 0:
        del state, metrics
        state, metrics, rows = run_local(survivors, True)
        if policy.clip > 0:
            factor_np = screen(
                policy, state.params["client"], start,
                torch.from_numpy(survivors).to(device), guard_state,
                rows=rows, grid=grid)[1].cpu().numpy()
    return state, metrics, rows, Screened(
        accept=accept, norms=norms, accept_np=accept_np,
        factor_np=factor_np, survivors=survivors, rejected=rejected,
        state=new_state)


def apply_clip(start, trained, factor_host):
    """Rescale each client's update by ``factor_host`` ((C,) host floats)
    IN PLACE, for a ``trained`` tree the caller owns: the rows whose
    factor is below 1 become ``start + factor * (trained - start)`` in
    float32, the reference's ``where(factor < 1, clipped, trained)``
    row by row; the others are not touched (a bitwise no-op at factor 1),
    and a full-width round clips without a second client stack. Returns
    ``trained``."""
    rows = np.flatnonzero(np.asarray(factor_host) < 1.0)
    for s, p in zip(leaves(start), leaves(trained)):
        for i in rows.tolist():
            f = torch.tensor(np.float32(factor_host[i]), device=p.device)
            p[i] = (s[i].float() + f * (p[i].float() - s[i].float())
                    ).to(p.dtype)
    return trained


def zero_rows_(tree, accept_host):
    """The rows whose ``accept_host`` ((C,) host 0/1) is 0 zeroed in place
    (0 x NaN is NaN: a rejected row must leave the average, not just
    weigh 0). Returns ``tree``."""
    bad = np.flatnonzero(np.asarray(accept_host) <= 0)
    if bad.size:
        for p in leaves(tree):
            p.index_fill_(0, torch.from_numpy(bad).to(p.device), 0)
    return tree
