"""Client completion-delay models for the asynchronous runtime.

The async runtime (:mod:`repro_torch.fed.runtime`) gives every dispatched
client a completion delay from a :class:`DelayModel`; the event schedule
then pops arrival cohorts in finish-time order. The shape of the delay
distribution decides how asynchronous the run is (GAS, arXiv:2409.01251:
staleness grows with the delay tail).

  =================  =====================================================
  model              delay of one dispatched client
  =================  =====================================================
  :func:`constant`   ``d`` exactly (``d=0`` is the synchronous barrier:
                     every client arrives at once)
  :func:`uniform`    ``U[lo, hi]``: bounded jitter, thin tail
  :func:`lognormal`  ``median * exp(sigma * z)``, ``z ~ N(0,1)``: the
                     heavy-tailed regime
  :func:`recorded`   the given arrays, in order (the same delays on every
                     device, or the reference's injected)
  =================  =====================================================

The reference samples from ``jax.random`` inside the compiled event; the
port draws on the host with numpy, as its participation schedulers do, so
the event schedule (finish times, versions) never waits for the device.
``sample(rng, shape)`` returns float32 numpy delays. The stream is keyed
by the run's seed and the server version: the init's draw comes from
``np.random.default_rng([seed, 0])`` and the event that makes version
``v`` draws from ``default_rng([seed, v])`` (:meth:`DelayModel.draw`),
so a resumed run redraws exactly the delays it would have drawn.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Sequence, Tuple

import numpy as np

DELAY_MODELS = ("constant", "uniform", "lognormal")


@dataclass(frozen=True)
class DelayModel:
    """``sample(rng, shape) -> (shape,) float32 non-negative delays``;
    ``table``: a recorded model's arrays (draw ``v`` returns
    ``table[v]``)."""

    name: str
    sample: Callable[[np.random.Generator, Tuple[int, ...]], np.ndarray]
    table: Optional[Tuple[np.ndarray, ...]] = None

    def draw(self, seed: int, version: int, shape) -> np.ndarray:
        """The delays of draw ``version`` of the stream ``seed``: 0 is the
        init's (K,), ``v`` the event's that makes server version ``v``."""
        shape = tuple(shape)
        if self.table is not None:
            d = np.asarray(self.table[version], np.float32)
            if d.shape != shape:
                raise ValueError(f"recorded delays {version} have shape "
                                 f"{d.shape}; the runtime asks {shape}")
            return d.copy()
        rng = np.random.default_rng([int(seed), int(version)])
        return np.asarray(self.sample(rng, shape), np.float32)

    def sample_sharded(self, seed: int, version: int, n: int,
                       n_shards: int, shard: int) -> np.ndarray:
        """Client shard ``shard``'s block of ``draw(seed, version, (n,))``
        when the n slots split into ``n_shards`` contiguous blocks.

        The stream is one host numpy generator, ``default_rng([seed,
        version])``, so every rank draws the whole (n,) vector (n float32
        from one generator, a few microseconds even at n = 1e6) and keeps
        its block: each rank's slice is bitwise the slice of the unsharded
        draw, and the blocks in shard order are the unsharded draw (the
        reference samples with the output sharded, threefry being
        value-deterministic, for the same result)."""
        if n % n_shards or not 0 <= shard < n_shards:
            raise ValueError(f"{n} slots do not split into block {shard} of "
                             f"{n_shards}")
        k = n // n_shards
        return self.draw(seed, version, (n,))[shard * k:(shard + 1) * k]


def constant(d: float = 1.0) -> DelayModel:
    """Every client takes exactly ``d`` time units. ``d=0`` makes the
    async runner a barrier-synchronized round (the sync special case)."""
    if d < 0:
        raise ValueError(f"constant delay must be >= 0, got {d}")

    def sample(rng, shape):
        return np.full(shape, d, np.float32)

    return DelayModel(name="constant", sample=sample)


def uniform(lo: float, hi: float) -> DelayModel:
    """Bounded jitter: delays ~ U[lo, hi]."""
    if not 0 <= lo <= hi:
        raise ValueError(f"uniform delay needs 0 <= lo <= hi, got [{lo}, {hi}]")

    def sample(rng, shape):
        u = rng.random(shape, dtype=np.float32)
        return np.float32(lo) + np.float32(hi - lo) * u

    return DelayModel(name="uniform", sample=sample)


def lognormal(median: float = 1.0, sigma: float = 1.0) -> DelayModel:
    """Heavy-tailed delays: ``median * exp(sigma * N(0,1))``. Most
    clients finish near the median; larger ``sigma`` means older arrivals
    and higher staleness under a fixed cohort size."""
    if median <= 0 or sigma < 0:
        raise ValueError(f"lognormal needs median > 0, sigma >= 0, got "
                         f"({median}, {sigma})")

    def sample(rng, shape):
        z = rng.standard_normal(shape, dtype=np.float32)
        return np.float32(median) * np.exp(np.float32(sigma) * z)

    return DelayModel(name="lognormal", sample=sample)


def recorded(arrays: Sequence) -> DelayModel:
    """A model that replays ``arrays``: draw 0 (the init's, one delay per
    client) is ``arrays[0]``, the event that makes server version ``v``
    gets ``arrays[v]`` (one per arrival), whatever the seed."""
    table = tuple(np.asarray(a, np.float32) for a in arrays)

    def sample(rng, shape):
        raise ValueError("a recorded delay model draws by version "
                         "(DelayModel.draw), not from a generator")

    return DelayModel(name="recorded", sample=sample, table=table)


def make_delays(spec: str) -> DelayModel:
    """Parse a launcher-flag spec into a delay model.

    ``"zero"`` | ``"constant[:D]"`` | ``"uniform:LO:HI"`` |
    ``"lognormal[:MEDIAN[:SIGMA]]"``.
    """
    parts = spec.split(":")
    name = parts[0]
    if name == "zero":
        if len(parts) != 1:
            raise ValueError("zero spec takes no arguments")
        return constant(0.0)
    if name == "constant":
        if len(parts) > 2:
            raise ValueError("constant spec is 'constant[:D]'")
        return constant(float(parts[1]) if len(parts) == 2 else 1.0)
    if name == "uniform":
        if len(parts) != 3:
            raise ValueError("uniform spec is 'uniform:LO:HI'")
        return uniform(float(parts[1]), float(parts[2]))
    if name == "lognormal":
        if len(parts) > 3:
            raise ValueError("lognormal spec is 'lognormal[:MEDIAN[:SIGMA]]'")
        median = float(parts[1]) if len(parts) >= 2 else 1.0
        sigma = float(parts[2]) if len(parts) == 3 else 1.0
        return lognormal(median, sigma)
    raise ValueError(f"unknown delay model {name!r}; expected "
                     f"{('zero',) + DELAY_MODELS}")
