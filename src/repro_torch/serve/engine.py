"""Continuous-batching serving engine over a fixed slot axis.

The engine holds ``slots`` concurrent sequences in one cache (dense or
paged, see :mod:`repro_torch.serve.cache`) and runs generation as:

* **admit** -- one fused prefill per request
  (:func:`repro_torch.models.transformer.forward_prefill_cached`): the
  whole prompt in one trunk pass (attention through the flash kernel,
  mLSTM through the chunkwise kernel), the cache copied into a freed
  slot, the first token sampled from the last-position logits. Prompts
  are never padded.
* **step** -- one batched decode advancing *every* slot by one token.
  Each slot carries its own position (a per-row ``index`` tensor); the
  per-row math is the single-sequence decode path, which keeps engine
  output token-identical to the token-by-token baseline
  (:func:`repro_torch.launch.serve.generate`, test-enforced).

Requests are admitted from an arrival queue into freed slots as
sequences finish -- no generation barrier -- unless
``admission='static'`` restores the barrier for A/B comparison.

The engine serves a copy of the params cast once to the compute dtype,
but for the leaves the reference uses in float32 (norm scales, the
xLSTM gate weights and biases, the MoE router and mamba's dt
projection, dt bias, ``A_log`` and ``D``: :data:`FLOAT32_LEAVES`). The
reference casts each other weight to the compute dtype at every use
(mamba's ``conv_w``, ``conv_b``, ``x_proj`` among them); casting once
yields the same values. A leaf
already in its serving dtype on the device is served as it is, not
copied: a model as large as the card holds one copy of its weights.
"""
from __future__ import annotations

import collections
import time
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.models import transformer as T
from repro_torch.models.common import dtype_of, resolve_device
from repro_torch.serve.cache import make_ops


@dataclass
class Request:
    """One generation request: prompt tokens + a token budget.

    ``deadline`` (optional) bounds the request's total time in the
    system, measured from ``arrival`` on the serve timeline (seconds
    under ``wall_clock=True``, decode steps otherwise). A slot still
    generating when its deadline passes is *evicted*: the partial
    sequence is returned (``Result.evicted == "deadline"``) and the slot
    and its pages are freed."""
    rid: int
    tokens: np.ndarray          # (P,) int prompt
    max_new: int                # tokens to generate (>= 1)
    arrival: float = 0.0        # seconds after serve() start
    deadline: Optional[float] = None  # max time in system, from arrival


@dataclass
class Result:
    rid: int
    tokens: np.ndarray          # (P + generated,) prompt + generated
    prompt_len: int
    arrival: float
    t_admit: float
    t_finish: float
    logits: Optional[List[np.ndarray]] = None
    # None = ran to its own max_new; "deadline" = deadline eviction;
    # "budget" = hit the engine-wide token_budget cap first
    evicted: Optional[str] = None

    @property
    def latency(self) -> float:
        return self.t_finish - self.arrival


@dataclass
class _Slot:
    active: bool = False
    rid: int = 0
    length: int = 0             # tokens absorbed so far == next write index
    max_new: int = 0
    generated: int = 0
    last_tok: int = 0
    n_pages: int = 0
    budget: int = 0             # min(max_new, engine token_budget)
    expiry: float = float("inf")  # absolute eviction time on the timeline


# leaves the reference applies in float32 whatever the compute dtype: norm
# scales, the mLSTM / sLSTM gate projections and biases, the MoE router
# (routing in float32: a bf16 router would move its logits and flip top-k
# choices) and mamba's dt_proj, dt_bias, A_log and D (dt and A = -exp(A_log)
# in bf16 would round the decay of every state entry)
FLOAT32_LEAVES = ("scale", "w_gates", "b_gates", "r_gates", "router",
                  "dt_proj", "dt_bias", "A_log", "D")


def serving_params(params, cfg, device):
    """The engine's copy of ``params`` on ``device``: every weight in the
    compute dtype, the :data:`FLOAT32_LEAVES` in float32 (``Tensor.to``
    returns a leaf that is already so as it is)."""
    dtype = dtype_of(cfg.dtype)

    def conv(tree, key=""):
        if isinstance(tree, dict):
            return {k: conv(v, k) for k, v in tree.items()}
        return tree.to(device, torch.float32 if key in FLOAT32_LEAVES
                       else dtype)

    return conv(params)


class ServeEngine:
    """Continuous-batching generation over a merged (non-split) model.

    params: ``{'client': ..., 'server': ...}`` as produced by
    :func:`repro_torch.models.transformer.init_params` or
    :func:`repro_torch.convert.params_from_reference`. Runs on ``cuda``
    unless ``device`` says otherwise; without a card that raises.
    """

    def __init__(self, params, cfg, *, slots: int = 4, max_len: int = 256,
                 pages: int = 0, page_size: int = 16,
                 temperature: float = 0.0, seed: int = 0,
                 admission: str = "continuous", record_logits: bool = False,
                 token_budget: Optional[int] = None, device="cuda"):
        if not cfg.is_decoder:
            raise ValueError("ServeEngine requires a decoder arch")
        if cfg.frontend is not None:
            raise ValueError("ServeEngine serves text-only archs "
                             f"(frontend={cfg.frontend!r})")
        if admission not in ("continuous", "static"):
            raise ValueError(f"unknown admission mode {admission!r}")
        if token_budget is not None and token_budget < 1:
            raise ValueError(f"token_budget must be >= 1, got {token_budget}")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.params = serving_params(params, cfg, self.device)
        self.slots = slots
        self.max_len = max_len
        self.temperature = float(temperature)
        self.admission = admission
        self.record_logits = record_logits
        self.token_budget = token_budget
        # sampling stream, derived from the seed so that it differs from
        # a param-init stream seeded with the same number
        self._gen = torch.Generator(self.device)
        self._gen.manual_seed(
            int(np.random.SeedSequence([seed, 1]).generate_state(1)[0]))

        self.ops = make_ops(cfg, slots, max_len, dtype_of(cfg.dtype),
                            self.device, pages=pages, page_size=page_size)
        self._cache = self.ops.init()
        self._table = np.full((slots, self.ops.max_pages), -1, np.int32)
        self._free_pages = list(range(pages - 1, -1, -1)) if pages else []
        self._free_slots = list(range(slots - 1, -1, -1))
        self._slot = [_Slot() for _ in range(slots)]
        self._out: Dict[int, list] = {}
        self._log: Dict[int, list] = {}
        self._admit_meta: Dict[int, tuple] = {}
        self._results: Dict[int, Result] = {}
        self._wave_open = True
        self._ctr = 0    # admits + steps: the clock when wall_clock=False

    # -- sampling ----------------------------------------------------------

    def _pick(self, logits: torch.Tensor) -> torch.Tensor:
        """Greedy or temperature sampling over (rows, V) float32 logits."""
        if self.temperature == 0.0:
            return logits.argmax(dim=-1)
        probs = torch.softmax(logits / self.temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=self._gen)[:, 0]

    # -- scheduling --------------------------------------------------------

    @property
    def n_active(self) -> int:
        return self.slots - len(self._free_slots)

    @torch.no_grad()
    def _try_admit(self, req: Request, now: float,
                   results: Dict[int, Result]) -> bool:
        if not self._free_slots:
            return False
        n_pages = 0
        if self.ops.paged:
            n_pages = self.ops.pages_needed(len(req.tokens) + req.max_new)
            if n_pages > len(self._free_pages):
                return False
        slot = self._free_slots.pop()
        row = np.full((self.ops.max_pages,), -1, np.int32)
        for j in range(n_pages):
            row[j] = self._free_pages.pop()
        self._table[slot] = row

        prompt = torch.as_tensor(np.asarray(req.tokens, np.int64)[None],
                                 device=self.device)
        logits, req_cache = T.forward_prefill_cached(
            self.params, {"tokens": prompt}, self.cfg, self.max_len)
        self._cache = self.ops.admit(self._cache, req_cache, row, slot)
        self._ctr += 1
        lg = logits[0, 0].float()
        tok0 = int(self._pick(lg[None])[0])

        s = self._slot[slot]
        s.active = True
        s.rid, s.length, s.max_new = req.rid, len(req.tokens), req.max_new
        s.generated, s.last_tok, s.n_pages = 1, tok0, n_pages
        s.budget = (req.max_new if self.token_budget is None
                    else min(req.max_new, self.token_budget))
        s.expiry = (float("inf") if req.deadline is None
                    else req.arrival + req.deadline)
        self._out[req.rid] = [tok0]
        if self.record_logits:
            self._log[req.rid] = [lg.cpu().numpy()]
        self._admit_meta[req.rid] = (req, now)
        if s.generated >= s.budget:
            self._finish(slot, now, results,
                         "budget" if s.budget < s.max_new else None)
        return True

    def _finish(self, slot: int, now: float, results: Dict[int, Result],
                evicted: Optional[str] = None):
        s = self._slot[slot]
        req, t_admit = self._admit_meta.pop(s.rid)
        self._free_pages.extend(
            int(p) for p in self._table[slot][:s.n_pages])
        self._table[slot] = -1
        self._free_slots.append(slot)
        results[s.rid] = Result(
            rid=s.rid,
            tokens=np.concatenate([np.asarray(req.tokens, np.int32),
                                   np.asarray(self._out.pop(s.rid), np.int32)]),
            prompt_len=len(req.tokens), arrival=req.arrival,
            t_admit=t_admit, t_finish=now,
            logits=self._log.pop(s.rid, None), evicted=evicted)
        s.active = False

    def _evict_expired(self, now: float, results: Dict[int, Result]) -> int:
        """Free every slot whose request deadline has passed; returns the
        count evicted."""
        n = 0
        for slot, s in enumerate(self._slot):
            if s.active and now >= s.expiry:
                self._finish(slot, now, results, "deadline")
                n += 1
        return n

    @torch.no_grad()
    def _step_once(self, now: float, results: Dict[int, Result]):
        # inactive slots are stepped too (their rows are never read)
        toks = torch.as_tensor([[s.last_tok] for s in self._slot],
                               dtype=torch.long, device=self.device)
        idxs = np.array([s.length for s in self._slot], np.int64)
        dense = self.ops.gather(self._cache, self._table)
        logits, new_dense = T.decode_step(
            self.params, {"tokens": toks}, dense,
            torch.as_tensor(idxs, device=self.device), self.cfg)
        self._ctr += 1
        logits = logits[:, 0].float()
        nxt = self._pick(logits).cpu().numpy()
        self._cache = self.ops.scatter(self._cache, new_dense, self._table,
                                       idxs)
        if self.record_logits:
            logits = logits.cpu().numpy()
        for slot, s in enumerate(self._slot):
            if not s.active:
                continue
            s.length += 1
            s.generated += 1
            s.last_tok = int(nxt[slot])
            self._out[s.rid].append(s.last_tok)
            if self.record_logits:
                self._log[s.rid].append(logits[slot])
            if s.generated >= s.budget:
                self._finish(slot, now, results,
                             "budget" if s.budget < s.max_new else None)

    # -- public API --------------------------------------------------------

    def _validate(self, req: Request):
        total = len(req.tokens) + req.max_new
        if req.max_new < 1:
            raise ValueError(f"request {req.rid}: max_new must be >= 1")
        if total > self.max_len:
            raise ValueError(
                f"request {req.rid}: {total} tokens > max_len={self.max_len}")

    def admit(self, req: Request, now: float = 0.0) -> bool:
        """Prefill one request into a free slot. False if no slot (or,
        paged, not enough free pages) is available."""
        self._validate(req)
        return self._try_admit(req, now, self._results)

    def step(self, now: float = 0.0) -> None:
        """Advance every active slot by one token. Slots past their
        request deadline are evicted first, not stepped."""
        self._evict_expired(now, self._results)
        if self.n_active:
            self._step_once(now, self._results)

    def take_finished(self) -> Dict[int, Result]:
        """Pop and return the requests finished since the last call."""
        out, self._results = self._results, {}
        return out

    def serve(self, requests: List[Request], *,
              wall_clock: bool = True) -> Dict[int, Result]:
        """Run a batch of requests to completion. Arrivals are honoured
        on the wall clock (``wall_clock=False`` treats every request as
        already arrived and counts time in admits + steps -- deterministic,
        for tests)."""
        for r in requests:
            self._validate(r)
            if r.deadline is not None and r.deadline <= 0:
                raise ValueError(
                    f"request {r.rid}: deadline must be > 0, "
                    f"got {r.deadline}")
        pending = collections.deque(
            sorted(requests, key=lambda r: (r.arrival, r.rid)))
        results: Dict[int, Result] = {}
        t0 = time.monotonic()

        while pending or self.n_active:
            now = (time.monotonic() - t0) if wall_clock else float(self._ctr)
            # deadline evictions free slots BEFORE admission, so a queued
            # request can take over an expired slot this very iteration
            self._evict_expired(now, results)
            if self.n_active == 0:
                self._wave_open = True  # static mode: new admission wave
            arrived = bool(pending) and (not wall_clock
                                         or pending[0].arrival <= now)
            may_admit = (self.admission == "continuous" or self._wave_open)
            if arrived and may_admit:
                if self._try_admit(pending[0], now, results):
                    pending.popleft()
                    continue
                if self.n_active == 0:
                    raise RuntimeError(
                        "page pool too small for a single request -- "
                        "raise ServeSpec.pages")
            if self.n_active:
                self._wave_open = False
                self._step_once(now, results)
            elif pending and wall_clock:
                time.sleep(min(0.01, max(0.0, pending[0].arrival - now)))
        return results

    def generate(self, prompts: np.ndarray, max_new: int) -> np.ndarray:
        """Batch convenience wrapper: all prompts arrive at t=0; returns
        (B, P + max_new) prompt+generated tokens, row i = prompt i."""
        prompts = np.asarray(prompts)
        reqs = [Request(i, prompts[i], max_new) for i in range(len(prompts))]
        res = self.serve(reqs, wall_clock=False)
        return np.stack([res[i].tokens for i in range(len(prompts))])

    def warmup(self, prompt_lens: List[int]):
        """Run one short request per prompt length, so that serving
        latency excludes first-call costs (kernel build, library
        handles, allocator growth)."""
        for P in prompt_lens:
            req = Request(rid=-(P + 1), tokens=np.zeros((P,), np.int32),
                          max_new=2)
            self.serve([req], wall_clock=False)

    def state_bytes(self) -> int:
        """Resident decode-cache bytes (pool budget when paged)."""
        return self.ops.state_bytes()
