"""ServeSpec -- declarative serving of a trained SCALA global model.

A frozen, JSON-round-trippable description of *what* to serve (arch +
federated training checkpoint), *how* (slots, paged-cache budget, max
length, sampling) and *where* (``device``, ``cuda`` by default).
:func:`build_serve` restores the checkpoint, merges the slot-0 client
half with the server half into the served global model, and returns a
:class:`ServeProgram` wrapping a ready
:class:`repro_torch.serve.ServeEngine`::

    from repro_torch import api

    spec = api.ServeSpec(arch="qwen1.5-0.5b", slots=8, max_len=1024,
                         pages=512, page_size=16)
    program = api.build_serve(spec)
    out = program.engine.generate(prompts, max_new=32)

With ``checkpoint_dir=""`` the model is freshly initialised from
``seed``. The JSON fields are those of ``repro.api.ServeSpec`` plus
``device``.
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from repro_torch import checkpoint, convert
from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import resolve_device
from repro_torch.models.transformer import check_supported

ADMISSION_MODES = ("continuous", "static")


@dataclass(frozen=True)
class ServeSpec:
    """Everything one serving deployment needs, declaratively.

    ``pages == 0`` serves from a dense ``slots x max_len`` cache;
    ``pages > 0`` from a paged pool of that many pages (bitwise the same
    output). ``temperature == 0`` is greedy.
    """

    arch: str = "qwen1.5-0.5b"
    reduced: bool = False
    checkpoint_dir: str = ""           # "" = fresh init from `seed`
    checkpoint_step: Optional[int] = None
    slots: int = 4
    max_len: int = 256
    pages: int = 0                     # 0 = dense cache
    page_size: int = 16
    temperature: float = 0.0
    seed: int = 0
    admission: str = "continuous"
    device: str = "cuda"

    def __post_init__(self):
        cfg = self.model_config()
        if not cfg.is_decoder:
            raise ValueError(f"arch {self.arch!r} is not a decoder; "
                             "ServeSpec serves autoregressive text models")
        if cfg.frontend is not None:
            raise ValueError(f"arch {self.arch!r} has frontend "
                             f"{cfg.frontend!r}; ServeSpec serves text-only "
                             "archs")
        check_supported(cfg)     # a block the port lacks: NotImplementedError
        if self.slots < 1:
            raise ValueError(f"slots must be >= 1, got {self.slots}")
        if self.max_len < 2:
            raise ValueError(f"max_len must be >= 2, got {self.max_len}")
        if self.pages < 0:
            raise ValueError(f"pages must be >= 0, got {self.pages}")
        if self.page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {self.page_size}")
        if self.temperature < 0:
            raise ValueError(
                f"temperature must be >= 0, got {self.temperature}")
        if self.admission not in ADMISSION_MODES:
            raise ValueError(f"unknown admission {self.admission!r}; "
                             f"expected {ADMISSION_MODES}")
        try:
            torch.device(self.device)
        except RuntimeError as e:
            raise ValueError(f"bad device {self.device!r}: {e}") from None

    def model_config(self) -> ModelConfig:
        cfg = get_config(self.arch)
        return cfg.reduced() if self.reduced else cfg

    # -- lossless serialization -------------------------------------------

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    def to_json(self, **kw) -> str:
        kw.setdefault("indent", 2)
        return json.dumps(self.to_dict(), **kw)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "ServeSpec":
        return cls(**d)

    @classmethod
    def from_json(cls, s: str) -> "ServeSpec":
        return cls.from_dict(json.loads(s))


@dataclass
class ServeProgram:
    """A built serving deployment.

    * ``prefill(tokens)`` -- fused prompt absorption: (last-position
      logits, full decode cache);
    * ``admit(request)`` -- prefill a request into a free engine slot
      (False when no capacity);
    * ``step()`` -- advance every active slot one token;
    * ``predict(batch)`` -- full-sequence logits of the served model;
    * ``engine`` -- the underlying :class:`repro_torch.serve.ServeEngine`.
    ``params`` is the engine's serving copy.
    """

    spec: ServeSpec
    cfg: ModelConfig
    params: Any
    engine: Any
    prefill: Callable
    admit: Callable
    step: Callable
    predict: Callable


def _port_params(arrays, cfg: ModelConfig, device):
    """The served params of a port checkpoint's arrays: the port's own
    layout, slot 0 of a stacked client half."""
    flat = checkpoint.expanded_arrays(arrays)
    probe = "client/embed/tok"
    prefix = "" if probe in flat else convert.FULL_STATE_PREFIX
    if prefix + probe not in flat:
        raise ValueError(f"port checkpoint has neither {probe!r} nor "
                         f"{convert.FULL_STATE_PREFIX + probe!r}: not a "
                         "params or full-state training checkpoint")
    tree = convert._nest({k[len(prefix):]: v for k, v in flat.items()
                          if k.startswith(prefix + "client/")
                          or k.startswith(prefix + "server/")})
    if np.shape(tree["client"]["embed"]["tok"]) != (cfg.vocab_size,
                                                    cfg.d_model):
        tree["client"] = convert._map(lambda a: a[0], tree["client"])
    return convert._map(lambda a: convert.to_tensor(a, device), tree)


def restore_global_params(cfg: ModelConfig, directory: str,
                          step: Optional[int] = None, device="cuda"):
    """Restore a federated training checkpoint and merge it into the
    served global model: one the port wrote
    (:mod:`repro_torch.checkpoint`) or ``repro.checkpoint.save``.

    A ``{'client': (K, ...) stacked, 'server': ...}`` params checkpoint
    serves client slot 0 (the aggregated global client half) with the
    server half; an already merged one restores as it is; a full-state
    checkpoint (``Trainer.save``) serves the params under its
    ``.inner/.params/`` keys. As in the reference, the newest file is
    read even when it is torn (the error is raised, no older step is
    tried).
    """
    step = checkpoint.latest_step(directory) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoints in {directory!r}")
    device = resolve_device(device)
    path = checkpoint.checkpoint_path(directory, step)
    with np.load(path) as data:
        port = checkpoint.PORT_KEY in data.files
    if port:
        return _port_params(checkpoint.load_arrays(path), cfg, device)
    return convert.params_from_npz(path, cfg, device)


def build_serve(spec: ServeSpec) -> ServeProgram:
    """Spec -> running deployment (restore + merge + engine)."""
    from repro_torch.models import transformer as T
    from repro_torch.serve import ServeEngine

    cfg = spec.model_config()
    device = resolve_device(spec.device)
    if spec.checkpoint_dir:
        params = restore_global_params(cfg, spec.checkpoint_dir,
                                       spec.checkpoint_step, device)
    else:
        gen = torch.Generator(device)
        gen.manual_seed(spec.seed)
        params = T.init_params(gen, cfg)

    engine = ServeEngine(
        params, cfg, slots=spec.slots, max_len=spec.max_len,
        pages=spec.pages, page_size=spec.page_size,
        temperature=spec.temperature, seed=spec.seed,
        admission=spec.admission, device=device)
    del params   # the engine holds the serving copy
    served = engine.params

    @torch.no_grad()
    def prefill(tokens):
        return T.forward_prefill_cached(served, {"tokens": tokens}, cfg,
                                        spec.max_len)

    @torch.no_grad()
    def predict(batch):
        return T.forward(served, batch, cfg)

    return ServeProgram(spec=spec, cfg=cfg, params=served, engine=engine,
                        prefill=prefill, admit=engine.admit,
                        step=engine.step, predict=predict)
