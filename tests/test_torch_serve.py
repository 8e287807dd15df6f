"""The PyTorch port's serving stack on the CPU.

* the port engine's greedy tokens == the JAX ``ServeEngine``'s, and its
  per-step logits within 2e-5 (float32, same converted params);
* paged == dense bitwise inside the port (tokens and per-step logits)
  under a mixed-length continuous schedule, and engine == the port's
  token-by-token loop;
* static admission == continuous; deadline and token-budget eviction as
  the reference does it;
* xLSTM (mLSTM + sLSTM, no attention): the fused prefill's logits and
  every cache leaf against the reference's ``forward_prefill_cached``,
  paged == dense with no page taken, and the engine's float32 gate
  weights;
* ``ServeSpec`` validation and JSON round trip; ``restore_global_params``
  from checkpoints written by ``repro.checkpoint.save`` (K-stacked,
  merged, full training state); ``build_serve`` and the CLI on the CPU;
* MoE (reduced qwen3-moe-30b-a3b): the engine against the JAX engine and
  the port's token-by-token loop, paged == dense, the router kept in
  float32 in a bf16 serving copy, the expert leaves converted bit for
  bit, the CLI;
* jamba (reduced jamba-1.5-large-398b: mamba, attention and MoE): the
  engine against the JAX engine, ``ServeSpec`` accepting it, paged ==
  dense with pages taken for the attention layers only, mamba's dt
  projection, dt bias, ``A_log`` and ``D`` kept in float32 in a bf16
  serving copy, the CLI.
"""
import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helpers import tiny_cfg, tiny_xlstm_cfg
from repro import checkpoint
from repro.configs import get_config
from repro.models import transformer as JT
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JServeEngine
from repro_torch import convert
from repro_torch.api import ServeSpec, build_serve, restore_global_params
from repro_torch.configs import get_config as tget_config
from repro_torch.configs.base import MambaConfig as TMambaConfig
from repro_torch.configs.base import ModelConfig as TModelConfig
from repro_torch.configs.base import MoEConfig as TMoEConfig
from repro_torch.configs.base import XLSTMConfig as TXLSTMConfig
from repro_torch.launch.serve import generate
from repro_torch.models import transformer as T
from repro_torch.serve import Request, ServeEngine

torch.set_num_threads(1)
TOL = dict(atol=2e-5, rtol=2e-5)


def _port_cfg(cfg):
    xlstm = cfg.xlstm and TXLSTMConfig(**dataclasses.asdict(cfg.xlstm))
    moe = cfg.moe and TMoEConfig(**dataclasses.asdict(cfg.moe))
    mamba = cfg.mamba and TMambaConfig(**dataclasses.asdict(cfg.mamba))
    return TModelConfig(**{f.name: getattr(cfg, f.name)
                           for f in dataclasses.fields(cfg)
                           if f.name not in ("moe", "mamba", "xlstm")},
                        xlstm=xlstm, moe=moe, mamba=mamba)


def _f32(cfg):
    return dataclasses.replace(cfg, dtype="float32", param_dtype="float32")


def _np(tree):
    return jax.tree.map(np.asarray, tree)


CONFIGS = {
    "tiny": tiny_cfg,
    "qwen-reduced": lambda: _f32(get_config("qwen1.5-0.5b").reduced()),
    "xlstm-tiny": tiny_xlstm_cfg,
    "xlstm-reduced": lambda: _f32(get_config("xlstm-1.3b").reduced()),
    "qwen3-moe-reduced": lambda: _f32(
        get_config("qwen3-moe-30b-a3b").reduced()),
    "jamba-reduced": lambda: _f32(
        get_config("jamba-1.5-large-398b").reduced()),
}
XLSTM = ["xlstm-tiny", "xlstm-reduced"]
# 16 random xLSTM layers amplify float32 rounding: the reference's own
# fused prefill and token-by-token decode differ by up to 1.4e-4 there
MODEL_TOL = {"xlstm-reduced": dict(atol=2e-4, rtol=2e-4)}


def _setup(cfg, seed=0):
    params = JT.init_params(jax.random.PRNGKey(seed), cfg)
    return params, convert.params_from_reference(_np(params), _port_cfg(cfg))


def _mixed_requests(vocab, seed=3):
    rng = np.random.default_rng(seed)
    lens = [6, 9, 12, 6, 9, 12, 6]
    news = [5, 3, 4, 6, 2, 5, 3]
    return [(i, rng.integers(0, vocab, P), n)
            for i, (P, n) in enumerate(zip(lens, news))]


def _engine(params, cfg, **kw):
    return ServeEngine(params, _port_cfg(cfg), device="cpu", **kw)


# --------------------------------------------------------------------------
# port engine == JAX engine
# --------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(CONFIGS))
def test_engine_matches_reference_engine(name):
    cfg = CONFIGS[name]()
    jparams, tparams = _setup(cfg)
    reqs = _mixed_requests(cfg.vocab_size)[:4]
    jeng = JServeEngine(jparams, cfg, slots=2, max_len=18, record_logits=True)
    want = jeng.serve([JRequest(i, t, n) for i, t, n in reqs],
                      wall_clock=False)
    teng = _engine(tparams, cfg, slots=2, max_len=18, record_logits=True)
    got = teng.serve([Request(i, t, n) for i, t, n in reqs],
                     wall_clock=False)
    tol = MODEL_TOL.get(name, TOL)
    for i, _, n in reqs:
        np.testing.assert_array_equal(got[i].tokens, want[i].tokens)
        assert len(got[i].logits) == len(want[i].logits) == n
        for a, b in zip(got[i].logits, want[i].logits):
            np.testing.assert_allclose(a, np.asarray(b), **tol)
        assert (got[i].t_admit, got[i].t_finish) == \
            (want[i].t_admit, want[i].t_finish)


@pytest.mark.parametrize("name", XLSTM)
def test_xlstm_prefill_cache_matches_reference(name):
    """Logits at the last position and every layer's decode cache (the
    mLSTM conv tail and (C, n, m), the sLSTM (c, n, m, h)) against the
    reference's fused prefill, on an odd prompt."""
    cfg = CONFIGS[name]()
    jparams, tparams = _setup(cfg)
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, (1, 13))
    jlogits, jcache = JT.forward_prefill_cached(
        jparams, {"tokens": jnp.asarray(toks)}, cfg, 20)
    pcfg = _port_cfg(cfg)
    logits, cache = T.forward_prefill_cached(
        tparams, {"tokens": torch.as_tensor(toks)}, pcfg, 20)
    tol = MODEL_TOL.get(name, TOL)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), **tol)
    want = convert.per_layer(jcache["client"], jcache["prologue"],
                             jcache["groups"], cfg)
    assert set(cache) == {f"blk{l}" for l in want}
    # state leaves (C sums outer products) are held to the tolerance of
    # their largest entry
    for l, leaves in want.items():
        got = cache[f"blk{l}"]
        assert set(got) == set(leaves)
        for key, a in leaves.items():
            a = np.asarray(a)
            assert got[key].shape == a.shape, f"blk{l}/{key}"
            err = np.abs(got[key].numpy() - a).max() / np.abs(a).max()
            assert err <= tol["rtol"], f"blk{l}/{key}: {err}"


@pytest.mark.parametrize("name", XLSTM)
def test_xlstm_paged_equals_dense_without_pages(name):
    """An attention-free model keeps all its state dense: a paged engine
    takes no page and serves bitwise what the dense one does, and both
    equal the token-by-token loop."""
    cfg = CONFIGS[name]()
    _, params = _setup(cfg)
    reqs = _mixed_requests(cfg.vocab_size)
    dense = _engine(params, cfg, slots=2, max_len=18, record_logits=True)
    paged = _engine(params, cfg, slots=2, max_len=18, pages=6, page_size=4,
                    record_logits=True)
    assert paged.ops.pages_needed(18) == 0
    assert paged.state_bytes() == dense.state_bytes()
    rd = dense.serve([Request(i, t, n) for i, t, n in reqs], wall_clock=False)
    rp = paged.serve([Request(i, t, n) for i, t, n in reqs], wall_clock=False)
    pcfg = _port_cfg(cfg)
    for i, toks, n in reqs:
        np.testing.assert_array_equal(rd[i].tokens, rp[i].tokens)
        assert all(np.array_equal(a, b)
                   for a, b in zip(rd[i].logits, rp[i].logits))
        ref = generate(params, pcfg, torch.as_tensor(toks[None]), 18, n)
        np.testing.assert_array_equal(rd[i].tokens, ref[0].numpy())
    assert len(paged._free_pages) == 6


def test_xlstm_serving_params_keep_float32_gates():
    """The reference applies the gate projections and biases in float32
    whatever the compute dtype; the engine's bf16 copy keeps them so."""
    cfg = tiny_xlstm_cfg(dtype="bfloat16")
    _, params = _setup(cfg)
    eng = _engine(params, cfg, slots=2, max_len=18)
    blocks = eng.params["server"]["blocks"]
    mlstm, slstm = blocks["blk2"]["mixer"], blocks["blk1"]["mixer"]
    for leaf in (mlstm["w_gates"], mlstm["b_gates"], slstm["w_gates"],
                 slstm["b_gates"], slstm["r_gates"],
                 mlstm["out_norm"]["scale"]):
        assert leaf.dtype == torch.float32
    for leaf in (mlstm["up"], mlstm["wq"], mlstm["conv_w"], mlstm["down"],
                 slstm["ffn_up"]):
        assert leaf.dtype == torch.bfloat16
    assert eng._cache["blk0"]["conv"].dtype == torch.bfloat16
    assert eng._cache["blk0"]["C"].dtype == torch.float32
    prompts = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 7))
    out = eng.generate(prompts, 4)
    assert out.shape == (2, 11) and out.max() < cfg.vocab_size


# --------------------------------------------------------------------------
# inside the port: paged == dense bitwise, engine == loop, static == cont.
# --------------------------------------------------------------------------


@pytest.mark.parametrize("window", [None, 5])
def test_paged_bitwise_dense_continuous(window):
    cfg = tiny_cfg(window_pattern=(window,))
    _, params = _setup(cfg)
    reqs = _mixed_requests(cfg.vocab_size)
    dense = _engine(params, cfg, slots=2, max_len=18, record_logits=True)
    paged = _engine(params, cfg, slots=2, max_len=18, pages=2 * 5,
                    page_size=4, record_logits=True)
    rd = dense.serve([Request(i, t, n) for i, t, n in reqs], wall_clock=False)
    rp = paged.serve([Request(i, t, n) for i, t, n in reqs], wall_clock=False)
    assert set(rd) == set(rp) == {i for i, _, _ in reqs}
    pcfg = _port_cfg(cfg)
    for i, toks, n in reqs:
        np.testing.assert_array_equal(rd[i].tokens, rp[i].tokens)
        assert len(rd[i].logits) == len(rp[i].logits) == n
        for a, b in zip(rd[i].logits, rp[i].logits):
            assert np.array_equal(a, b)                 # bitwise
        ref = generate(params, pcfg, torch.as_tensor(toks[None]), 18, n)
        np.testing.assert_array_equal(rd[i].tokens, ref[0].numpy())
    assert len(paged._free_pages) == 10 and len(paged._free_slots) == 2


def test_bf16_serving_copy_and_paged_bitwise_dense():
    """A bf16 config: the engine serves a copy cast once to bf16 (norm
    scales stay f32), and paged stays bitwise equal to dense."""
    cfg = tiny_cfg(dtype="bfloat16")
    _, params = _setup(cfg)
    reqs = _mixed_requests(cfg.vocab_size)[:4]
    dense = _engine(params, cfg, slots=2, max_len=18, record_logits=True)
    paged = _engine(params, cfg, slots=2, max_len=18, pages=10, page_size=4,
                    record_logits=True)
    blk = dense.params["server"]["blocks"]["blk1"]
    assert blk["mixer"]["wq"].dtype == torch.bfloat16
    assert blk["norm1"]["scale"].dtype == torch.float32
    assert dense._cache["blk0"]["k"].dtype == torch.bfloat16
    rd = dense.serve([Request(i, t, n) for i, t, n in reqs], wall_clock=False)
    rp = paged.serve([Request(i, t, n) for i, t, n in reqs], wall_clock=False)
    for i, _, _ in reqs:
        np.testing.assert_array_equal(rd[i].tokens, rp[i].tokens)
        assert all(np.array_equal(a, b)
                   for a, b in zip(rd[i].logits, rp[i].logits))


def test_static_admission_matches_continuous():
    cfg = tiny_cfg()
    _, params = _setup(cfg)
    reqs = _mixed_requests(cfg.vocab_size)
    rc = _engine(params, cfg, slots=2, max_len=18).serve(
        [Request(i, t, n) for i, t, n in reqs], wall_clock=False)
    rs = _engine(params, cfg, slots=2, max_len=18, admission="static").serve(
        [Request(i, t, n) for i, t, n in reqs], wall_clock=False)
    for i, _, _ in reqs:
        np.testing.assert_array_equal(rc[i].tokens, rs[i].tokens)


def test_temperature_sampling_deterministic():
    cfg = tiny_cfg()
    _, params = _setup(cfg)
    prompts = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 6))
    outs = [_engine(params, cfg, slots=2, max_len=16, temperature=0.8,
                    seed=7).generate(prompts, 4) for _ in range(2)]
    np.testing.assert_array_equal(outs[0], outs[1])
    assert outs[0].min() >= 0 and outs[0].max() < cfg.vocab_size


def test_admit_step_take_finished_and_errors():
    cfg = tiny_cfg()
    _, params = _setup(cfg)
    prompts = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 5))
    eng = _engine(params, cfg, slots=2, max_len=12)
    assert eng.admit(Request(0, prompts[0], 3))
    assert eng.admit(Request(1, prompts[1], 1))       # finishes at admit
    done = eng.take_finished()
    assert set(done) == {1} and done[1].tokens.shape == (6,)
    for _ in range(2):
        eng.step()
    done = eng.take_finished()
    assert set(done) == {0} and done[0].tokens.shape == (8,)
    assert eng.n_active == 0
    ref = generate(params, _port_cfg(cfg), torch.as_tensor(prompts[:1]), 12, 3)
    np.testing.assert_array_equal(done[0].tokens, ref[0].numpy())

    with pytest.raises(ValueError, match="max_new"):
        eng.admit(Request(0, prompts[0], 0))
    with pytest.raises(ValueError, match="max_len"):
        eng.admit(Request(0, prompts[0], 8))          # 5 + 8 > 12
    small = _engine(params, cfg, slots=1, max_len=16, pages=1, page_size=4)
    with pytest.raises(RuntimeError, match="page pool"):
        small.serve([Request(0, prompts[0], 4)], wall_clock=False)


def test_deadline_and_budget_eviction():
    """The reference's eviction contract (tests/test_faults.py), and the
    deadline schedule equal to the reference engine's."""
    cfg = tiny_cfg()
    jparams, params = _setup(cfg)
    prompts = np.random.default_rng(1).integers(0, cfg.vocab_size, (3, 4))

    eng = _engine(params, cfg, slots=2, max_len=64)
    base = eng.serve([Request(i, prompts[i], 6) for i in range(3)],
                     wall_clock=False)
    assert all(r.evicted is None and len(r.tokens) == 10
               for r in base.values())

    # one slot: rid0's deadline evicts it mid-generation, rid1 takes over
    reqs = [(0, prompts[0], 20, 3.0), (1, prompts[1], 4, None)]
    res = _engine(params, cfg, slots=1, max_len=64).serve(
        [Request(i, t, n, deadline=d) for i, t, n, d in reqs],
        wall_clock=False)
    assert res[0].evicted == "deadline"
    assert 1 <= len(res[0].tokens) - 4 < 20
    assert res[1].evicted is None and len(res[1].tokens) - 4 == 4
    assert res[1].t_admit >= res[0].t_finish
    want = JServeEngine(jparams, cfg, slots=1, max_len=64).serve(
        [JRequest(i, t, n, deadline=d) for i, t, n, d in reqs],
        wall_clock=False)
    for i in (0, 1):
        np.testing.assert_array_equal(res[i].tokens, want[i].tokens)
        assert (res[i].evicted, res[i].t_finish) == \
            (want[i].evicted, want[i].t_finish)

    # token budget: capped at 3, prefix bitwise the uncapped generation's
    res3 = _engine(params, cfg, slots=2, max_len=64, token_budget=3).serve(
        [Request(0, prompts[0], 10), Request(1, prompts[1], 2)],
        wall_clock=False)
    assert res3[0].evicted == "budget" and len(res3[0].tokens) == 4 + 3
    assert res3[1].evicted is None
    np.testing.assert_array_equal(res3[0].tokens, base[0].tokens[:7])

    # paged: eviction returns the pages to the pool
    eng4 = _engine(params, cfg, slots=2, max_len=64, pages=8, page_size=4)
    res4 = eng4.serve([Request(0, prompts[0], 20, deadline=2.0),
                       Request(1, prompts[1], 20, deadline=2.0),
                       Request(2, prompts[2], 3, arrival=1.0)],
                      wall_clock=False)
    assert res4[0].evicted == "deadline" and res4[1].evicted == "deadline"
    assert res4[2].evicted is None
    assert len(eng4._free_pages) == 8 and len(eng4._free_slots) == 2

    with pytest.raises(ValueError, match="deadline"):
        eng.serve([Request(9, prompts[0], 2, deadline=0.0)],
                  wall_clock=False)
    with pytest.raises(ValueError, match="token_budget"):
        _engine(params, cfg, slots=1, max_len=64, token_budget=0)


def test_cuda_default_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    cfg = tiny_cfg()
    _, params = _setup(cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeEngine(params, _port_cfg(cfg), slots=1, max_len=8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_serve(ServeSpec(reduced=True))


# --------------------------------------------------------------------------
# ServeSpec
# --------------------------------------------------------------------------


def test_servespec_validation():
    with pytest.raises(ValueError, match="frontend"):
        ServeSpec(arch="whisper-tiny", reduced=True)
    with pytest.raises(ValueError, match="frontend"):
        ServeSpec(arch="internvl2-26b", reduced=True)
    with pytest.raises(ValueError, match="slots"):
        ServeSpec(reduced=True, slots=0)
    with pytest.raises(ValueError, match="max_len"):
        ServeSpec(reduced=True, max_len=1)
    with pytest.raises(ValueError, match="pages"):
        ServeSpec(reduced=True, pages=-1)
    with pytest.raises(ValueError, match="page_size"):
        ServeSpec(reduced=True, page_size=0)
    with pytest.raises(ValueError, match="temperature"):
        ServeSpec(reduced=True, temperature=-0.1)
    with pytest.raises(ValueError, match="admission"):
        ServeSpec(reduced=True, admission="fifo")
    with pytest.raises(ValueError, match="device"):
        ServeSpec(reduced=True, device="nonsense")


def test_servespec_json_roundtrip_and_reference_fields():
    from repro.api import ServeSpec as JServeSpec
    spec = ServeSpec(arch="xlstm-1.3b", reduced=True, slots=8, max_len=64,
                     pages=16, page_size=8, temperature=0.5, seed=3,
                     admission="static", device="cpu")
    assert ServeSpec.from_json(spec.to_json()) == spec
    ref = dataclasses.asdict(JServeSpec())
    assert set(dataclasses.asdict(ServeSpec())) == set(ref) | {"device"}
    d = spec.to_dict()
    d.pop("device")
    assert JServeSpec.from_dict(d).to_dict() == d


# --------------------------------------------------------------------------
# checkpoints written by the reference -> serving
# --------------------------------------------------------------------------


def _cfg_qwen():
    return _f32(get_config("qwen1.5-0.5b").reduced())


def _assert_same_params(got, want):
    if isinstance(want, dict):
        assert got.keys() == want.keys()
        for k in want:
            _assert_same_params(got[k], want[k])
    else:
        np.testing.assert_array_equal(got.numpy(), want.numpy())


@pytest.mark.parametrize("layout", ["stacked", "merged", "full-state"])
def test_restore_global_params(tmp_path, layout):
    cfg = _cfg_qwen()
    pcfg = _port_cfg(cfg)
    params = _np(JT.init_params(jax.random.PRNGKey(0), cfg))
    want = convert.params_from_reference(params, pcfg)
    if layout == "stacked":
        # K = 3 client slots; slot 0 is the aggregated global client half
        other = _np(JT.init_params(jax.random.PRNGKey(1), cfg))["client"]
        tree = {"client": jax.tree.map(lambda a, b: np.stack([a, b, b]),
                                       params["client"], other),
                "server": params["server"]}
    elif layout == "merged":
        tree = params
    else:
        tree = {".inner": {".params": params,
                           ".opt": {"mu": np.zeros(3, np.float32)}},
                ".round": np.int32(4)}
    d = str(tmp_path / "ckpt")
    checkpoint.save(d, 2, jax.tree.map(np.zeros_like, tree))
    checkpoint.save(d, 5, tree)
    _assert_same_params(restore_global_params(pcfg, d, device="cpu"), want)
    assert restore_global_params(pcfg, d, 2, device="cpu")["server"][
        "head"]["out"].abs().max() == 0


def test_restore_errors(tmp_path):
    pcfg = tget_config("qwen1.5-0.5b").reduced()
    with pytest.raises(FileNotFoundError):
        restore_global_params(pcfg, str(tmp_path / "nope"), device="cpu")
    d = str(tmp_path / "bad")
    checkpoint.save(d, 1, {"weights": np.zeros(3)})
    with pytest.raises(ValueError, match="not a params"):
        restore_global_params(pcfg, d, device="cpu")
    checkpoint.save(d, 2, _np(JT.init_params(jax.random.PRNGKey(0),
                                             tiny_cfg())))
    with pytest.raises(ValueError, match="client embedding"):
        restore_global_params(pcfg, d, device="cpu")


def test_build_serve_from_checkpoint(tmp_path):
    """ServeSpec -> build_serve on a reference checkpoint: predict and
    prefill match the reference model, and the engine serves."""
    cfg = _cfg_qwen()
    jparams = JT.init_params(jax.random.PRNGKey(0), cfg)
    d = str(tmp_path / "ckpt")
    checkpoint.save(d, 1, jparams)
    prog = build_serve(ServeSpec(arch="qwen1.5-0.5b", reduced=True,
                                 checkpoint_dir=d, slots=2, max_len=24,
                                 device="cpu"))
    # the spec's reduced config computes in f32 already
    assert prog.cfg == tget_config("qwen1.5-0.5b").reduced()
    toks = np.arange(2 * 12).reshape(2, 12) % cfg.vocab_size
    want, _ = JT.forward(jparams, {"tokens": jnp.asarray(toks)}, cfg,
                         remat=False)
    got = prog.predict({"tokens": torch.as_tensor(toks)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    logits, cache = prog.prefill(torch.as_tensor(toks[:1, :8]))
    assert logits.shape == (1, 1, cfg.vocab_size)
    assert cache["blk0"]["k"].shape == (1, 24, cfg.num_kv_heads, cfg.head_dim)
    assert prog.admit(Request(0, toks[0, :8], 2))
    prog.step()
    done = prog.engine.take_finished()
    assert set(done) == {0} and done[0].tokens.shape == (10,)


def _cli_rows_agree(monkeypatch, capsys, arch_flags):
    """The serving CLI on the CPU, dense, paged and ``--reference``: each
    prints tok/s and the same sample row."""
    from repro_torch.launch import serve
    base = ["serve"] + arch_flags + [
        "--reduced", "--device", "cpu", "--batch", "3", "--prompt-len", "6",
        "--gen", "3", "--slots", "2"]
    rows = []
    for extra in ([], ["--pages", "8", "--page-size", "4"], ["--reference"]):
        monkeypatch.setattr(sys, "argv", base + extra)
        serve.main()
        out = capsys.readouterr().out
        assert "tok/s" in out
        rows.append(out.split("sample row:")[1].strip())
    assert rows[0] == rows[1] == rows[2]


def test_cli_runs_on_cpu(monkeypatch, capsys):
    _cli_rows_agree(monkeypatch, capsys, [])


# --------------------------------------------------------------------------
# MoE
# --------------------------------------------------------------------------

MOE_ARCH = "qwen3-moe-30b-a3b"
JAMBA = "jamba-1.5-large-398b"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_engine_matches_loop_and_paged_dense(dtype):
    """Reduced qwen3-moe: paged == dense bitwise under the mixed
    continuous schedule; in float32 the engine (dropless fused prefill,
    decode at the configured capacity) == the token-by-token loop; a bf16
    serving copy keeps the router in float32 and the experts in bf16."""
    cfg = dataclasses.replace(get_config(MOE_ARCH).reduced(), dtype=dtype)
    _, params = _setup(cfg)
    reqs = _mixed_requests(cfg.vocab_size)
    dense = _engine(params, cfg, slots=2, max_len=18, record_logits=True)
    paged = _engine(params, cfg, slots=2, max_len=18, pages=2 * 5,
                    page_size=4, record_logits=True)
    ffn = dense.params["server"]["blocks"]["blk2"]["ffn"]
    assert ffn["router"].dtype == torch.float32
    assert {ffn[k].dtype for k in ("gate", "up", "down")} == {
        getattr(torch, dtype)}
    rd = dense.serve([Request(i, t, n) for i, t, n in reqs], wall_clock=False)
    rp = paged.serve([Request(i, t, n) for i, t, n in reqs], wall_clock=False)
    pcfg = _port_cfg(cfg)
    for i, toks, n in reqs:
        np.testing.assert_array_equal(rd[i].tokens, rp[i].tokens)
        assert all(np.array_equal(a, b)
                   for a, b in zip(rd[i].logits, rp[i].logits))
        if dtype == "float32":
            ref = generate(params, pcfg, torch.as_tensor(toks[None]), 18, n)
            np.testing.assert_array_equal(rd[i].tokens, ref[0].numpy())


def test_moe_serving_copy_shares_leaves_already_served():
    """A leaf already in its serving dtype on the device is served as it
    is: a 61 GB bf16 model is not copied a second time."""
    from repro_torch.serve.engine import serving_params
    cfg = dataclasses.replace(tget_config(MOE_ARCH).reduced(),
                              dtype="bfloat16", param_dtype="bfloat16")
    gen = torch.Generator()
    gen.manual_seed(0)
    params = T.init_params(gen, cfg)
    served = serving_params(params, cfg, torch.device("cpu"))
    src = params["server"]["blocks"]["blk2"]["ffn"]
    got = served["server"]["blocks"]["blk2"]["ffn"]
    for k in ("router", "gate", "up", "down"):
        assert got[k] is src[k], k


def test_moe_leaves_convert_bitwise(tmp_path):
    """``params_from_reference`` and ``params_from_npz`` carry every
    layer's router, gate, up and down bit for bit, out of the client
    blocks, the prologue and the stacked scan groups."""
    cfg = _f32(get_config(MOE_ARCH).reduced())
    pcfg = _port_cfg(cfg)
    tree = _np(JT.init_params(jax.random.PRNGKey(0), cfg))
    client_l, prologue_l, first, n_scan = JT._layout(cfg)
    gs = cfg.group_size
    want = {l: tree["client"]["blocks"][f"blk{i}"]["ffn"]
            for i, l in enumerate(client_l)}
    want.update({l: tree["server"]["prologue"][f"blk{i}"]["ffn"]
                 for i, l in enumerate(prologue_l)})
    for g in range(n_scan):
        for j in range(gs):
            want[first + g * gs + j] = {
                k: a[g] for k, a in tree["server"]["groups"][f"blk{j}"][
                    "ffn"].items()}
    assert sorted(want) == list(range(cfg.num_layers))
    d = str(tmp_path / "ckpt")
    path = checkpoint.save(d, 1, tree)
    for got in (convert.params_from_reference(tree, pcfg),
                convert.params_from_npz(path, pcfg)):
        for l, leaves in want.items():
            half = "client" if l < cfg.split_layer else "server"
            ffn = got[half]["blocks"][f"blk{l}"]["ffn"]
            assert ffn.keys() == leaves.keys() == {"router", "gate", "up",
                                                   "down"}
            for k, a in leaves.items():
                assert ffn[k].numpy().dtype == a.dtype
                np.testing.assert_array_equal(ffn[k].numpy(), a)


def test_servespec_serves_moe_and_refuses_jamba():
    """Every MoE arch is accepted, jamba (mamba + attention + MoE) too,
    at full and reduced size. The frontend archs' blocks (whisper's
    cross-attention) are ported, but ServeSpec still refuses both for
    their frontend, as the reference's does."""
    for arch in (MOE_ARCH, "dbrx-132b", JAMBA):
        for reduced in (False, True):
            spec = ServeSpec(arch=arch, reduced=reduced)
            assert spec.model_config().moe is not None
    assert ServeSpec(arch=JAMBA).model_config().mamba.d_state == 16
    from repro_torch.models.blocks import check_spec
    whisper = tget_config("whisper-tiny")
    assert whisper.block_spec(0).cross_attn
    check_spec(whisper.block_spec(0))
    for arch in ("whisper-tiny", "internvl2-26b"):
        with pytest.raises(ValueError, match="frontend"):
            ServeSpec(arch=arch, reduced=True)


def test_cli_serves_moe_on_cpu(monkeypatch, capsys):
    _cli_rows_agree(monkeypatch, capsys, ["--arch", MOE_ARCH])


# --------------------------------------------------------------------------
# jamba: mamba + attention + MoE
# --------------------------------------------------------------------------


def test_jamba_paged_equals_dense_pages_for_attention_only():
    """Reduced jamba (14 mamba layers, 2 attention): the paged pool holds
    k, v for the attention layers alone, mamba's conv and h stay dense
    slot rows; paged == dense bitwise under the mixed continuous schedule,
    and both equal the token-by-token loop."""
    cfg = CONFIGS["jamba-reduced"]()
    _, params = _setup(cfg)
    reqs = _mixed_requests(cfg.vocab_size)
    dense = _engine(params, cfg, slots=2, max_len=18, record_logits=True)
    paged = _engine(params, cfg, slots=2, max_len=18, pages=2 * 5,
                    page_size=4, record_logits=True)
    attn = {f"blk{l}" for l, s in enumerate(cfg.block_specs)
            if s.mixer == "attn"}
    assert attn and len(attn) < cfg.num_layers
    assert {i.layer for i in paged.ops.kv} == attn
    assert {i.name for i in paged.ops.dense} == {"conv", "h"}
    for layer, leaves in paged._cache.items():
        if layer in attn:
            assert leaves["k"].shape[:2] == (10, 4)
        else:
            assert leaves["h"].shape[0] == leaves["conv"].shape[0] == 2
    assert paged.ops.pages_needed(18) == 5
    rd = dense.serve([Request(i, t, n) for i, t, n in reqs], wall_clock=False)
    rp = paged.serve([Request(i, t, n) for i, t, n in reqs], wall_clock=False)
    pcfg = _port_cfg(cfg)
    for i, toks, n in reqs:
        np.testing.assert_array_equal(rd[i].tokens, rp[i].tokens)
        assert all(np.array_equal(a, b)
                   for a, b in zip(rd[i].logits, rp[i].logits))
        ref = generate(params, pcfg, torch.as_tensor(toks[None]), 18, n)
        np.testing.assert_array_equal(rd[i].tokens, ref[0].numpy())
    assert len(paged._free_pages) == 10


def test_jamba_serving_params_keep_float32_ssm_leaves():
    """The reference computes dt and A = -exp(A_log) in float32 whatever
    the compute dtype: the engine's bf16 copy keeps mamba's dt_proj,
    dt_bias, A_log and D so, the conv and the projections in bf16; the
    state h stays float32 in a bf16 cache."""
    cfg = dataclasses.replace(get_config(JAMBA).reduced(),
                              dtype="bfloat16")
    _, params = _setup(cfg)
    eng = _engine(params, cfg, slots=2, max_len=18)
    mixer = eng.params["client"]["blocks"]["blk0"]["mixer"]
    for k in ("dt_proj", "dt_bias", "A_log", "D"):
        assert mixer[k].dtype == torch.float32, k
    for k in ("in_proj", "conv_w", "conv_b", "x_proj", "out_proj"):
        assert mixer[k].dtype == torch.bfloat16, k
    assert eng._cache["blk0"]["conv"].dtype == torch.bfloat16
    assert eng._cache["blk0"]["h"].dtype == torch.float32
    prompts = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 7))
    out = eng.generate(prompts, 4)
    assert out.shape == (2, 11) and out.max() < cfg.vocab_size


def test_cli_serves_jamba_on_cpu(monkeypatch, capsys):
    _cli_rows_agree(monkeypatch, capsys, ["--arch", JAMBA])
