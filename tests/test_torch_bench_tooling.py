"""The port's boundary and serving legs, the dry run's report and the
table runner's new legs, on the CPU against the JAX package.

* boundary: the fused and dual loss stages of ``lace`` and ``logits``
  agree with each other, and with the reference's ``lace2_grads`` /
  ``lace_loss`` / ``dual_adjusted_xent`` on the same numpy inputs, within
  1e-5 of the largest entry; the result has ``bench_boundary``'s keys;
* serve: on MICRO, from the reference's params through ``convert.py``,
  the static, continuous and paged legs' greedy tokens equal each other
  and the reference engine's on the same prompts;
* report: an ok and a skip row render; ``run.py --table boundary | serve
  | roofline --device cpu --quick`` runs.
"""
import json

import jax
import numpy as np
import pytest

from benchmarks import boundary as ref_boundary
from benchmarks import serve as ref_serve
from repro.core import losses as ref_losses
from repro.kernels.lace import ops as ref_lace
from repro.models import transformer as JT
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JServeEngine
from repro_torch import convert
from repro_torch.benchmarks import boundary, serve
from repro_torch.benchmarks import run as table_run
from repro_torch.configs import get_config
from repro_torch.configs.base import InputShape
from repro_torch.launch.dryrun import dryrun_one
from repro_torch.perf import report

CELL = (32, 64, 32)          # d, tokens per group, chunk
CLASSES = 97


def _close(a, b, tol=1e-5):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    scale = max(np.abs(b).max(), 1e-30)
    assert np.abs(a - b).max() <= tol * scale, np.abs(a - b).max() / scale


def test_boundary_lace_fused_dual_and_reference_agree():
    d, n, ck = CELL
    dual, fused = boundary.lace_pair(d, n, ck, classes=CLASSES, device="cpu")
    got_f, got_d = fused(), dual()
    for a, b in zip(got_f, got_d):
        _close(a, b)
    feats, w, labels, p_s, p_k = boundary.lace_case(d, n, CLASSES)
    ids = np.arange(boundary.G)
    want = ref_lace.lace2_grads(feats, w, labels, p_s, None, p_k, ids, None,
                                boundary.TAU, boundary.EPS, ck)[:5]
    for a, b in zip(got_f, want):
        _close(a, b)
    ls, (gf_s, gw_s) = jax.value_and_grad(
        lambda f, wh: ref_lace.lace_loss(f, wh, labels, p_s, None, None,
                                         boundary.TAU, boundary.EPS, ck),
        argnums=(0, 1))(feats, w)
    lk, gf_k = jax.value_and_grad(
        lambda f: ref_lace.lace_loss(f, w, labels, p_k, ids, None,
                                     boundary.TAU, boundary.EPS, ck))(feats)
    for a, b in zip(got_d, (ls, lk, gf_s, gf_k, gw_s)):
        _close(a, b)


def test_boundary_logits_fused_dual_and_reference_agree():
    d, n, ck = CELL
    dual, fused = boundary.logits_pair(d, n, ck, classes=CLASSES,
                                       device="cpu")
    got_f, got_d = fused(), dual()
    for a, b in zip(got_f, got_d):
        _close(a, b)
    logits, labels, p_s, p_k = boundary.logits_case(d, n, CLASSES)
    want = ref_losses.dual_adjusted_xent(logits, labels, prior_s=p_s,
                                         prior_k=p_k, tau=boundary.TAU)
    for a, b in zip(got_f, want):
        _close(a, b)


def _keys(tree):
    if isinstance(tree, dict):
        return {k: _keys(v) for k, v in tree.items()}
    return type(tree).__name__ in ("int", "float")


def test_boundary_result_has_the_reference_keys():
    grid = (CELL,)
    got = boundary.bench_boundary(grid=grid, reps=1, device="cpu")
    want = ref_boundary.bench_boundary(grid=grid, reps=1)
    assert _keys(got["backends"]) == _keys(want["backends"])
    assert set(got) == set(want) and set(got["config"]) == set(
        want["config"])
    assert got["backend"] == "cpu"
    for entry in got["backends"].values():
        assert entry["max_speedup"] >= entry["min_speedup"] > 0


def test_serve_legs_equal_each_other_and_the_reference():
    jparams = JT.init_params(jax.random.PRNGKey(0), ref_serve.MICRO)
    params = convert.params_from_reference(
        jax.tree.map(np.asarray, jparams), serve.MICRO)
    res = serve.bench_serve(arch=None, n_requests=6, slots_list=(2,),
                            reps=1, gap_scale=0.0, device="cpu",
                            params=params)
    entry = res["slots"]["2"]
    legs = [entry["batch"]["static"], entry["batch"]["continuous"],
            entry["open_loop"]["static"], entry["open_loop"]["continuous"],
            entry["paged"]]
    for leg in legs[1:]:
        assert leg["tokens"] == legs[0]["tokens"]
    reqs = serve.requests(serve.MICRO, 6, serve.PROMPT_LENS, serve.GENS,
                          "lognormal:1:1", 0.0)
    max_len = max(serve.PROMPT_LENS) + max(serve.GENS)
    jres = JServeEngine(jparams, ref_serve.MICRO, slots=2,
                        max_len=max_len).serve(
        [JRequest(r.rid, r.tokens, r.max_new) for r in reqs],
        wall_clock=False)
    assert {r.rid: np.asarray(jres[r.rid].tokens).tolist()
            for r in reqs} == legs[0]["tokens"]
    assert entry["batch"]["continuous_speedup"] > 0
    assert entry["paged"]["cache_ratio_vs_dense"] > 0
    assert set(entry["open_loop"]["continuous"]) >= {"latency_p50_s",
                                                     "latency_p99_s"}


def _records():
    cfg = get_config("qwen1.5-0.5b").reduced()
    ok = dryrun_one("qwen1.5-0.5b", "p", cfg=cfg,
                    shape=InputShape("p", 16, 2, "prefill"))
    skip = dryrun_one("gemma3-12b", "train_4k", grid_name="16x16")
    assert ok["status"] == "ok" and skip["status"] == "skip"
    return [ok, skip]


def test_report_renders_ok_and_skip_rows():
    recs = _records()
    recs[1]["mesh"] = "1"           # both rows on one grid's table
    for table in (report.dryrun_table(recs, "1"),
                  report.roofline_table(recs, "1")):
        lines = table.splitlines()
        assert len(lines) == 4
        assert "| qwen1.5-0.5b | p |" in lines[2] or \
            "| qwen1.5-0.5b | p |" in lines[3]
        assert any("skip" in line and "gemma3-12b" in line
                   for line in lines)
    assert "one-line fix" in report.roofline_table(recs, "1")


@pytest.mark.parametrize("table", ["boundary", "serve", "roofline"])
def test_table_runner_legs_run_on_cpu(table, tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(boundary, "GRID", (CELL, CELL))
    for rec in _records():
        path = tmp_path / f"{rec['arch']}__{rec['shape']}__{rec['mesh']}.json"
        path.write_text(json.dumps(rec))
    out_json = tmp_path / "out.json"
    res = table_run.main(["--table", table, "--device", "cpu", "--quick",
                          "--dryrun-dir", str(tmp_path), "--out",
                          str(out_json)])
    lines = capsys.readouterr().out.splitlines()
    assert lines and all(line.startswith(table) for line in lines)
    if table == "roofline":
        assert res["records"] == 2
        assert any(",ok," in line for line in lines)
    else:
        assert json.loads(out_json.read_text())["device"]["platform"] == \
            "cpu"
