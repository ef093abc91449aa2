"""The harness finds what BENCHMARK.json names, refuses what it does not, builds
the result line the contract asks for, and watches for forbidden modules."""
from __future__ import annotations

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

from pmbench import harness
from pmbench.harness import Outcome

BENCH = harness.benchmark()


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_resolves_by_name(workload):
    cell = harness.find_cell(BENCH, workload)
    assert cell.config["family"] and cell.traffic["kind"]
    assert harness.driver(cell).run
    assert {m["name"] for m in cell.end_to_end} >= {"setup_s"}
    assert len(cell.end_to_end) >= 2 and cell.per_layer
    for m in cell.per_layer:
        assert callable(harness.reader(m["name"]))
    assert cell.limits


@pytest.mark.parametrize("what", ["workload", "config", "traffic", "limits", "driver", "metric"])
def test_unknown_names_are_refused(what, tmp_path):
    bench = json.loads(json.dumps(BENCH))
    w = bench["workloads"][0]
    if what == "workload":
        with pytest.raises(KeyError, match="unknown workload"):
            harness.find_cell(bench, "no_such.cell")
    elif what == "config":
        w["config"] = "no_such_config"
        with pytest.raises(KeyError, match="unknown config"):
            harness.find_cell(bench, w["name"])
    elif what == "traffic":
        w["traffic"] = "no_such_mix"
        with pytest.raises(KeyError, match="unknown traffic mix"):
            harness.find_cell(bench, w["name"])
    elif what == "limits":
        w["name"] = "pm_vqvae_celeb_a.no_limits"
        with pytest.raises(KeyError, match="unknown limits file"):
            harness.find_cell(bench, w["name"])
    elif what == "driver":
        cell = harness.find_cell(bench, w["name"])
        cell.config = dict(cell.config, family="no_such_family")
        with pytest.raises(KeyError, match="unknown driver"):
            harness.driver(cell)
    else:
        with pytest.raises(KeyError, match="unknown metric reader"):
            harness.reader("no_such.metric")


def _outcome(checks):
    return Outcome(attempted=7, failed=0, end_to_end={"setup_s": 1.5, "train_imgs_per_s": 400.0},
                   checks=checks, memory_peak_bytes=123, facts={"batch_ms": [1.0, 3.0]})


def test_result_line_keys_and_checks_last():
    cell = harness.find_cell(BENCH, "pm_vqvae_celeb_a.train")
    res = harness.result(cell, _outcome({"loss_gap": (1e-7, 1e-5)}), False, "H100", "700 W")
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(res)[-1] == "checks"
    assert res["correct"] is True
    assert set(res["metrics"]) == {"setup_s", "train_imgs_per_s"}
    assert res["metrics"]["setup_s"] == {"value": 1.5, "unit": "s"}
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(res["device"])
    assert res["checks"] == {"loss_gap": {"value": 1e-7, "limit": 1e-5}}
    json.dumps(res)


@pytest.mark.parametrize("value", [2e-5, float("nan"), float("inf")])
def test_a_number_over_its_limit_is_not_correct(value):
    cell = harness.find_cell(BENCH, "pm_vqvae_celeb_a.train")
    res = harness.result(cell, _outcome({"loss_gap": (value, 1e-5)}), False, "H100", None)
    assert res["correct"] is False


def test_traced_line_reports_readable_per_layer_metrics_only():
    cell = harness.find_cell(BENCH, "pm_vqvae_celeb_a.train")
    out = _outcome({})
    res = harness.result(cell, out, True, "H100", None)
    # no traced window and no window facts: only the host span has something to read
    assert set(res["metrics"]) == {"data.batch_ms.train"}
    assert res["metrics"]["data.batch_ms.train"]["value"] == 2.0
    out.facts.update(steps=10, window_s=1.0)
    res = harness.result(cell, out, True, "H100", None)
    assert set(res["metrics"]) == {"data.batch_ms.train", "mfu.train"}
    assert 0 < res["metrics"]["mfu.train"]["value"] < 100


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "posterior_matching_tpu_like", sys)
    monkeypatch.setitem(sys.modules, "jaxtyping_stub", sys)
    assert harness.forbidden_loaded() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    monkeypatch.setitem(sys.modules, "posterior_matching_tpu", sys)
    assert harness.forbidden_loaded() == ["jax.numpy", "posterior_matching_tpu"]


def test_a_run_loads_no_forbidden_module():
    """Drive a whole (tiny, CPU) run of every cell in a fresh process and list
    what it loaded."""
    code = (
        "import time, sys\n"
        "from pmbench import harness\n"
        "from pmbench.tests.tiny import tiny_cell\n"
        "for w in [w['name'] for w in harness.benchmark()['workloads']]:\n"
        "    c = tiny_cell(w)\n"
        "    harness.driver(c).run(c, seed=3, seconds=0.2, trace=False, device='cpu',\n"
        "                         t_start=time.time())\n"
        "print('loaded:' + ','.join(harness.forbidden_loaded()))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=harness.ROOT, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "loaded:"


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_reference_imports_nothing_of_the_program():
    files = sorted((harness.PKG / "reference").glob("*.py")) + [harness.PKG / "masks.py",
                                                                 harness.PKG / "weights.py"]
    for path in files:
        for mod in _imports(path):
            top = mod.split(".", 1)[0]
            assert top not in harness.FORBIDDEN + ("posterior_matching_torch",), (path, mod)


def test_no_file_of_the_benchmark_imports_jax():
    for path in harness.PKG.rglob("*.py"):
        for mod in _imports(path):
            assert mod.split(".", 1)[0] not in harness.FORBIDDEN, (path, mod)


def test_run_exits_without_a_card(tmp_path):
    """Here (no CUDA device) a run prints no result and exits non-zero."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run([sys.executable, "-m", "pmbench.run", "--workload",
                          "pm_vqvae_celeb_a.train", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], capture_output=True, text=True, cwd=harness.ROOT,
                         timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA device" in out.stderr


def test_run_refuses_an_unknown_workload():
    out = subprocess.run([sys.executable, "-m", "pmbench.run", "--workload", "nope",
                          "--seed", "1", "--seconds", "1"], capture_output=True, text=True,
                         cwd=harness.ROOT, timeout=300)
    assert out.returncode == 2 and out.stdout.strip() == ""


def test_trace_window_busy_idle_and_breakdown():
    from pmbench.profiling import TraceWindow, breakdown

    tw = TraceWindow(2, [("k1", 10, 20), ("k2", 30, 40), ("k1", 45, 50), ("k3", 15, 25)],
                     [("aten::add", 0, 100), ("aten::mm", 26, 29), ("cudaLaunchKernel", 27, 28)],
                     5, 60)
    assert tw.window_s == pytest.approx(55e-6)
    assert tw.busy_s() == pytest.approx(30e-6)          # [10, 25] + [30, 40] + [45, 50]
    assert tw.device_s(("k1",)) == pytest.approx(15e-6)
    out = breakdown(tw)
    assert out["device_ops"][0] == ["k1", pytest.approx(15e-6)]
    # gaps [5, 10], [25, 30], [40, 45], [50, 60]: [25, 30] under aten::mm (the
    # runtime call inside it is skipped), the rest under aten::add
    assert dict(out["idle_gaps"]) == {"aten::add": pytest.approx(20e-6),
                                      "aten::mm": pytest.approx(5e-6)}


def test_breakdown_names_gaps_from_the_named_window():
    """The metrics' window (device activity alone) gives the device ops; the
    second window, which recorded the host's ops too, names the idle gaps."""
    from pmbench.profiling import TraceWindow, breakdown

    tw = TraceWindow(1, [("k1", 10, 20)], [], 0, 30)
    tw.named = TraceWindow(1, [("k1", 40, 50)], [("aten::mm", 30, 45), ("aten::add", 50, 70)],
                           30, 70)
    assert tw.busy_s() == pytest.approx(10e-6) and tw.window_s == pytest.approx(30e-6)
    out = breakdown(tw)
    assert out["device_ops"] == [["k1", pytest.approx(10e-6)]]
    assert dict(out["idle_gaps"]) == {"aten::mm": pytest.approx(10e-6),
                                      "aten::add": pytest.approx(20e-6)}


def test_idle_share_is_of_the_windows_time_a_unit():
    """Busy 30 us a profiled unit against 100 us a step in the untraced
    window: 70% idle, whatever the traced window's own length."""
    from pmbench.profiling import TraceWindow

    cell = harness.find_cell(BENCH, "pm_vqvae_celeb_a.train")
    out = _outcome({})
    out.trace = TraceWindow(2, [("k1", 0, 40), ("k2", 100, 120)], [], 0, 400)
    out.facts.update(steps=10_000, window_s=1.0)
    assert harness.reader("device.idle_pct.train")(cell, out) == pytest.approx(70.0)
    assert harness.reader("device.idle_pct.impute")(cell, out) is None   # no requests
