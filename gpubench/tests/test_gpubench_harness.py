"""The harness is driven by its files: every cell, configuration and
metric loads by name; a new one dropped into a copy of the tree runs with
no other edit; the result line has the shape its readers expect; the
command fails without a card. CPU runs use the cells cut by ``tiny.py``."""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from gpubench import harness, run
from gpubench.registry import Registry
from gpubench.tests import tiny

HOME = Path(__file__).resolve().parent.parent
ROOT = HOME.parent
REG = Registry()


@pytest.fixture(autouse=True)
def _threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def test_every_entry_loads_from_its_file():
    bench = REG.bench
    for c in bench["configs"]:
        cfg = REG.config(c["name"])
        assert cfg["name"] == c["name"]
        assert c["file"] == f"gpubench/configs/{c['name']}.json"
        assert cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"]
        REG.generator(cfg["generator"])
        harness.ref_train.family(cfg["family"])
    for w in bench["workloads"]:
        wl = REG.workload(w["name"])
        assert (wl["name"], wl["config"], wl["traffic"]) == (
            w["name"], w["config"], w["traffic"])
        assert w["name"] == f"{w['config']}.{w['traffic']}"
    for m in bench["per_layer"]:
        assert callable(REG.reader(m["name"]))
    names = {m["name"] for m in bench["end_to_end"]}
    assert names == {"samples_per_s", "setup_s"}
    for w in bench["workloads"]:
        assert REG.per_layer(w["name"]), w["name"]


def _line(name, traced, seed=5, config=None, workload=None, reg=REG):
    cfg, wl = tiny.cell(name)
    res = harness.run(reg, reg.cell(name), seed, 0.2, traced, "cpu", 0.0,
                      config=config or cfg, workload=workload or wl)
    return res, run.result_line(reg, reg.cell(name), res, traced, 1)


def test_the_result_line_has_its_shape(monkeypatch):
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i=0: "card")
    for traced in (False, True):
        res, line = _line("bert-base.oktopk.gb256", traced)
        keys = list(line)
        assert keys[:5] == ["correct", "attempted", "failed", "metrics",
                            "device"]
        assert keys[-1] == "checks"
        assert line["correct"] is True and line["failed"] == 0
        assert line["attempted"] >= 1
        assert set(line["device"]) >= {"platform", "kind", "count",
                                       "memory_peak_bytes"}
        for m in line["metrics"].values():
            assert set(m) == {"value", "unit"}
            assert isinstance(m["value"], float) and m["value"] > 0
        for k, v in line["checks"].items():
            assert set(v) == {"value", "limit"}
        if not traced:
            assert set(line["metrics"]) == {"samples_per_s", "setup_s"}
        else:
            # no card: only the counters and the FLOPs have a reading
            assert set(line["metrics"]) == {"wire_bytes_per_step",
                                            "mfu_pct"}
        json.dumps(line)


def _copy_tree(tmp_path: Path) -> Path:
    dst = tmp_path / "checkout"
    shutil.copytree(HOME, dst / "gpubench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    shutil.copy(ROOT / "BENCHMARK.json", dst / "BENCHMARK.json")
    return dst


def test_a_new_cell_configuration_and_metric_are_files_alone(tmp_path):
    """Into a copy of the tree: a configuration (BERT at the program's
    bert_tiny widths), a cell on it and a per-layer metric, each a new
    file and an entry in BENCHMARK.json. A process started in the copy
    runs the cell and reads the metric."""
    dst = _copy_tree(tmp_path)
    home = dst / "gpubench"
    cfg, wl = tiny.cell("bert-base.oktopk.gb256")
    cfg["name"] = "bert-tiny"
    wl.update(name="bert-tiny.oktopk.gb8", config="bert-tiny",
              traffic="oktopk.gb8")
    (home / "configs" / "bert-tiny.json").write_text(json.dumps(cfg))
    (home / "workloads" / "bert-tiny.oktopk.gb8.json").write_text(
        json.dumps(wl))
    (home / "metrics" / "steps_read.py").write_text(
        "def read(ctx):\n    return 1.0 + ctx.wire_bytes_per_step\n")
    bench = json.loads((dst / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "bert-tiny", "source": cfg["source"],
                             "file": "gpubench/configs/bert-tiny.json",
                             "reduced": cfg["reduced"], "why": "a test"})
    bench["workloads"].append({"name": "bert-tiny.oktopk.gb8",
                               "config": "bert-tiny",
                               "traffic": "oktopk.gb8", "chips": 1,
                               "why": "a test"})
    bench["per_layer"].append({"name": "steps_read", "unit": "bytes",
                               "better": "lower", "source": "program_counter",
                               "layer": "test", "moves": "samples_per_s",
                               "workloads": ["bert-tiny.oktopk.gb8"]})
    (dst / "BENCHMARK.json").write_text(json.dumps(bench))
    code = (
        "import json, torch\n"
        "torch.set_num_threads(2)\n"
        "from unittest import mock\n"
        "from gpubench import harness, run\n"
        "from gpubench.registry import Registry\n"
        "reg = Registry()\n"
        "cell = reg.cell('bert-tiny.oktopk.gb8')\n"
        "res = harness.run(reg, cell, 11, 0.2, True, 'cpu', 0.0)\n"
        "with mock.patch('torch.cuda.get_device_name', lambda i=0: 'c'):\n"
        "    print(json.dumps(run.result_line(reg, cell, res, True, 1)))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=dst,
                         env={"PYTHONPATH": f"{dst}:{ROOT}",
                              "PATH": "/usr/bin:/bin"},
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True
    assert line["metrics"]["steps_read"]["value"] > 1.0
    import gpubench
    assert Path(gpubench.__file__).parent == HOME   # this process's tree


def test_a_new_exchange_is_a_file_alone(tmp_path):
    """Into a copy of the tree: ``reference/exchange_mean.py``, the dense
    mean under another name. A cell whose compressor is ``mean`` finds it
    by name, through the same calls the harness makes, and trains as
    ``dense`` does."""
    dst = _copy_tree(tmp_path)
    ref = dst / "gpubench" / "reference"
    (ref / "exchange_mean.py").write_text(
        (ref / "exchange_dense.py").read_text())
    code = (
        "import json, torch\n"
        "torch.set_num_threads(2)\n"
        "from gpubench import harness\n"
        "from gpubench.registry import Registry\n"
        "from gpubench.tests import tiny\n"
        "reg = Registry()\n"
        "cfg, wl = tiny.cell('bert-base.dense.gb256')\n"
        "table = harness.ref_train.family('bert').leaf_table(cfg['model'])\n"
        "pool = reg.generator(cfg['generator']).make_pool(cfg, wl, 7, 'cpu')\n"
        "out = {}\n"
        "for name in ('dense', 'mean'):\n"
        "    wl['compressor'] = name\n"
        "    ex = harness.ref_train.exchange(name)\n"
        "    assert ex.program_settings(cfg) == {}\n"
        "    _, r = harness.reference(cfg, wl, table, pool, 7, 'cpu')\n"
        "    out[name] = r['losses'] + r['wire_bytes']\n"
        "print(json.dumps(out))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=dst,
                         env={"PYTHONPATH": f"{dst}:{ROOT}",
                              "PATH": "/usr/bin:/bin"},
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["mean"] == got["dense"]
    with pytest.raises(ValueError, match="no reference exchange"):
        harness.ref_train.exchange("mean")       # not in this tree


def test_the_command_fails_without_a_card():
    out = subprocess.run(
        [sys.executable, "-m", "gpubench.run", "--workload",
         "vgg16-cifar10.dense.gb2048", "--seed", "2147483711", "--seconds",
         "1", "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=300, env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin",
                          "PYTHONPATH": str(ROOT)})
    assert out.returncode != 0
    assert "{" not in out.stdout
    assert "CUDA" in out.stderr


def test_the_command_fails_without_the_program(tmp_path):
    """A checkout with only BENCHMARK.json and gpubench/: no result."""
    dst = _copy_tree(tmp_path)
    out = subprocess.run(
        [sys.executable, "-m", "gpubench.run", "--workload",
         "vgg16-cifar10.dense.gb2048", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=dst, capture_output=True, text=True,
        timeout=300, env={"PATH": "/usr/bin:/bin", "PYTHONPATH": str(dst)})
    assert out.returncode != 0
    assert "{" not in out.stdout


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda:0")


@pytest.mark.cuda
def test_a_cell_runs_on_the_card(cuda_device):
    out = subprocess.run(
        [sys.executable, "-m", "gpubench.run", "--workload",
         "vgg16-cifar10.dense.gb2048", "--seed", "2147483712", "--seconds",
         "2", "--trace", "1"], cwd=ROOT, capture_output=True, text=True,
        timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True
    assert line["device"]["busy_s"] > 0
    assert {"fwd_bwd_ms", "device_idle_pct", "mfu_pct"} <= set(
        line["metrics"])
