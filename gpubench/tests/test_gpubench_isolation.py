"""Nothing of the benchmark imports JAX or the JAX package, and the
reference imports nothing of the program: top-level module names are
compared whole (``oktopk_tpu_torch`` is not ``oktopk_tpu``)."""

from __future__ import annotations

import ast
import json
import subprocess
import sys
from pathlib import Path

from gpubench import isolation

HOME = Path(__file__).resolve().parent.parent
ROOT = HOME.parent
PROGRAM = "oktopk_tpu_torch"


def _imports(path: Path):
    """Top-level names of every module ``path`` imports (absolute
    imports; relative ones stay inside the benchmark)."""
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield isolation.top_level(a.name)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield isolation.top_level(node.module)
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", None) == "import_module"
              and node.args and isinstance(node.args[0], ast.JoinedStr)):
            head = node.args[0].values[0]
            if isinstance(head, ast.Constant):
                yield isolation.top_level(head.value)


def test_top_level_names_are_compared_whole():
    assert isolation.forbidden(["oktopk_tpu_torch", "oktopk_tpu_torch.ops"
                                ]) == []
    assert isolation.forbidden(["oktopk_tpu.ops", "jaxlib.xla", "flax",
                                "jax", "numpy"]) == ["flax", "jax", "jaxlib",
                                                     "oktopk_tpu"]


def test_no_source_of_the_benchmark_imports_jax():
    files = sorted(HOME.rglob("*.py"))
    assert files
    for f in files:
        bad = isolation.forbidden(_imports(f))
        assert not bad, f"{f} imports {bad}"


def test_the_reference_imports_nothing_of_the_program():
    files = sorted((HOME / "reference").rglob("*.py"))
    assert len(files) >= 8
    for f in files:
        names = set(_imports(f))
        assert PROGRAM not in names, f
        assert not isolation.forbidden(names), f


def _modules_after(code: str):
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\n"
         "print(json.dumps(sorted(sys.modules)))"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_a_process_of_the_benchmark_holds_no_jax():
    """Every module of the benchmark, the program's command lines and a
    CPU run of a small cell, then no JAX in ``sys.modules``."""
    code = (
        "import torch\n"
        "torch.set_num_threads(2)\n"
        "import gpubench.run, gpubench.readings, gpubench.faults\n"
        "from gpubench import harness\n"
        "from gpubench.registry import Registry\n"
        "from gpubench.tests import tiny\n"
        "import oktopk_tpu_torch.train.main_bert\n"
        "import oktopk_tpu_torch.train.main_trainer\n"
        "reg = Registry()\n"
        "for m in reg.bench['per_layer']:\n"
        "    reg.reader(m['name'])\n"
        "cfg, wl = tiny.cell('bert-base.oktopk.gb256')\n"
        "harness.run(reg, reg.cell('bert-base.oktopk.gb256'), 3, 0.2, True,"
        " 'cpu', 0.0, config=cfg, workload=wl)\n")
    mods = _modules_after(code)
    assert PROGRAM in {isolation.top_level(m) for m in mods}
    assert isolation.forbidden(mods) == []


def test_the_reference_alone_loads_nothing_of_the_program():
    code = ("import gpubench.reference.train, gpubench.reference.bert, "
            "gpubench.reference.vgg, gpubench.judge, gpubench.flops")
    mods = _modules_after(code)
    tops = {isolation.top_level(m) for m in mods}
    assert PROGRAM not in tops
    assert isolation.forbidden(mods) == []
