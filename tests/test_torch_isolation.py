"""The port stands alone: neither ``oktopk_tpu_torch/`` (its launch
layer, process-group comm, resilience layer, autotuner, settings,
micro-benchmarks, pipeline, ring attention and the sequence- and
tensor-parallel BERT included) nor
``chip_smoke.py`` (nor the port's profiling, A/B and drill scripts,
``psum_ab.py``, ``bf16_card_yardstick.py`` and ``port_chaos_drill.py``
among them, nor the worker module that the process-group tests spawn)
imports ``jax``, ``flax``, ``optax``, ``msgpack`` or ``oktopk_tpu``, and
importing every module of the package leaves ``jax`` out of
``sys.modules``."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "oktopk_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "msgpack", "oktopk_tpu")


def _sources():
    files = sorted(PKG.rglob("*.py")) + [
        ROOT / "chip_smoke.py", ROOT / "scripts" / "port_profile.py",
        ROOT / "scripts" / "compaction_ab.py",
        ROOT / "scripts" / "psum_ab.py",
        ROOT / "scripts" / "bf16_card_yardstick.py",
        ROOT / "scripts" / "port_chaos_drill.py",
        ROOT / "tests" / "torch_dist_child.py"]
    assert len(files) > 20
    for mod in ("launch.py", "comm/process_group.py", "comm/fabric.py",
                "collectives/hierarchical.py", "obs/metrics_buffer.py",
                "obs/quality.py", "obs/volume.py", "ops/prng.py",
                "data/loaders.py", "models/resnet.py",
                "models/imagenet_resnet.py", "models/preresnet.py",
                "models/resnext.py", "models/densenet.py",
                "models/alexnet.py", "models/caffe_cifar.py",
                "models/mnistnet.py", "data/tokenization.py",
                "data/bert_pretrain.py", "data/audio.py",
                "native/__init__.py", "native/tokenizer.py",
                "native/loader.py", "utils/decoder.py", "train/msgpack.py",
                "train/durable.py", "train/checkpoint.py",
                "train/preemption.py", "train/evaluate.py",
                "train/glue.py", "obs/events.py", "obs/journal.py",
                "obs/anatomy.py", "obs/tracing.py",
                "obs/rollup.py", "obs/export.py", "obs/regress.py",
                "autotune/journal.py", "utils/logging.py",
                "utils/profiling.py", "resilience/__init__.py",
                "resilience/faults.py", "resilience/guard.py",
                "resilience/journal.py", "resilience/supervisor.py",
                "resilience/density.py", "resilience/drills.py",
                "resilience/feedback.py", "autotune/__init__.py",
                "autotune/calibrate.py", "autotune/trial.py",
                "autotune/policy.py", "utils/cost_model.py",
                "utils/flops.py", "settings.py", "benchmarks/__init__.py",
                "benchmarks/collectives.py", "parallel/__init__.py",
                "parallel/pipeline.py", "parallel/bert_pipeline.py",
                "models/bert_staged.py", "optim/stashing.py",
                "utils/flatten.py", "parallel/grid.py",
                "parallel/transposes.py", "parallel/ring_attention.py",
                "parallel/bert_seq.py", "parallel/bert_tp.py",
                "optim/flat.py", "parallel/bert_moe.py"):
        assert PKG / mod in files
    return files


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "id", None) == "__import__"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value)


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    for name in _imported_roots(path):
        root = name.split(".")[0]
        assert root not in FORBIDDEN, f"{path.name} imports {name}"


def test_importing_the_package_loads_no_jax():
    mods = sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts)
        .replace(".__init__", "") for p in PKG.rglob("*.py"))
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r}]\n"
            "print('LOADED', bad)\n"
            "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stdout + r.stderr
