"""Run one cell of the benchmark and print its result.

    python -m gpubench.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

The cell is an entry of ``BENCHMARK.json`` at the checkout's root. The
run needs as many CUDA cards as the cell asks for, and fails without
them. Earlier lines of standard output name the card, its power limit,
the peak memory and the window's steps; the last line is one JSON object
with ``correct``, ``attempted``, ``failed``, ``metrics``, ``device``,
with ``--trace 1`` ``breakdown``, and last ``checks``: each number the
correctness check compared, with its limit. The same numbers are the
last lines of standard error.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def set_environment() -> None:
    """Before torch starts CUDA: cuBLAS repeats only with a workspace
    configured before the context exists, as the program's command lines
    set it; kernel caches stay at fixed paths inside the checkout."""
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "gpubench" / ".cache"
                                         / "triton")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"not read ({e})"
    return out.stdout.strip().splitlines()[0] if out.stdout else "not read"


def result_line(reg, cell, res, traced: bool, chips: int) -> dict:
    import torch

    name = cell["name"]
    metrics = {}
    if traced:
        for m in reg.per_layer(name):
            value = reg.reader(m["name"])(res["context"])
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in reg.end_to_end(name):
            metrics[m["name"]] = {"value": res["measured"][m["name"]],
                                  "unit": m["unit"]}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": chips, "memory_peak_bytes": res["memory_peak_bytes"]}
    line = {"correct": res["correct"], "attempted": res["attempted"],
            "failed": res["failed"], "metrics": metrics, "device": device}
    summary = res["summary"]
    if traced and summary is not None:
        device["busy_s"] = summary["busy_s"]
        device["window_s"] = summary["window_s"]
        line["breakdown"] = {"device_ops": summary["device_ops"],
                             "idle_gaps": summary["idle_gaps"]}
    line["checks"] = {k: {"value": v, "limit": lim}
                      for k, (v, lim) in res["checks"].items()}
    return line


def main(argv=None) -> int:
    args = parse_args(argv)
    set_environment()
    import torch
    from gpubench import harness, isolation
    from gpubench.registry import Registry

    reg = Registry()
    cell = reg.cell(args.workload)
    chips = int(cell["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"gpubench: cell {cell['name']} needs {chips} CUDA card(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    traced = bool(args.trace)
    res = harness.run(reg, cell, args.seed, args.seconds, traced, "cuda:0",
                      T_START)
    line = result_line(reg, cell, res, traced, chips)
    found = isolation.forbidden(sys.modules)
    if found:
        print(f"gpubench: the process holds {found}", file=sys.stderr)
        return 3
    print(f"card: {power_limit()}")
    print(f"memory_peak_bytes: {res['memory_peak_bytes']}")
    print("setup phases: " + ", ".join(
        f"{k} {v:.3f} s" for k, v in res["setup_phases"].items()))
    print(f"window: {res['attempted']} steps of {res['rows']} samples in "
          f"{res['window_s']:.6f} s")
    if traced and res["summary"] is not None:
        print(f"traced window: {len(res['context'].profiled_steps)} steps "
              f"in {res['summary']['window_s']:.6f} s")
    print(json.dumps(line))
    sys.stdout.flush()
    for k, (v, lim) in res["checks"].items():
        print(f"check {k} {v!r} limit {lim!r}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
