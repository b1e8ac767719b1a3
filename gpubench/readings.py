"""The readings the correctness limits are set from, at a cell's own size.

    python -m gpubench.readings --workload <cell>[,<cell>...] \\
        --seeds <n>,<n>,... [--controls 3] [--upper tf32,...] [--out FILE]

For each seed: the program's compared steps (sound) against the
reference, which gives the lower reading of each number. For the first
``--controls`` seeds (3) also the controls and the faults named by
``--upper`` (all), each against the same reference run, which give the
upper readings:
- ``tf32``: the reference itself in the program's place, computed in TF32
  (the nearest precision below the configuration's float32, TF32 off);
- ``bfloat16``: the program with its own lower precision switched on
  (``--compute-dtype bfloat16``);
- ``half_batch``, ``no_exchange``: faults planted in the program
  (``faults.py``); a state left unchanged reads 1 by the measure and is
  not run.
No window is measured: training's readings need none. Needs a CUDA card.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import copy  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

CONTROL_SEEDS = 3
UPPER = ("tf32", "bfloat16", "half_batch", "no_exchange")


def readings(reg, name: str, seed: int, variants, device) -> dict:
    from gpubench import faults, harness

    workload = reg.workload(name)
    config = reg.config(reg.cell(name)["config"])
    progs, pool, table = {}, None, None
    for v in variants:
        if v == "tf32":
            continue
        wl, tamper = workload, None
        if v == "bfloat16":
            wl = copy.deepcopy(workload)
            wl["compute_dtype"] = "bfloat16"
        elif v != "sound":
            tamper = faults.FAULTS[v]
        t = time.perf_counter()
        trainer, table, pool = harness.build(reg, config, wl, seed, device,
                                             tamper)
        prog = harness.compared_steps(trainer, pool, wl["warm_steps"])
        prog["losses"] = [float(x) for x in prog["losses"]]
        prog["wire_bytes"] = [float(x) for x in prog["wire_bytes"]]
        progs[v] = prog
        del trainer
        harness.free(device)
        print(f"  {name} seed {seed} {v}: program "
              f"{time.perf_counter() - t:.1f} s", flush=True)
    t = time.perf_counter()
    w0, ref = harness.reference(config, workload, table, pool, seed, device)
    print(f"  {name} seed {seed}: reference {time.perf_counter() - t:.1f} s",
          flush=True)
    if "tf32" in variants:
        _, low = harness.reference(config, workload, table, pool, seed,
                                   device, "tf32")
        progs["tf32"] = {k: low[k] for k in ("losses", "wire_bytes",
                                              "received", "params")}
    out = {v: harness.compare(config, table, p, w0, ref, diagnose=True)
           for v, p in progs.items()}
    out["losses"] = ref["losses"]
    out["wire_bytes"] = ref["wire_bytes"]
    del w0, ref
    harness.free(device)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--controls", type=int, default=CONTROL_SEEDS)
    p.add_argument("--upper", default=",".join(UPPER))
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    from gpubench.run import set_environment
    set_environment()
    import torch
    from gpubench.registry import Registry

    if not torch.cuda.is_available():
        print("gpubench.readings: no CUDA card", file=sys.stderr)
        return 2
    reg = Registry()
    seeds = [int(s) for s in args.seeds.split(",")]
    upper = [v for v in args.upper.split(",") if v]
    unknown = set(upper) - set(UPPER)
    if unknown:
        p.error(f"--upper: no control or fault {sorted(unknown)}")
    result = {"card": torch.cuda.get_device_name(0), "cells": {}}
    for name in args.workload.split(","):
        rows = {}
        for i, seed in enumerate(seeds):
            variants = ["sound"] + (upper if i < args.controls else [])
            rows[seed] = readings(reg, name, seed, variants, "cuda:0")
            print(json.dumps({"cell": name, "seed": seed,
                              **{v: rows[seed][v] for v in variants}}),
                  flush=True)
        result["cells"][name] = rows
        if args.out:
            Path(args.out).parent.mkdir(parents=True, exist_ok=True)
            Path(args.out).write_text(json.dumps(result, indent=1))
    print(f"readings: {time.perf_counter() - T_START:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
