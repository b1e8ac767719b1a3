#!/usr/bin/env python3
"""The float psum across processes, timed against the all_gather form it
replaced: four gloo ranks on one card (or the CPU), each a
``ProcessGroupComm``.

- ``reduce_scatter``: ``ProcessGroupComm.psum`` (pad to a multiple of P,
  one ``all_to_all_single``, a rank-order sum of the owned chunk, one
  ``all_gather``);
- ``all_gather``: every rank's row gathered, then added in rank order
  (the form before the reduce-scatter).

Both add each element in rank order 0..P-1, so every rank checks them
bit-equal. Each rank times the two in turns (reduce_scatter, all_gather,
all_gather, reduce_scatter; ``--reps`` calls each turn, synchronised,
host clock) at each ``--n`` (default VGG-16's and DeepSpeech's flat
sizes, the dense warmup's psum) and prints one JSON line per rank and
size. Example:

    python3 scripts/psum_ab.py --reps 5
    python3 scripts/psum_ab.py --device cpu --n 4096 --reps 2
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def all_gather_psum(comm, x):
    g = comm.all_gather(x)[0]
    s = g[0].clone()
    for p in range(1, comm.size):
        s = s + g[p]
    return s.unsqueeze(0)


def rank_main(rank, world, store, device, sizes, reps, out):
    import torch
    from oktopk_tpu_torch import launch
    from oktopk_tpu_torch.comm import ProcessGroupComm
    launch.maybe_initialize(
        "gloo", device, env={"OKTOPK_NUM_PROCS": str(world),
                             "OKTOPK_PROC_ID": str(rank)},
        init_method=f"file://{store}", timeout_s=300)
    comm = ProcessGroupComm()
    dev = torch.device(device)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    lines = []
    for n in sizes:
        gen = torch.Generator(device=dev).manual_seed(rank)
        x = torch.randn((1, n), generator=gen, device=dev)
        new, old = comm.psum(x), all_gather_psum(comm, x)
        equal = torch.equal(new.view(torch.int32), old.view(torch.int32))
        times = {"reduce_scatter": [], "all_gather": []}
        for form in ("reduce_scatter", "all_gather", "all_gather",
                     "reduce_scatter"):
            fn = comm.psum if form == "reduce_scatter" else (
                lambda t: all_gather_psum(comm, t))
            for _ in range(reps):
                sync()
                t0 = time.perf_counter()
                fn(x)
                sync()
                times[form].append((time.perf_counter() - t0) * 1e3)
        lines.append({"rank": rank, "world": world, "n": n,
                      "device": str(dev), "bit_equal": equal,
                      **{f"{k}_ms": {"median": statistics.median(v),
                                     "min": min(v), "max": max(v)}
                         for k, v in times.items()}})
    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump(lines, f)
    import torch.distributed as dist
    dist.destroy_process_group()


def main():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--world", type=int, default=4)
    p.add_argument("--device", default="cuda:0")
    p.add_argument("--n", type=int, nargs="+",
                   default=[14728266, 54791168])
    p.add_argument("--reps", type=int, default=5)
    args = p.parse_args()
    import multiprocessing as mp
    import subprocess
    if args.device.startswith("cuda"):
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True).stdout.strip()
        print(json.dumps({"card": smi}), flush=True)
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="psum_ab_") as tmp:
        procs = [ctx.Process(target=rank_main, args=(
            r, args.world, os.path.join(tmp, "store"), args.device, args.n,
            args.reps, tmp)) for r in range(args.world)]
        for q in procs:
            q.start()
        for q in procs:
            q.join(600)
        codes = [q.exitcode for q in procs]
        for q in procs:
            if q.is_alive():
                q.kill()
        if codes != [0] * args.world:
            print(f"psum_ab: rank exit codes {codes}", file=sys.stderr)
            return 1
        for r in range(args.world):
            for line in json.load(open(os.path.join(tmp, f"rank{r}.json"))):
                print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
