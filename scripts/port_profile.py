#!/usr/bin/env python3
"""Where the time goes in the PyTorch port's training step on one GPU.

Runs ``oktopk_tpu_torch``'s Trainer at VGG-16 full width with P workers
stacked on the card (the ``chip_smoke.py`` trainer configuration by
default), then over ``--steps`` steady-state steps reports, as JSON lines:

- ``phases``: per step, the device-clock time (CUDA events, synchronised
  per step) of forward/backward + flat-gradient copy, the sparse
  collective, and the SGD update; and the host wall clock of the step;
- ``kernels``: ``torch.profiler`` device time by kernel name, per step,
  the top ``--top`` and the port's own two kernels, with the device busy
  share of the profiled window (busy = summed kernel time / wall time);
- ``ab``: the same step with ``--compressor dense`` in place of oktopk,
  so the collective's end-to-end cost reads as a difference.

Needs a CUDA device. Example:

    python3 scripts/port_profile.py --steps 4
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

OWN_KERNELS = ("fs_sweep", "fs_zero", "cp_count", "cp_scan", "cp_write")


def emit(obj):
    print(json.dumps(obj), flush=True)


def build_trainer(args, compressor):
    import torch
    from oktopk_tpu_torch.config import OkTopkConfig, TrainConfig
    from oktopk_tpu_torch.train.trainer import Trainer
    cfg = TrainConfig(dnn="vgg16", batch_size=args.batch // args.workers,
                      lr=0.1, density=args.density, num_workers=args.workers,
                      compressor=compressor, seed=0)
    algo = OkTopkConfig(warmup_steps=1, local_recompute_every=1,
                        global_recompute_every=args.global_every,
                        threshold_method=args.threshold_method)
    return Trainer(cfg, algo_cfg=algo, device=torch.device("cuda"))


class PhaseClock:
    """CUDA events around the trainer's collective and optimizer calls;
    the rest of the step is forward/backward and the flat-gradient copy."""

    def __init__(self, trainer):
        import torch
        self.torch = torch
        self.marks = []
        inner_step, inner_upd = trainer.grad_step, trainer.optimizer.update

        def step(flat):
            self._mark("collective_start")
            out = inner_step(flat)
            self._mark("collective_end")
            return out

        def update(params, grads):
            self._mark("optimizer_start")
            inner_upd(params, grads)
            self._mark("optimizer_end")

        trainer.grad_step = step
        trainer.optimizer.update = update

    def _mark(self, name):
        ev = self.torch.cuda.Event(enable_timing=True)
        ev.record()
        self.marks.append((name, ev))

    def run(self, trainer, batch):
        self.marks = []
        self._mark("start")
        t0 = time.perf_counter()
        trainer.train_step(batch)
        self._mark("end")
        self.torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        ev = dict(self.marks)
        return {"wall_ms": wall,
                "device_ms": ev["start"].elapsed_time(ev["end"]),
                "fwd_bwd_ms": ev["start"].elapsed_time(
                    ev["collective_start"]),
                "collective_ms": ev["collective_start"].elapsed_time(
                    ev["collective_end"]),
                "optimizer_ms": ev["optimizer_start"].elapsed_time(
                    ev["optimizer_end"])}


def main():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--steps", type=int, default=4)
    p.add_argument("--workers", type=int, default=4)
    p.add_argument("--batch", type=int, default=64, help="global batch")
    p.add_argument("--density", type=float, default=0.02)
    p.add_argument("--global-every", type=int, default=4)
    p.add_argument("--threshold-method", default="bisect")
    p.add_argument("--top", type=int, default=15)
    args = p.parse_args()

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from oktopk_tpu_torch.data import synthetic_batch

    if not torch.cuda.is_available():
        print("port_profile: needs a CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    emit({"card": smi, "torch": torch.__version__, **vars(args)})
    rng = np.random.RandomState(0)
    batches = [synthetic_batch("vgg16", args.batch, rng)
               for _ in range(args.steps + 2)]

    results = {}
    for comp in ("oktopk", "dense"):
        trainer = build_trainer(args, comp)
        clock = PhaseClock(trainer)
        for b in batches[:2]:                 # dense warmup + first sparse
            clock.run(trainer, b)
        rows = [clock.run(trainer, b) for b in batches[2:]]
        results[comp] = rows
        summ = {k: statistics.median(r[k] for r in rows) for k in rows[0]}
        emit({"phases": comp, "per_step": rows, "median": summ})
        if comp != "oktopk":
            continue
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for b in batches[2:]:
                trainer.train_step(b)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        kern = {}
        for e in prof.key_averages():
            dt = getattr(e, "self_device_time_total", None)
            if dt is None:
                dt = getattr(e, "self_cuda_time_total", 0)
            if dt and e.device_type == torch.autograd.DeviceType.CUDA:
                kern[e.key] = (kern.get(e.key, (0.0, 0))[0] + dt / 1e3,
                               kern.get(e.key, (0.0, 0))[1] + e.count)
        busy = sum(v[0] for v in kern.values())
        top = sorted(kern.items(), key=lambda kv: -kv[1][0])[:args.top]
        own = {k: v for k, v in kern.items()
               if any(o in k for o in OWN_KERNELS)}
        emit({"kernels": [
            {"name": k[:90], "ms_per_step": v[0] / args.steps,
             "calls_per_step": v[1] / args.steps,
             "share_of_busy": v[0] / busy if busy else None}
            for k, v in top],
            "own": {k: {"ms_per_step": v[0] / args.steps,
                        "calls_per_step": v[1] / args.steps}
                    for k, v in own.items()},
            "distinct_kernels": len(kern),
            "kernel_launches_per_step": sum(v[1] for v in kern.values())
            / args.steps,
            "device_busy_ms_per_step": busy / args.steps,
            "wall_ms_per_step": wall / args.steps,
            "device_busy_share": busy / wall if wall else None})
    ok = statistics.median(r["wall_ms"] for r in results["oktopk"])
    dn = statistics.median(r["wall_ms"] for r in results["dense"])
    emit({"ab": {"oktopk_wall_ms": ok, "dense_wall_ms": dn,
                 "collective_cost_ms": ok - dn}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
