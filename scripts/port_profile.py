#!/usr/bin/env python3
"""Where the time goes in the PyTorch port's training step on one GPU.

Runs ``oktopk_tpu_torch``'s Trainer at full width with P workers stacked
on the card: VGG-16 (the ``chip_smoke.py`` trainer configuration, by
default); with ``--model bert_base``, BERT-base pretraining as
``main_bert.build_trainer`` builds it (the ``chip_smoke.py`` bert_trainer
configuration: bs 8 per worker, seq 128, d = 0.01, the BERT cadences, no
dense warmup); with ``--model lstman4``, DeepSpeech on AN4 as
``main_trainer.build_trainer`` builds it (the ``chip_smoke.py``
lstman4_trainer configuration: 5 x 800, bs 2 per worker, 201 frames,
d = 0.02, ``--grad-clip 400``, one dense warmup step). It profiles the first sparse step on its own (``kernels``
line with ``"window": "first"``: for BERT the exact recompute and the
repartition), then over ``--steps`` steady-state steps reports, as JSON
lines:

- ``phases``: per step, the device-clock time (CUDA events, synchronised
  per step) of forward/backward + flat-gradient copy, the sparse
  collective, and the optimizer update (SGD, or BertAdam with its flat
  copies); and the host wall clock of the step;
- ``kernels``: ``torch.profiler`` device time by kernel name, per step,
  the top ``--top`` and the port's own two kernels, with the device busy
  share of the profiled window (busy = summed kernel time / wall time);
- ``ab``: the same step with the dense allreduce in place of each
  compressor, so each collective's end-to-end cost reads as a difference.

``--compressors`` names the sparse compressors to profile (comma
separated, default oktopk); each gets its ``phases`` and ``kernels``
lines. ``--cudnn-ab`` instead times the model's oktopk step with cuDNN
deterministic (the Trainer's setting) and not, in turns (on, off, off,
on; ``--steps`` steps each, after the warmup and first sparse step):
the ``cudnn_ab`` line. ``--obs-ab`` times VGG-16's oktopk step with
the quality taps (``TrainConfig.obs`` and ``obs_quality``) and without,
two trainers in turns (taps, none, none, taps; ``--steps`` steps each,
after the warmup and first sparse step), then profiles ``--steps``
steady steps of each: the ``obs_ab`` line and a ``kernels`` line each
(``oktopk+taps``, ``oktopk``). Needs a CUDA device.

``--anatomy`` instead captures one step anatomy with
``obs/anatomy.py::capture_pipeline_anatomy`` (the counterpart of
``scripts/profile_step.py``'s ``--anatomy``): over a
``StackedComm(--anatomy-workers)``, a flat gradient of ``--anatomy-n``
split in ``--anatomy-buckets``, each phase timed under its range,
``step_anatomy`` and ``overlap_report`` journalled to
``--anatomy-journal``, the trace under ``--anatomy-logdir`` (a fresh
temporary directory by default), each ``--phase-limit PHASE=MS``
checked; one ``ANATOMY {...}`` line. On the card unless ``--device
cpu``. Examples:

    python3 scripts/port_profile.py --steps 4 --compressors oktopk,topkA
    python3 scripts/port_profile.py --model bert_base --steps 3
    python3 scripts/port_profile.py --model lstman4 --steps 4
    python3 scripts/port_profile.py --cudnn-ab --steps 6
    python3 scripts/port_profile.py --obs-ab --steps 6
    python3 scripts/port_profile.py --anatomy --anatomy-n 14728266 \
        --anatomy-buckets 2 --anatomy-workers 4
    python3 scripts/port_profile.py --anatomy --device cpu \
        --anatomy-n 262144 --phase-limit select=50
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

OWN_KERNELS = ("fs_sweep", "fs_zero", "cp_prefill", "cp_compact")


def emit(obj):
    print(json.dumps(obj), flush=True)


def build_trainer(args, compressor, obs: bool = False):
    """(trainer, batches, warmup steps) for ``args.model``; ``obs`` turns
    the quality taps on (VGG-16)."""
    import numpy as np
    import torch
    from oktopk_tpu_torch.config import OkTopkConfig, TrainConfig
    from oktopk_tpu_torch.data import synthetic_batch
    from oktopk_tpu_torch.train.trainer import Trainer
    steps = args.steps + 2
    if args.model.startswith("bert"):
        from oktopk_tpu_torch.train import main_bert
        bargs = main_bert.parse_args([
            "--model", args.model, "--num-workers", str(args.workers),
            "--batch-size", str(args.batch // args.workers),
            "--num-minibatches", str(steps), "--compressor", compressor,
            "--density", str(args.density), "--seed", "0"])
        trainer, data = main_bert.build_trainer(bargs)
        return trainer, [next(data) for _ in range(steps)], 0
    if args.model == "lstman4":
        from oktopk_tpu_torch.train import main_trainer
        targs = main_trainer.parse_args([
            "--dnn", "lstman4", "--dataset", "an4", "--num-workers",
            str(args.workers), "--batch-size", str(args.batch // args.workers),
            "--lr", "0.001", "--grad-clip", "400", "--warmup-steps", "1",
            "--compressor", compressor, "--density", str(args.density),
            "--seed", "0", "--max-iters", str(steps)])
        trainer, data, _, _ = main_trainer.build_trainer(targs)
        return trainer, [next(data) for _ in range(steps)], 1
    cfg = TrainConfig(dnn="vgg16", batch_size=args.batch // args.workers,
                      lr=0.1, density=args.density, num_workers=args.workers,
                      compressor=compressor, seed=0, obs=obs,
                      obs_quality=obs)
    algo = OkTopkConfig(warmup_steps=1, local_recompute_every=1,
                        global_recompute_every=args.global_every,
                        threshold_method=args.threshold_method)
    rng = np.random.RandomState(0)
    return (Trainer(cfg, algo_cfg=algo, device=torch.device("cuda")),
            [synthetic_batch("vgg16", args.batch, rng) for _ in range(steps)],
            1)


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

        def update(*a):
            self._mark("optimizer_start")
            out = inner_upd(*a)
            self._mark("optimizer_end")
            return out

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


def profile_window(trainer, batches, args, comp, window):
    """Emit the ``kernels`` line of ``batches`` run under the profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from oktopk_tpu_torch.obs.anatomy import parse_scope_level
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for b in batches:
            trainer.train_step(b)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kern = {}
    for e in prof.key_averages():
        dt = getattr(e, "self_device_time_total", None)
        if dt is None:
            dt = getattr(e, "self_cuda_time_total", 0)
        # the phase ranges' spans on the stream are not kernels
        if (dt and e.device_type == torch.autograd.DeviceType.CUDA
                and parse_scope_level(e.key) is None):
            kern[e.key] = (kern.get(e.key, (0.0, 0))[0] + dt / 1e3,
                           kern.get(e.key, (0.0, 0))[1] + e.count)
    busy = sum(v[0] for v in kern.values())
    top = sorted(kern.items(), key=lambda kv: -kv[1][0])[:args.top]
    own = {k: v for k, v in kern.items()
           if any(o in k for o in OWN_KERNELS)}
    n = len(batches)
    emit({"compressor": comp, "window": window, "steps": n, "kernels": [
        {"name": k[:90], "ms_per_step": v[0] / n, "calls_per_step": v[1] / n,
         "share_of_busy": v[0] / busy if busy else None}
        for k, v in top],
        "own": {k: {"ms_per_step": v[0] / n, "calls_per_step": v[1] / n}
                for k, v in own.items()},
        "distinct_kernels": len(kern),
        "kernel_launches_per_step": sum(v[1] for v in kern.values()) / n,
        "device_busy_ms_per_step": busy / n,
        "wall_ms_per_step": wall / n,
        "device_busy_share": busy / wall if wall else None})


def cudnn_ab(args):
    """The oktopk step with cuDNN deterministic and not, in turns."""
    import torch
    steps = args.steps
    args.steps = 4 * steps + 1
    trainer, batches, warm = build_trainer(args, "oktopk")
    clock = PhaseClock(trainer)
    for b in batches[:warm + 1]:         # warmup and first sparse steps
        clock.run(trainer, b)
    rows = {True: [], False: []}
    rest = batches[warm + 1:]
    for i, det in enumerate((True, False, False, True)):
        torch.backends.cudnn.deterministic = det
        torch.backends.cudnn.benchmark = False
        rows[det] += [clock.run(trainer, b)
                      for b in rest[i * steps:(i + 1) * steps]]
    torch.backends.cudnn.deterministic = True
    emit({"cudnn_ab": {
        "deterministic" if det else "nondeterministic": {
            "per_step": r, "median": {k: statistics.median(x[k] for x in r)
                                      for k in r[0]}}
        for det, r in rows.items()}})


def obs_ab(args):
    """VGG-16's oktopk step with the quality taps and without, in turns;
    then a profiled steady window of each."""
    import torch
    steps = args.steps
    args.steps = 3 * steps      # warmup, first, 2 x steps, steps profiled
    runs = {}
    for taps in (True, False):
        trainer, batches, warm = build_trainer(args, "oktopk", obs=taps)
        clock = PhaseClock(trainer)
        for b in batches[:warm + 1]:     # warmup and first sparse steps
            clock.run(trainer, b)
        runs[taps] = (trainer, clock, iter(batches[warm + 1:]), [])
    for taps in (True, False, False, True):
        trainer, clock, data, rows = runs[taps]
        rows += [clock.run(trainer, next(data)) for _ in range(steps)]
    emit({"obs_ab": {
        "taps" if taps else "no_taps": {
            "per_step": r, "median": {k: statistics.median(x[k] for x in r)
                                      for k in r[0]}}
        for taps, (_, _, _, r) in runs.items()}})
    for taps, (trainer, _, data, _) in runs.items():
        profile_window(trainer, list(data), args,
                       "oktopk+taps" if taps else "oktopk", "steady")
    torch.cuda.empty_cache()


def _parse_phase_limits(specs):
    """``["select=5", ...]`` -> ``{"select": 5.0}``."""
    limits = {}
    for spec in specs or []:
        name, _, val = spec.partition("=")
        if not name or not val:
            raise SystemExit(f"--phase-limit wants PHASE=MS, got {spec!r}")
        limits[name.strip()] = float(val)
    return limits


def anatomy_main(args) -> int:
    """--anatomy: capture one step anatomy over stacked workers, journal
    it and check the phase limits."""
    import tempfile

    from oktopk_tpu_torch.comm import StackedComm
    from oktopk_tpu_torch.config import OkTopkConfig
    from oktopk_tpu_torch.obs.anatomy import (capture_pipeline_anatomy,
                                              phase_totals)
    from oktopk_tpu_torch.obs.journal import EventBus, RunJournal
    from oktopk_tpu_torch.obs.regress import RegressionDetector

    P = args.anatomy_workers
    cfg = OkTopkConfig(n=args.anatomy_n, num_workers=P,
                       density=args.density, warmup_steps=0)
    bus = EventBus()
    RunJournal(args.anatomy_journal, bus)
    logdir = args.anatomy_logdir or tempfile.mkdtemp(
        prefix="oktopk_anatomy_")
    analysis = capture_pipeline_anatomy(
        cfg, StackedComm(P), logdir, num_buckets=args.anatomy_buckets,
        iters=max(2, min(args.steps, 5)), bus=bus, step=0,
        device=args.device)
    out = {"journal": args.anatomy_journal, "logdir": logdir,
           "workers": P, "buckets": args.anatomy_buckets,
           "n": args.anatomy_n, "device": args.device}
    limits = _parse_phase_limits(args.phase_limit)
    if analysis is None:
        out["anatomy_unavailable"] = "profiler capture failed"
    else:
        out.update({k: analysis[k] for k in
                    ("compute_ms", "comm_ms", "overlap_ms",
                     "overlap_ratio", "step_ms", "ideal_ms",
                     "serialization_ms", "critical_phase")})
        out["phase_totals_ms"] = phase_totals(analysis)
        if limits:
            det = RegressionDetector(None, bus=bus, phase_limits=limits)
            breaches = det.observe_phases(0, out["phase_totals_ms"])
            out["phase_breaches"] = [b["key"] for b in breaches]
    print("ANATOMY " + json.dumps(out), flush=True)
    return 0


def main():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--model", default="vgg16",
                   choices=["vgg16", "bert_base", "bert_tiny", "lstman4"])
    p.add_argument("--steps", type=int, default=4)
    p.add_argument("--workers", type=int, default=4)
    p.add_argument("--batch", type=int, default=None,
                   help="global batch (default: 64 for VGG-16, 8 per "
                        "worker for BERT)")
    p.add_argument("--density", type=float, default=None,
                   help="default: 0.02 for VGG-16, 0.01 for BERT")
    p.add_argument("--global-every", type=int, default=4)
    p.add_argument("--threshold-method", default="bisect")
    p.add_argument("--top", type=int, default=15)
    p.add_argument("--compressors", default="oktopk",
                   help="comma-separated sparse compressors to profile")
    p.add_argument("--cudnn-ab", action="store_true",
                   help="time the oktopk step with cuDNN deterministic "
                        "and not, in turns")
    p.add_argument("--obs-ab", action="store_true",
                   help="time VGG-16's oktopk step with the quality taps "
                        "and without, in turns")
    p.add_argument("--anatomy", action="store_true",
                   help="capture, analyse and journal a step anatomy "
                        "(obs/anatomy.py) instead of the step profile")
    p.add_argument("--anatomy-journal", default="anatomy_journal.jsonl",
                   metavar="PATH", help="run-journal JSONL for --anatomy")
    p.add_argument("--anatomy-buckets", type=int, default=4)
    p.add_argument("--anatomy-workers", type=int, default=8,
                   help="stacked workers for --anatomy")
    p.add_argument("--anatomy-n", type=int, default=1 << 18,
                   help="flat gradient length for the --anatomy probes")
    p.add_argument("--anatomy-logdir", default=None,
                   help="profiler trace dir (default: fresh tempdir)")
    p.add_argument("--phase-limit", action="append", default=[],
                   metavar="PHASE=MS",
                   help="journal a regression when a phase-family total "
                        "exceeds MS (repeatable; --anatomy mode)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="--anatomy's device (the step profiles need the "
                        "card)")
    args = p.parse_args()
    bert = args.model.startswith("bert")
    if args.batch is None:
        args.batch = {"lstman4": 2 * args.workers}.get(
            args.model, 8 * args.workers if bert else 64)
    if args.density is None:
        args.density = 0.01 if bert else 0.02
    names = [c for c in args.compressors.split(",") if c]

    # cuBLAS repeats its sums only with this set before the CUDA context
    # exists (as the Trainer's deterministic cuDNN, for the A/B)
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch

    if args.anatomy and args.device == "cpu":
        return anatomy_main(args)
    if not torch.cuda.is_available():
        print("port_profile: needs a CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    emit({"card": smi, "torch": torch.__version__, **vars(args)})
    if args.anatomy:
        return anatomy_main(args)
    if args.cudnn_ab:
        cudnn_ab(args)
        return 0
    if args.obs_ab:
        obs_ab(args)
        return 0

    results = {}
    for comp in names + ["dense"]:
        trainer, batches, warm = build_trainer(args, comp)
        clock = PhaseClock(trainer)
        for b in batches[:warm]:                    # dense warmup steps
            clock.run(trainer, b)
        if comp == "dense":
            clock.run(trainer, batches[warm])
        else:                          # the first sparse step on its own
            profile_window(trainer, batches[warm:warm + 1], args, comp,
                           "first")
        rows = [clock.run(trainer, b) for b in batches[warm + 1:]]
        results[comp] = rows
        summ = {k: statistics.median(r[k] for r in rows) for k in rows[0]}
        emit({"phases": comp, "per_step": rows, "median": summ})
        if comp != "dense":
            profile_window(trainer, batches[warm + 1:], args, comp,
                           "steady")
        del trainer, clock
        torch.cuda.empty_cache()
    wall = {c: statistics.median(r["wall_ms"] for r in rows)
            for c, rows in results.items()}
    emit({"ab": {"dense_wall_ms": wall["dense"],
                 **{c: {"wall_ms": wall[c],
                        "collective_cost_ms": wall[c] - wall["dense"]}
                    for c in names}}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
