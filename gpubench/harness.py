"""One run of one cell.

Set-up builds the program's trainer through its command line's
``build_trainer``, hands it the benchmark's weights (drawn on the device
from the seed in one call, flax's initialisers by leaf), makes the
cell's pool of batches on the device from the seed, and runs the warm
steps through ``Trainer.train_step`` on the pool's first batches: they
are the steps the check compares (step 1 the exact recompute and the
repartition), and they run every shape the window runs. The window is a
closed loop of ``train_step`` over the pool for ``seconds``, with no
synchronise but the one at its end; the step's metric tensors are read
after it. A traced run also records each step's CUDA events
(``trace.StepClock``), then profiles ``trace_steps`` further steady
steps (the exchange reference's ``steady``: no exact threshold, no
repartition) on the device alone, then two more with the host's ops to
name the idle gaps. Then the program is freed and the reference runs
the compared steps again from the same weights and batches.
"""

from __future__ import annotations

import dataclasses
import gc
import hashlib
import math
import time
from typing import Callable, Dict, List, Optional

import torch

from gpubench import flops, judge, peaks, port, trace
from gpubench.reference import optim as ref_optim
from gpubench.reference import train as ref_train


def derive(seed: int, tag: str) -> int:
    """A 63-bit generator seed for one use of the run's seed."""
    h = hashlib.sha256(f"{tag}:{seed}".encode()).digest()
    return int.from_bytes(h[:8], "big") >> 1


def make_weights(table, seed: int, device) -> torch.Tensor:
    """The flat weights in JAX order: one normal draw on the device, then
    each leaf's scale and offset (``("normal", std)``, zeros, ones)."""
    sizes = torch.tensor([math.prod(s) for _, s, _ in table])
    std = torch.tensor([i[1] if i[0] == "normal" else 0.0
                        for _, _, i in table])
    shift = torch.tensor([1.0 if i[0] == "ones" else 0.0
                          for _, _, i in table])
    g = torch.Generator(device=device).manual_seed(derive(seed, "weights"))
    z = torch.randn(int(sizes.sum()), generator=g, device=device)
    sizes = sizes.to(device)
    return (z * torch.repeat_interleave(std.to(device), sizes)
            + torch.repeat_interleave(shift.to(device), sizes))


@dataclasses.dataclass
class ReadContext:
    """What the per-layer readers see (``metrics/__init__.py``)."""
    config: Dict
    workload: Dict
    steps: List[Dict[str, float]]
    trace: Optional[Dict]
    profiled_steps: List[int]
    exchange: object
    samples_per_s: float
    wire_bytes_per_step: float
    flops_per_sample: float
    peak_flops: float


def _step(trainer, batch, clock):
    if clock is not None:
        clock.start()
    m = trainer.train_step(batch)
    if clock is not None:
        clock.end()
    return m


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def build(reg, config: Dict, workload: Dict, seed: int, device,
          tamper: Optional[Callable] = None,
          marks: Optional[List] = None):
    """(trainer, leaf table, pool): the program built, checked against
    the configuration and the reference's layout, given the benchmark's
    weights; ``tamper`` (tests, faults) then breaks it. ``marks`` gets
    (phase, clock) at the end of each phase, after a synchronise."""
    def mark(name):
        if marks is not None:
            _sync(device)
            marks.append((name, time.perf_counter()))

    table = ref_train.family(config["family"]).leaf_table(config["model"])
    settings = ref_train.exchange(workload["compressor"]).program_settings(
        config)
    trainer = port.build_trainer(config, workload, seed, device)
    mark("trainer")
    port.check_config(trainer, config, workload, settings)
    port.check_layout(trainer, table)
    port.load_weights(trainer, make_weights(table, seed, device))
    mark("weights")
    if tamper is not None:
        tamper(trainer)
    traffic = reg.generator(config["generator"])
    pool = traffic.make_pool(config, workload, derive(seed, "traffic"),
                             device)
    mark("pool")
    if len(pool) <= workload["warm_steps"]:
        raise ValueError("the pool must hold more batches than warm steps")
    return trainer, table, pool


def compared_steps(trainer, pool, warm: int, clock=None) -> Dict:
    """Run the warm steps; what the check compares: each step's loss and
    wire bytes (device tensors), the optimizer's state after step 1 and
    the flat parameters after the last (on the host)."""
    out = {"losses": [], "wire_bytes": []}
    for s in range(warm):
        m = _step(trainer, pool[s], clock)
        out["losses"].append(m["loss"])
        out["wire_bytes"].append(m["wire_bytes"])
        if s == 0:
            out["state"] = port.optimizer_state(trainer).cpu()
    out["params"] = port.flat_params(trainer).cpu()
    return out


def reference(config: Dict, workload: Dict, table, pool, seed: int, device,
              precision: str = "float32"):
    """(weights, the reference's compared steps) on the run's weights and
    the pool's first batches."""
    w0 = make_weights(table, seed, device)
    return w0, ref_train.run(config, workload["compressor"],
                             workload["density"], w0,
                             pool[:workload["warm_steps"]], seed, precision)


def compare(config: Dict, table, prog: Dict, w0, ref: Dict,
            diagnose: bool = False) -> Dict:
    """The check's numbers: the program's compared steps (``prog``, from
    ``compared_steps``; or the reference's own, with ``"received"`` in
    place of ``"state"``) against the reference's (``ref``)."""
    dev = w0.device
    mine = {"losses": [float(x) for x in prog["losses"]],
            "wire_bytes": [float(x) for x in prog["wire_bytes"]],
            "params": prog["params"].to(dev)}
    mine["received"] = (prog["received"].to(dev) if "received" in prog
                        else ref_optim.received_gradient(
                            config["training"], prog["state"].to(dev), w0))
    nums = judge.numbers(mine, ref, w0, table)
    if diagnose:
        nums.update(judge.diagnostics(mine, ref, w0, table))
    return nums


def free(device) -> None:
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def run(reg, cell: Dict, seed: int, seconds: float, traced: bool, device,
        t_start: float, tamper: Optional[Callable] = None,
        config: Optional[Dict] = None,
        workload: Optional[Dict] = None) -> Dict:
    """Measure and check one cell; returns the result's fields. ``tamper``
    (tests) breaks the trainer after it is built; ``config`` and
    ``workload`` replace the files of those names."""
    workload = workload or reg.workload(cell["name"])
    config = config or reg.config(cell["config"])
    P = config["data_parallel_workers"]
    rows = P * workload["batch_per_worker"]
    on_card = torch.device(device).type == "cuda"

    marks = [("imports", time.perf_counter())]
    trainer, table, pool = build(reg, config, workload, seed, device, tamper,
                                 marks)
    warm = workload["warm_steps"]
    clock = trace.StepClock(trainer) if traced and on_card else None
    prog = compared_steps(trainer, pool, warm, clock)
    _sync(device)
    marks.append(("warm_steps", time.perf_counter()))
    setup_s = time.perf_counter() - t_start
    edges = [t_start] + [t for _, t in marks]
    setup_phases = {name: b - a for (name, _), a, b in
                    zip(marks, edges, edges[1:])}

    if clock is not None:
        clock.steps.clear()
    window, i = [], warm
    t0 = time.perf_counter()
    while True:
        m = _step(trainer, pool[i % len(pool)], clock)
        window.append((m["loss"], m["wire_bytes"]))
        i += 1
        if time.perf_counter() - t0 >= seconds:
            break
    _sync(device)
    window_s = time.perf_counter() - t0
    steps = len(window)

    n = sum(math.prod(s) for _, s, _ in table)
    ex = ref_train.exchange(workload["compressor"])
    exchange = ex.context(n, P, workload["density"], config)
    splits, summary, profiled = [], None, []
    if traced and on_card:
        splits = clock.splits()
        # the profile holds steady steps only (no exact threshold or
        # repartition, which the window has at their own rate), where
        # the next 256 steps hold as many in a row
        T = workload["trace_steps"]
        start = next((j for j in range(i, i + 256)
                      if all(ex.steady(exchange, s)
                             for s in range(j, j + T))), i)
        for s in range(i, start):
            _step(trainer, pool[s % len(pool)], None)
        i = start
        _sync(device)
        profiled = list(range(i, i + T))

        def more(steps):
            return lambda: [_step(trainer, pool[s % len(pool)], None)
                            for s in steps]

        summary = trace.summarize(trace.profile_steps(more(profiled), False))
        named = list(range(profiled[-1] + 1, profiled[-1] + 3))
        hosted = trace.summarize(trace.profile_steps(more(named), True))
        if summary is not None and hosted is not None:
            summary["idle_gaps"] = hosted["idle_gaps"]
    memory_peak = (torch.cuda.max_memory_allocated(device) if on_card
                   else 0)
    losses = torch.stack([l for l, _ in window]).double().cpu()
    wire = torch.stack([w for _, w in window]).double().cpu()
    prog["losses"] = [float(x) for x in prog["losses"]]
    prog["wire_bytes"] = [float(x) for x in prog["wire_bytes"]]
    del trainer, clock, window, m
    free(device)

    w0, ref = reference(config, workload, table, pool, seed, device)
    nums = compare(config, table, prog, w0, ref)
    failed = int((~torch.isfinite(losses)).sum())
    correct = judge.verdict(nums, workload["limits"]) and failed == 0

    samples_per_s = steps * rows / window_s
    out = {"correct": correct, "attempted": steps, "failed": failed,
           "measured": {"samples_per_s": samples_per_s,
                        "setup_s": setup_s},
           "memory_peak_bytes": int(memory_peak), "window_s": window_s,
           "setup_phases": setup_phases,
           "rows": rows, "checks": {k: (nums[k], workload["limits"][k])
                                    for k in judge.NUMBERS},
           "summary": summary}
    if traced:
        out["context"] = ReadContext(
            config=config, workload=workload, steps=splits, trace=summary,
            profiled_steps=profiled, exchange=exchange,
            samples_per_s=samples_per_s,
            wire_bytes_per_step=float(wire.sum()) / steps,
            flops_per_sample=flops.per_sample(
                config, workload, reg.generator(config["generator"])),
            peak_flops=peaks.FLOPS_PER_S[workload["compute_dtype"]])
    return out
