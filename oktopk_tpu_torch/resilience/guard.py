"""The in-step anomaly guard: detect, agree, skip, roll back.

Counterpart of ``oktopk_tpu/resilience/guard.py``:

1. **detect** — per bucket, count nonfinite elements of each worker's
   local gradient (NaN/Inf never survive a ``>= threshold`` compare, so a
   poisoned worker would otherwise silently park the NaNs in its
   residual) plus nonfinite-or-absurd elements of the reduced gradient
   (a flipped exponent bit lands near 1e38 — ``abs_limit`` catches it);
2. **agree** — psum the per-bucket counts over the comm, so every worker
   takes the same skip decision;
3. **skip + roll back** — on any trip the optimizer update, the
   BatchNorm statistics, the local momenta and every bucket's compressor
   state (residual, thresholds, drift, boundaries) are restored with
   ``torch.where`` on the device flag: the step is a no-op on training
   state, bit for bit. Only the step counters advance.

The guard is tensor work on the device: no host sync. ``HealthState``
is replicated (one value for every worker, not a [W] row) and keeps a
host mirror of its attempted-step clock, ``host_step``, as
``SparseState`` does: every step advances the clock, skipped or not, so
the host knows it without reading the card, and the fault plans index
time by it.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List

import torch


@dataclasses.dataclass(frozen=True)
class GuardConfig:
    """``abs_limit`` is the sane-gradient magnitude ceiling for the
    reduced vector: values beyond it count as anomalies even while
    finite (wire bit-flips produce ~1e38 without tripping
    ``isfinite``)."""

    abs_limit: float = 1e18

    def __post_init__(self):
        if not self.abs_limit > 0:
            raise ValueError(f"abs_limit must be > 0, got {self.abs_limit}")


HEALTH_FIELDS = ("step", "steps_skipped", "last_anomaly_step",
                 "bucket_trips")


@dataclasses.dataclass
class HealthState:
    """Replicated numeric-health counters (JAX's ``HealthState``).

    ``step`` counts *attempted* steps and is the fault plans' and the
    supervisor's clock; ``bucket_trips`` accumulates per-bucket trips so
    escalation state survives a checkpoint round-trip."""

    step: torch.Tensor               # i32 — attempted steps (monotonic)
    steps_skipped: torch.Tensor      # i32 — cumulative guard skips
    last_anomaly_step: torch.Tensor  # i32 — -1 until the first trip
    bucket_trips: torch.Tensor       # i32[num_buckets] — cumulative trips
    host_step: int = 0               # host mirror of step


def init_health(num_buckets: int = 1, device=None) -> HealthState:
    nb = max(1, int(num_buckets))

    def scalar(v):
        return torch.full((), v, dtype=torch.int32, device=device)

    return HealthState(
        step=scalar(0), steps_skipped=scalar(0),
        last_anomaly_step=scalar(-1),
        bucket_trips=torch.zeros((nb,), dtype=torch.int32, device=device),
        host_step=0)


def local_anomaly_count(flat: torch.Tensor, reduced: torch.Tensor,
                        cfg: GuardConfig) -> torch.Tensor:
    """Each worker's anomaly evidence for one bucket, over the last
    dimension (i32: a scalar for [n] inputs, [W] for [W, n] rows):
    nonfinite local gradient elements + nonfinite-or-absurd reduced
    elements."""
    local_bad = torch.sum(~torch.isfinite(flat), -1)
    wire_bad = torch.sum(~torch.isfinite(reduced)
                         | (torch.abs(reduced) > cfg.abs_limit), -1)
    return (local_bad + wire_bad).to(torch.int32)


def agree(counts: List[torch.Tensor], comm):
    """psum the per-bucket counts ([W] each) -> (global i32[nb] counts,
    0-d bool any-anomaly flag), identical on every worker.

    The counts cross the comm as int32, JAX's type: ``StackedComm``
    adds the rows and ``ProcessGroupComm`` all_reduces integers, exact
    in any order. A float32 sum would not be: a count reaches 2·n_b per
    worker, above float32's exact 2^24 at BERT-base's n."""
    total = comm.psum(torch.stack(counts, 1).to(torch.int32))[0]
    return total, torch.sum(total) > 0


def guarded(any_bad: torch.Tensor, old: Any, new: Any) -> Any:
    """``new`` normally; bit-identical ``old`` on a skip: ``torch.where``
    on every tensor of a tensor, list, tuple, dict or dataclass. A
    leaf that is not a tensor (a host mirror) is ``new``'s."""
    if isinstance(new, torch.Tensor):
        return torch.where(any_bad, old, new)
    if isinstance(new, (list, tuple)):
        return type(new)(guarded(any_bad, o, n) for o, n in zip(old, new))
    if isinstance(new, dict):
        return {k: guarded(any_bad, old[k], v) for k, v in new.items()}
    if dataclasses.is_dataclass(new):
        return dataclasses.replace(new, **{
            f.name: guarded(any_bad, getattr(old, f.name),
                            getattr(new, f.name))
            for f in dataclasses.fields(new)})
    return new


def advance(health: HealthState, any_bad: torch.Tensor,
            bucket_counts: torch.Tensor) -> HealthState:
    """Post-step health bookkeeping (always advances the attempt
    counter, on the device and on the host: a skipped step consumed its
    batch)."""
    bad_i = any_bad.to(torch.int32)
    return HealthState(
        step=health.step + 1,
        steps_skipped=health.steps_skipped + bad_i,
        last_anomaly_step=torch.where(any_bad, health.step,
                                      health.last_anomaly_step),
        bucket_trips=health.bucket_trips
        + (bucket_counts > 0).to(torch.int32),
        host_step=health.host_step + 1)
