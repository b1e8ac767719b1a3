"""Deterministic, step-indexed fault injection.

Counterpart of ``oktopk_tpu/resilience/faults.py``. ``FaultSpec``,
``FaultPlan``, ``FAULT_KINDS``, ``dead_workers``, ``latency_ms``,
``with_latency``, ``degraded_fake_ms`` and ``corrupt_checkpoint`` are
copies (the same validation, the same bytes). The two seams that touch
tensors act on the comm's stacked worker rows:

- ``inject_grad_faults(plan, flat, step, first_worker, bucket)`` poisons
  the [W, n_b] bucket gradient, row w being worker ``first_worker + w``
  (JAX's shard w). ``step`` is the health clock's host mirror
  (``HealthState.host_step``), so which faults fire is decided on the
  host: an inactive plan adds no device work, and an active one no
  device sync.
- ``make_wire_hook(plan, comm)`` builds the hook that
  ``collectives/wire.py::install_wire_fault`` installs: it corrupts the
  value buffer [W, ...] on the planned sender rows only, at the bucket's
  host step (``SparseState.host_step``, which the algorithms pass).

``count`` corrupts the leading ``count`` elements of each targeted row
(-1: the whole row), as JAX's leading mask does on a shard's buffer.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional, Tuple

import torch

FAULT_KINDS = ("nan_grad", "inf_grad", "scale_grad", "wire_bitflip",
               "wire_zero", "latency", "chip_loss",
               "ckpt_truncate", "ckpt_bitflip", "ckpt_torn")


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One fault: ``kind`` active on attempted-step indices
    ``[step, step + duration)``.

    ``worker``/``bucket`` select a single worker / gradient bucket (-1 =
    all). ``count`` bounds the corruption to the leading elements of the
    target buffer (-1 = the whole buffer). ``latency_ms`` applies to
    ``kind == "latency"`` only; ``bit_mask`` overrides the XOR pattern of
    ``wire_bitflip`` (0 = flip the top exponent bit of the wire dtype);
    ``scale`` is the multiplier of ``scale_grad``. ``chip_loss`` is
    permanent (``duration`` ignored) and must name a concrete ``worker``.
    """

    kind: str
    step: int
    duration: int = 1
    worker: int = -1
    bucket: int = -1
    count: int = -1
    latency_ms: float = 0.0
    bit_mask: int = 0
    scale: float = 1.0

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(
                f"unknown fault kind {self.kind!r}; one of {FAULT_KINDS}")
        if self.duration < 1:
            raise ValueError(f"duration must be >= 1, got {self.duration}")
        if self.step < 0:
            raise ValueError(f"step must be >= 0, got {self.step}")
        if self.kind == "chip_loss" and self.worker < 0:
            raise ValueError("chip_loss must name a concrete worker (>= 0)")


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """A deterministic schedule of faults (hashable)."""

    faults: Tuple[FaultSpec, ...] = ()

    def __post_init__(self):
        # accept any iterable of specs but store a hashable tuple
        object.__setattr__(self, "faults", tuple(self.faults))

    def of_kind(self, *kinds: str) -> Tuple[FaultSpec, ...]:
        return tuple(f for f in self.faults if f.kind in kinds)

    @property
    def grad_faults(self) -> Tuple[FaultSpec, ...]:
        return self.of_kind("nan_grad", "inf_grad", "scale_grad")

    @property
    def chip_faults(self) -> Tuple[FaultSpec, ...]:
        return self.of_kind("chip_loss")

    @property
    def wire_faults(self) -> Tuple[FaultSpec, ...]:
        return self.of_kind("wire_bitflip", "wire_zero")

    @property
    def latency_faults(self) -> Tuple[FaultSpec, ...]:
        return self.of_kind("latency")

    @property
    def ckpt_faults(self) -> Tuple[FaultSpec, ...]:
        return self.of_kind("ckpt_truncate", "ckpt_bitflip", "ckpt_torn")


def _target_rows(spec: FaultSpec, step: int, first_worker: int,
                 W: int) -> List[int]:
    """The local rows of [W, ...] that ``spec`` hits at host ``step``
    (JAX's per-shard activity flag, evaluated for every row at once)."""
    if not spec.step <= step < spec.step + spec.duration:
        return []
    if spec.worker < 0:
        return list(range(W))
    w = spec.worker - first_worker
    return [w] if 0 <= w < W else []


def _corrupt_rows(x: torch.Tensor, rows: List[int], count: int,
                  corrupt: Callable[[torch.Tensor], torch.Tensor]
                  ) -> torch.Tensor:
    """``x`` with the leading ``count`` elements (all for count < 0) of
    each row in ``rows`` replaced by ``corrupt`` of them; a copy, the
    caller's buffer untouched."""
    W = x.shape[0]
    out = x.clone(memory_format=torch.contiguous_format)
    flat = out.view(W, -1)
    m = flat.shape[1] if count < 0 else min(count, flat.shape[1])
    idx = torch.tensor(rows, dtype=torch.long, device=x.device)
    seg = flat[idx, :m]
    flat[idx, :m] = corrupt(seg)
    return out


def inject_grad_faults(plan: FaultPlan, flat: torch.Tensor, step: int,
                       first_worker: int, bucket: int) -> torch.Tensor:
    """Poison the [W, n_b] gradient of ``bucket`` per the plan: row w is
    worker ``first_worker + w``, ``step`` the host mirror of the
    attempted-step clock. Returns ``flat`` itself when no fault fires."""
    for f in plan.grad_faults:
        if f.bucket >= 0 and f.bucket != bucket:
            continue
        rows = _target_rows(f, step, first_worker, flat.shape[0])
        if not rows:
            continue
        if f.kind == "scale_grad":
            # multiplicative blow-up: finite, structure-preserving — the
            # near-abs_limit regime the density backoff drills target
            scale = torch.tensor(f.scale, dtype=flat.dtype,
                                 device=flat.device)
            flat = _corrupt_rows(flat, rows, f.count, lambda s: s * scale)
        else:
            bad = float("inf") if f.kind == "inf_grad" else float("nan")
            flat = _corrupt_rows(flat, rows, f.count,
                                 lambda s: torch.full_like(s, bad))
    return flat


def dead_workers(plan: FaultPlan, step: int) -> Tuple[int, ...]:
    """Ranks whose chip has died at or before host step ``step``.

    Chip loss is permanent — ``duration`` is ignored — so this is the
    cumulative set, sorted. Host-side by design: a dead chip is an
    orchestrator-level observation, never a device value.
    """
    return tuple(sorted({f.worker for f in plan.chip_faults
                         if f.step <= step}))


# float dtype -> (the integer view of the same width, the default mask:
# the top exponent bit)
_BIT_VIEWS = {torch.bfloat16: (torch.int16, 1 << 14),
              torch.float16: (torch.int16, 1 << 14),
              torch.float32: (torch.int32, 1 << 30),
              torch.float64: (torch.int64, 1 << 62)}


def _bitflip(x: torch.Tensor, mask: int) -> torch.Tensor:
    """XOR the float bits of ``x`` (0 = flip the top exponent bit),
    through a signed integer view of the same width: the bits of JAX's
    unsigned ``lax.bitcast_convert_type`` form."""
    itype, default = _BIT_VIEWS[x.dtype]
    bits = torch.iinfo(itype).bits
    m = (mask or default) & ((1 << bits) - 1)
    if m >= 1 << (bits - 1):        # the same bits, as a signed value
        m -= 1 << bits
    return torch.bitwise_xor(x.view(itype), m).view(x.dtype)


def make_wire_hook(plan: FaultPlan, comm
                   ) -> Callable[[torch.Tensor, object, object],
                                 torch.Tensor]:
    """The hook ``collectives/wire.py`` applies to every value buffer
    [W, ...] as it crosses an exchange (install with
    ``wire.install_wire_fault``).

    It corrupts the payload on the chosen SENDER rows only (row w is
    worker ``comm.first_worker + w``) — fabric corruption of that
    worker's outgoing messages — and targets one bucket via
    ``cfg.bucket_index``. ``step`` is the bucket's host step counter;
    a call site that cannot supply one (step=None) is left untouched.
    """

    def hook(x, cfg, step):
        if step is None or not plan.wire_faults:
            return x
        for f in plan.wire_faults:
            if f.bucket >= 0 and f.bucket != getattr(cfg, "bucket_index", 0):
                continue
            rows = _target_rows(f, int(step), comm.first_worker, x.shape[0])
            if not rows:
                continue
            if f.kind == "wire_zero":
                x = _corrupt_rows(x, rows, f.count, torch.zeros_like)
            else:
                x = _corrupt_rows(x, rows, f.count,
                                  lambda s, m=f.bit_mask: _bitflip(s, m))
        return x

    return hook


def latency_ms(plan: FaultPlan, step: int, bucket: int = 0) -> float:
    """Total injected collective latency (ms) active at host step ``step``
    for ``bucket`` — the degraded-fabric model for timing paths."""
    return float(sum(
        f.latency_ms for f in plan.latency_faults
        if f.step <= step < f.step + f.duration
        and (f.bucket < 0 or f.bucket == bucket)))


def with_latency(step_fn, plan: FaultPlan, bucket: int = 0,
                 sleep=time.sleep, start_step: int = 0):
    """Wrap a step with the plan's latency inflation: each call sleeps
    ``latency_ms`` for its (host-side) step index before dispatching.

    ``start_step`` seeds the internal counter so the plan's step indices
    line up with the run's attempted-step clock after a checkpoint
    restore or an elastic re-mesh. The wrapped fn exposes
    ``wrapped.seek(step)`` to re-seed in place (e.g. after a mid-run
    restore)."""
    counter = {"step": int(start_step)}

    def wrapped(*args, **kwargs):
        ms = latency_ms(plan, counter["step"], bucket)
        counter["step"] += 1
        if ms > 0:
            sleep(ms / 1e3)
        return step_fn(*args, **kwargs)

    def seek(step: int) -> None:
        counter["step"] = int(step)

    wrapped.seek = seek
    return wrapped


def degraded_fake_ms(base: Callable[[str, int, float], float],
                     plan: FaultPlan, bucket_of_n: Optional[dict] = None,
                     step: int = 0) -> Callable[[str, int, float], float]:
    """Inflate an autotune ``fake_ms`` injector by the plan's latency:
    models what the trial phase measures on a degraded fabric.
    ``bucket_of_n`` maps bucket flat sizes to bucket ids (the trial
    signature carries n, not the bucket index)."""

    def fake(algo: str, n: int, density: float) -> float:
        b = (bucket_of_n or {}).get(int(n), 0)
        return float(base(algo, n, density)) + latency_ms(plan, step, b)

    return fake


def corrupt_checkpoint(path: str, kind: str, bit_mask: int = 0x40,
                       offset: int = -1) -> None:
    """Deterministically damage a checkpoint file at rest (host-side;
    the drill seam for the ``ckpt_*`` fault kinds).

    - ``ckpt_truncate``: the file becomes its leading half — a crashed
      writer or lost tail; caught by the manifest size check.
    - ``ckpt_bitflip``: one byte (middle of the file, or ``offset``) is
      XORed with ``bit_mask`` — at-rest bit rot. The size is preserved,
      so only the digest catches it.
    - ``ckpt_torn``: a non-atomic writer died mid-publish — the final
      file holds a prefix AND a stale ``<path>.tmp`` remnant is left
      behind.

    The sidecar manifest is left intact on purpose: the corruption is in
    the data, and the manifest is what convicts it.
    """
    if kind not in ("ckpt_truncate", "ckpt_bitflip", "ckpt_torn"):
        raise ValueError(f"not a checkpoint fault kind: {kind!r}")
    with open(path, "rb") as f:
        data = f.read()
    if len(data) < 2:
        raise ValueError(f"checkpoint {path} too small to corrupt")
    if kind == "ckpt_truncate":
        with open(path, "wb") as f:
            f.write(data[: len(data) // 2])
    elif kind == "ckpt_bitflip":
        buf = bytearray(data)
        i = offset if 0 <= offset < len(buf) else len(buf) // 2
        buf[i] ^= (bit_mask & 0xFF) or 0x40
        with open(path, "wb") as f:
            f.write(bytes(buf))
    else:  # ckpt_torn
        with open(path, "wb") as f:
            f.write(data[: max(1, 2 * len(data) // 3)])
        with open(path + ".tmp", "wb") as f:
            f.write(data[: max(1, len(data) // 3)])
