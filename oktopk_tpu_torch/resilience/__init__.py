"""Fault injection, the in-step anomaly guard, and supervised
dense-fallback.

Counterpart of ``oktopk_tpu/resilience/__init__.py``. Ok-Topk's error-feedback residuals make sparse training
*stateful*: one NaN/Inf gradient or corrupted wire payload poisons every
later step through the residual, and the reference only *warns* on NaN
gradient sparsity (VGG/dl_trainer.py:608-609). The layers:

1. ``faults``     — a deterministic, step-indexed :class:`FaultPlan`
   with injection seams for NaN/Inf/scaled gradients (on the stacked
   [W, n_b] bucket gradient), corrupted wire payloads (the
   ``collectives/wire.py`` seam), latency, chip loss and damaged
   checkpoint files;
2. ``guard``      — the in-step guard: per-bucket anomaly counts psum'd
   so every worker agrees, then the whole step rolled back with
   ``torch.where`` on the device flag (no host sync);
3. ``supervisor`` — host-side escalation: strikes, per-bucket dense
   fallback, restore from the last good checkpoint, remesh on chip loss;
4. ``journal``    — the JSONL health log;
5. ``density``    — :class:`DensityBackoff`, the guard-aware density
   controller;
6. ``feedback``   — :class:`AutotuneFeedback`, the fault→autotune loop:
   a sustained stream of regressions or guard trips forces a
   re-calibrate and re-tune;
7. ``drills``     — the chaos-drill catalog behind
   ``scripts/port_chaos_drill.py`` (imported on its own: it builds
   Trainers).
"""

from oktopk_tpu_torch.resilience.density import DensityBackoff  # noqa: F401
from oktopk_tpu_torch.resilience.faults import (  # noqa: F401
    FaultPlan,
    FaultSpec,
    dead_workers,
    inject_grad_faults,
    latency_ms,
    make_wire_hook,
    with_latency,
)
from oktopk_tpu_torch.resilience.feedback import (  # noqa: F401
    AutotuneFeedback,
)
from oktopk_tpu_torch.resilience.guard import (  # noqa: F401
    GuardConfig,
    HealthState,
    init_health,
)
from oktopk_tpu_torch.resilience.journal import HealthJournal  # noqa: F401
from oktopk_tpu_torch.resilience.supervisor import (  # noqa: F401
    Action,
    Supervisor,
)
