"""The port's observability layer: the typed run journal, the
signal-fidelity taps, wire-byte budgets, rollups, export and regression
detection.

Counterpart of ``oktopk_tpu/obs/__init__.py``, and import-free as it
is: ``autotune/journal.py`` imports ``obs.events`` (for the schema
version) while ``obs.journal`` imports ``autotune/journal.py`` (for the
environment header and JSONL reader), so importing either submodule
here would close that loop into a cycle. Callers import the submodules
directly:

  - :mod:`oktopk_tpu_torch.obs.events`  — schema-versioned event
    definitions + validation (no imports of the package at all);
  - :mod:`oktopk_tpu_torch.obs.journal` — :class:`EventBus` and
    :class:`RunJournal` (the single per-run JSONL sink);
  - :mod:`oktopk_tpu_torch.obs.volume`  — per-algorithm analytic
    wire-byte budgets and conformance ratios;
  - :mod:`oktopk_tpu_torch.obs.regress` — step-time regression
    detection, quality-summary and phase-limit watching, baseline-gap
    warnings;
  - :mod:`oktopk_tpu_torch.obs.quality` — the step's signal-fidelity
    taps (compression error, residual growth, effective density,
    threshold drift, winner-index churn);
  - :mod:`oktopk_tpu_torch.obs.metrics_buffer` — the device-side ring
    the taps push into (drained by the host on its own cadence);
  - :mod:`oktopk_tpu_torch.obs.rollup` — windowed rollups of flushed
    quality events with breach detection;
  - :mod:`oktopk_tpu_torch.obs.export` — Prometheus-textfile export of
    the latest rollups.

Not ported yet (ROADMAP.md): ``anatomy.py`` and ``tracing.py``.
"""
