"""Per-layer metric readers, one file each, found by the metric's name.

Each file defines ``read(ctx)`` and returns a number, or None where it
finds nothing to read (the harness then leaves the metric out of the
line). ``ctx`` (``harness.ReadContext``) carries what the traced run
measured: ``steps`` (each window step's CUDA-event split: ``fwd_bwd_ms``,
``collective_ms``, ``optimizer_ms``, ``step_ms``), ``trace`` (the
profiler summary of ``trace.summarize``, or None), ``profiled_steps``
(the exchange's step counters in the profiled window), ``exchange``
(the exchange reference's ``context``: a ``SparseConfig`` for oktopk,
None for dense), ``samples_per_s``
(the traced run's window), ``wire_bytes_per_step`` (the program's
counter over the window), ``flops_per_sample``, ``peak_flops`` and
``config`` / ``workload``.
"""
