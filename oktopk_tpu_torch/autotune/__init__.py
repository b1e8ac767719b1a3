"""The autotuner's journal (``journal.py``), which the run journal
builds on. The autotuner itself (calibrate, trial, policy) is not ported
yet (ROADMAP.md)."""
