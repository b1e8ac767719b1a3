"""Stand-alone micro-benchmarks of the port (``collectives``: one sparse
allreduce, timed step by step)."""
