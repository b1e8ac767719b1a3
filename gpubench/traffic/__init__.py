"""Traffic generators: one module per kind of batch, named by a
configuration's ``generator``. Each exposes ``make_pool(config, workload,
seed, device)``: ``workload["pool_batches"]`` global batches of
``data_parallel_workers * batch_per_worker`` rows, drawn on ``device``
from ``seed`` in a few large calls; every seed gives the same shapes."""
