"""Stand-alone sparse-allreduce micro-benchmark.

Counterpart of ``oktopk_tpu/benchmarks/collectives.py`` (reference C26
analogue: ``benchmark_gtopk_sparse_allreduce``, VGG/allreducer.py:
1649-1677, run as ``python -m mpi4py allreducer.py`` on random 25M-float
tensors). The workers are stacked on one device (``StackedComm``):
``--num-workers`` takes the place of JAX's ``--fake-devices`` (default 4,
the port's main path), and ``--device`` defaults to ``cuda``.

Usage:
    python -m oktopk_tpu_torch.benchmarks.collectives --algo oktopk \\
        --n 1048576 --density 0.01 --steps 10 [--num-workers 4] \\
        [--device cpu]

Prints a header line, then each step's time (host clock, the card
synchronised before and after the step), its communication volume
(worker 0's ``last_volume``, elements) and ``eps_vs_dense`` (the relative
error of the reduced vector against the dense mean). The gradients are
``np.random.RandomState(0)``'s, as JAX's: a base draw plus 0.3 of a fresh
one every step, made on the host and copied before the clock starts. The
first step is an untimed warm-up.
"""

from __future__ import annotations

import argparse
import sys
import time


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--algo", default="oktopk")
    p.add_argument("--n", type=int, default=1 << 20)
    p.add_argument("--density", type=float, default=0.01)
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--num-workers", type=int, default=4,
                   help="workers stacked on the device")
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda)")
    p.add_argument("--local-recompute-every", type=int, default=1)
    p.add_argument("--global-recompute-every", type=int, default=4)
    args = p.parse_args(argv)

    import numpy as np
    import torch

    from oktopk_tpu_torch import resolve_device
    from oktopk_tpu_torch.collectives.api import (batched_init_state,
                                                  build_allreduce_step,
                                                  eps_vs_dense)
    from oktopk_tpu_torch.comm import StackedComm
    from oktopk_tpu_torch.config import OkTopkConfig

    dev = resolve_device(args.device)
    P = args.num_workers
    cfg = OkTopkConfig(
        n=args.n, num_workers=P, density=args.density, warmup_steps=0,
        local_recompute_every=args.local_recompute_every,
        global_recompute_every=args.global_recompute_every)
    step = build_allreduce_step(args.algo, cfg, StackedComm(P), warmup=False)
    state = batched_init_state(cfg, dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    rng = np.random.RandomState(0)
    base = rng.randn(P, args.n).astype(np.float32)
    grads = torch.from_numpy(base).to(dev)
    out, state = step(grads, state)            # warm-up
    sync()
    name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")
    print(f"algo={args.algo} n={args.n} P={P} k={cfg.k} device={name}",
          flush=True)
    for i in range(args.steps):
        grads = torch.from_numpy(
            base + 0.3 * rng.randn(P, args.n).astype(np.float32)).to(dev)
        sync()
        t0 = time.perf_counter()
        out, state = step(grads, state)
        sync()
        dt = time.perf_counter() - t0
        eps = float(eps_vs_dense(grads.mean(0), out[0]))
        print(f"step {i}: {dt * 1e3:8.2f} ms  "
              f"volume {float(state.last_volume[0]):10.0f} elems  "
              f"eps_vs_dense {eps:.4f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
