"""Trial phase: time candidate (algorithm, density) pairs on the device.

Counterpart of ``oktopk_tpu/autotune/trial.py`` (``TrialRunner`` :33).
Each trial builds the same collective step the training step would run
(``collectives.api.build_allreduce_step``) at the bucket's size over the
comm, feeds it N(0,1) gradients (``np.random.RandomState(seed).randn(P,
n)``, the comm's local rows, on the device), and times K steps after one
untimed one, the card synchronised before and after each timed call
(``collectives.api.time_allreduce_step``). The median per-step ms is the
policy's posterior over candidates.

Built steps and their initial states are memoised per (algo, n,
density), dense pinned to density 1.0 so that every density shares its
entry; every ``measure`` re-times the cached step from the same initial
state (the JAX runner re-times its compiled program from its cached
state: a step never writes its input state, so the cached one stays
pristine), so a re-tune sees the fabric as it is now and times the same
work. ``invalidate()`` drops the cache (after an elastic resize changes
the comm).

Across processes every rank runs the same trials in the same order (the
steps are collectives) and the ranks agree on each median before the
policy reads it: the largest over the ranks (``calibrate.agree_max``,
whose docstring says why). A trial whose step fails raises: it never
counts as an infinitely slow candidate.

Fake-timing injection (``fake_ms``) replaces the device entirely: the CPU
tests check the policy (crossovers, hysteresis, journal schema) against a
synthetic fabric. Its values are the injector's on every rank, so they
are not agreed.
"""

from __future__ import annotations

import statistics
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from oktopk_tpu_torch import resolve_device
from oktopk_tpu_torch.autotune.calibrate import agree_max
from oktopk_tpu_torch.config import OkTopkConfig


class TrialRunner:
    """Times candidate collectives over a comm (or a fake fabric).

    ``fake_ms(algo, n, density) -> ms`` short-circuits the device path.
    ``base_cfg`` carries the algorithm knobs (cadences, wire dtype, ...)
    every trial shares; n/density are overridden per candidate.
    ``device`` is where the trials run: CUDA unless the caller asks for
    the CPU (not read with ``fake_ms``).
    """

    def __init__(self, comm=None, trial_steps: int = 3, seed: int = 0,
                 base_cfg: Optional[OkTopkConfig] = None,
                 fake_ms: Optional[Callable[[str, int, float], float]] = None,
                 device=None):
        if comm is None and fake_ms is None:
            raise ValueError("TrialRunner needs a comm or a fake_ms injector")
        self.comm = comm
        self.device = (resolve_device(device) if fake_ms is None
                       else torch.device(device or "cpu"))
        self.trial_steps = max(1, int(trial_steps))
        self.seed = seed
        self.base_cfg = base_cfg or OkTopkConfig()
        self.fake_ms = fake_ms
        self._cache: Dict[Tuple[str, int, float], tuple] = {}
        self._grads: Dict[int, torch.Tensor] = {}

    @property
    def num_workers(self) -> int:
        if self.comm is None:
            return self.base_cfg.num_workers or 1
        return int(self.comm.size)

    def invalidate(self):
        """Drop memoised steps and gradients (e.g. after the comm
        changed)."""
        self._cache.clear()
        self._grads.clear()

    def measure(self, algo: str, n: int, density: float) -> float:
        """Median per-step ms of ``algo`` on an n-element bucket."""
        if self.fake_ms is not None:
            return float(self.fake_ms(algo, int(n), float(density)))
        return self._measure_real(algo, int(n), float(density))

    def _bucket_grads(self, n: int) -> torch.Tensor:
        if n not in self._grads:
            rng = np.random.RandomState(self.seed)
            first, W = self.comm.first_worker, self.comm.local_workers
            rows = rng.randn(self.num_workers, n).astype(np.float32)
            self._grads[n] = torch.from_numpy(
                rows[first:first + W]).to(self.device)
        return self._grads[n]

    def _measure_real(self, algo: str, n: int, density: float) -> float:
        from oktopk_tpu_torch.collectives.api import (batched_init_state,
                                                      build_allreduce_step,
                                                      time_allreduce_step)

        # dense ignores density; pin it so the cache key is shared across
        # whatever densities the candidate list carries
        d = 1.0 if algo == "dense" else density
        key = (algo, n, d)
        if key not in self._cache:
            cfg = self.base_cfg.replace(
                n=n, num_workers=self.num_workers, density=min(d, 1.0),
                warmup_steps=0, density_schedule=None)
            step = build_allreduce_step(algo, cfg, self.comm, warmup=False)
            self._cache[key] = (step, batched_init_state(
                cfg, self.device, comm=self.comm))
        step, state = self._cache[key]
        times_ms, _ = time_allreduce_step(step, self._bucket_grads(n), state,
                                          iters=self.trial_steps)
        med = float(statistics.median(times_ms))
        return agree_max(self.comm, [med], self.device)[0]
