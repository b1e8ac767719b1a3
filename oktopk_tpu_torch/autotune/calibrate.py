"""Online alpha-beta fabric calibration.

Counterpart of ``oktopk_tpu/autotune/calibrate.py`` (``DEFAULT_PROBE_SIZES``
:34, ``default_coefficients`` :51, ``_design_row`` :56, ``fit_alpha_beta``
:63, ``_default_measure`` :80, ``probe_fabric`` :114). The fit and its
design matrix are copies; ``FabricCoefficients`` is the one class of the
port's ``comm/fabric.py``, re-exported here.

``utils/cost_model.py`` ships the reference's MPI constants and the JAX
package's ICI ones; neither describes the fabric a run lands on. This
module measures it: time a few dense allreduce probes of increasing size
over the comm, then least-squares fit the ring-allreduce alpha-beta law

    t(n) = msgs(P) * alpha + elems(n, P) * beta,
    msgs(P) = 2 (P-1),  elems(n, P) = 2 n (P-1) / P        (P > 1)

which is linear in (alpha, beta). With P == 1 the collective is a no-op
and the probe times only dispatch + memory traffic; the design matrix
degenerates to (1, n), so alpha absorbs the dispatch floor and beta the
per-element pass.

A probe is the comm's own ``pmean`` of a [W, n] float32 tensor on the
trainer's device (W the comm's local workers): on ``StackedComm`` a row
sum in device memory, on ``ProcessGroupComm`` the rank-order
reduce-scatter over the process group. It is warmed once, the card
synchronised before and after each timed call, and the median of the
repeats enters the fit.

Across processes every rank runs the same probes in the same order (they
are collectives), and the ranks agree on the medians before anything is
fitted (``agree_max``): each median is the largest over the ranks,
because the slowest rank sets a collective's pace, and the max of the
gathered values is the same number on every rank, so every rank fits the
same coefficients and later makes the same decisions. (Rank 0's values,
broadcast, would agree as well, but would price the collective at a pace
the slowest rank does not keep.)
"""

from __future__ import annotations

import time
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from oktopk_tpu_torch import resolve_device
from oktopk_tpu_torch.comm.fabric import FabricCoefficients
from oktopk_tpu_torch.utils.cost_model import ICI_ALPHA, ICI_BETA

__all__ = ["DEFAULT_PROBE_SIZES", "FabricCoefficients", "agree_max",
           "default_coefficients", "fit_alpha_beta", "probe_fabric"]

# Probe sizes: span the bucket sizes real models produce (64k..4M elements
# covers mnistnet through VGG-16 buckets) without making startup slow.
DEFAULT_PROBE_SIZES = (1 << 16, 1 << 18, 1 << 20, 1 << 22)


def default_coefficients() -> FabricCoefficients:
    return FabricCoefficients(alpha=ICI_ALPHA, beta=ICI_BETA,
                              source="default")


def _design_row(n: int, p: int) -> Tuple[float, float]:
    """(alpha-coefficient, beta-coefficient) of one probe in the
    allreduce law."""
    if p > 1:
        return 2.0 * (p - 1), 2.0 * n * (p - 1) / p
    return 1.0, float(n)


def fit_alpha_beta(sizes: Sequence[int], times_s: Sequence[float],
                   num_workers: int,
                   source: str = "measured") -> FabricCoefficients:
    """Least-squares alpha-beta fit of measured allreduce times.

    ``times_s[i]`` is the per-step time (seconds) of an allreduce over
    ``sizes[i]`` f32 elements on ``num_workers`` workers. Coefficients are
    clamped to a tiny positive floor — a fit driven negative by noise would
    otherwise make every predicted cost meaningless.
    """
    sizes = list(sizes)
    times = np.asarray(list(times_s), np.float64)
    if len(sizes) != len(times) or len(sizes) < 2:
        raise ValueError(
            f"need >= 2 (size, time) samples, got {len(sizes)}/{len(times)}")
    A = np.asarray([_design_row(n, num_workers) for n in sizes], np.float64)
    coef, *_ = np.linalg.lstsq(A, times, rcond=None)
    alpha = float(max(coef[0], 1e-12))
    beta = float(max(coef[1], 1e-15))
    pred = A @ np.asarray([alpha, beta])
    rel = (pred - times) / np.maximum(times, 1e-12)
    return FabricCoefficients(
        alpha=alpha, beta=beta, source=source, nsamples=len(sizes),
        residual=float(np.sqrt(np.mean(rel ** 2))))


def agree_max(comm, values: Sequence[float], device) -> list:
    """``values`` made the same on every rank: element-wise the largest
    over the ranks (one all_gather of a float64 row). Returned unchanged
    by a comm within one process (it holds all of its workers)."""
    values = [float(v) for v in values]
    if comm is None or comm.local_workers == comm.size:
        return values
    row = torch.tensor([values], dtype=torch.float64, device=device)
    return comm.all_gather(row)[0].amax(0).cpu().tolist()


def _sync(device: torch.device) -> None:
    """Wait for the card (a no-op on the CPU, whose calls are
    synchronous)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _default_measure(comm, device: torch.device,
                     repeats: int) -> Callable[[int], Sequence[float]]:
    """Time the comm's ``pmean`` of a [W, n] float32 tensor at size n:
    one warm call, then ``repeats`` calls, each between two
    synchronisations of the card (seconds)."""
    W = comm.local_workers

    def measure(n: int) -> Sequence[float]:
        x = torch.zeros((W, n), dtype=torch.float32, device=device)
        comm.pmean(x)                              # warm
        out = []
        for _ in range(repeats):
            _sync(device)
            t0 = time.perf_counter()
            comm.pmean(x)
            _sync(device)
            out.append(time.perf_counter() - t0)
        return out

    return measure


def probe_fabric(comm=None, sizes: Sequence[int] = DEFAULT_PROBE_SIZES,
                 repeats: int = 3,
                 measure: Optional[Callable[[int], Sequence[float]]] = None,
                 num_workers: Optional[int] = None,
                 device=None) -> FabricCoefficients:
    """Measure the fabric: run probe allreduces and fit alpha-beta.

    ``measure(n) -> [seconds, ...]`` can be injected (tests, or fabrics
    timed elsewhere); the default times the comm's ``pmean`` on
    ``device`` (CUDA unless the caller asks for the CPU). The median over
    repeats of each size enters the fit; across processes, the largest
    median over the ranks (``agree_max``).
    """
    src = "injected"
    if measure is None:
        if comm is None:
            raise ValueError("probe_fabric needs a comm or a measure fn")
        device = resolve_device(device)
        num_workers = comm.size
        measure = _default_measure(comm, device, repeats)
        src = "measured"
    elif num_workers is None:
        raise ValueError("num_workers is required with an injected measure")
    med = [float(np.median(list(measure(n)))) for n in sizes]
    if src == "measured":
        med = agree_max(comm, med, device)
    return fit_alpha_beta(sizes, med, num_workers, source=src)
