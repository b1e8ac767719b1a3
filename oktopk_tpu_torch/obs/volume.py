"""Per-algorithm analytic wire-byte budgets and conformance ratios.

Counterpart of ``oktopk_tpu/obs/volume.py:48-227``, pure Python and the
same floats. ``SparseState.last_wire_bytes`` is what a step put on the
wire per worker; ``budget_bytes`` is what the algorithm is allowed in a
steady-state step, so ``conformance_ratio = measured / budget <= 1`` is
a checkable invariant:

- ``oktopk``: the paper's 6k scalars, 3k (index, value) pairs, on its
  predicted steps (the every-``global_recompute_every`` exact recompute
  draws from the larger ``cap_exact`` pool);
- ``topkA``/``topkA2``: exactly kP pairs; ``gtopk``: 2k pairs per
  butterfly round;
- ``topkAopt``/``gaussiank``: P·cap_local pairs, the fixed buffers'
  ceiling;
- ``topkSA``/``gaussiankSA``: the split phase's 2(P−1)·cap_pair pairs
  plus the gather (topkSA's may densify to 2n f32 values);
- ``dense``: 2n f32 values;
- ``hierarchical``: per level (``hierarchical_budget_bytes``), the intra
  ring's 2n(P_pod−1)/P_pod f32 values and the outer algorithm's budget
  at P = num_pods.

``capacity_bytes`` is the static ceiling any step can move.
"""

from __future__ import annotations

import math

from oktopk_tpu_torch.config import OkTopkConfig

# registry aliases (collectives/registry.py): same function, same wire
_ALIAS = {"gaussiankconcat": "gaussiank", "topkDSA": "topkSA"}


def _canon(name: str) -> str:
    return _ALIAS.get(name, name)


def _intra_budget_bytes(hcfg) -> float:
    """Dense ring allreduce over the pod: 2n(P_pod−1)/P_pod f32 values —
    the exact pattern collectives/hierarchical.py accounts per step."""
    pod = hcfg.pod_size
    return 2.0 * hcfg.n * (pod - 1) / max(1, pod) * 4.0


def hierarchical_budget_bytes(hcfg) -> dict:
    """Per-level steady-state budgets for a ``HierarchicalConfig``:
    ``{"intra": dense-ring bytes over the pod, "inter": the outer
    algorithm's flat budget at P=num_pods}``."""
    return {"intra": _intra_budget_bytes(hcfg),
            "inter": budget_bytes(hcfg.outer, hcfg.outer_cfg)}


def _as_hierarchical(name: str, cfg):
    """Return cfg as a HierarchicalConfig when ``name`` names the
    two-level composition, else None (lazy import keeps obs free of a
    static collectives dependency)."""
    if name != "hierarchical":
        return None
    from oktopk_tpu_torch.collectives.hierarchical import HierarchicalConfig
    if not isinstance(cfg, HierarchicalConfig):
        raise TypeError("'hierarchical' volume accounting needs a "
                        f"HierarchicalConfig, got {type(cfg).__name__}")
    return cfg


def budget_bytes(name: str, cfg: OkTopkConfig) -> float:
    """Per-worker steady-state wire-byte budget for one step of
    algorithm ``name`` under ``cfg``. Measured ``last_wire_bytes`` must
    satisfy ``measured <= budget`` (conformance ratio <= 1.0).

    ``name="hierarchical"`` (with a ``HierarchicalConfig``) returns the
    level sum — see :func:`hierarchical_budget_bytes` for the split."""
    hcfg = _as_hierarchical(name, cfg)
    if hcfg is not None:
        return float(sum(hierarchical_budget_bytes(hcfg).values()))
    name = _canon(name)
    P, n, k = cfg.num_workers, cfg.n, cfg.k
    pair = float(cfg.wire_pair_bytes)
    if name == "dense":
        return 2.0 * n * 4.0
    if name in ("topkA", "topkA2"):
        return float(k) * P * pair
    if name == "gtopk":
        rounds = max(1, int(math.log2(P)))
        return 2.0 * k * rounds * pair
    if name == "oktopk":
        return 3.0 * k * pair          # the paper's 6k scalars
    if name in ("topkAopt", "gaussiank"):
        return float(P) * cfg.cap_local * pair
    if name == "topkSA":
        split = 2.0 * (P - 1) * cfg.cap_pair * pair
        gather = max(float(P) * cfg.cap_local * pair, 2.0 * n * 4.0)
        return split + gather
    if name == "gaussiankSA":
        split = 2.0 * (P - 1) * cfg.cap_pair * pair
        return split + float(P) * cfg.cap_local * pair
    raise ValueError(f"no wire-byte budget for algorithm {name!r}")


def capacity_bytes(name: str, cfg: OkTopkConfig) -> float:
    """Static worst-case ceiling: the most any single step (including
    oktopk's exact-recompute steps) can put on the wire per worker.
    Hierarchical: the (exact) intra ring plus the outer capacity."""
    hcfg = _as_hierarchical(name, cfg)
    if hcfg is not None:
        return float(_intra_budget_bytes(hcfg)
                     + capacity_bytes(hcfg.outer, hcfg.outer_cfg))
    name = _canon(name)
    P, n, k = cfg.num_workers, cfg.n, cfg.k
    pair = float(cfg.wire_pair_bytes)
    if name == "dense":
        return 2.0 * n * 4.0
    if name in ("topkA", "topkA2"):
        return float(k) * P * pair
    if name == "gtopk":
        rounds = max(1, int(math.log2(P)))
        return 2.0 * k * rounds * pair
    if name == "oktopk":
        split = 2.0 * (P - 1) * cfg.cap_pair * pair
        gather = float(P) * max(cfg.cap_gather, cfg.cap_exact) * pair
        return split + gather
    if name in ("topkAopt", "gaussiank"):
        return float(P) * cfg.cap_local * pair
    if name == "topkSA":
        split = 2.0 * (P - 1) * cfg.cap_pair * pair
        gather = max(float(P) * cfg.cap_local * pair, 2.0 * n * 4.0)
        return split + gather
    if name == "gaussiankSA":
        split = 2.0 * (P - 1) * cfg.cap_pair * pair
        return split + float(P) * cfg.cap_local * pair
    raise ValueError(f"no wire-byte capacity for algorithm {name!r}")


def conformance_ratio(name: str, cfg: OkTopkConfig,
                      measured_bytes: float) -> float:
    """measured / budget. <= 1.0 means the algorithm kept its analytic
    volume promise on the wire."""
    b = budget_bytes(name, cfg)
    return float(measured_bytes) / b if b > 0 else float("inf")


def volume_report(name: str, cfg: OkTopkConfig, mean_wire_bytes: float,
                  *, bucket: int = 0, step: int = 0,
                  steps: int = 0) -> dict:
    """Assemble one ``volume_report`` event payload
    (obs/events.py schema) from a measured per-step mean."""
    return {
        "step": int(step), "bucket": int(bucket), "algo": name,
        "n": int(cfg.n), "density": float(cfg.density),
        "steps": int(steps),
        "mean_wire_bytes": float(mean_wire_bytes),
        "budget_bytes": float(budget_bytes(name, cfg)),
        "capacity_bytes": float(capacity_bytes(name, cfg)),
        "conformance_ratio": conformance_ratio(name, cfg,
                                               mean_wire_bytes),
    }


def hierarchical_volume_report(hcfg, mean_intra_bytes: float,
                               mean_inter_bytes: float, *,
                               bucket: int = 0, step: int = 0,
                               steps: int = 0) -> list:
    """Per-level ``volume_report`` payloads for a two-level run.

    Takes the measured per-step means of ``SparseState.
    last_wire_bytes_intra`` / ``last_wire_bytes_inter`` and returns
    THREE level-tagged payloads — ``level="intra"`` (dense ring vs its
    exact budget), ``level="inter"`` (the outer algorithm vs its flat
    budget at P=num_pods), and ``level="total"`` (the sums, whose
    ``conformance_ratio`` is the combined invariant the acceptance
    tests hold <= 1.0). Each payload validates against the flat
    ``volume_report`` schema; ``level`` is the only added field."""
    budgets = hierarchical_budget_bytes(hcfg)
    ocfg = hcfg.outer_cfg
    base = {"step": int(step), "bucket": int(bucket), "n": int(hcfg.n),
            "steps": int(steps)}
    intra_b = budgets["intra"]
    levels = [
        {**base, "level": "intra", "algo": hcfg.inner, "density": 1.0,
         "mean_wire_bytes": float(mean_intra_bytes),
         "budget_bytes": float(intra_b),
         "capacity_bytes": float(intra_b),
         "conformance_ratio": (float(mean_intra_bytes) / intra_b
                               if intra_b > 0 else float("inf"))},
        {**base, "level": "inter", "algo": hcfg.outer,
         "density": float(ocfg.density),
         "mean_wire_bytes": float(mean_inter_bytes),
         "budget_bytes": float(budgets["inter"]),
         "capacity_bytes": float(capacity_bytes(hcfg.outer, ocfg)),
         "conformance_ratio": conformance_ratio(hcfg.outer, ocfg,
                                                mean_inter_bytes)},
    ]
    total_mean = float(mean_intra_bytes) + float(mean_inter_bytes)
    total_budget = float(sum(budgets.values()))
    levels.append(
        {**base, "level": "total", "algo": "hierarchical",
         "density": float(hcfg.density),
         "mean_wire_bytes": total_mean,
         "budget_bytes": total_budget,
         "capacity_bytes": float(capacity_bytes("hierarchical", hcfg)),
         "conformance_ratio": (total_mean / total_budget
                               if total_budget > 0 else float("inf"))})
    return levels
