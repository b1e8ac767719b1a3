"""What decides ``correct``: the program's first training steps held to
the plain reference's on the same weights and batches.

Eight numbers, each against the limit its cell's workload file states
(a limit of null: not compared, where no control or fault separates the
number from sound runs, or a steadier number stands in for it; the
workload file and ``PERF.md`` give its readings):
- ``loss_gap``: the largest relative gap of a step's loss (the mean over
  the workers) over the compared steps; ``loss_gap_first``: step 1's,
  steady where the later steps amplify a few flipped selections;
- ``grad_gap``: the gradient the optimizer received in step 1, worked
  out from the state that step left: by the worst leaf, the gap between
  the program's norm of the leaf and the reference's, over the larger of
  the reference's norm of that leaf and of the median leaf;
- ``update_gap``: the same of the parameters' change over the compared
  steps, leaving out the leaves whose received gradient in the reference
  is under a thousandth of the median leaf's (they move by round-off);
- ``grad_gap_median``, ``update_gap_median``: the same gaps of the median
  leaf, over the leaves whose reference norm is not zero: steady where a
  few small leaves swing (a ReLU or max-pool decision flipped by float32
  rounding sends a whole gradient path elsewhere);
- ``wire_gap``: the largest relative gap of a step's wire bytes (worker
  0's counter against the reference's count); ``wire_gap_first``: step
  1's, steady where the later steps' selections part (a count that
  crosses a capacity moves a whole block of indices).
The median leaf is the median of the reference's nonzero leaf norms.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch

NUMBERS = ("loss_gap", "loss_gap_first", "grad_gap", "grad_gap_median",
           "update_gap", "update_gap_median", "wire_gap", "wire_gap_first")
NEGLIGIBLE = 1e-3


def leaf_norms(flat: torch.Tensor, table) -> torch.Tensor:
    out, off = [], 0
    for _, shape, _ in table:
        size = math.prod(shape)
        out.append(torch.linalg.vector_norm(flat[off:off + size].double()))
        off += size
    return torch.stack(out).cpu()


def _median_nonzero(norms: torch.Tensor) -> float:
    nz = norms[norms > 0]
    return float(nz.median()) if nz.numel() else 0.0


def leaf_gaps(prog: torch.Tensor, ref: torch.Tensor,
              table) -> torch.Tensor:
    """Each leaf's |‖prog‖ - ‖ref‖| / max(‖ref‖, median leaf)."""
    pn, rn = leaf_norms(prog, table), leaf_norms(ref, table)
    denom = torch.clamp(rn, min=_median_nonzero(rn))
    diff = (pn - rn).abs()
    return torch.where(denom > 0, diff / torch.where(denom > 0, denom, 1.0),
                       torch.where(diff > 0, math.inf, 0.0))


def norm_gap(prog: torch.Tensor, ref: torch.Tensor, table,
             keep: Optional[torch.Tensor] = None) -> float:
    """The worst leaf's gap (``leaf_gaps``), over the ``keep`` leaves."""
    gap = leaf_gaps(prog, ref, table)
    if keep is not None:
        gap = gap[keep]
    return float(gap.max()) if gap.numel() else 0.0


def median_gap(prog: torch.Tensor, ref: torch.Tensor, table,
               keep: Optional[torch.Tensor] = None) -> float:
    """The median leaf's gap over the ``keep`` leaves whose reference
    norm is not zero."""
    gap = leaf_gaps(prog, ref, table)
    live = leaf_norms(ref, table) > 0
    if keep is not None:
        live = live & keep
    gap = gap[live]
    return float(gap.median()) if gap.numel() else 0.0


def _rel(a: List[float], b: List[float]) -> float:
    return max(abs(x - y) / abs(y) if y != 0 else
               (0.0 if x == y else math.inf) for x, y in zip(a, b))


def numbers(prog: Dict, ref: Dict, w0: torch.Tensor, table) -> Dict:
    """``prog`` and ``ref``: ``losses`` and ``wire_bytes`` of the compared
    steps, ``received`` (step 1's gradient) and ``params`` after the
    compared steps, all flat in the JAX order of ``table``."""
    rg = leaf_norms(ref["received"], table)
    moved = rg >= NEGLIGIBLE * _median_nonzero(rg)
    grads = (prog["received"], ref["received"], table)
    changes = (prog["params"] - w0, ref["params"] - w0, table)
    return {
        "loss_gap": _rel(prog["losses"], ref["losses"]),
        "loss_gap_first": _rel(prog["losses"][:1], ref["losses"][:1]),
        "grad_gap": norm_gap(*grads),
        "grad_gap_median": median_gap(*grads),
        "update_gap": norm_gap(*changes, keep=moved),
        "update_gap_median": median_gap(*changes, keep=moved),
        "wire_gap": _rel(prog["wire_bytes"], ref["wire_bytes"]),
        "wire_gap_first": _rel(prog["wire_bytes"][:1], ref["wire_bytes"][:1]),
    }


def diagnostics(prog: Dict, ref: Dict, w0: torch.Tensor, table) -> Dict:
    """What the readings look at beside the numbers: each step's loss and
    wire gap; the worst leaves; the elements that are nonzero on one
    side only (a selection that flipped), in all and in the worst leaf,
    and there the elements that differ by more than half the
    reference's largest."""
    out = {"loss_gaps": [_rel([a], [b]) for a, b in zip(prog["losses"],
                                                          ref["losses"])],
           "wire_gaps": [_rel([a], [b]) for a, b in
                         zip(prog["wire_bytes"], ref["wire_bytes"])]}
    sizes = [math.prod(s) for _, s, _ in table]
    offsets = [sum(sizes[:i]) for i in range(len(sizes))]
    for name, p, r in (("grad", prog["received"], ref["received"]),
                       ("update", prog["params"] - w0, ref["params"] - w0)):
        g = leaf_gaps(p, r, table)
        worst = torch.argsort(g, descending=True)[:3]
        out[f"{name}_worst"] = [[table[i][0], float(g[i])] for i in worst]
        out[f"{name}_one_sided"] = int(((p != 0) ^ (r != 0)).sum())
        i = int(worst[0])
        lp, lr = (x[offsets[i]:offsets[i] + sizes[i]] for x in (p, r))
        big = 0.5 * float(lr.abs().max())
        out[f"{name}_worst_leaf"] = {
            "size": sizes[i], "nonzero_program": int((lp != 0).sum()),
            "nonzero_reference": int((lr != 0).sum()),
            "one_sided": int(((lp != 0) ^ (lr != 0)).sum()),
            "apart": int(((lp - lr).abs() > big).sum())}
    return out


def verdict(nums: Dict, limits: Dict) -> bool:
    """Every number that has a limit finite and at most its limit."""
    compared = [k for k in NUMBERS if limits[k] is not None]
    if not compared:
        raise ValueError("no number has a limit")
    return all(math.isfinite(nums[k]) and nums[k] <= limits[k]
               for k in compared)
