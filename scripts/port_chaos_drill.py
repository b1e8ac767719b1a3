#!/usr/bin/env python
"""Run the port's deterministic chaos drills on stacked workers.

Usage:
    python scripts/port_chaos_drill.py --list
    python scripts/port_chaos_drill.py --drill chip_loss --device cpu
    python scripts/port_chaos_drill.py --drill all --json

The PyTorch port's counterpart of ``scripts/chaos_drill.py``, with its
flags and ``--device`` (the port's entry points run on ``cuda`` unless
given ``cpu``). Each drill scripts one incident (chip loss, guard
pressure, a corrupt checkpoint, a degraded fabric that forces an
autotune re-tune) end to end through the port's Trainer —
real steps, real collectives over a ``StackedComm``, a deterministic
``FaultPlan`` — and checks both the recovery and the journalled
timeline. The catalog is ``oktopk_tpu_torch/resilience/drills.py``, the
code ``tests/test_torch_chaos_drills.py`` holds against the JAX
package's drills.

Exit status is 0 only when every requested drill passes every check.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--drill", default="all",
                    help="drill name from the catalog, or 'all'")
    ap.add_argument("--list", action="store_true",
                    help="list available drills and exit")
    ap.add_argument("--json", action="store_true",
                    help="emit one JSON line per drill instead of text")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    from oktopk_tpu_torch.resilience.drills import DRILLS, run_drill

    if args.list:
        for name, fn in sorted(DRILLS.items()):
            doc = (fn.__doc__ or "").strip().split("\n")[0]
            print(f"{name:<18} {doc}")
        return 0

    names = sorted(DRILLS) if args.drill == "all" else [args.drill]
    all_ok = True
    for name in names:
        report = run_drill(name, device=args.device)
        all_ok = all_ok and report.ok
        if args.json:
            print(json.dumps({
                "drill": report.name, "ok": report.ok,
                "checks": [{"name": n, "passed": p, "detail": d}
                           for n, p, d in report.checks],
                "notes": {k: v for k, v in report.notes.items()
                          if isinstance(v, (int, float, str, list))},
                "journal_events": len(report.journal)}))
        else:
            print(report.summary())
    return 0 if all_ok else 1


if __name__ == "__main__":
    sys.exit(main())
