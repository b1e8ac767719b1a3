"""Per-bucket algorithm/density autotuner.

Counterpart of ``oktopk_tpu/autotune/`` with its export list
(``oktopk_tpu/autotune/__init__.py:26-39``). The sparse collectives only
beat dense allreduce in the regime the fabric, gradient size and density
put them in (PAPERS.md: "On the Utility of Gradient Compression..."
arXiv 2103.00543; SparCML's dynamic sparse/dense switching, arXiv
1802.08021). This package makes the algorithm a measured runtime
decision per gradient bucket instead of a command-line flag:

1. ``calibrate`` — fit alpha/beta from a few timed probe collectives (the
   comm's ``pmean``) at startup (least squares on the alpha-beta
   allreduce law), replacing the ``utils/cost_model.py`` constants;
2. ``trial``     — time each candidate (algorithm, density) for K steps
   per bucket on the device, through ``collectives.api.
   build_allreduce_step``;
3. ``policy``    — the cost-model prior orders the candidates, the trial
   measurements form the posterior; hysteresis and a re-tune period keep
   decisions from thrashing the step with re-plans;
4. ``journal``   — the JSONL decision log (bucket, candidates, predicted
   vs measured ms, chosen algo/density), which the run journal builds on.
"""

from oktopk_tpu_torch.autotune.calibrate import (  # noqa: F401
    FabricCoefficients,
    fit_alpha_beta,
    probe_fabric,
)
from oktopk_tpu_torch.autotune.journal import (  # noqa: F401
    DecisionJournal,
    read_journal,
)
from oktopk_tpu_torch.autotune.policy import (  # noqa: F401
    Autotuner,
    AutotunePolicy,
    BucketPlan,
    Candidate,
    predict_ms,
)
from oktopk_tpu_torch.autotune.trial import TrialRunner  # noqa: F401
