"""Global debug/profiling flags.

Counterpart of ``oktopk_tpu/settings.py``, copied, with the same
``OKTOPK_*`` environment names (reference ``VGG/settings.py:1-39``:
DEBUG, SPARSE, WARMUP, PROFILING, PROFILING_NORM, PROFILING_GRAD,
TENSORBOARD module-level switches). They do not change hot-path
behaviour at import time; they are read once where the relevant feature
is built:

- ``PROFILING_NORM`` -> the Trainer's ``profile_norm`` default: the step
  adds an ``eps_vs_dense`` metric (a dense pmean beside the sparse
  collective every step, like reference VGG/allreducer.py:584-606,
  1072-1080);
- ``PROFILING`` -> the per-step selection counts and thresholds (always
  in the metrics; this flag widens log verbosity);
- ``PROFILING_GRAD`` -> ``main_trainer`` dumps the gradient stream's
  sparse state (``grad_dumps/iter_<step>.npz``) after each chunk.

- ``ANATOMY`` -> ``obs/anatomy.py``'s phase ranges (on unless
  ``OKTOPK_ANATOMY`` is ``0``, ``false`` or ``off``, as the JAX
  package's ``obs/anatomy.py`` reads it).

Env overrides: OKTOPK_DEBUG / OKTOPK_PROFILING / OKTOPK_PROFILING_NORM /
OKTOPK_PROFILING_GRAD / OKTOPK_TENSORBOARD / OKTOPK_ANATOMY.
"""

import os


def _env_flag(name: str, default: bool = False) -> bool:
    v = os.environ.get(name)
    return default if v is None else v.lower() in ("1", "true", "yes")


DEBUG = _env_flag("OKTOPK_DEBUG")
PROFILING = _env_flag("OKTOPK_PROFILING")
PROFILING_NORM = _env_flag("OKTOPK_PROFILING_NORM")
PROFILING_GRAD = _env_flag("OKTOPK_PROFILING_GRAD")
TENSORBOARD = _env_flag("OKTOPK_TENSORBOARD")
ANATOMY = os.environ.get("OKTOPK_ANATOMY", "1").lower() not in (
    "0", "false", "off")
