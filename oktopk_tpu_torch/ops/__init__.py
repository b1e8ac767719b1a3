"""Selection, packing, threshold and kernel ops of the port.

Like ``oktopk_tpu/ops/__init__.py:13``, the package exports the top-k
thresholds (``exact_topk``, ``ratio2threshold``, ``k2threshold``); the
other ops are imported from their modules.
"""

from oktopk_tpu_torch.ops.topk import (  # noqa: F401
    exact_topk,
    k2threshold,
    ratio2threshold,
)
