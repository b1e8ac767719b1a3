"""Host-side utilities of the port (``oktopk_tpu/utils/__init__.py``'s
exports: the alpha-beta cost model and the logger)."""

from oktopk_tpu_torch.utils.cost_model import (  # noqa: F401
    allgather_cost,
    allreduce_cost,
    sparse_allreduce_cost,
    topk_cost,
)
from oktopk_tpu_torch.utils.logging import get_logger  # noqa: F401
