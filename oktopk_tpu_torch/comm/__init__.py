from oktopk_tpu_torch.comm.process_group import (
    HierarchicalProcessComm,
    ProcessGroupComm,
    hierarchical_process_comm,
)
from oktopk_tpu_torch.comm.stacked import (
    HierarchicalStackedComm,
    StackedComm,
    hierarchical_comm,
)

__all__ = ["HierarchicalProcessComm", "HierarchicalStackedComm",
           "ProcessGroupComm", "StackedComm", "hierarchical_comm",
           "hierarchical_process_comm"]
