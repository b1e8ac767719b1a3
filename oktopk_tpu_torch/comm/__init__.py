from oktopk_tpu_torch.comm.process_group import ProcessGroupComm
from oktopk_tpu_torch.comm.stacked import StackedComm

__all__ = ["ProcessGroupComm", "StackedComm"]
