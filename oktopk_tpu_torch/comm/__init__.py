from oktopk_tpu_torch.comm.stacked import StackedComm

__all__ = ["StackedComm"]
