from oktopk_tpu_torch.optim.sgd import SGD

__all__ = ["SGD"]
