from oktopk_tpu_torch.data.loaders import make_dataset
from oktopk_tpu_torch.data.synthetic import synthetic_batch, synthetic_iterator

__all__ = ["make_dataset", "synthetic_batch", "synthetic_iterator"]
