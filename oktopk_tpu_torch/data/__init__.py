from oktopk_tpu_torch.data.synthetic import synthetic_batch, synthetic_iterator

__all__ = ["synthetic_batch", "synthetic_iterator"]
