from oktopk_tpu_torch.models.registry import create_model

__all__ = ["create_model"]
