from oktopk_tpu_torch.optim.bert_adam import BertAdam
from oktopk_tpu_torch.optim.sgd import SGD

__all__ = ["BertAdam", "SGD"]
