"""Model registry (counterpart of ``oktopk_tpu/models/registry.py``; the
VGG and BERT entries so far). BERT factories take ``BertConfig`` fields
as keywords (``dropout=0.0``), as the JAX registry does."""

from __future__ import annotations

from oktopk_tpu_torch.models.bert import BertConfig, BertForPreTraining
from oktopk_tpu_torch.models.vgg import VGG

MODELS = {
    "vgg16": lambda **kw: VGG(name_cfg="vgg16", **kw),
    "vgg19": lambda **kw: VGG(name_cfg="vgg19", **kw),
    "bert_base": lambda **kw: BertForPreTraining(BertConfig.base(**kw)),
    "bert_large": lambda **kw: BertForPreTraining(BertConfig.large(**kw)),
    "bert_tiny": lambda **kw: BertForPreTraining(BertConfig.tiny(**kw)),
}


def create_model(dnn: str, **kw):
    try:
        factory = MODELS[dnn]
    except KeyError:
        raise NotImplementedError(
            f"dnn {dnn!r} is not ported to oktopk_tpu_torch yet (ported: "
            f"{sorted(MODELS)}); see ROADMAP.md") from None
    return factory(**kw)
