"""Model registry (counterpart of ``oktopk_tpu/models/registry.py``; the
VGG, BERT, PTB LSTM and DeepSpeech entries so far). Factories take the
model's fields as keywords (``dropout=0.0`` for BERT, ``hidden_size=``
for the LSTM), and the tiny entries' overrides are the JAX registry's
(:49-66)."""

from __future__ import annotations

from oktopk_tpu_torch.models.bert import BertConfig, BertForPreTraining
from oktopk_tpu_torch.models.deepspeech import DeepSpeech
from oktopk_tpu_torch.models.lstm import PTBLSTM
from oktopk_tpu_torch.models.vgg import VGG

MODELS = {
    "vgg16": lambda **kw: VGG(name_cfg="vgg16", **kw),
    "vgg19": lambda **kw: VGG(name_cfg="vgg19", **kw),
    "lstm": lambda **kw: PTBLSTM(**kw),
    "lstm_tiny": lambda **kw: PTBLSTM(**{"vocab_size": 1024,
                                         "hidden_size": 192,
                                         "dropout_keep": 1.0, **kw}),
    "lstman4": lambda **kw: DeepSpeech(**kw),
    "lstman4_tiny": lambda **kw: DeepSpeech(**{"rnn_hidden": 128,
                                               "num_layers": 2, **kw}),
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
