"""Model registry (counterpart of ``oktopk_tpu/models/registry.py``):
every name of the JAX registry. Factories take the JAX model's fields
as keywords (``depth``, ``stage_sizes``, ``cardinality``,
``growth_rate``, ``dropout=0.0`` for BERT, ``hidden_size=`` for the
LSTM, ...), and the named entries' overrides are the JAX registry's
(:34-72)."""

from __future__ import annotations

from oktopk_tpu_torch.models.alexnet import AlexNet
from oktopk_tpu_torch.models.bert import BertConfig, BertForPreTraining
from oktopk_tpu_torch.models.caffe_cifar import CaffeCifar
from oktopk_tpu_torch.models.deepspeech import DeepSpeech
from oktopk_tpu_torch.models.densenet import DenseNet
from oktopk_tpu_torch.models.imagenet_resnet import ResNet50
from oktopk_tpu_torch.models.lstm import PTBLSTM
from oktopk_tpu_torch.models.mnistnet import MnistNet
from oktopk_tpu_torch.models.preresnet import PreResNet
from oktopk_tpu_torch.models.resnet import CifarResNet
from oktopk_tpu_torch.models.resnext import ResNeXt
from oktopk_tpu_torch.models.vgg import VGG

MODELS = {
    "vgg16": lambda **kw: VGG(name_cfg="vgg16", **kw),
    "vgg19": lambda **kw: VGG(name_cfg="vgg19", **kw),
    "resnet20": lambda **kw: CifarResNet(depth=20, **kw),
    "resnet56": lambda **kw: CifarResNet(depth=56, **kw),
    "resnet110": lambda **kw: CifarResNet(depth=110, **kw),
    "resnet50": lambda **kw: ResNet50(**kw),
    "alexnet": lambda **kw: AlexNet(**kw),
    "densenet100": lambda **kw: DenseNet(**{"depth": 100, **kw}),
    "preresnet110": lambda **kw: PreResNet(**{"depth": 110, **kw}),
    "resnext29": lambda **kw: ResNeXt(**{"depth": 29, **kw}),
    "caffe_cifar": lambda **kw: CaffeCifar(**kw),
    "mnistnet": lambda **kw: MnistNet(**kw),
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

# the image models and the shape of one input image (H, W, C)
IMAGE_SHAPES = {
    **{nm: (32, 32, 3) for nm in ("vgg16", "vgg19", "resnet20", "resnet56",
                                  "resnet110", "alexnet", "densenet100",
                                  "preresnet110", "resnext29",
                                  "caffe_cifar")},
    "resnet50": (224, 224, 3),
    "mnistnet": (28, 28, 1),
}


def create_model(dnn: str, **kw):
    try:
        factory = MODELS[dnn]
    except KeyError:
        raise NotImplementedError(
            f"dnn {dnn!r} is not ported to oktopk_tpu_torch (ported: "
            f"{sorted(MODELS)}); see ROADMAP.md") from None
    return factory(**kw)
