"""Parallelism beyond data-parallel (``oktopk_tpu/parallel/__init__.py``):
the data x inner grid they share (``grid.py``), the GPipe pipeline
(``pipeline.py``) and BERT pretraining through it (``bert_pipeline.py``),
ring attention (``ring_attention.py``) and sequence-parallel BERT
(``bert_seq.py``), tensor-parallel BERT (``bert_tp.py``), the Switch
top-1 MoE BERT over expert ranks (``bert_moe.py``), and the shard_map
transposes of replicated values and of the all_to_all
(``transposes.py``)."""

from oktopk_tpu_torch.parallel.pipeline import gpipe_apply  # noqa: F401
from oktopk_tpu_torch.parallel.ring_attention import (  # noqa: F401
    ring_attention, ring_self_attention)
