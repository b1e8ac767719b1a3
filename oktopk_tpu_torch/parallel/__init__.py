"""Parallelism beyond data-parallel (``oktopk_tpu/parallel/__init__.py``):
the GPipe pipeline (``pipeline.py``) and BERT pretraining through it over
a data x pipe grid (``bert_pipeline.py``). Ring attention, tensor,
expert and sequence parallelism are not ported yet (ROADMAP.md)."""

from oktopk_tpu_torch.parallel.pipeline import gpipe_apply  # noqa: F401
