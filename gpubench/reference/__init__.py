"""The benchmark's plain reference: what the program under test must compute.

Plain PyTorch in float32 with TF32 off, written from the published
descriptions and the JAX package's semantics, in files of their own. It
imports nothing of the program (``oktopk_tpu_torch``), nothing of the JAX
package and no JAX, and it takes none of the program's state: the
benchmark hands both sides the same weights and batches, and every
quantity the program derives from them (dropout keys and masks, sparse
thresholds, region boundaries, selections, residuals, optimizer moments)
is worked out here again.

- ``prng.py``: JAX's threefry2x32 key algebra and Bernoulli masks, and
  flax's ``make_rng`` site keys (a frozen copy of the semantics);
- ``precision.py``: the products, in float32 or in TF32 (the control);
- ``bert.py``, ``vgg.py``: the model families, parameters kept as views
  of one flat vector in JAX's leaf order and layout;
- ``exchange_oktopk.py``, ``exchange_dense.py``: the gradient exchanges
  over P stacked workers, each found by the cell's compressor;
- ``optim.py``: SGD and BertAdam on flat vectors;
- ``train.py``: a few data-parallel steps from the benchmark's weights
  and batches.
"""
