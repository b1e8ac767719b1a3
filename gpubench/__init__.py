"""The benchmark of the PyTorch and CUDA port, ``oktopk_tpu_torch``, on
NVIDIA H100 cards: ``python -m gpubench.run --workload <cell> --seed <n>
--seconds <s> --trace <0|1>`` (``README.md``)."""
