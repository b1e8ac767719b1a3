"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates without sparsity, at the full 700 W power limit)."""

HBM_BYTES_PER_S = 3.35e12

# FLOP/s by the precision a configuration computes in (a cell's
# ``compute_dtype``); float32 with TF32 off runs outside the tensor cores.
# The lower precisions are here for the cells that later add them, since
# this file, like every file of the benchmark, is not edited later
FLOPS_PER_S = {
    "float32": 67e12,
    "tf32": 495e12,
    "bfloat16": 989e12,
    "float16": 989e12,
}
