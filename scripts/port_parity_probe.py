#!/usr/bin/env python3
"""Measure last-bit differences between the PyTorch port and the JAX
package on the CPU, as ROADMAP.md (Queue 3, H10 to H13) reports them:

1. the Gaussian threshold (``ops/gaussian.py`` in both packages) over
   ``--seeds`` normal rows of n = 2^15 at d = 0.02, scaled and shifted:
   the largest distance in ulps, and in how many rows an |x| lies
   between the two thresholds (the selections then differ);
2. ``m * a + b`` (momentum correction, m = 0.9) over 2^20 normal pairs:
   how many results of XLA's CPU backend (jitted) differ from PyTorch's;
3. LayerNorm (BERT, eps 1e-12) over 4096 rows of 768 normal values
   (mean 1, std 3; then mean 300, std 1, where E[x^2] - E[x]^2 cancels):
   flax ``nn.LayerNorm`` (jitted) against the port's hand-written
   fast-variance form and against ``F.layer_norm``, the largest absolute
   difference and the elements that differ;
4. the attention mask fill: softmax over [8, 12, 128, 128] normal logits
   (std 4) with key padding, masked logits set to ``finfo(float32).min``
   (flax, the port) against the reference's additive -10000 bias, the
   largest absolute difference of the weights.

    JAX_PLATFORMS=cpu python scripts/port_parity_probe.py --seeds 40

Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--seeds", type=int, default=40)
    args = ap.parse_args(argv)

    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import numpy as np
    import torch

    from oktopk_tpu.ops.gaussian import gaussian_threshold as jax_gauss
    from oktopk_tpu_torch.ops.gaussian import gaussian_threshold

    n = 1 << 15
    k = int(0.02 * n)
    jg = jax.jit(jax_gauss, static_argnums=1)
    rng = np.random.RandomState(0)
    worst, between = 0, 0
    for _ in range(args.seeds):
        x = (rng.randn(n) * 10.0 ** rng.uniform(-3, 3)
             + rng.randn() * 0.3).astype(np.float32)
        a = np.float32(jg(jnp.asarray(x), k))
        b = np.float32(gaussian_threshold(torch.from_numpy(x), k))
        worst = max(worst, abs(int(a.view(np.int32))
                               - int(b.view(np.int32))))
        lo, hi = min(a, b), max(a, b)
        between += int(((np.abs(x) >= lo) & (np.abs(x) < hi)).any())

    a = rng.randn(1 << 20).astype(np.float32)
    b = rng.randn(1 << 20).astype(np.float32)
    xla = np.asarray(jax.jit(lambda u, v: 0.9 * u + v)(a, b))
    port = (0.9 * torch.from_numpy(a) + torch.from_numpy(b)).numpy()

    import flax.linen as nn
    import torch.nn.functional as F
    from oktopk_tpu_torch.models.bert import LayerNorm
    ln = nn.LayerNorm(epsilon=1e-12)
    lnorm = {}
    for tag, std, mean in (("", 3.0, 1.0), ("offset300_", 1.0, 300.0)):
        x = (std * rng.randn(4096, 768) + mean).astype(np.float32)
        v = ln.init(jax.random.PRNGKey(0), x)
        want = np.asarray(jax.jit(ln.apply)(v, x))
        with torch.no_grad():
            ours = LayerNorm(768, 1e-12)(torch.from_numpy(x)).numpy()
            lib = F.layer_norm(torch.from_numpy(x), (768,),
                               eps=1e-12).numpy()
        for who, got in (("port", ours), ("torch", lib)):
            lnorm[f"layernorm_{tag}{who}_max_abs_diff"] = float(
                np.abs(got - want).max())
            lnorm[f"layernorm_{tag}{who}_elements_differ"] = int(
                (got != want).sum())

    logits = torch.from_numpy((4.0 * rng.randn(8, 12, 128, 128))
                              .astype(np.float32))
    keys = torch.ones(8, 128, dtype=torch.bool)
    for b in range(8):
        keys[b, 128 - 12 * b:] = False
    mask = keys[:, None, None, :]
    w_min = torch.softmax(torch.where(
        mask, logits, torch.tensor(torch.finfo(torch.float32).min)), -1)
    w_add = torch.softmax(logits + (~mask).float() * -10000.0, -1)
    print(json.dumps({
        "gaussian_rows": args.seeds, "n": n, "k": k,
        "gaussian_max_ulps": worst, "gaussian_rows_selection_differs":
        between, "fma_pairs": a.size,
        "fma_results_differ": int((xla != port).sum()),
        "layernorm_elements": 4096 * 768, **lnorm,
        "mask_fill_max_abs_diff": float((w_min - w_add).abs().max())}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
