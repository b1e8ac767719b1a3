"""Ring attention: exact attention over a sequence-sharded comm.

Counterpart of ``oktopk_tpu/parallel/ring_attention.py``. Queries stay
with their rank, key/value blocks rotate around the ring one hop a step
(``pipeline.ring_hop``, whose backward hops back: ``lax.ppermute``'s
transpose), and the softmax is accumulated online (a running max and
normaliser), so no [T, T] score matrix is built: each score block is
[T/P, T/P].

A tensor is ``[W, B, T/P, H, D]`` rows, W being the ranks this process
holds (``comm.local_workers``: every rank of a ``StackedComm``, one of a
``ProcessGroupComm``), row w rank ``comm.first_worker + w``. Each row's
block is computed on its own, so the rows of the stacked comm and the
ranks across processes agree bit for bit.

The arithmetic is JAX's: q scaled before the score product, masked
scores filled with -1e30 in float32, the running max, normaliser and
output in float32 with the correction ``exp(m - m_new)``, the K/V mask
rotating with K and V, P hops (the last brings each block home), and the
output divided by ``max(l, 1e-30)`` and cast back to q's dtype. Plain
matmul and exp: ``scaled_dot_product_attention`` would not accumulate
this way.
"""

from __future__ import annotations

from typing import Optional

import torch

from oktopk_tpu_torch.parallel.pipeline import ring_hop

NEG = -1e30


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   comm, kv_mask: Optional[torch.Tensor] = None,
                   scale: Optional[float] = None) -> torch.Tensor:
    """Exact softmax attention with K/V ring rotation.

    Args:
      q, k, v: [W, B, T/P, H, D] local shards.
      comm: the sequence comm (P = ``comm.size`` ranks).
      kv_mask: optional [W, B, T/P] bool, True where the key position is
        attendable (the padding mask); it rotates with k and v.
      scale: defaults to 1/sqrt(D).

    Returns: [W, B, T/P, H, D], the local queries' attention output.
    """
    P, W = comm.size, q.shape[0]
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    q = q * scale
    f32 = torch.float32
    neg = torch.full((), NEG, dtype=f32, device=q.device)
    if kv_mask is None:
        kv_mask = torch.ones(k.shape[:3], dtype=torch.bool, device=k.device)
    B, T, H, D = q.shape[1:]
    # [B, H, T, D] a row: scores [B, H, T, Tk], m and l [B, H, T]
    qh = q.permute(0, 1, 3, 2, 4)
    m = [torch.full((B, H, T), NEG, dtype=f32, device=q.device)
         for _ in range(W)]
    l_ = [torch.zeros((B, H, T), dtype=f32, device=q.device)
          for _ in range(W)]
    o = [torch.zeros((B, H, T, D), dtype=f32, device=q.device)
         for _ in range(W)]
    kk, vv = k, v
    mask = kv_mask.to(torch.uint8)      # the wire carries no bool
    for _ in range(P):
        for w in range(W):
            s = torch.matmul(qh[w], kk[w].permute(0, 2, 3, 1)).to(f32)
            s = torch.where(mask[w][:, None, None, :] != 0, s, neg)
            m_new = torch.maximum(m[w], s.amax(-1))
            corr = torch.exp(m[w] - m_new)
            p = torch.exp(s - m_new[..., None])
            l_[w] = l_[w] * corr + p.sum(-1)
            o[w] = o[w] * corr[..., None] + torch.matmul(
                p, vv[w].permute(0, 2, 1, 3).to(f32))
            m[w] = m_new
        # rotate K/V (and their mask) one hop around the ring
        kk, vv = ring_hop(kk, comm), ring_hop(vv, comm)
        mask = comm.ppermute_ring(mask)
    out = torch.stack([(ow / torch.clamp(lw, min=1e-30)[..., None])
                       for ow, lw in zip(o, l_)])
    return out.permute(0, 1, 3, 2, 4).to(q.dtype)


def ring_self_attention(x: torch.Tensor, wq, wk, wv, wo, num_heads: int,
                        comm, kv_mask: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """Projection, ring attention and output projection (a functional
    building block for sequence-sharded transformer layers).

    x: [W, B, T/P, E]; wq/wk/wv: [E, H*D]; wo: [H*D, E] (one copy for
    every row, or [W, ...] rows)."""
    W, B, T, E = x.shape
    D = wq.shape[-1] // num_heads

    def proj(w):
        return torch.matmul(x, w).reshape(W, B, T, num_heads, D)

    out = ring_attention(proj(wq), proj(wk), proj(wv), comm,
                         kv_mask=kv_mask)
    return torch.matmul(out.reshape(W, B, T, num_heads * D), wo)
