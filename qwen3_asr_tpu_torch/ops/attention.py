"""Plain attention of the encoders: full (the ASR tower below the flash
crossover) and block-diagonal windows (the aligner's tower).

Port of qwen3_asr_tpu/ops/attention.py::mha_attention and
::block_diagonal_attention, which the JAX package leaves to XLA: f32 scores
and softmax, probabilities cast to the value dtype, f32 accumulation of the
value product.
"""

from __future__ import annotations

import torch


def causal_mask(T: int, S: int, offset, valid_len, device=None) -> torch.Tensor:
    """[T, S] bool: row t attends to s iff s <= offset + t and s < valid_len
    (offset: cached positions before this block; valid_len: real cache
    rows)."""
    rows = torch.arange(T, device=device)[:, None]
    cols = torch.arange(S, device=device)[None, :]
    return (cols <= offset + rows) & (cols < valid_len)


def block_diagonal_mask(n_ctx: int, window: int, device=None) -> torch.Tensor:
    """[n_ctx, n_ctx] bool: attend within windows of `window` positions
    (segment id = position // window)."""
    seg = torch.arange(n_ctx, device=device) // window
    return seg[:, None] == seg[None, :]


def mha_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  mask: torch.Tensor | None, scale: float) -> torch.Tensor:
    """q [T, n_heads, D], k/v [S, n_kv, D], mask [T, S] bool (True =
    attend) or None -> [T, n_heads, D] in q's dtype. GQA by h // group."""
    T, n_heads, D = q.shape
    S, n_kv, _ = k.shape
    group = n_heads // n_kv
    qg = q.reshape(T, n_kv, group, D).float()
    scores = torch.einsum("tkgd,skd->kgts", qg, k.float()) * scale
    if mask is not None:
        scores = scores.masked_fill(~mask[None, None], float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("kgts,skd->tkgd", probs.to(v.dtype).float(), v.float())
    return out.reshape(T, n_heads, D).to(q.dtype)


def block_diagonal_attention_batch(q: torch.Tensor, k: torch.Tensor,
                                   v: torch.Tensor, window: int, scale: float,
                                   n_valid=None) -> torch.Tensor:
    """Windowed attention on a batch: q, k, v [B, T, n_heads, D] -> [B, T,
    n_heads, D] in q's dtype. Row t attends to the keys of its own window
    of `window` positions (segment t // window). T is padded to whole
    windows and the windows run as one batched product, O(T * window).
    Keys past the bound (T, or n_valid[b] when given: [B] ints, a tensor
    on q's device in the encoder's layer loop) are
    masked; each score row keeps its diagonal finite (clamped to -1e30), so
    a padding row's softmax never sees only -inf and gives no NaN."""
    B, T, H, D = q.shape
    n_win = -(-T // window)
    pad = n_win * window - T

    def split(x):
        x = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad))
        return x.reshape(B, n_win, window, H, D).float()

    qw, kw, vw = split(q), split(k), split(v)
    scores = torch.einsum("bwthd,bwshd->bwhts", qw, kw) * scale
    if pad > 0 or n_valid is not None:
        # built on q's device: a host-side mask copied in would stall the
        # stream in every layer
        dev = q.device
        bound = torch.full((B,), T, device=dev) if n_valid is None else \
            torch.as_tensor(n_valid, device=dev).reshape(B)
        pos = torch.arange(n_win * window, device=dev).reshape(n_win, window)
        valid = pos[None] < bound[:, None, None]                  # [B, n_win, window]
        scores = scores.masked_fill(~valid[:, :, None, None, :], float("-inf"))
        eye = torch.eye(window, dtype=torch.bool, device=q.device)
        scores = torch.where(eye, torch.clamp(scores, min=-1e30), scores)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bwhts,bwshd->bwthd", probs.to(v.dtype).float(), vw)
    return out.reshape(B, n_win * window, H, D)[:, :T].to(q.dtype)


def block_diagonal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             window: int, scale: float, n_valid=None
                             ) -> torch.Tensor:
    """Port of qwen3_asr_tpu/ops/attention.py::block_diagonal_attention
    (plain XLA there, plain PyTorch here): q, k, v [T, n_heads, D], keys at
    position >= n_valid (an int, or None for T) masked -> [T, n_heads, D]."""
    nv = None if n_valid is None else [int(n_valid)]
    return block_diagonal_attention_batch(q[None], k[None], v[None], window,
                                          scale, nv)[0]
