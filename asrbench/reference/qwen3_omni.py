"""Qwen3-Omni-30B-A3B's thinker in float32, TF32 off: the `qwen3_omni`
family's plain reference, run a decoder layer at a time over every judged
request (`tests/plain_qwen3_omni.py` is the tier-1 tests' copy, the whole
tree at once; a test holds the two equal).

The configuration is the thinker's published `text_config` at the top
level and its `audio_config` (`asrbench/configs/qwen3-omni-30b-a3b-
thinker.json`); weights come in the benchmark's layout ([in, out]
matrices; a layer's experts [E, in, out]).

- The tower is Qwen3-ASR's (`model.encode`: the conv stem, attention in
  windows of n_window_infer mel frames, proj1 / proj2), at the thinker's
  widths (`audio_view`). Upstream's AuT runs the same ops.
- A decoder layer: RMSNorm, q / k / v, per-head RMSNorm of q and k, M-RoPE
  over three position rows (`mrope`), grouped-KV causal attention, Wo, the
  residual; RMSNorm, the sparse MoE block (`moe`): router logits in f32,
  softmax, the top k, renormalised (norm_topk_prob), every expert
  run on its rows (SwiGLU), no shared expert; the residual.
- The head: the final RMSNorm, then the untied lm_head.

Departures from upstream (Qwen3OmniMoeThinker in transformers) are noted
where they occur. No kernel and nothing of the program is imported.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from asrbench.reference.model import _rms_norm, exact_f32, int4
from asrbench.reference.prompt import conv_rows

EXPERT_MATRICES = ("experts_gate", "experts_up", "experts_down")


def audio_view(cfg: dict) -> dict:
    """The tower's shapes under the keys `model.encode` and `work.py` read:
    windows of n_window_infer mel frames, 13 rows a 100-frame chunk (104),
    LayerNorm eps 1e-5 (Whisper's; the published audio_config gives none)."""
    a = cfg["audio_config"]
    return {"encoder_layers": a["encoder_layers"], "d_model": a["d_model"],
            "attention_heads": a["encoder_attention_heads"], "ffn_dim": a["encoder_ffn_dim"],
            "conv_channels": a["downsample_hidden_size"], "num_mel_bins": a["num_mel_bins"],
            "n_window": a["n_window"], "n_window_infer": a["n_window_infer"],
            "output_dim": a["output_dim"], "layer_norm_eps": 1e-5,
            "attention_window_rows": conv_rows(2 * a["n_window"]) * (
                a["n_window_infer"] // (2 * a["n_window"]))}


def positions(T: int, device) -> torch.Tensor:
    """The three M-RoPE position rows [3, T] of an audio-only prompt: equal,
    0 .. T-1 (upstream's get_rope_index gives audio and text tokens
    consecutive positions on all three rows)."""
    return torch.arange(T, device=device)[None].expand(3, T)


def mrope(x: torch.Tensor, pos3: torch.Tensor, theta: float, section: list[int],
          interleaved: bool) -> torch.Tensor:
    """Multimodal RoPE on x [T, heads, D] at position rows pos3 [3, T]:
    frequency i takes its angle from row t, h or w by the sections
    (interleaved: i % 3 within 3 * section[j], as upstream's
    apply_interleaved_mrope; else contiguous runs), then NEOX pairs (x[i],
    x[i + D/2]). Angles are f32(position) * f32(1 / theta^(2i / D)), the
    frequencies worked out in float64."""
    T, _, D = x.shape
    half = D // 2
    inv = torch.from_numpy((1.0 / (theta ** (np.arange(0, half, dtype=np.float64) * 2.0 / D)))
                           .astype(np.float32)).to(x.device)
    ang = pos3.float()[:, :, None] * inv[None, None, :]          # [3, T, half]
    row = torch.zeros(half, dtype=torch.long)
    if interleaved:
        for j in (1, 2):
            row[j:3 * section[j]:3] = j
    else:
        row[section[0]:section[0] + section[1]] = 1
        row[section[0] + section[1]:] = 2
    a = ang.gather(0, row.to(x.device)[None, None, :].expand(1, T, half))[0]
    cos, sin = torch.cos(a)[:, None], torch.sin(a)[:, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(lw: dict, cfg: dict, h: torch.Tensor) -> torch.Tensor:
    """One layer's causal self-attention block over h [T, hidden] with its
    residual."""
    T = h.shape[0]
    nh, nkv, hd = cfg["num_attention_heads"], cfg["num_key_value_heads"], cfg["head_dim"]
    eps, rs = cfg["rms_norm_eps"], cfg["rope_scaling"]
    pos3 = positions(T, h.device)
    y = _rms_norm(h, lw["attn_norm"], eps)
    q = _rms_norm((y @ lw["wq"]).reshape(T, nh, hd), lw["q_norm"], eps)
    k = _rms_norm((y @ lw["wk"]).reshape(T, nkv, hd), lw["k_norm"], eps)
    v = (y @ lw["wv"]).reshape(T, nkv, hd)
    q = mrope(q, pos3, cfg["rope_theta"], rs["mrope_section"], rs["mrope_interleaved"])
    k = mrope(k, pos3, cfg["rope_theta"], rs["mrope_section"], rs["mrope_interleaved"])
    k = k.repeat_interleave(nh // nkv, dim=1)
    v = v.repeat_interleave(nh // nkv, dim=1)
    causal = torch.ones(T, T, dtype=torch.bool, device=h.device).tril()
    s = torch.einsum("thd,shd->hts", q, k) / math.sqrt(hd)
    s = s.masked_fill(~causal[None], float("-inf"))
    o = torch.einsum("hts,shd->thd", s.softmax(-1), v).reshape(T, nh * hd)
    return h + o @ lw["wo"]


def moe(lw: dict, cfg: dict, y: torch.Tensor) -> torch.Tensor:
    """The sparse MoE block on normed rows y [T, hidden] (no residual): the
    router's softmax in f32, the top k, renormalised over them with
    norm_topk_prob; each expert's SwiGLU on its rows, weighted, added into
    the rows in ascending expert order. Upstream rounds the weights to the
    hidden dtype before the product; here everything is f32."""
    k = cfg["num_experts_per_tok"]
    probs = torch.softmax(y @ lw["router"], dim=-1)
    w, ids = torch.topk(probs, k, dim=-1)
    if cfg["norm_topk_prob"]:
        w = w / w.sum(dim=-1, keepdim=True)
    out = torch.zeros_like(y)
    for e in torch.unique(ids).tolist():
        rows, slot = torch.nonzero(ids == e, as_tuple=True)
        x = y[rows]
        z = (F.silu(x @ lw["experts_gate"][e]) * (x @ lw["experts_up"][e])) @ lw["experts_down"][e]
        out.index_add_(0, rows, z * w[rows, slot, None])
    return out


def decoder_layer(lw: dict, cfg: dict, h: torch.Tensor) -> torch.Tensor:
    """One thinker layer (every layer is sparse: decoder_sparse_step 1,
    mlp_only_layers [])."""
    with exact_f32():
        h = attention(lw, cfg, h)
        return h + moe(lw, cfg, _rms_norm(h, lw["ffn_norm"], cfg["rms_norm_eps"]))


def lm_logits(top: dict, cfg: dict, h: torch.Tensor) -> torch.Tensor:
    """The final norm and the untied head: h [T, hidden] -> [T, vocab]."""
    with exact_f32():
        return _rms_norm(h, top["output_norm"], cfg["rms_norm_eps"]) @ top["lm_head"]


def int4_experts(lw: dict) -> None:
    """The control's layer: its expert matrices rounded to int4 per output
    channel (`model.int4`), in place, a matrix at a time."""
    for key in EXPERT_MATRICES:
        lw[key] = int4(lw[key])
