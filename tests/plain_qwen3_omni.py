"""Qwen3-Omni-30B-A3B's thinker in float32, plain torch, the whole tree at
once: the tier-1 tests' reference for the port's MoE path. The benchmark's
copy (`asrbench/reference/qwen3_omni.py`) runs the same operations a
decoder layer at a time; `tests/test_torch_moe.py` holds the two equal.

No kernel, no cache, no batching; TF32 off. The configuration is the
thinker's published `text_config` at the top level with its `audio_config`
group (`asrbench/configs/qwen3-omni-30b-a3b-thinker.json`, or the family's
tiny version of it). Weights: [in, out] matrices, OIHW convolutions,
per-layer leaves stacked on a leading layer axis, a layer's experts [E, in,
out]:

    encoder: conv{1,2,3}_{w,b}, conv_out_w, layers {attn_norm_{w,b}, w{q,k,v,o},
             b{q,k,v,o}, ffn_norm_{w,b}, w_up, b_up, w_down, b_down}, ln_post_{w,b},
             proj{1,2}_{w,b}
    decoder: token_embd [V, H], lm_head [H, V], output_norm, layers {attn_norm,
             wq, wk, wv, wo, q_norm, k_norm, ffn_norm, router [H, E],
             experts_gate / experts_up [E, H, F], experts_down [E, F, H]}

Departures from upstream (transformers' Qwen3OmniMoeThinker) are noted at
their lines.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch
import torch.nn.functional as F

CHUNK = 100   # mel frames a conv chunk (2 * n_window)


@contextlib.contextmanager
def exact_f32():
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def conv_rows(frames: int) -> int:
    for _ in range(3):
        frames = (frames - 1) // 2 + 1
    return frames


def _layer_norm(x, w, b, eps):
    return F.layer_norm(x, (x.shape[-1],), w, b, eps)


def _rms_norm(x, w, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w


def _sinusoid(n: int, d: int, device) -> torch.Tensor:
    half = d // 2
    div = torch.exp(-math.log(10000.0) * torch.arange(half, dtype=torch.float64)
                    / (half - 1))
    ang = torch.arange(n, dtype=torch.float64)[:, None] * div[None]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=1).float().to(device)


def encode(enc: dict, cfg: dict, mel: torch.Tensor) -> torch.Tensor:
    """log-mel [n_mels, n_frames] -> audio rows [n_audio, output_dim]: the
    conv stem on zero-padded 100-frame chunks (GELU after each conv), a
    sinusoidal position a chunk row, each chunk's valid rows, the layers
    with attention in windows of n_window_infer frames (13 rows a chunk),
    ln_post, proj1 with GELU, proj2. LayerNorm eps 1e-5 (Whisper's; the
    published audio_config gives none)."""
    a = cfg["audio_config"]
    n_mels, n_frames = mel.shape
    n_chunks = -(-n_frames // CHUNK)
    x = F.pad(mel, (0, n_chunks * CHUNK - n_frames))
    x = x.reshape(n_mels, n_chunks, CHUNK).permute(1, 0, 2)[:, None]
    with exact_f32():
        for i in (1, 2, 3):
            x = F.gelu(F.conv2d(x, enc[f"conv{i}_w"], enc[f"conv{i}_b"], stride=2, padding=1))
        B, C, H, W = x.shape
        x = x.permute(0, 3, 1, 2).reshape(B, W, C * H) @ enc["conv_out_w"]
        x = x + _sinusoid(W, a["d_model"], x.device)[None]
        last = conv_rows(n_frames - (n_chunks - 1) * CHUNK)
        h = torch.cat([x[c, :(W if c < n_chunks - 1 else last)] for c in range(n_chunks)])
        T, d, nh = h.shape[0], a["d_model"], a["encoder_attention_heads"]
        hd = d // nh
        window = conv_rows(2 * a["n_window"]) * (a["n_window_infer"] // (2 * a["n_window"]))
        seg = torch.arange(T, device=h.device) // window
        mask = seg[:, None] == seg[None, :]
        eps = 1e-5
        for l in range(a["encoder_layers"]):
            lw = {k: v[l] for k, v in enc["layers"].items()}
            y = _layer_norm(h, lw["attn_norm_w"], lw["attn_norm_b"], eps)
            q = (y @ lw["wq"] + lw["bq"]).reshape(T, nh, hd)
            k = (y @ lw["wk"] + lw["bk"]).reshape(T, nh, hd)
            v = (y @ lw["wv"] + lw["bv"]).reshape(T, nh, hd)
            s = torch.einsum("thd,shd->hts", q, k) / math.sqrt(hd)
            s = s.masked_fill(~mask[None], float("-inf"))
            o = torch.einsum("hts,shd->thd", s.softmax(-1), v).reshape(T, d)
            h = h + o @ lw["wo"] + lw["bo"]
            y = _layer_norm(h, lw["ffn_norm_w"], lw["ffn_norm_b"], eps)
            h = h + F.gelu(y @ lw["w_up"] + lw["b_up"]) @ lw["w_down"] + lw["b_down"]
        h = _layer_norm(h, enc["ln_post_w"], enc["ln_post_b"], eps)
        h = F.gelu(h @ enc["proj1_w"] + enc["proj1_b"])
        return h @ enc["proj2_w"] + enc["proj2_b"]


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
    frequencies worked out in float64 (upstream: in float32)."""
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
    residual: RMSNorm, q / k RMSNorm per head, M-RoPE, grouped KV heads."""
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
    the rows in ascending expert order; no shared expert. Upstream rounds
    the weights to the hidden dtype before the product; here all is f32."""
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
    """One thinker layer: every layer is sparse (decoder_sparse_step 1,
    mlp_only_layers [])."""
    with exact_f32():
        h = attention(lw, cfg, h)
        return h + moe(lw, cfg, _rms_norm(h, lw["ffn_norm"], cfg["rms_norm_eps"]))


def embed(dec: dict, tokens: list[int], audio: torch.Tensor, audio_offset: int) -> torch.Tensor:
    """The token rows with the audio rows over [audio_offset, audio_offset +
    len(audio))."""
    ids = torch.tensor(tokens, dtype=torch.long, device=audio.device)
    h = dec["token_embd"][ids].clone()
    h[audio_offset:audio_offset + audio.shape[0]] = audio
    return h


def forward(tree: dict, cfg: dict, mel: torch.Tensor, tokens: list[int],
            audio_offset: int) -> torch.Tensor:
    """The whole thinker on one prompt: the tower on the log-mel, the audio
    rows spliced into `tokens`, every layer, the final norm and the untied
    head -> logits [len(tokens), vocab] f32."""
    dec = tree["decoder"]
    h = embed(dec, tokens, encode(tree["encoder"], cfg, mel), audio_offset)
    for l in range(cfg["num_hidden_layers"]):
        h = decoder_layer({k: v[l] for k, v in dec["layers"].items()}, cfg, h)
    with exact_f32():
        return _rms_norm(h, dec["output_norm"], cfg["rms_norm_eps"]) @ dec["lm_head"]
