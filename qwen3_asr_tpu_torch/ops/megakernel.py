"""Greedy decode step on the decode pack (int4 or int8 weights) with an
int8, bf16 or int4 KV cache: the CUDA kernels `csrc/megakernel.cu` and
their plain PyTorch twin.

Port of qwen3_asr_tpu/ops/megakernel.py: `mega_decode_step_i8` (int8 KV),
`mega_decode_step` (bf16 KV) and `mega_decode_step_i4` (int4 KV), each on
the int8 pack (`pack_megakernel_params(int4=False)`, the default, which
`--quantize auto` / `int8pc` runs) or the int4 one (`int4=True`). The
reference's streamed-KV mode (`kv_stream=True`) is the same function; the
kernels read any S with one attention path, so it has no entry here. The int4
quantizer (`_int4_group_for`, `_quant_int4_groups` with the MSE clip search)
is ported as it is. The packs' layouts are the port's own, plain row major:
int8 weights `[L, in, out]` with one f32 scale per output column `[L, out]`
(the int8pc leaves as they are); int4 weights `[L, in/2, out]` uint8 with
row 2r in the low nibble and row 2r+1 in the high nibble of byte row r,
scales `[L, in/G, out]` f32. The lm head's vocab is zero-padded to
HEAD_PAD. Which pack a tree holds is read from its dtype (uint8 nibbles or
int8 codes), as the JAX kernel reads it from the packed row count. The
TPU's tile-major packs, scale blocks and ring geometry are not ported.

Cache layout at the public functions: k/v `[L, S, n_kv * head_dim]` int8
with scales `[L, S, n_kv]` f32, or bf16 without scales (the prefill's
layout), or the int4 cache: uint8 `[L, S/2, n_kv * head_dim]`, byte row r
holding cache row 2r in its low nibble and row 2r + 1 in its high one, with
scales `[L, S, n_kv]` f32 (the reference keeps them as `[L, n_kv, S]`, a
Mosaic layout). `pack_kv_int4` makes it from the prefill's int8 rows. A
step writes cache row `pos` in place and reads rows `< pos`.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from qwen3_asr_tpu_torch.config import DecoderConfig
from qwen3_asr_tpu_torch.ops.decode_attention import rope_coef, rope_row
from qwen3_asr_tpu_torch.ops.q8_matmul import INV127, quantize_rows, rms_norm_f32
from qwen3_asr_tpu_torch.ops.support import (
    check,
    raise_on_error,
    require_cuda,
    stream_ptr,
)
from qwen3_asr_tpu_torch.runtime.profiler import span

INT4_GROUP = 512   # rows per (group, output column) scale
CHUNK_IN = 1024    # the reference's group sizes divide its 1024-row chunks
HEAD_PAD = 128     # the lm head's vocab is zero-padded to this multiple
_INT4_CLIP_CANDIDATES = (0.9, 0.8)
INV7 = float(np.float32(1.0 / 7.0))  # amax / 7 as XLA computes it
KV4_FROM8 = float(np.float32(7.0 / 127.0))   # pack_kv_int4's f32 constants
KV4_SCALE = float(np.float32(127.0 / 7.0))


# ---------------------------------------------------------------------------
# int4 quantization and the pack
# ---------------------------------------------------------------------------

def _int4_group_for(n_in: int) -> int:
    """Scale-group rows for an input dim: the largest divisor of
    gcd(n_in, 1024) that is <= 512 (the reference's grouping rule)."""
    base = math.gcd(n_in, CHUNK_IN)
    g = min(INT4_GROUP, base)
    while base % g:
        g -= 1
    if n_in % 2 or n_in // g > 8:
        raise ValueError(f"int4: no valid scale grouping for in dim {n_in}")
    return g


def _quant_int4_groups(w: torch.Tensor, G: int | None = None
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """f32 [in, out] -> (int4 values in int8 [in, out] in [-7, 7], scales f32
    [in/G, out]): symmetric per (G-row group, column), keeping whichever of
    absmax and the clipped candidates gives the least squared error."""
    n_in, n_out = w.shape
    if G is None:
        G = _int4_group_for(n_in)
    wg = w.float().reshape(n_in // G, G, n_out)
    amax = wg.abs().amax(dim=1)
    best_s = torch.clamp(amax * INV7, min=1e-12)
    best_q = torch.clamp(torch.round(wg / best_s[:, None, :]), -7, 7)
    best_err = ((best_q * best_s[:, None, :] - wg) ** 2).sum(dim=1)
    for c in _INT4_CLIP_CANDIDATES:
        s = torch.clamp(amax * (c / 7.0), min=1e-12)
        q = torch.clamp(torch.round(wg / s[:, None, :]), -7, 7)
        err = ((q * s[:, None, :] - wg) ** 2).sum(dim=1)
        m = err < best_err
        best_err = torch.where(m, err, best_err)
        best_s = torch.where(m, s, best_s)
        best_q = torch.where(m[:, None, :], q, best_q)
    return best_q.to(torch.int8).reshape(n_in, n_out), best_s


def pack_nibbles(q: torch.Tensor) -> torch.Tensor:
    """int4 values in int8 [..., in, out] -> uint8 [..., in/2, out]: byte
    row r = (row 2r+1 << 4) | (row 2r & 0xF)."""
    u = q.view(torch.uint8)
    return ((u[..., 1::2, :] & 0xF) << 4) | (u[..., 0::2, :] & 0xF)


def unpack_nibbles(b: torch.Tensor) -> torch.Tensor:
    """uint8 [..., in/2, out] -> sign-extended int8 [..., in, out]."""
    lo = ((b & 0xF).to(torch.int16) ^ 8) - 8
    hi = ((b >> 4).to(torch.int16) ^ 8) - 8
    out = torch.stack([lo, hi], dim=-2)           # [..., in/2, 2, out]
    return out.reshape(*b.shape[:-2], 2 * b.shape[-2], b.shape[-1]).to(torch.int8)


def pack_kv_int4(kq: torch.Tensor, scale: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """The prefill's int8 cache -> the int4 cache, bit-equal to
    qwen3_asr_tpu/ops/megakernel.py::pack_kv_int4: kq [L, S, DKV] int8 with
    scales [L, S, n_kv] -> (uint8 [L, S/2, DKV] nibble pairs, scales * 127/7
    [L, S, n_kv] f32), the codes requantized as clip(round(q * 7/127), -7,
    7). Plain torch on the device: the reference runs it in XLA, once after
    the prefill."""
    q4 = torch.clamp(torch.round(kq.float() * KV4_FROM8), -7, 7).to(torch.int8)
    return pack_nibbles(q4).contiguous(), scale.float() * KV4_SCALE


def _pack_i4(w: torch.Tensor, G: int) -> tuple[torch.Tensor, torch.Tensor]:
    q, s = _quant_int4_groups(w, G)
    return pack_nibbles(q), s


def pack_megakernel_params(dec_params: dict, cfg: DecoderConfig,
                           int4: bool = False) -> dict:
    """Build the decode pack from a fused int8pc decoder tree (after
    quantize_decoder_params('int8pc') and fuse_decoder_params). int4=False:
    the int8pc codes and per-column scales as they are; int4=True: each
    int8pc weight dequantized (q * s) and re-quantized to int4 in groups.
    The lm head's vocab is zero-padded to a multiple of HEAD_PAD (padding
    columns are masked before the argmax). Prefill keeps the int8pc
    leaves."""
    cfg.require_dense(f"the {'int4' if int4 else 'int8'} decode pack (K1)")
    layers = dec_params["layers"]
    if not (isinstance(layers.get("wqkv"), dict) and "i8pc:q" in layers["wqkv"]
            and "lm_head_pc" in dec_params):
        raise ValueError("the decode pack needs the fused int8pc layout "
                         "(quantize_decoder_params('int8pc') + "
                         "fuse_decoder_params)")
    pack = {}
    for name, key in (("qkv", "wqkv"), ("wo", "wo"),
                      ("gu", "w_gate_up"), ("wd", "w_down")):
        q8, s8 = layers[key]["i8pc:q"], layers[key]["i8pc:s"]
        if not int4:
            pack[f"{name}_q"] = q8.contiguous()
            pack[f"{name}_s"] = s8.float().contiguous()
            continue
        G = _int4_group_for(q8.shape[-2])
        qs, ss = zip(*(_pack_i4(q8[l].float() * s8[l][None, :].float(), G)
                       for l in range(q8.shape[0])))
        pack[f"{name}_q"] = torch.stack(qs).contiguous()
        pack[f"{name}_s"] = torch.stack(ss).contiguous()
    hq = dec_params["lm_head_pc"]["i8pc:q"]
    hs = dec_params["lm_head_pc"]["i8pc:s"].float()
    H, V = hq.shape
    pad = -(-V // HEAD_PAD) * HEAD_PAD - V
    if int4:
        hw = torch.nn.functional.pad(hq.float() * hs[None, :], (0, pad))
        pack["head_q"], pack["head_s"] = _pack_i4(hw, _int4_group_for(H))
    else:
        pack["head_q"] = torch.nn.functional.pad(hq, (0, pad)).contiguous()
        pack["head_s"] = torch.nn.functional.pad(hs, (0, pad)).contiguous()
    f32 = torch.float32
    pack["attn_norm"] = layers["attn_norm"].to(f32).contiguous()
    pack["ffn_norm"] = layers["ffn_norm"].to(f32).contiguous()
    pack["q_norm"] = layers["q_norm"].to(f32).contiguous()
    pack["k_norm"] = layers["k_norm"].to(f32).contiguous()
    pack["out_norm"] = dec_params["output_norm"].to(f32).contiguous()
    pack["embd"] = dec_params["token_embd"].to(torch.bfloat16)  # the kernel's x is bf16
    return pack


def has_megakernel(dec_params: dict) -> bool:
    """True iff the decoder tree carries a decode pack."""
    return "mega" in dec_params


def weight_bits(pack: dict) -> int:
    """4 for the int4 pack (uint8 nibble bytes), 8 for the int8 one."""
    dt = pack["qkv_q"].dtype
    if dt == torch.uint8:
        return 4
    if dt == torch.int8:
        return 8
    raise TypeError(f"qkv_q: expected uint8 (int4) or int8 codes, got {dt}")


def scale_group(pack: dict, n_in: int) -> int:
    """Input rows per scale of a product with n_in input rows: the int4
    group, or all n_in rows (one scale per column) for int8 weights."""
    return _int4_group_for(n_in) if weight_bits(pack) == 4 else n_in


# ---------------------------------------------------------------------------
# plain twin
# ---------------------------------------------------------------------------

def _gemv_ref(xq, sx, wq, ws):
    """int8 [in] activation codes times the pack's weights -> f32 [N].
    int4 (packed [in/2, N], group scales [n_g, N]): per group f32(int32 dot)
    * (sx * s_g), summed over groups in order; int8 ([in, N], scales [N]):
    f32(int32 dot over all rows) * (sx * s). The dots run in float64, exact
    for these integer ranges."""
    if wq.dtype == torch.int8:
        return (xq.double() @ wq.double()).float() * (sx * ws)
    w8 = unpack_nibbles(wq)
    n_g = ws.shape[0]
    G = w8.shape[0] // n_g
    acc = None
    for g in range(n_g):
        part = (xq[g * G:(g + 1) * G].double() @ w8[g * G:(g + 1) * G].double())
        term = part.float() * (sx * ws[g])
        acc = term if acc is None else acc + term
    return acc


def _quant_row(xf):
    xq, sx = quantize_rows(xf[None])
    return xq[0], sx[0, 0]


def _bf(x):
    return x.to(torch.bfloat16).float()


def _write_fresh_row(cache, sc, l: int, pos: int, rows_f):
    """The fresh [n_kv, D] f32 rows into cache row pos of layer l: bf16
    rounded to nearest even; int8 codes with s = amax / 127; int4 codes with
    s = amax / 7 in their nibble of byte row pos // 2 (the other nibble
    kept). The divisions by 127 and 7 are multiplies by their f32
    reciprocals, as XLA compiles them."""
    if cache.dtype == torch.bfloat16:
        cache[l, pos] = rows_f.reshape(-1).to(cache.dtype)
        return
    i4 = cache.dtype == torch.uint8
    qmax = 7 if i4 else 127
    s = torch.clamp(rows_f.abs().amax(dim=1) * (INV7 if i4 else INV127), min=1e-12)
    q = torch.clamp(torch.round(rows_f / s[:, None]), -qmax, qmax).to(torch.int8)
    sc[l, pos] = s
    if not i4:
        cache[l, pos] = q.reshape(-1)
        return
    nib = q.reshape(-1).view(torch.uint8) & 0xF
    old = cache[l, pos // 2]
    cache[l, pos // 2] = ((old & 0xF0) | nib) if pos % 2 == 0 else ((nib << 4) | (old & 0xF))


def _cache_rows(cache, l: int, pos: int) -> torch.Tensor:
    """Cache rows < pos of layer l as f32 [pos, DKV] (int4 pairs unpacked)."""
    if cache.dtype == torch.uint8:
        return unpack_nibbles(cache[l, :(pos + 1) // 2])[:pos].float()
    return cache[l, :pos].float()


def mega_decode_step_ref(pack, cfg: DecoderConfig, token_or_x, pos: int,
                         k, v, k_s=None, v_s=None, return_logits: bool = False):
    """Plain twin of the kernels, for either pack and any cache: the same
    step in PyTorch ops, on any device. k, v int8 [L, S, DKV] or int4 pairs
    uint8 [L, S/2, DKV], each with scales k_s, v_s [L, S, n_kv], or bf16
    (k_s, v_s None). Writes cache row `pos` in place. -> (token int32 [1], h
    f32 [1, H]) or, with return_logits, (token, h, logits f32 [V])."""
    L, FF, eps = cfg.n_layers, cfg.intermediate_size, cfg.rms_norm_eps
    x = _embed_ref(pack, cfg, token_or_x)
    for l in range(L):
        h1 = _attention_ref(pack, cfg, l, x, pos, k, v, k_s, v_s)
        xq, sx = _quant_row(_bf(rms_norm_f32(h1, pack["ffn_norm"][l], eps)))
        gu = _bf(_gemv_ref(xq, sx, pack["gu_q"][l], pack["gu_s"][l]))
        g32, u32 = gu[:FF], gu[FF:]
        act = _bf((g32 * torch.sigmoid(g32)) * u32)
        xq, sx = _quant_row(act)
        x = _bf(h1 + _bf(_gemv_ref(xq, sx, pack["wd_q"][l], pack["wd_s"][l])))
    return _head_ref(pack, cfg, x, return_logits)


def _embed_ref(pack, cfg: DecoderConfig, token_or_x) -> torch.Tensor:
    """The step's input row, f32 [H] of bf16 values: the embedding row of an
    int32 token, or the given row."""
    if token_or_x.dtype == torch.int32:
        x = pack["embd"][token_or_x.reshape(-1)[0].long()].float()
    else:
        x = token_or_x.reshape(cfg.hidden_size).float()
    return _bf(x)


def _attention_ref(pack, cfg: DecoderConfig, l: int, x, pos: int, k, v, k_s, v_s
                   ) -> torch.Tensor:
    """Layer l's attention block of the twin on the row x (f32 [H]): the QKV
    product, attention at pos (`_attend_ref`, which writes the fresh row at
    pos), the Wo product and the residual. -> h1 f32 [H] of bf16 values."""
    xq, sx = _quant_row(_bf(rms_norm_f32(x, pack["attn_norm"][l], cfg.rms_norm_eps)))
    qkv = _bf(_gemv_ref(xq, sx, pack["qkv_q"][l], pack["qkv_s"][l]))
    xq, sx = _quant_row(_attend_ref(pack, cfg, l, qkv, pos, k, v, k_s, v_s))
    return _bf(x + _bf(_gemv_ref(xq, sx, pack["wo_q"][l], pack["wo_s"][l])))


def _attend_ref(pack, cfg: DecoderConfig, l: int, qkv, pos: int, k, v, k_s, v_s
                ) -> torch.Tensor:
    """Layer l's attention of the twin on its bf16 QKV row (f32 [DQ + 2
    DKV]): QK-norm, RoPE at pos, attention over the cache rows < pos and the
    fresh column, whose K/V row is written at row pos. -> the attention row
    f32 [DQ] of bf16 values."""
    NH, NKV, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    DQ, group, eps = NH * D, NH // NKV, cfg.rms_norm_eps
    scale = float(np.float32(1.0 / float(np.sqrt(D))))
    quant = k_s is not None
    rows = qkv.reshape(NH + 2 * NKV, D)
    q_all = rope_row(rms_norm_f32(rows[:NH], pack["q_norm"][l], eps), pos,
                     cfg.rope_theta) * scale
    k_all = rope_row(rms_norm_f32(rows[NH:NH + NKV], pack["k_norm"][l], eps),
                     pos, cfg.rope_theta)
    v_all = rows[NH + NKV:]
    kc = _cache_rows(k, l, pos).reshape(pos, NKV, D)
    vc = _cache_rows(v, l, pos).reshape(pos, NKV, D)
    heads = []
    for h in range(NKV):
        q = q_all[h * group:(h + 1) * group]        # [group, D]
        s_cache = q @ kc[:, h].T
        p_v = None
        if quant:   # the row scales on the scores and on the V sum's probs
            s_cache = s_cache * k_s[l, :pos, h][None, :]
            p_v = v_s[l, :pos, h][None, :]
        s_fresh = q @ k_all[h][:, None]             # [group, 1]
        m = torch.maximum(s_cache.amax(dim=1, keepdim=True), s_fresh)
        p_cache = torch.exp(s_cache - m)
        p_fresh = torch.exp(s_fresh - m)
        denom = p_cache.sum(dim=1, keepdim=True) + p_fresh
        o = (p_cache if p_v is None else p_cache * p_v) @ vc[:, h]
        heads.append((o + p_fresh * v_all[h][None, :]) / denom)
    attn = _bf(torch.cat(heads, dim=0).reshape(DQ))
    _write_fresh_row(k, k_s, l, pos, k_all)
    _write_fresh_row(v, v_s, l, pos, v_all)
    return attn


def _head_ref(pack, cfg: DecoderConfig, x, return_logits: bool):
    """The final norm, the lm head and the argmax of the twin on x (f32
    [H]). -> (token int32 [1], x [1, H]) or, with return_logits, (token, x,
    logits f32 [V])."""
    H = cfg.hidden_size
    xq, sx = _quant_row(_bf(rms_norm_f32(x, pack["out_norm"], cfg.rms_norm_eps)))
    logits = _gemv_ref(xq, sx, pack["head_q"], pack["head_s"])[:cfg.vocab_size]
    tok = torch.argmax(logits).to(torch.int32).reshape(1)
    if return_logits:
        return tok, x.reshape(1, H), logits
    return tok, x.reshape(1, H)


# ---------------------------------------------------------------------------
# CUDA kernels
# ---------------------------------------------------------------------------

class _Ptrs(ctypes.Structure):
    _fields_ = [(n, ctypes.c_void_p) for n in (
        "embd", "attn_norm", "ffn_norm", "q_norm", "k_norm", "out_norm",
        "qkv_q", "qkv_s", "wo_q", "wo_s", "gu_q", "gu_s", "wd_q", "wd_s",
        "head_q", "head_s", "k_cache", "v_cache", "k_scale", "v_scale",
        "token_in", "x_in", "token_out", "h_out", "scratch")]


class _Dims(ctypes.Structure):
    _fields_ = [(n, ctypes.c_int) for n in (
        "L", "H", "NH", "NKV", "D", "FF", "V", "Vp", "S", "pos",
        "g_qkv", "g_wo", "g_gu", "g_wd", "g_head", "wbits", "pdl")] + [
        (n, ctypes.c_float) for n in ("eps", "rope_coef", "scale")]


def _dims(pack, cfg: DecoderConfig, S: int, pos: int, pdl: bool = False) -> _Dims:
    """The kernels' dimensions; pos is the host's bound of the positions
    (it sizes the attention grid), pdl K1's programmatic dependent launch."""
    H, D = cfg.hidden_size, cfg.head_dim
    DQ, FF = cfg.n_heads * D, cfg.intermediate_size
    return _Dims(
        L=cfg.n_layers, H=H, NH=cfg.n_heads, NKV=cfg.n_kv_heads, D=D, FF=FF,
        V=cfg.vocab_size, Vp=pack["head_q"].shape[1], S=S, pos=pos,
        g_qkv=scale_group(pack, H), g_wo=scale_group(pack, DQ),
        g_gu=scale_group(pack, H), g_wd=scale_group(pack, FF),
        g_head=scale_group(pack, H), wbits=weight_bits(pack), pdl=int(pdl),
        eps=cfg.rms_norm_eps, rope_coef=rope_coef(cfg.rope_theta, D),
        scale=float(np.float32(1.0 / float(np.sqrt(D)))))


def _check_pack(pack, cfg: DecoderConfig, dev) -> None:
    H, D, L = cfg.hidden_size, cfg.head_dim, cfg.n_layers
    DQ, DKV, FF = cfg.n_heads * D, cfg.n_kv_heads * D, cfg.intermediate_size
    int4 = weight_bits(pack) == 4
    wdt, rows = (torch.uint8, 2) if int4 else (torch.int8, 1)
    for name, n_in, n_out in (("qkv", H, DQ + 2 * DKV), ("wo", DQ, H),
                              ("gu", H, 2 * FF), ("wd", FF, H)):
        n_g = n_in // scale_group(pack, n_in)
        check(pack[f"{name}_q"], f"{name}_q", wdt, (L, n_in // rows, n_out), dev)
        check(pack[f"{name}_s"], f"{name}_s", torch.float32,
              (L, n_g, n_out) if int4 else (L, n_out), dev)
    Vp = pack["head_q"].shape[1]
    check(pack["head_q"], "head_q", wdt, (H // rows, Vp), dev)
    check(pack["head_s"], "head_s", torch.float32,
          (H // _int4_group_for(H), Vp) if int4 else (Vp,), dev)
    for name, shape in (("attn_norm", (L, H)), ("ffn_norm", (L, H)),
                        ("q_norm", (L, D)), ("k_norm", (L, D)), ("out_norm", (H,))):
        check(pack[name], name, torch.float32, shape, dev)
    check(pack["embd"], "embd", torch.bfloat16, (cfg.vocab_size, H), dev)


# entry point and launch counter by cache dtype
_ENTRIES = {torch.int8: "qw_mega_decode_step_i8", torch.bfloat16: "qw_mega_decode_step",
            torch.uint8: "qw_mega_decode_step_i4"}


# Kernel launches of one K1 step at L layers: per layer the QKV GEMV,
# attention, the Wo, gate-up and down GEMVs (each GEMV making its own input
# codes); then the final norm, the lm head and the two argmax passes
# (csrc/megakernel.cuh, decode_step; the scratch memset is no kernel).
def step_kernels(n_layers: int) -> int:
    return 5 * n_layers + 4


class DecodeStep:
    """The CUDA decode step bound to one pack (int4 or int8 weights) and one
    cache (int8 or int4 pairs with scales k_s / v_s, or bf16 with none):
    validates the pack and the cache once, allocates the scratch and the
    device position once, and then launches a step per call, through
    `qw_mega_decode_step_i8` (int8 cache), `qw_mega_decode_step` (bf16) or
    `qw_mega_decode_step_i4` (int4). The kernels read the position from the
    device and size their grids by S, so a step can be captured in a CUDA
    graph and replayed at any position (`GraphStep`). `pdl`: the GEMVs start
    under their predecessors' tails (programmatic dependent launch).
    `mega_decode_step_i8`, `mega_decode_step` and `mega_decode_step_i4` wrap
    it for single calls."""

    def __init__(self, pack, cfg: DecoderConfig, k, v, k_s=None, v_s=None, *,
                 pdl: bool = True):
        from qwen3_asr_tpu_torch.ops.build import kernel

        dev = k.device
        require_cuda(k, "k cache")
        _check_pack(pack, cfg, dev)
        L, NKV, DKV = cfg.n_layers, cfg.n_kv_heads, cfg.n_kv_heads * cfg.head_dim
        if k.dtype not in _ENTRIES:
            raise TypeError(f"k cache: expected int8, uint8 (int4 pairs) or bf16, "
                            f"got {k.dtype}")
        rows = 2 if k.dtype == torch.uint8 else 1
        S = k.shape[1] * rows
        check(k, "k cache", k.dtype, (L, S // rows, DKV), dev)
        check(v, "v cache", k.dtype, (L, S // rows, DKV), dev)
        if k.dtype != torch.bfloat16:
            if k_s is None or v_s is None:
                raise ValueError(f"a {k.dtype} cache needs its scales")
            check(k_s, "k scales", torch.float32, (L, S, NKV), dev)
            check(v_s, "v scales", torch.float32, (L, S, NKV), dev)
        elif k_s is not None or v_s is not None:
            raise ValueError("a bf16 cache takes no scales")
        self.cfg, self.dev, self.S = cfg, dev, S
        self.pack, self.cache = pack, (k, v, k_s, v_s)
        self.counter = _COUNTERS[k.dtype]
        self._fn = kernel(_ENTRIES[k.dtype],
                          [ctypes.POINTER(_Ptrs), ctypes.POINTER(_Dims),
                           ctypes.c_void_p, ctypes.c_void_p])
        self.dims = _dims(pack, cfg, S, S - 1, pdl)
        nbytes = kernel("qw_mega_scratch_bytes", [ctypes.POINTER(_Dims)],
                        ctypes.c_size_t)(ctypes.byref(self.dims))
        self.scratch = torch.empty(nbytes, dtype=torch.uint8, device=dev)
        self.h = torch.empty(1, cfg.hidden_size, dtype=torch.float32, device=dev)
        self.pos = torch.ones(1, dtype=torch.int32, device=dev)
        p = {n: pack[n].data_ptr() for n in (
            "embd", "attn_norm", "ffn_norm", "q_norm", "k_norm", "out_norm",
            "qkv_q", "qkv_s", "wo_q", "wo_s", "gu_q", "gu_s", "wd_q", "wd_s",
            "head_q", "head_s")}
        self.ptrs = _Ptrs(**p, k_cache=k.data_ptr(), v_cache=v.data_ptr(),
                          k_scale=None if k_s is None else k_s.data_ptr(),
                          v_scale=None if v_s is None else v_s.data_ptr(),
                          h_out=self.h.data_ptr(),
                          scratch=self.scratch.data_ptr())

    def __call__(self, token_or_x: torch.Tensor, pos, out: torch.Tensor) -> None:
        """One step: reads the int32 token (or bf16 [1, H] row) on the
        device, writes the next token into `out` (int32 [1] on the device;
        it may be the token's own buffer) and the cache row at the
        position: `pos` a host int (written into self.pos on the stream) or
        an int32 [1] tensor on the device, read there."""
        self.enqueue(token_or_x, pos, out)
        self.counter.launches += 1

    def enqueue(self, token_or_x: torch.Tensor, pos, out: torch.Tensor) -> None:
        """__call__ without the launch count (GraphStep's capture)."""
        if isinstance(pos, torch.Tensor):
            check(pos, "pos", torch.int32, (1,), self.dev)
        else:
            if not 1 <= pos < self.S:
                raise ValueError(f"pos {pos} outside [1, {self.S})")
            self.pos.fill_(pos)
            pos = self.pos
        if token_or_x.dtype == torch.int32:
            check(token_or_x, "token", torch.int32, (1,), self.dev)
            self.ptrs.token_in, self.ptrs.x_in = token_or_x.data_ptr(), None
        else:
            check(token_or_x, "x", torch.bfloat16, (1, self.cfg.hidden_size),
                  self.dev)
            self.ptrs.token_in, self.ptrs.x_in = None, token_or_x.data_ptr()
        check(out, "token out", torch.int32, (1,), self.dev)
        self.ptrs.token_out = out.data_ptr()
        raise_on_error(self._launch(pos), self.counter.__name__)

    def _launch(self, pos: torch.Tensor) -> int:
        """The step's C entry at the device position `pos`."""
        return self._fn(ctypes.byref(self.ptrs), ctypes.byref(self.dims),
                        ctypes.c_void_p(pos.data_ptr()), stream_ptr(self.dev))


class GraphStep:
    """A DecodeStep captured once in a CUDA graph and replayed per token.

    The graph holds the step on two buffers of its own, the token (read,
    then overwritten with the next token) and the position, and one device
    op after it that advances the position, so consecutive replays decode
    consecutive tokens with no host work but the replay. `run(out, i, pos)`
    decodes the token of out[i - 1] at position pos into out[i]: the first
    call runs the step eagerly (which also loads every kernel) and then
    captures it; later calls write the position only when the previous
    replay did not leave it there, and copy out[i - 1] in only when it is
    not the previous replay's own argmax, out[i - 1] as that replay left it
    (the greedy loops). `own_tokens=False` (a sampled loop, whose caller
    overwrites out[i] with another token after each call) copies out[i - 1]
    in before every replay. `h` is the step's hidden state before the final
    norm, f32 [1, H], as the last call left it. The host's checks ran at
    capture. A capture that fails raises; there is no eager fallback.
    Counts one launch of the step's entry per replay."""

    def __init__(self, step: DecodeStep, own_tokens: bool = True):
        self.step = step
        self.own_tokens = own_tokens
        self.tok = torch.zeros(1, dtype=torch.int32, device=step.dev)
        self.pos = torch.ones(1, dtype=torch.int32, device=step.dev)
        self.graph = None
        self._last = None   # (out's data pointer, index) the token buffer holds
        self._next_pos = None

    def _capture(self) -> None:
        cur = torch.cuda.current_stream(self.step.dev)
        side = torch.cuda.Stream(self.step.dev)
        side.wait_stream(cur)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.stream(side):
            graph.capture_begin(capture_error_mode="thread_local")
            try:
                self.step.enqueue(self.tok, self.pos, self.tok)
                self._advance()
            finally:
                graph.capture_end()
        cur.wait_stream(side)
        self.graph = graph

    def _advance(self) -> None:
        """The graph's last node: the position of the next replay."""
        self.pos.add_(1)

    def __call__(self, out: torch.Tensor, i: int, pos: int) -> None:
        if self.graph is None:
            with span("qwen3.graph_capture"):
                self.step(out[i - 1:i], pos, out[i:i + 1])
                self._capture()
            return
        if not 1 <= pos < self.step.S:
            raise ValueError(f"pos {pos} outside [1, {self.step.S})")
        if self._next_pos != pos:
            self.pos.fill_(pos)
        if self._last != (out.data_ptr(), i - 1):
            self.tok.copy_(out[i - 1:i])
        self.graph.replay()
        out[i:i + 1].copy_(self.tok)
        self._last = (out.data_ptr(), i) if self.own_tokens else None
        self._next_pos = pos + 1
        self.step.counter.launches += 1

    @property
    def h(self) -> torch.Tensor:
        return self.step.h


def _single_step(pack, cfg, token_or_x, pos, k, v, k_s, v_s):
    if k.device.type == "cpu":
        return mega_decode_step_ref(pack, cfg, token_or_x, pos, k, v, k_s, v_s)
    step = DecodeStep(pack, cfg, k, v, k_s, v_s)
    out = torch.empty(1, dtype=torch.int32, device=k.device)
    step(token_or_x.to(k.device).contiguous(), pos, out)
    return out, step.h


def mega_decode_step_i8(pack, cfg: DecoderConfig, token_or_x, pos: int,
                        k, v, k_s, v_s):
    """One greedy decode step over an int8 KV cache, on either pack.
    `token_or_x` is an int32 [1] token (its embedding row is gathered on the
    device) or a bf16 [1, H] embedded row. Writes cache row `pos` in place.
    -> (next token int32 [1], h f32 [1, H], the hidden state before the
    final norm). CPU tensors take the twin; CUDA tensors launch the kernels
    or raise."""
    return _single_step(pack, cfg, token_or_x, pos, k, v, k_s, v_s)


def mega_decode_step(pack, cfg: DecoderConfig, token_or_x, pos: int, k, v):
    """The same step over a bf16 KV cache (k, v [L, S, n_kv * head_dim]
    bf16, no scales)."""
    return _single_step(pack, cfg, token_or_x, pos, k, v, None, None)


def mega_decode_step_i4(pack, cfg: DecoderConfig, token_or_x, pos: int,
                        k, v, k_s, v_s):
    """The same step over the int4 cache (k, v uint8 [L, S/2, n_kv *
    head_dim] nibble pairs, scales [L, S, n_kv] f32, from pack_kv_int4): the
    fresh row's codes (s = amax / 7) go into their nibble of byte row pos //
    2, the other nibble kept."""
    return _single_step(pack, cfg, token_or_x, pos, k, v, k_s, v_s)


mega_decode_step_i8.launches = 0
mega_decode_step.launches = 0
mega_decode_step_i4.launches = 0
_COUNTERS = {torch.int8: mega_decode_step_i8, torch.bfloat16: mega_decode_step,
             torch.uint8: mega_decode_step_i4}
