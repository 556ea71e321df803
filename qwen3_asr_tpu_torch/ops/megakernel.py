"""Greedy decode step with int4 weights and an int8 KV cache: the CUDA
kernels `csrc/megakernel.cu` and their plain PyTorch twin.

Port of qwen3_asr_tpu/ops/megakernel.py in its int4-weight / int8-KV /
resident mode (`mega_decode_step_i8` on an `int4=True` pack). The int4
quantizer (`_int4_group_for`, `_quant_int4_groups` with the MSE clip
search) is ported as it is; the pack layout is the port's own, plain row
major: weights `[L, in/2, out]` uint8 with row 2r in the low nibble and row
2r+1 in the high nibble of byte row r, scales `[L, in/G, out]` f32. The
TPU's tile-major packs, scale blocks and ring geometry are not ported.

Cache layout at the public functions: k/v `[L, S, n_kv * head_dim]` int8
and scales `[L, S, n_kv]` f32 (the prefill's layout). A step writes cache
row `pos` in place and reads rows `< pos`.
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

INT4_GROUP = 512   # rows per (group, output column) scale
CHUNK_IN = 1024    # the reference's group sizes divide its 1024-row chunks
HEAD_PAD = 128     # the lm head's vocab is zero-padded to this multiple
_INT4_CLIP_CANDIDATES = (0.9, 0.8)
INV7 = float(np.float32(1.0 / 7.0))  # amax / 7 as XLA computes it


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
    """int4 values in int8 [in, out] -> uint8 [in/2, out]: byte row r =
    (row 2r+1 << 4) | (row 2r & 0xF)."""
    u = q.view(torch.uint8)
    return ((u[1::2] & 0xF) << 4) | (u[0::2] & 0xF)


def unpack_nibbles(b: torch.Tensor) -> torch.Tensor:
    """uint8 [..., in/2, out] -> sign-extended int8 [..., in, out]."""
    lo = ((b & 0xF).to(torch.int16) ^ 8) - 8
    hi = ((b >> 4).to(torch.int16) ^ 8) - 8
    out = torch.stack([lo, hi], dim=-2)           # [..., in/2, 2, out]
    return out.reshape(*b.shape[:-2], 2 * b.shape[-2], b.shape[-1]).to(torch.int8)


def _pack_i4(w: torch.Tensor, G: int) -> tuple[torch.Tensor, torch.Tensor]:
    q, s = _quant_int4_groups(w, G)
    return pack_nibbles(q), s


def pack_megakernel_params(dec_params: dict, cfg: DecoderConfig) -> dict:
    """Build the int4 decode pack from a fused int8pc decoder tree (after
    quantize_decoder_params('int8pc') and fuse_decoder_params): each int8pc
    weight is dequantized (q * s) and re-quantized to int4 in groups; the
    lm head's vocab is zero-padded to a multiple of HEAD_PAD (padding
    columns are masked before the argmax). Prefill keeps the int8pc leaves."""
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
        n_in = q8.shape[-2]
        G = _int4_group_for(n_in)
        qs, ss = zip(*(_pack_i4(q8[l].float() * s8[l][None, :].float(), G)
                       for l in range(q8.shape[0])))
        pack[f"{name}_q"] = torch.stack(qs).contiguous()
        pack[f"{name}_s"] = torch.stack(ss).contiguous()
    hq = dec_params["lm_head_pc"]["i8pc:q"]
    hs = dec_params["lm_head_pc"]["i8pc:s"].float()
    H, V = hq.shape
    Vp = -(-V // HEAD_PAD) * HEAD_PAD
    hw = torch.nn.functional.pad(hq.float() * hs[None, :], (0, Vp - V))
    pack["head_q"], pack["head_s"] = _pack_i4(hw, _int4_group_for(H))
    f32 = torch.float32
    pack["attn_norm"] = layers["attn_norm"].to(f32).contiguous()
    pack["ffn_norm"] = layers["ffn_norm"].to(f32).contiguous()
    pack["q_norm"] = layers["q_norm"].to(f32).contiguous()
    pack["k_norm"] = layers["k_norm"].to(f32).contiguous()
    pack["out_norm"] = dec_params["output_norm"].to(f32).contiguous()
    pack["embd"] = dec_params["token_embd"]
    return pack


# ---------------------------------------------------------------------------
# plain twin
# ---------------------------------------------------------------------------

def _gemv_i4_ref(xq, sx, wq, ws):
    """int8 [in] x packed int4 [in/2, N] with group scales [n_g, N] ->
    f32 [N]: per group f32(int32 dot) * (sx * s_g), summed over groups in
    order. The dot runs in float64, exact for these integer ranges."""
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


def mega_decode_step_i8_ref(pack, cfg: DecoderConfig, token_or_x, pos: int,
                            k, v, k_s, v_s, return_logits: bool = False):
    """Plain twin of the kernels: the same step in PyTorch ops, on any
    device. Writes cache row `pos` in place. -> (token int32 [1], h f32
    [1, H]) or, with return_logits, (token, h, logits f32 [V])."""
    H, NH, NKV, D = cfg.hidden_size, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    L, FF, eps = cfg.n_layers, cfg.intermediate_size, cfg.rms_norm_eps
    DQ, DKV, group = NH * D, NKV * D, NH // NKV
    scale = float(np.float32(1.0 / float(np.sqrt(D))))
    if token_or_x.dtype == torch.int32:
        x = pack["embd"][token_or_x.reshape(-1)[0].long()].float()
    else:
        x = token_or_x.reshape(H).float()
    x = _bf(x)
    for l in range(L):
        xq, sx = _quant_row(_bf(rms_norm_f32(x, pack["attn_norm"][l], eps)))
        qkv = _bf(_gemv_i4_ref(xq, sx, pack["qkv_q"][l], pack["qkv_s"][l]))
        rows = qkv.reshape(NH + 2 * NKV, D)
        q_all = rope_row(rms_norm_f32(rows[:NH], pack["q_norm"][l], eps), pos,
                         cfg.rope_theta) * scale
        k_all = rope_row(rms_norm_f32(rows[NH:NH + NKV], pack["k_norm"][l], eps),
                         pos, cfg.rope_theta)
        v_all = rows[NH + NKV:]
        kc = k[l, :pos].reshape(pos, NKV, D).float()
        vc = v[l, :pos].reshape(pos, NKV, D).float()
        ks, vs = k_s[l, :pos], v_s[l, :pos]             # [pos, NKV]
        heads = []
        for h in range(NKV):
            q = q_all[h * group:(h + 1) * group]        # [group, D]
            s_cache = (q @ kc[:, h].T) * ks[:, h][None, :]
            s_fresh = q @ k_all[h][:, None]             # [group, 1]
            m = torch.maximum(s_cache.amax(dim=1, keepdim=True), s_fresh)
            p_cache = torch.exp(s_cache - m)
            p_fresh = torch.exp(s_fresh - m)
            denom = p_cache.sum(dim=1, keepdim=True) + p_fresh
            o = (p_cache * vs[:, h][None, :]) @ vc[:, h]
            heads.append((o + p_fresh * v_all[h][None, :]) / denom)
        attn = _bf(torch.cat(heads, dim=0).reshape(DQ))
        for rows_f, cache, sc in ((k_all, k, k_s), (v_all, v, v_s)):
            s = torch.clamp(rows_f.abs().amax(dim=1) * INV127, min=1e-12)
            q8 = torch.clamp(torch.round(rows_f / s[:, None]), -127, 127)
            cache[l, pos] = q8.to(torch.int8).reshape(DKV)
            sc[l, pos] = s
        xq, sx = _quant_row(attn)
        h1 = _bf(x + _bf(_gemv_i4_ref(xq, sx, pack["wo_q"][l], pack["wo_s"][l])))
        xq, sx = _quant_row(_bf(rms_norm_f32(h1, pack["ffn_norm"][l], eps)))
        gu = _bf(_gemv_i4_ref(xq, sx, pack["gu_q"][l], pack["gu_s"][l]))
        g32, u32 = gu[:FF], gu[FF:]
        act = _bf((g32 * torch.sigmoid(g32)) * u32)
        xq, sx = _quant_row(act)
        x = _bf(h1 + _bf(_gemv_i4_ref(xq, sx, pack["wd_q"][l], pack["wd_s"][l])))
    xq, sx = _quant_row(_bf(rms_norm_f32(x, pack["out_norm"], eps)))
    logits = _gemv_i4_ref(xq, sx, pack["head_q"], pack["head_s"])[:cfg.vocab_size]
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
        "g_qkv", "g_wo", "g_gu", "g_wd", "g_head")] + [
        (n, ctypes.c_float) for n in ("eps", "rope_coef", "scale")]


def _dims(pack, cfg: DecoderConfig, S: int, pos: int) -> _Dims:
    H, D = cfg.hidden_size, cfg.head_dim
    DQ, FF = cfg.n_heads * D, cfg.intermediate_size
    return _Dims(
        L=cfg.n_layers, H=H, NH=cfg.n_heads, NKV=cfg.n_kv_heads, D=D, FF=FF,
        V=cfg.vocab_size, Vp=pack["head_q"].shape[1], S=S, pos=pos,
        g_qkv=_int4_group_for(H), g_wo=_int4_group_for(DQ),
        g_gu=_int4_group_for(H), g_wd=_int4_group_for(FF),
        g_head=_int4_group_for(H), eps=cfg.rms_norm_eps,
        rope_coef=rope_coef(cfg.rope_theta, D),
        scale=float(np.float32(1.0 / float(np.sqrt(D)))))


def _check_pack(pack, cfg: DecoderConfig, dev) -> None:
    H, D, L = cfg.hidden_size, cfg.head_dim, cfg.n_layers
    DQ, DKV, FF = cfg.n_heads * D, cfg.n_kv_heads * D, cfg.intermediate_size
    for name, n_in, n_out in (("qkv", H, DQ + 2 * DKV), ("wo", DQ, H),
                              ("gu", H, 2 * FF), ("wd", FF, H)):
        n_g = n_in // _int4_group_for(n_in)
        check(pack[f"{name}_q"], f"{name}_q", torch.uint8, (L, n_in // 2, n_out), dev)
        check(pack[f"{name}_s"], f"{name}_s", torch.float32, (L, n_g, n_out), dev)
    Vp = pack["head_q"].shape[1]
    check(pack["head_q"], "head_q", torch.uint8, (H // 2, Vp), dev)
    check(pack["head_s"], "head_s", torch.float32,
          (H // _int4_group_for(H), Vp), dev)
    for name, shape in (("attn_norm", (L, H)), ("ffn_norm", (L, H)),
                        ("q_norm", (L, D)), ("k_norm", (L, D)), ("out_norm", (H,))):
        check(pack[name], name, torch.float32, shape, dev)
    check(pack["embd"], "embd", torch.bfloat16, (cfg.vocab_size, H), dev)


class DecodeStep:
    """The CUDA decode step bound to one pack and one cache: validates the
    pack and the cache once, allocates the scratch once, and then launches
    a step per call. `mega_decode_step_i8` wraps it for single calls."""

    def __init__(self, pack, cfg: DecoderConfig, k, v, k_s, v_s):
        from qwen3_asr_tpu_torch.ops.build import kernel

        dev = k.device
        require_cuda(k, "k cache")
        L, S, DKV = k.shape
        _check_pack(pack, cfg, dev)
        NKV = cfg.n_kv_heads
        check(k, "k cache", torch.int8, (cfg.n_layers, S, NKV * cfg.head_dim), dev)
        check(v, "v cache", torch.int8, (cfg.n_layers, S, NKV * cfg.head_dim), dev)
        check(k_s, "k scales", torch.float32, (cfg.n_layers, S, NKV), dev)
        check(v_s, "v scales", torch.float32, (cfg.n_layers, S, NKV), dev)
        self.cfg, self.dev, self.S = cfg, dev, S
        self.pack, self.cache = pack, (k, v, k_s, v_s)
        self._fn = kernel("qw_mega_decode_step_i8",
                          [ctypes.POINTER(_Ptrs), ctypes.POINTER(_Dims),
                           ctypes.c_void_p])
        nbytes = kernel("qw_mega_scratch_bytes", [ctypes.POINTER(_Dims)],
                        ctypes.c_size_t)(ctypes.byref(_dims(pack, cfg, S, 1)))
        self.scratch = torch.empty(nbytes, dtype=torch.uint8, device=dev)
        self.h = torch.empty(1, cfg.hidden_size, dtype=torch.float32, device=dev)
        p = {n: pack[n].data_ptr() for n in (
            "embd", "attn_norm", "ffn_norm", "q_norm", "k_norm", "out_norm",
            "qkv_q", "qkv_s", "wo_q", "wo_s", "gu_q", "gu_s", "wd_q", "wd_s",
            "head_q", "head_s")}
        self.ptrs = _Ptrs(**p, k_cache=k.data_ptr(), v_cache=v.data_ptr(),
                          k_scale=k_s.data_ptr(), v_scale=v_s.data_ptr(),
                          h_out=self.h.data_ptr(),
                          scratch=self.scratch.data_ptr())

    def __call__(self, token_or_x: torch.Tensor, pos: int,
                 out: torch.Tensor) -> None:
        """One step: reads the int32 token (or bf16 [1, H] row) on the
        device, writes the next token into `out` (int32 [1] on the
        device) and the cache row `pos`."""
        if not 1 <= pos < self.S:
            raise ValueError(f"pos {pos} outside [1, {self.S})")
        if token_or_x.dtype == torch.int32:
            check(token_or_x, "token", torch.int32, (1,), self.dev)
            self.ptrs.token_in, self.ptrs.x_in = token_or_x.data_ptr(), None
        else:
            check(token_or_x, "x", torch.bfloat16, (1, self.cfg.hidden_size),
                  self.dev)
            self.ptrs.token_in, self.ptrs.x_in = None, token_or_x.data_ptr()
        check(out, "token out", torch.int32, (1,), self.dev)
        self.ptrs.token_out = out.data_ptr()
        dims = _dims(self.pack, self.cfg, self.S, pos)
        rc = self._fn(ctypes.byref(self.ptrs), ctypes.byref(dims),
                      stream_ptr(self.dev))
        raise_on_error(rc, "mega_decode_step_i8")
        mega_decode_step_i8.launches += 1


def mega_decode_step_i8(pack, cfg: DecoderConfig, token_or_x, pos: int,
                        k, v, k_s, v_s):
    """One greedy decode step, int4 weights and int8 KV. `token_or_x` is an
    int32 [1] token (its embedding row is gathered on the device) or a bf16
    [1, H] embedded row. Writes cache row `pos` in place. -> (next token
    int32 [1], h f32 [1, H], the hidden state before the final norm). CPU
    tensors take the twin; CUDA tensors launch the kernels or raise."""
    if k.device.type == "cpu":
        return mega_decode_step_i8_ref(pack, cfg, token_or_x, pos, k, v, k_s, v_s)
    step = DecodeStep(pack, cfg, k, v, k_s, v_s)
    out = torch.empty(1, dtype=torch.int32, device=k.device)
    step(token_or_x.to(k.device).contiguous(), pos, out)
    return out, step.h


mega_decode_step_i8.launches = 0
