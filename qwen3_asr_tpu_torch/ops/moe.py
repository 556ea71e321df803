"""The Qwen3-MoE feed-forward on int8 experts (Qwen3-Omni's thinker): the
router, the prefill's grouped expert products and the MoE decode step, the
CUDA kernels of `csrc/moe.cu` (and `pf_moe_combine` of
`csrc/prefill_fused.cu`) with their plain PyTorch twins.

They replace no TPU kernel: the JAX package has no mixture-of-experts
model. A layer's leaves, stacked on a leading layer axis L:

- `router` bf16 [L, H, E] ([in, out], as every matrix of the tree);
- `experts_gu` {"q": int8 [L, E, 2F, H], "s": f32 [L, E, 2F]}: each
  expert's gate rows, then its up rows, output-major (a row is one output
  channel's H input codes), with one scale an output channel;
- `experts_down` {"q": int8 [L, E, H, F], "s": f32 [L, E, H]}.

`quantize_experts` rounds [in, out] expert matrices to these leaves as
`quantize_pc_weights` rounds the dense ones. A prefill layer runs, on the
row codes xq / sx of RMSNorm(h1) that the layer's residual pass left:

  route          the router's logits (f32, sx * codes . router), softmax,
                 the top k, their weights renormalised over them;
                 the (row, expert) pairs sorted by expert, with each
                 expert's offset, all on the device
  moe_gate_up    per expert, its pairs' codes x its gate | up rows, the
                 bf16 SwiGLU rows
  norm_quant_rows  (F1, `ops/prefill_fused.py`, no norm) their codes
  moe_down       per expert, those codes x its down rows, dequantized and
                 weighted, into each pair's slot
  moe_combine    the residual: h1 + each row's K slots summed in order,
                 then the next layer's codes (F3's form)

A decode step (`MoeDecodeStep`, the C entry `qw_moe_decode_step_*`) runs,
a layer, `moe_attn_layer`: the attention half as one persistent launch
(the QKV product, attention, the Wo product, h1 and the FFN norm's row
codes, one block an SM, on output-major copies of the int8pc codes
streamed into shared memory; twin `moe_attn_layer_ref`); the router on
those codes (top-k on the device); the routed experts' gate-up and down
GEMVs; then K1's final norm, lm head and argmax; every token one CUDA
graph replay (`ops/megakernel.py::GraphStep`). The twins are plain torch in
the kernels' order of operations: integer dots exact (float64), the same
bf16 roundings and the same quantizer; only f32 sums of the router, the
norms and the softmax may differ in order. CPU tensors take the twin; CUDA
tensors launch the kernel (counted in `.launches`) or raise.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from qwen3_asr_tpu_torch.config import DecoderConfig
from qwen3_asr_tpu_torch.ops.decode_attention import rope_coef
from qwen3_asr_tpu_torch.ops.megakernel import (
    HEAD_PAD,
    DecodeStep,
    _attend_ref,
    _bf,
    _Dims,
    _embed_ref,
    _head_ref,
    _Ptrs,
    _quant_row,
)
from qwen3_asr_tpu_torch.ops.prefill_fused import _deq, codes_buffer, norm_quant_rows_ref
from qwen3_asr_tpu_torch.ops.q8_matmul import INV127, quantize_pc_weights, rms_norm_f32
from qwen3_asr_tpu_torch.ops.support import (
    check,
    full_f32,
    raise_on_error,
    require_cuda,
    stream_ptr,
)

BF16, F32, I32, I8 = torch.bfloat16, torch.float32, torch.int32, torch.int8
_PTR, _INT, _FLOAT = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def quantize_experts(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """float [..., in, out] expert matrices -> (int8 [..., out, in], f32
    [..., out]): `quantize_pc_weights`' codes and scales, output-major."""
    q, s = quantize_pc_weights(w)
    return q.transpose(-1, -2).contiguous(), s


def expert_leaves(gate: torch.Tensor, up: torch.Tensor, down: torch.Tensor
                  ) -> tuple[dict, dict]:
    """A layer's (or a stack's) experts gate, up [..., E, H, F] and down
    [..., E, F, H] -> the `experts_gu` and `experts_down` leaves."""
    q, s = quantize_experts(torch.cat([gate, up], dim=-1))
    dq, ds = quantize_experts(down)
    return {"q": q, "s": s}, {"q": dq, "s": ds}


# -- the router ------------------------------------------------------------------

def route(xq: torch.Tensor, sx: torch.Tensor, router: torch.Tensor, k: int
          ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The router of N rows from their codes xq [>= N, H] int8 and scales sx
    [N, 1] (router bf16 [H, E]) -> (wts f32 [N k], the pairs' weights, pair
    row * k + j for the row's j-th expert; order int32 [N k], the pairs
    sorted by expert; off int32 [E + 1], expert e's slots [off[e], off[e +
    1]) of the order). Logits sx * (codes . router) in f32, the softmax, the
    top k, their weights renormalised over them. On the card: the
    logits' product (bf16 codes, which hold int8 exactly, f32 sums) and one
    launch of `moe_route` (the top k, the weights, the counting sort; an
    expert's pairs in no fixed order, which no product depends on); no host
    wait."""
    if xq.device.type == "cpu":
        return route_ref(xq, sx, router, k)
    require_cuda(xq, "xq")
    from qwen3_asr_tpu_torch.ops.build import kernel

    N, E, dev = sx.shape[0], router.shape[1], xq.device
    check(sx, "sx", F32, (N, 1), dev)
    check(router, "router", BF16, (xq.shape[1], E), dev)
    logits = torch.mm(xq[:N].to(BF16), router, out_dtype=F32)
    wts = torch.empty(N * k, dtype=F32, device=dev)
    ids = torch.empty(N * k, dtype=I32, device=dev)
    order = torch.empty(N * k, dtype=I32, device=dev)
    off = torch.empty(E + 1, dtype=I32, device=dev)
    fn = kernel("qw_moe_route", [_PTR, _PTR] + [_INT] * 3 + [_PTR] * 5)
    rc = fn(logits.data_ptr(), sx.data_ptr(), N, E, k, wts.data_ptr(),
            ids.data_ptr(), order.data_ptr(), off.data_ptr(), stream_ptr(dev))
    raise_on_error(rc, "moe_route")
    route.launches += 1
    return wts, order, off


route.launches = 0


def route_ref(xq, sx, router, k: int):
    """Plain twin of `route` (the pairs of an expert in pair order)."""
    N, E = sx.shape[0], router.shape[1]
    with full_f32():
        logits = (xq[:N].float() @ router.float()) * sx
    top, ids = torch.topk(torch.softmax(logits, dim=-1), k, dim=-1)
    top = top / top.sum(dim=-1, keepdim=True)
    flat = ids.reshape(-1)
    order = torch.argsort(flat, stable=True).to(I32)
    counts = torch.zeros(E, dtype=I32, device=xq.device).scatter_add_(
        0, flat, torch.ones_like(flat, dtype=I32))
    off = torch.zeros(E + 1, dtype=I32, device=xq.device)
    off[1:] = torch.cumsum(counts, 0, dtype=I32)
    return top.reshape(-1).float(), order, off


def prefill_work(N: int, H: int, F: int, k: int, device) -> dict:
    """The grouped products' buffers for one prefill of N rows: the SwiGLU
    rows, their codes (a `codes_buffer`) and scales for the down product,
    the pairs' slots, and `stats` int32 [2]: the experts with a pair, summed
    over the layers, and the most pairs one expert took."""
    P = N * k
    return {"act": torch.empty(P, F, dtype=BF16, device=device),
            "fq": codes_buffer(P, F, device),
            "fs": torch.empty(P, 1, dtype=F32, device=device),
            "ys": torch.empty(P, H, dtype=F32, device=device),
            "stats": torch.zeros(2, dtype=I32, device=device)}


# -- the twins -------------------------------------------------------------------

def _dot(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Exact int8 a [n, in] x int8 w [out, in] -> int32 [n, out]."""
    return (a.double() @ w.double().T).to(I32)


def moe_gate_up_ref(xq, sx, order, off, q, s, k: int, work: dict):
    """Plain twin of `moe_gate_up`."""
    from qwen3_asr_tpu_torch.models.decoder import silu

    F = q.shape[1] // 2
    act = work["act"]
    rows = (order // k).long()
    bounds = off.tolist()
    for e in range(len(bounds) - 1):
        a, b = bounds[e], bounds[e + 1]
        if a == b:
            continue
        r = rows[a:b]
        g_u = _deq(_dot(xq[r], q[e]), sx[r], s[e])
        act[a:b] = silu(g_u[:, :F]) * g_u[:, F:]
        work["stats"][0] += 1
        work["stats"][1] = max(int(work["stats"][1]), b - a)
    return act


def moe_down_ref(fq, fs, order, off, wts, q, s, work: dict):
    """Plain twin of `moe_down`."""
    ys = work["ys"]
    bounds = off.tolist()
    for e in range(len(bounds) - 1):
        a, b = bounds[e], bounds[e + 1]
        if a == b:
            continue
        pairs = order[a:b].long()
        val = _deq(_dot(fq[a:b], q[e]), fs[a:b], s[e])
        ys[pairs] = wts[pairs, None] * val.float()
    return ys


def moe_combine_ref(res, ys, k: int, w, eps: float, codes, sx_out):
    """Plain twin of `moe_combine`."""
    N, H = res.shape
    t = ys[:N * k].reshape(N, k, H)
    acc = t[:, 0].clone()
    for j in range(1, k):
        acc = acc + t[:, j]
    h = res + acc.to(BF16)
    if w is not None:
        norm_quant_rows_ref(h, w, eps, codes, sx_out)
    return h


# -- the grouped products --------------------------------------------------------

def moe_gate_up(xq: torch.Tensor, sx: torch.Tensor, order: torch.Tensor, off: torch.Tensor,
                q: torch.Tensor, s: torch.Tensor, k: int, work: dict) -> torch.Tensor:
    """Every pair's gate | up product on its row's codes (xq [>= N, H] int8,
    sx [N, 1]) against its expert's rows q int8 [E, 2F, H] (scales s [E,
    2F]) -> its bf16 SwiGLU row, act [N k, F] in `order`'s slots (work's
    buffer, `prefill_work`); counts the layer into work["stats"]."""
    if xq.device.type == "cpu":
        return moe_gate_up_ref(xq, sx, order, off, q, s, k, work)
    require_cuda(xq, "xq")
    from qwen3_asr_tpu_torch.ops.build import kernel

    dev = xq.device
    E, N2, H = q.shape
    N, F = sx.shape[0], N2 // 2
    check(xq, "xq", I8, device=dev)
    if xq.dim() != 2 or xq.shape[0] < N or xq.shape[1] != H:
        raise ValueError(f"xq: expected int8 [>= {N}, {H}], got {tuple(xq.shape)}")
    check(sx, "sx", F32, (N, 1), dev)
    check(order, "order", I32, (N * k,), dev)
    check(off, "off", I32, (E + 1,), dev)
    check(q, "q", I8, (E, N2, H), dev)
    check(s, "s", F32, (E, N2), dev)
    act = work["act"]
    check(act, "act", BF16, (N * k, F), dev)
    fn = kernel("qw_moe_gate_up", [_PTR] * 6 + [_INT] * 4 + [_PTR] * 3)
    rc = fn(xq.data_ptr(), sx.data_ptr(), order.data_ptr(), off.data_ptr(), q.data_ptr(),
            s.data_ptr(), H, F, E, k, act.data_ptr(), work["stats"].data_ptr(),
            stream_ptr(dev))
    raise_on_error(rc, "moe_gate_up")
    moe_gate_up.launches += 1
    return act


moe_gate_up.launches = 0


def moe_down(fq: torch.Tensor, fs: torch.Tensor, order: torch.Tensor, off: torch.Tensor,
             wts: torch.Tensor, q: torch.Tensor, s: torch.Tensor, work: dict) -> torch.Tensor:
    """Every pair's down product on its codes (fq int8 [>= N k, F], fs [N k,
    1], slot order) against its expert's rows q int8 [E, H, F] (scales s [E,
    H]), dequantized to bf16 and weighted by wts [N k] -> ys f32 [N k, H] by
    pair (work's buffer)."""
    if fq.device.type == "cpu":
        return moe_down_ref(fq, fs, order, off, wts, q, s, work)
    require_cuda(fq, "fq")
    from qwen3_asr_tpu_torch.ops.build import kernel

    dev = fq.device
    E, H, F = q.shape
    P = order.shape[0]
    check(fq, "fq", I8, device=dev)
    if fq.dim() != 2 or fq.shape[0] < P or fq.shape[1] != F:
        raise ValueError(f"fq: expected int8 [>= {P}, {F}], got {tuple(fq.shape)}")
    check(fs, "fs", F32, (P, 1), dev)
    check(order, "order", I32, (P,), dev)
    check(off, "off", I32, (E + 1,), dev)
    check(wts, "wts", F32, (P,), dev)
    check(q, "q", I8, (E, H, F), dev)
    check(s, "s", F32, (E, H), dev)
    ys = work["ys"]
    check(ys, "ys", F32, (P, H), dev)
    fn = kernel("qw_moe_down", [_PTR] * 7 + [_INT] * 3 + [_PTR, _PTR])
    rc = fn(fq.data_ptr(), fs.data_ptr(), order.data_ptr(), off.data_ptr(), wts.data_ptr(),
            q.data_ptr(), s.data_ptr(), H, F, E, ys.data_ptr(), stream_ptr(dev))
    raise_on_error(rc, "moe_down")
    moe_down.launches += 1
    return ys


moe_down.launches = 0


def moe_combine(res: torch.Tensor, ys: torch.Tensor, k: int, w: torch.Tensor | None,
                eps: float, codes: torch.Tensor, sx_out: torch.Tensor) -> torch.Tensor:
    """res [N, H] bf16 + bf16(the sum of each row's k weighted expert
    outputs ys [N k, H] f32, in order) -> h [N, H] bf16; with w [H], the
    codes and row scales of rms_norm(h, w) into codes[:N] / sx_out [N, 1]."""
    if res.device.type == "cpu":
        return moe_combine_ref(res, ys, k, w, eps, codes, sx_out)
    require_cuda(res, "res")
    from qwen3_asr_tpu_torch.ops.build import kernel

    N, H = res.shape
    dev = res.device
    check(res, "res", BF16, device=dev)
    check(ys, "ys", F32, (N * k, H), dev)
    if w is not None:
        check(w, "w", BF16, (H,), dev)
        check(codes, "codes", I8, device=dev)
        check(sx_out, "sx", F32, (N, 1), dev)
    out = torch.empty_like(res)
    fn = kernel("qw_pf_moe_combine", [_PTR, _PTR, _INT, _PTR, _FLOAT, _FLOAT] + [_PTR] * 3
                + [_INT, _INT, _PTR])
    rc = fn(res.data_ptr(), ys.data_ptr(), k, None if w is None else w.data_ptr(), float(eps),
            INV127, out.data_ptr(), codes.data_ptr(), sx_out.data_ptr(), N, H, stream_ptr(dev))
    raise_on_error(rc, "moe_combine")
    moe_combine.launches += 1
    return out


moe_combine.launches = 0


# -- the decode step -------------------------------------------------------------

def pack_moe_params(dec_params: dict, cfg: DecoderConfig) -> dict:
    """The MoE decode step's inputs from a fused int8pc MoE decoder tree:
    the attention's int8pc codes and scales as they are, the lm head's
    (`lm_head_pc`, its vocab zero-padded to HEAD_PAD), f32 norms, the bf16
    embedding, the router and the experts' leaves; and output-major copies
    of the QKV and Wo codes (`qkv_t`, `wo_t`), which the step's GEMVs read."""
    layers = dec_params["layers"]
    if not (isinstance(layers.get("wqkv"), dict) and "i8pc:q" in layers["wqkv"]
            and "lm_head_pc" in dec_params and "experts_gu" in layers):
        raise ValueError("the MoE decode step needs the fused int8pc layout with "
                         "int8 experts (quantize_decoder_params('int8pc') + "
                         "fuse_decoder_params)")
    f32 = torch.float32
    pack = {"qkv_q": layers["wqkv"]["i8pc:q"].contiguous(),
            "qkv_s": layers["wqkv"]["i8pc:s"].to(f32).contiguous(),
            "wo_q": layers["wo"]["i8pc:q"].contiguous(),
            "wo_s": layers["wo"]["i8pc:s"].to(f32).contiguous()}
    # the step's GEMVs read a row of output channels at a time
    pack["qkv_t"] = pack["qkv_q"].transpose(1, 2).contiguous()
    pack["wo_t"] = pack["wo_q"].transpose(1, 2).contiguous()
    hq = dec_params["lm_head_pc"]["i8pc:q"]
    hs = dec_params["lm_head_pc"]["i8pc:s"].to(f32)
    pad = -(-hq.shape[1] // HEAD_PAD) * HEAD_PAD - hq.shape[1]
    pack["head_q"] = torch.nn.functional.pad(hq, (0, pad)).contiguous() if pad else hq
    pack["head_s"] = torch.nn.functional.pad(hs, (0, pad)).contiguous() if pad else hs
    for name in ("attn_norm", "ffn_norm", "q_norm", "k_norm"):
        pack[name] = layers[name].to(f32).contiguous()
    pack["out_norm"] = dec_params["output_norm"].to(f32).contiguous()
    pack["embd"] = dec_params["token_embd"].to(BF16)
    pack["router"] = layers["router"].to(BF16).contiguous()
    for name, key in (("gu", "experts_gu"), ("dn", "experts_down")):
        pack[f"{name}_q"] = layers[key]["q"].contiguous()
        pack[f"{name}_s"] = layers[key]["s"].to(f32).contiguous()
    return pack


def router_ref(xq: torch.Tensor, sx, router: torch.Tensor, k: int):
    """The decode step's router on one row's codes xq [H] (scale sx):
    logits sx * (codes . router) in f32, the top k by logit (desc), weights
    exp(l - max) over their sum. -> (ids, wts)."""
    logits = (xq.double() @ router.double()).float() * sx
    vals, ids = torch.topk(logits, k)
    ex = torch.exp(vals - vals[0])
    return ids, ex / ex.sum()


def moe_attn_layer_ref(pack, cfg: DecoderConfig, l: int, x, pos: int, k, v, k_s=None,
                       v_s=None):
    """Plain twin of `moe_attn_layer`, layer l's attention half on the row
    x (f32 [H] of bf16 values), phase by phase on the output-major copies
    the kernel reads: the attention norm's codes and the QKV terms (f32(dot)
    * (sx * s)), attention at pos (its fresh K/V row written at row pos),
    the attention row's codes and the Wo terms, h1 = bf16(x + bf16(wo)) and
    the FFN norm's codes. -> (h1 f32 [H], xq int8 [H], sx f32 scalar, the
    cache row at pos: (k, v) or, with scales, (k, v, k_s, v_s))."""
    eps = cfg.rms_norm_eps
    xq, sx = _quant_row(_bf(rms_norm_f32(x, pack["attn_norm"][l], eps)))
    qkv = _bf(_dot(xq[None], pack["qkv_t"][l])[0].float() * (sx * pack["qkv_s"][l]))
    aq, asx = _quant_row(_attend_ref(pack, cfg, l, qkv, pos, k, v, k_s, v_s))
    wo = _dot(aq[None], pack["wo_t"][l])[0].float() * (asx * pack["wo_s"][l])
    h1 = _bf(x + _bf(wo))
    xq, sx = _quant_row(_bf(rms_norm_f32(h1, pack["ffn_norm"][l], eps)))
    row = (k[l, pos], v[l, pos]) if k_s is None else (k[l, pos], v[l, pos], k_s[l, pos],
                                                      v_s[l, pos])
    return h1, xq, sx, row


def moe_decode_step_ref(pack, cfg: DecoderConfig, token_or_x, pos: int, k, v,
                        k_s=None, v_s=None, return_logits: bool = False):
    """Plain twin of the MoE decode step over an int8 (k_s, v_s given) or a
    bf16 cache: per layer the attention half (`moe_attn_layer_ref`), the
    router and the k routed experts: gate-up terms f32(dot) * (sx * s), the
    SwiGLU row bf16(silu(bf16 g) * bf16 u) and its codes, the down terms
    weighted, summed over the experts in order into the residual; K1's
    twin's head. Writes cache row `pos`. -> (token int32 [1], h f32 [1, H])
    or, with return_logits, (token, h, logits f32 [V])."""
    F, K = cfg.moe_intermediate_size, cfg.n_experts_per_tok
    x = _embed_ref(pack, cfg, token_or_x)
    for l in range(cfg.n_layers):
        h1, xq, sx, _ = moe_attn_layer_ref(pack, cfg, l, x, pos, k, v, k_s, v_s)
        ids, wts = router_ref(xq, sx, pack["router"][l], K)
        moe = None
        for j, e in enumerate(ids.tolist()):
            gu = (xq.double() @ pack["gu_q"][l, e].double().T).float() * (sx * pack["gu_s"][l, e])
            g, u = _bf(gu[:F]), _bf(gu[F:])
            aq, asx = _quant_row(_bf((g * (1.0 / (1.0 + torch.exp(-g)))) * u))
            dn = (aq.double() @ pack["dn_q"][l, e].double().T).float() * (asx * pack["dn_s"][l, e])
            term = wts[j] * _bf(dn)
            moe = term if moe is None else moe + term
        x = _bf(h1 + _bf(moe))
    return _head_ref(pack, cfg, x, return_logits)


class _MoePtrs(ctypes.Structure):
    _fields_ = [(n, ctypes.c_void_p) for n in (
        "qkv_t", "wo_t", "router", "gu_q", "gu_s", "dn_q", "dn_s", "part", "ids", "wts", "cnt", "slices",
        "tcnt", "acnt", "gu_terms", "bar", "done")]


class _MoeDims(ctypes.Structure):
    _fields_ = [(n, ctypes.c_int) for n in ("E", "K")]


def _check_moe_pack(pack, cfg: DecoderConfig, dev) -> None:
    H, D, L = cfg.hidden_size, cfg.head_dim, cfg.n_layers
    DQ, DKV = cfg.n_heads * D, cfg.n_kv_heads * D
    E, F = cfg.n_experts, cfg.moe_intermediate_size
    for name, dtype, shape in (
            ("qkv_t", I8, (L, DQ + 2 * DKV, H)), ("qkv_s", F32, (L, DQ + 2 * DKV)),
            ("wo_t", I8, (L, H, DQ)), ("wo_s", F32, (L, H)),
            ("head_q", I8, (H, pack["head_q"].shape[1])), ("head_s", F32, (pack["head_q"].shape[1],)),
            ("attn_norm", F32, (L, H)), ("ffn_norm", F32, (L, H)), ("q_norm", F32, (L, D)),
            ("k_norm", F32, (L, D)), ("out_norm", F32, (H,)), ("embd", BF16, (cfg.vocab_size, H)),
            ("router", BF16, (L, H, E)), ("gu_q", I8, (L, E, 2 * F, H)), ("gu_s", F32, (L, E, 2 * F)),
            ("dn_q", I8, (L, E, H, F)), ("dn_s", F32, (L, E, H))):
        check(pack[name], name, dtype, shape, dev)


ROUTER_SLICE = 256   # input rows a router block of the step sums (csrc/moe.cu)
_MOE_ENTRIES = {torch.int8: "qw_moe_decode_step_i8", torch.bfloat16: "qw_moe_decode_step"}


def step_kernels(n_layers: int) -> int:
    """Kernel launches of one MoE step: per layer the attention half
    (`moe_attn_layer`), the router and the two expert GEMVs; then the final
    norm, the lm head and the two argmax passes (the scratch memset is no
    kernel)."""
    return 4 * n_layers + 4


class MoeDecodeStep(DecodeStep):
    """The CUDA MoE decode step bound to one pack (`pack_moe_params`) and one
    int8 (with scales) or bf16 cache [L, S, n_kv * head_dim], as
    `DecodeStep` binds K1's: its checks, scratch and device position once,
    then a step a call (`qw_moe_decode_step_i8` / `qw_moe_decode_step`),
    capturable in a CUDA graph (`GraphStep`). `attn_blocks`: the grid of the
    persistent attention launch, one block an SM, every block resident (a
    cooperative launch; the constructor raises where a block does not
    fit)."""

    def __init__(self, pack, cfg: DecoderConfig, k, v, k_s=None, v_s=None):
        from qwen3_asr_tpu_torch.ops.build import kernel

        dev = k.device
        require_cuda(k, "k cache")
        _check_moe_pack(pack, cfg, dev)
        if k.dtype not in _MOE_ENTRIES:
            raise TypeError(f"the MoE step takes an int8 or a bf16 KV cache, got {k.dtype}")
        L, NKV, D, H = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim, cfg.hidden_size
        S = k.shape[1]
        check(k, "k cache", k.dtype, (L, S, NKV * D), dev)
        check(v, "v cache", k.dtype, (L, S, NKV * D), dev)
        if k.dtype == torch.int8:
            if k_s is None or v_s is None:
                raise ValueError("an int8 cache needs its scales")
            check(k_s, "k scales", F32, (L, S, NKV), dev)
            check(v_s, "v scales", F32, (L, S, NKV), dev)
        elif k_s is not None or v_s is not None:
            raise ValueError("a bf16 cache takes no scales")
        self.cfg, self.dev, self.S = cfg, dev, S
        self.pack, self.cache = pack, (k, v, k_s, v_s)
        self.counter = moe_decode_step
        self._fn = kernel(_MOE_ENTRIES[k.dtype],
                          [ctypes.POINTER(_Ptrs), ctypes.POINTER(_Dims),
                           ctypes.POINTER(_MoePtrs), ctypes.POINTER(_MoeDims),
                           ctypes.c_void_p, ctypes.c_void_p])
        DQ, F, E, K = cfg.n_heads * D, cfg.moe_intermediate_size, cfg.n_experts, cfg.n_experts_per_tok
        self.dims = _Dims(
            L=L, H=H, NH=cfg.n_heads, NKV=NKV, D=D, FF=F, V=cfg.vocab_size,
            Vp=pack["head_q"].shape[1], S=S, pos=S - 1, g_qkv=H, g_wo=DQ, g_gu=H, g_wd=F,
            g_head=H, wbits=8, pdl=0, eps=cfg.rms_norm_eps,
            rope_coef=rope_coef(cfg.rope_theta, D),
            scale=float(np.float32(1.0 / float(np.sqrt(D)))))
        nbytes = kernel("qw_mega_scratch_bytes", [ctypes.POINTER(_Dims)],
                        ctypes.c_size_t)(ctypes.byref(self.dims))
        self.scratch = torch.empty(nbytes, dtype=torch.uint8, device=dev)
        self.h = torch.empty(1, H, dtype=F32, device=dev)
        self.pos = torch.ones(1, dtype=I32, device=dev)
        self.part = torch.empty(-(-H // ROUTER_SLICE) * E, dtype=F32, device=dev)
        self.ids = torch.zeros(K, dtype=I32, device=dev)
        self.wts = torch.zeros(K, dtype=F32, device=dev)
        self.cnt = torch.zeros(1, dtype=I32, device=dev)
        self.slices = torch.empty(K * H, dtype=F32, device=dev)
        self.tcnt = torch.zeros(-(-H // 32), dtype=I32, device=dev)
        self.acnt = torch.zeros(cfg.n_heads, dtype=I32, device=dev)
        self.gu_terms = torch.empty(K * 2 * F, dtype=F32, device=dev)
        self.done = torch.zeros(1, dtype=I32, device=dev)
        blocks = ctypes.c_int(0)
        grid = kernel("qw_moe_attn_blocks",
                      [ctypes.POINTER(_Dims), _INT, ctypes.POINTER(ctypes.c_int)])
        raise_on_error(grid(ctypes.byref(self.dims), int(k.dtype == torch.int8),
                            ctypes.byref(blocks)), "moe_attn_layer's grid")
        self.attn_blocks = blocks.value
        self.bar = torch.zeros(1, dtype=I32, device=dev)
        p = {n: pack[n].data_ptr() for n in (
            "embd", "attn_norm", "ffn_norm", "q_norm", "k_norm", "out_norm",
            "qkv_q", "qkv_s", "wo_q", "wo_s", "head_q", "head_s")}
        self.ptrs = _Ptrs(**p, k_cache=k.data_ptr(), v_cache=v.data_ptr(),
                          k_scale=None if k_s is None else k_s.data_ptr(),
                          v_scale=None if v_s is None else v_s.data_ptr(),
                          h_out=self.h.data_ptr(), scratch=self.scratch.data_ptr())
        self.moe_ptrs = _MoePtrs(
            **{n: pack[n].data_ptr() for n in ("qkv_t", "wo_t", "router", "gu_q", "gu_s",
                                               "dn_q", "dn_s")},
            part=self.part.data_ptr(), ids=self.ids.data_ptr(), wts=self.wts.data_ptr(),
            cnt=self.cnt.data_ptr(), slices=self.slices.data_ptr(), tcnt=self.tcnt.data_ptr(),
            acnt=self.acnt.data_ptr(), gu_terms=self.gu_terms.data_ptr(),
            bar=self.bar.data_ptr(), done=self.done.data_ptr())
        self.moe_dims = _MoeDims(E=E, K=K)

    def _launch(self, pos: torch.Tensor) -> int:
        return self._fn(ctypes.byref(self.ptrs), ctypes.byref(self.dims),
                        ctypes.byref(self.moe_ptrs), ctypes.byref(self.moe_dims),
                        ctypes.c_void_p(pos.data_ptr()), stream_ptr(self.dev))


def moe_decode_step(pack, cfg: DecoderConfig, token_or_x, pos: int, k, v, k_s=None,
                    v_s=None):
    """One greedy MoE decode step (an int32 [1] token or a bf16 [1, H] row
    at position pos; cache row pos written). -> (next token int32 [1], h
    f32 [1, H], the hidden state before the final norm). CPU tensors take
    the twin; CUDA tensors launch the step or raise."""
    if k.device.type == "cpu":
        return moe_decode_step_ref(pack, cfg, token_or_x, pos, k, v, k_s, v_s)
    step = MoeDecodeStep(pack, cfg, k, v, k_s, v_s)
    out = torch.empty(1, dtype=I32, device=k.device)
    step(token_or_x.to(k.device).contiguous(), pos, out)
    return out, step.h


moe_decode_step.launches = 0
