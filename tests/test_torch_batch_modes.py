"""Batches in every weight and cache mode, against the JAX package at the
tiny config: the batched decode-attention twin (K4 batched) against the
JAX kernel under `jax.vmap`, the per-layer decode step at B rows and its
XLA-attention variant (`use_decode_attn_kernel=False`) single and batched,
`transcribe_batch` without a decode pack against the JAX package's
`batched_transcribe_step` (its vmapped XLA step), and with the decode pack
over a bf16 cache (K3's bf16 mode) against the JAX megakernel in
interpret mode row by row. The CUDA kernels against one-row launches and
K1: tests/test_torch_cuda.py.

Tolerances, each with its reason:
- K4 batched twin vs the vmapped Pallas kernel: rtol 1e-4, atol 1e-5 x the
  output's scale, as tests/test_torch_decode_attention.py (the same f32
  math, summed in another order); each row equal to the one-row twin on
  its slab (the same function);
- one step of the per-layer path, port vs JAX (XLA attention) and the
  batched step vs the single step on each row: h relative L2 < 1e-2 and
  the fresh cache rows relative L2 < 1e-2 (bf16 activations; the JAX CPU
  program's excess precision and the B-row products' other f32 sums move
  last bits, as in tests/test_torch_batch.py's prefill);
- transcribe_batch tokens and n_kept: equal, free-running and with an EOS
  that stops the rows at different steps (the decoder's matrices drawn
  GAIN times wider, seed 7: no near tie on these inputs, as in
  tests/test_torch_batch.py);
- every other mode (int4 / int8pc / auto weights x the three caches): a
  batch runs and each row gives max_tokens in-range tokens (EOS off).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qwen3_asr_tpu.models import decoder as jdec
from qwen3_asr_tpu.ops.decode_attention import decode_attention as jax_da
from qwen3_asr_tpu.parallel.mesh import batched_transcribe_step
from qwen3_asr_tpu.pipeline import asr as jasr_mod
from qwen3_asr_tpu.text.prompt import audio_start_pos, build_asr_prompt
from qwen3_asr_tpu_torch.models import decoder as tdec
from qwen3_asr_tpu_torch.ops import decode_attention as tda
from qwen3_asr_tpu_torch.pipeline.asr import Qwen3ASR, TranscribeParams

from test_torch_auto import dense_tree, port_model
from test_torch_batch import AUDIO
from test_torch_q8_e2e import jax_and_port

MAX_TOKENS = 8
NH, NKV, D, S = 4, 2, 128, 96
OFFSETS = (0, 17, 64, 95)
REL = 1e-2


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _t(a):
    """A JAX array as a torch tensor (bf16 travels as f32, exactly)."""
    if a.dtype == jnp.bfloat16:
        return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("quant", [False, True])
def test_decode_attention_batch_twin_matches_vmapped_pallas(quant):
    rng = np.random.default_rng(11 + quant)
    B = len(OFFSETS)
    qkv = jnp.asarray(rng.standard_normal((B, 1, (NH + 2 * NKV) * D)), jnp.bfloat16)
    k = (rng.standard_normal((B, S, NKV, D)) * 0.8).astype(np.float32)
    v = rng.standard_normal((B, S, NKV, D)).astype(np.float32)
    qn = jnp.asarray(1 + 0.1 * rng.standard_normal(D), jnp.bfloat16)
    kn = jnp.asarray(1 + 0.1 * rng.standard_normal(D), jnp.bfloat16)
    offsets = np.array(OFFSETS, np.int32)
    pos = offsets + np.array([0, 3, 0, 0], np.int32)   # one row ropes past its offset
    kw = dict(n_heads=NH, n_kv=NKV, head_dim=D, eps=1e-6, theta=1e6, scale=1 / np.sqrt(D))
    if quant:
        (kq, ks), (vq, vs) = jdec._quantize_kv_rows(jnp.asarray(k)), \
            jdec._quantize_kv_rows(jnp.asarray(v))
        jk, jv, jsc = kq, vq, (ks, vs)
    else:
        jk, jv, jsc = jnp.asarray(k, jnp.bfloat16), jnp.asarray(v, jnp.bfloat16), None

    def one(q, kc, vc, o, p, *sc):
        extra = dict(k_scale=sc[0], v_scale=sc[1]) if sc else {}
        return jax_da(q, kc, vc, qn, kn, o, p, interpret=True, **kw, **extra)

    want = jax.vmap(one)(qkv, jk, jv, jnp.asarray(offsets), jnp.asarray(pos),
                         *(jsc or ()))
    tsc = dict(k_scale=_t(jsc[0]), v_scale=_t(jsc[1])) if quant else {}
    targs = (_t(qkv)[:, 0], _t(jk), _t(jv), _t(qn), _t(kn))
    got = tda.decode_attention_batch(*targs, torch.from_numpy(offsets),
                                     torch.from_numpy(pos), int(offsets.max()), **kw, **tsc)
    for g, w, name in zip(got, want, ("attn", "k_new", "v_new")):
        w = np.asarray(w, np.float32).reshape(g.shape)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4,
                                   atol=1e-5 * float(np.abs(w).max()), err_msg=name)
    for b in range(B):   # row b is the one-row call on slab b
        rs = {n: t[b] for n, t in tsc.items()}
        single = tda.decode_attention(targs[0][b:b + 1], targs[1][b], targs[2][b],
                                      targs[3], targs[4], int(offsets[b]), int(pos[b]),
                                      **kw, **rs)
        for g, s in zip(got, single):
            assert torch.equal(g[b:b + 1], s), b


POS = (5, 12, 9)   # the rows' positions in the step tests (cache rows < pos filled)
STEP_S = 16


def _step_setup(quantize, kv_cache, seed=7):
    """(JAX decoder tree, its config, the port's decoder, its config, JAX
    caches per row, the rows' inputs [B, H] bf16) at the tiny config."""
    j, t = jax_and_port(quantize, kv_cache, seed=seed)
    jd, jcfg = j.params["decoder"], j.cfg.decoder
    rng = np.random.default_rng(seed)
    caches = []
    for p in POS:
        c = jdec.init_kv_cache(jcfg, STEP_S, jnp.int8 if kv_cache == "int8" else jnp.bfloat16)
        rows = {n: jnp.asarray(rng.standard_normal(
            (jcfg.n_layers, p, jcfg.n_kv_heads, jcfg.head_dim)) * 0.5, jnp.bfloat16)
            for n in ("k", "v")}
        for n in ("k", "v"):
            if kv_cache == "int8":
                q, s = jdec._quantize_kv_rows(rows[n])
                c[n] = c[n].at[:, :p].set(q)
                c[n + "_s"] = c[n + "_s"].at[:, :p].set(s)
            else:
                c[n] = c[n].at[:, :p].set(rows[n])
        caches.append(c)
    x = jnp.asarray(rng.standard_normal((len(POS), jcfg.hidden_size)) * 0.5, jnp.bfloat16)
    return jd, jcfg, t.params["decoder"], t.cfg.decoder, caches, x


def _jax_step(jd, jcfg, x, cache, p):
    return jdec.decoder_forward(jd, jcfg, x[None], jnp.asarray([p], jnp.int32), cache,
                                cache_offset=p, kv_valid_len=p + 1)


def _port_batch_cache(caches):
    """The rows' JAX caches as the port's batched cache [B, L, S, ...], K / V
    rows flattened to n_kv * head_dim."""
    return {n: torch.stack([_t(c[n]).flatten(2) for c in caches]) for n in caches[0]}


STEP_MODES = [("q8_0", "bf16"), ("q8_0", "int8"), (False, "bf16")]


@pytest.mark.parametrize("dak", [True, False])
@pytest.mark.parametrize("quantize,kv_cache", STEP_MODES)
def test_decode_step_batch_matches_jax(quantize, kv_cache, dak):
    """One step of B rows at their own positions, the batched step (dak:
    K4 batched's twin; else the XLA attention row by row) and the single
    step on each row (decoder_forward at T = 1), against the JAX step on
    each row's cache (the XLA attention: the JAX CPU program's only
    decode attention)."""
    jd, jcfg, td, tcfg, caches, x = _step_setup(quantize, kv_cache)
    tcfg = dataclasses.replace(tcfg, use_decode_attn_kernel=dak)
    want = [_jax_step(jd, jcfg, x[b], caches[b], p) for b, p in enumerate(POS)]
    batch = _port_batch_cache(caches)
    pos = torch.tensor(POS, dtype=torch.int32)
    h = tdec.decode_step_batch(td, tcfg, _t(x), batch, pos, POS)
    for b, p in enumerate(POS):
        hw, cw = want[b]
        single = {n: _t(c) for n, c in caches[b].items()}
        hs = tdec.decoder_forward(td, tcfg, _t(x)[b:b + 1], single, p + 1, prefill=False,
                                  cache_offset=p)
        assert _rel(h[b].float(), hw[0]) < REL, (b, _rel(h[b].float(), hw[0]))
        assert _rel(hs[0].float(), hw[0]) < REL, b
        for n in ("k", "v"):
            w_row = np.asarray(cw[n][:, p], np.float32)                # [L, n_kv, D]
            got = batch[n][b, :, p].float().unflatten(-1, w_row.shape[1:])
            if kv_cache == "int8":
                w_row = w_row * np.asarray(cw[n + "_s"][:, p])[..., None]
                got = got * batch[n + "_s"][b, :, p, :, None]
            assert _rel(got, w_row) < REL, (b, n)
            # rows other than p untouched
            assert torch.equal(batch[n][b, :, :p], single[n][:, :p].flatten(2))
            assert not batch[n][b, :, p + 1:].any()


def _jax_batch(j, audios, cache_dtype):
    """The JAX package's batched_transcribe_step on the CPU (the vmapped XLA
    step without a decode pack), as its transcribe_batch calls it."""
    dcfg = j.cfg.decoder
    feats = jasr_mod.frontend_feats_batch(j, audios, 0)
    prompts = [build_asr_prompt(f[1], dcfg) for f in feats]
    P = -(-max(len(p) for p in prompts) // 128) * 128
    B = len(audios)
    toks = np.full((B, P), dcfg.pad_token_id, np.int32)
    for b, p in enumerate(prompts):
        toks[b, :len(p)] = p
    cap = max(int(f[0].shape[0]) for f in feats)
    audio = jnp.zeros((B, cap, dcfg.hidden_size), jnp.bfloat16)
    for b, f in enumerate(feats):
        audio = audio.at[b, :f[0].shape[0]].set(f[0].astype(jnp.bfloat16))
    out, nk = batched_transcribe_step(
        j.params["decoder"], dcfg, jnp.asarray(toks),
        jnp.asarray([len(p) for p in prompts], jnp.int32), audio,
        jnp.asarray([f[1] for f in feats], jnp.int32), audio_start_pos(prompts[0], dcfg),
        MAX_TOKENS, cache_dtype=cache_dtype)
    return np.asarray(out), np.asarray(nk)


def _with_eos(model, eos):
    model.cfg = dataclasses.replace(model.cfg, decoder=dataclasses.replace(
        model.cfg.decoder, eos_token_id=eos))


@pytest.mark.parametrize("quantize,kv_cache", STEP_MODES)
def test_transcribe_batch_matches_jax(quantize, kv_cache):
    """Without a decode pack: tokens and n_kept equal to the JAX package's
    batched_transcribe_step, free-running and with an EOS that the rows
    first emit at different steps."""
    j, t = jax_and_port(quantize, kv_cache)
    jdt = jnp.int8 if kv_cache == "int8" else jnp.bfloat16
    params = TranscribeParams(max_tokens=MAX_TOKENS)
    out_j, nk_j = _jax_batch(j, AUDIO, jdt)
    got = t.transcribe_batch(AUDIO, params)
    assert all(r.success for r in got)
    assert [r.tokens for r in got] == [[int(x) for x in o] for o in out_j]
    assert (nk_j == MAX_TOKENS).all() and len({tuple(o) for o in out_j}) > 1

    def first(e):
        return [int(np.flatnonzero(r == e)[0]) if (r == e).any() else MAX_TOKENS
                for r in out_j]

    eos = next(int(e) for e in out_j.reshape(-1)
               if min(first(e)) >= 1 and len(set(first(e))) > 1)
    _with_eos(j, eos)
    _with_eos(t, eos)
    out_j, nk_j = _jax_batch(j, AUDIO, jdt)
    got = t.transcribe_batch(AUDIO, params)
    assert [len(r.tokens) for r in got] == nk_j.tolist() == first(eos)
    assert [r.tokens for r in got] == [[int(x) for x in o[:n]] for o, n in zip(out_j, nk_j)]


def test_transcribe_batch_auto_bf16_matches_jax_megakernel():
    """quantize="auto" over a bf16 cache (K3's bf16 mode, its twin here):
    each row's tokens equal the JAX single-sequence megakernel's (bf16
    cache, interpret mode) on that utterance; the JAX package batches this
    mode on its XLA step, whose rows the megakernel's equal."""
    from qwen3_asr_tpu.models.generate import generate_greedy
    from qwen3_asr_tpu.ops.megakernel import pack_megakernel_params
    from qwen3_asr_tpu.runtime import params as jparams

    cfg, dense = dense_tree()
    t = port_model(cfg, dense, quantize="auto", kv_cache="bf16")
    assert "mega" in t.params["decoder"] and t.cache_dtype == torch.bfloat16
    dec = jax.tree.map(np.asarray, jparams.fuse_decoder_params(
        jparams.quantize_decoder_params(dense["decoder"], "int8pc")))
    dec["mega"] = pack_megakernel_params(dec, cfg.decoder, int4=False)
    got = t.transcribe_batch(AUDIO, TranscribeParams(max_tokens=MAX_TOKENS))
    want = []
    for samples in AUDIO:
        feats = _jax_feats(dense, cfg, samples)
        prompt = build_asr_prompt(int(feats.shape[0]), cfg.decoder)
        toks = np.full(-(-len(prompt) // 128) * 128, cfg.decoder.pad_token_id, np.int32)
        toks[:len(prompt)] = prompt
        out, n_kept = generate_greedy(
            dec, cfg.decoder, jnp.asarray(toks), jnp.int32(len(prompt)), feats,
            jnp.int32(feats.shape[0]), audio_start_pos(prompt, cfg.decoder), MAX_TOKENS,
            cache_dtype=jnp.bfloat16, _force_mega_interpret=True)
        want.append([int(x) for x in np.asarray(out)[:int(n_kept)]])
    assert [r.tokens for r in got] == want
    assert len({tuple(w) for w in want}) > 1


def _jax_feats(dense, cfg, samples):
    from qwen3_asr_tpu.audio.mel import _mel_device, filters_t_device
    from qwen3_asr_tpu.models.encoder import _encode_jit
    from qwen3_asr_tpu_torch.audio.mel import generate_mel_filters
    from qwen3_asr_tpu_torch.models.e2e import _pad_pcm

    buf, n_frames = _pad_pcm(samples)
    mel = _mel_device(jnp.asarray(buf), filters_t_device(generate_mel_filters()), n_frames).T
    return _encode_jit(dense["encoder"], cfg.encoder, mel, n_frames)


@pytest.mark.parametrize("kv_cache", ["bf16", "int8", "int4"])
@pytest.mark.parametrize("quantize", ["auto", "int8pc", "int4", "q8_0", "none"])
def test_transcribe_batch_runs_in_every_mode(quantize, kv_cache):
    """Every mode Qwen3ASR offers batches: each row max_tokens in-range
    tokens, EOS off."""
    from qwen3_asr_tpu_torch.config import tiny_asr_config as port_tiny

    t = Qwen3ASR(quantize=False if quantize == "none" else quantize, kv_cache=kv_cache,
                 device="cpu")
    t.load_random(port_tiny(), seed=2)
    _with_eos(t, -1)
    res = t.transcribe_batch(AUDIO[:2], TranscribeParams(max_tokens=4))
    V = t.cfg.decoder.vocab_size
    assert all(r.success and len(r.tokens) == 4 and all(0 <= x < V for x in r.tokens)
               for r in res)
    assert ("mega" in t.params["decoder"]) == (quantize in ("auto", "int8pc", "int4"))


def test_server_closed_batch_without_a_pack_is_one_transcribe_batch():
    """ASRServer on a q8_0 model (no decode pack, its int8 cache): two
    requests in one closed batch run as one transcribe_batch, none through
    transcribe, and get transcribe_batch's tokens."""
    from qwen3_asr_tpu_torch.config import tiny_asr_config as port_tiny
    from qwen3_asr_tpu_torch.serve import ASRServer

    t = Qwen3ASR(quantize="q8_0", kv_cache="int8", device="cpu")
    t.load_random(port_tiny(), seed=4)
    _with_eos(t, -1)
    params = TranscribeParams(max_tokens=3, print_timing=False)
    calls = []
    batch, single = t.transcribe_batch, t.transcribe
    t.transcribe_batch = lambda audios, p: calls.append(len(audios)) or batch(audios, p)
    t.transcribe = lambda *a, **k: calls.append("transcribe") or single(*a, **k)
    srv = ASRServer(t, params, max_batch=2, max_wait_ms=2000)
    try:
        got = [f.result(timeout=300) for f in [srv.submit(a) for a in AUDIO[:2]]]
    finally:
        srv.close()
    assert calls == [2]
    assert [g.tokens for g in got] == [r.tokens for r in batch(AUDIO[:2], params)]


@pytest.mark.parametrize("quantize,kv_cache", STEP_MODES)
def test_decode_step_batch_rejects_a_row_at_S(quantize, kv_cache):
    """decode_step_batch stores each row's fresh K/V at its position, in the
    kernel's launch: a row at position S (no such cache row) raises in the
    first layer's attention call, before anything is stored."""
    _, _, td, tcfg, caches, x = _step_setup(quantize, kv_cache, seed=5)
    cache = _port_batch_cache(caches)
    before = {n: t.clone() for n, t in cache.items()}
    S = cache["k"].shape[2]
    pos = (5, S, 9)
    with pytest.raises(ValueError, match="store=True"):
        tdec.decode_step_batch(td, tcfg, _t(x), cache,
                               torch.tensor(pos, dtype=torch.int32), pos)
    for n in cache:
        assert torch.equal(cache[n], before[n]), n


@pytest.mark.parametrize("batched", [False, True], ids=["single", "batched"])
@pytest.mark.parametrize("quantize,kv_cache", STEP_MODES)
def test_decode_step_store_path_is_the_store_after_the_step(monkeypatch, quantize,
                                                            kv_cache, batched):
    """The decode steps' kernel path stores the fresh K/V rows through the
    decode-attention call (store=True). Against the path that left them to
    `_store` after the call (the call with store=False, then `_store` of its
    k_new / v_new at each row's position, layer by layer): the same h and
    the same caches, bit for bit; and against the JAX step on each row's
    cache, h and the fresh rows at the tests' bounds (relative L2 < REL)."""
    jd, jcfg, td, tcfg, caches, x = _step_setup(quantize, kv_cache, seed=9)
    want = [_jax_step(jd, jcfg, x[b], caches[b], p) for b, p in enumerate(POS)]
    pos = torch.tensor(POS, dtype=torch.int32)
    fresh = []
    real = tdec.decode_attention_batch if batched else tdec.decode_attention

    def without_store(*a, store, **kw):
        assert store
        out = real(*a, **kw)
        fresh.append(out[1:])
        return out

    def run(name, fn):
        with monkeypatch.context() as m:
            if fn is not None:
                m.setattr(tdec, name, fn)
            if batched:
                cache = _port_batch_cache(caches)
                return tdec.decode_step_batch(td, tcfg, _t(x), cache, pos, POS), [cache]
            hs, cs = [], []
            for b, p in enumerate(POS):
                cache = {n: _t(c) for n, c in caches[b].items()}
                hs.append(tdec.decoder_forward(td, tcfg, _t(x)[b:b + 1], cache, p + 1,
                                               prefill=False, cache_offset=p))
                cs.append(cache)
            return torch.cat(hs), cs

    name = "decode_attention_batch" if batched else "decode_attention"
    h, got_caches = run(name, None)
    h_old, old_caches = run(name, without_store)
    for l, (k_new, v_new) in enumerate(fresh):   # the parent path's stores
        if batched:
            tdec._store(old_caches[0], l % tcfg.n_layers, (torch.arange(len(POS)),
                                                           pos.long()), k_new, v_new)
        else:
            b, layer = divmod(l, tcfg.n_layers)
            tdec._store(old_caches[b], layer, POS[b], k_new[0], v_new[0])
    assert torch.equal(h, h_old)
    for got, old in zip(got_caches, old_caches):
        for n in got:
            assert torch.equal(got[n], old[n]), n
    for b, p in enumerate(POS):
        hw, cw = want[b]
        assert _rel(h[b].float(), hw[0]) < REL, b
        cache = got_caches[0] if batched else got_caches[b]
        for n in ("k", "v"):
            w_row = np.asarray(cw[n][:, p], np.float32)
            row = cache[n][b, :, p] if batched else cache[n][:, p]
            g = row.float().reshape(w_row.shape)
            if kv_cache == "int8":
                w_row = w_row * np.asarray(cw[n + "_s"][:, p])[..., None]
                g = g * (cache[n + "_s"][b, :, p] if batched else cache[n + "_s"][:, p])[..., None]
            assert _rel(g, w_row) < REL, (b, n)
