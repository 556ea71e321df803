"""Port weights and quantizers vs the JAX package, at the tiny config.

The same dense weights go through both packages: int8pc codes and scales
must be bit-equal, int4 codes and scales bit-equal except where two clip
candidates' squared errors tie within 1e-6 relative (the search's f32 sums
run in another order), and the nibble packing must match byte for byte.

Also holds the helpers the other test_torch_* files share.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qwen3_asr_tpu import config as jconfig
from qwen3_asr_tpu.config import tiny_asr_config
from qwen3_asr_tpu.ops import megakernel as jmk
from qwen3_asr_tpu.runtime import params as jparams
from qwen3_asr_tpu_torch import config as tconfig
from qwen3_asr_tpu_torch.ops import megakernel as tmk
from qwen3_asr_tpu_torch.runtime import params as tparams

NEAR_TIE_TOL = 0.2  # scripts/chipgate.py: argmax flips below this logit gap


def port_config(cfg):
    """A JAX package config (ASRModelConfig, AlignerModelConfig,
    DecoderConfig or AudioEncoderConfig) -> the port's own dataclass,
    rebuilt field by field from dataclasses.asdict: the port's functions
    take only their own configs."""
    if isinstance(cfg, jconfig.ASRModelConfig):
        return tconfig.ASRModelConfig(encoder=port_config(cfg.encoder),
                                      decoder=port_config(cfg.decoder))
    if isinstance(cfg, jconfig.AlignerModelConfig):
        return tconfig.AlignerModelConfig(
            encoder=port_config(cfg.encoder), decoder=port_config(cfg.decoder),
            timestamp_token_id=cfg.timestamp_token_id,
            timestamp_segment_time_ms=cfg.timestamp_segment_time_ms)
    cls = {jconfig.DecoderConfig: tconfig.DecoderConfig,
           jconfig.AudioEncoderConfig: tconfig.AudioEncoderConfig}[type(cfg)]
    return cls(**dataclasses.asdict(cfg))


def jax_tree(cfg, seed=3, quantize=True):
    """The JAX package's ASR tree as numpy (dense, or int8pc + fused)."""
    p = jparams.init_asr_params(cfg, seed, jnp.bfloat16)
    p = jax.tree.map(np.asarray, p)
    if quantize:
        dec = jparams.quantize_decoder_params(p["decoder"], "int8pc")
        p["decoder"] = jax.tree.map(np.asarray,
                                    jparams.fuse_decoder_params(dec))
    return p


def near_tie_mask(w, G):
    """(group, column) pairs where two int4 clip candidates' errors tie
    within 1e-6 relative: either side of the tie is a right answer."""
    wg = w.astype(np.float64).reshape(w.shape[0] // G, G, w.shape[1])
    amax = np.abs(wg).max(axis=1)
    errs = []
    for c in (1.0,) + jmk._INT4_CLIP_CANDIDATES:
        s = np.maximum(amax * np.float32(c / 7.0), 1e-12).astype(np.float32)
        q = np.clip(np.rint(wg / s[:, None, :]), -7, 7)
        errs.append(((q * s[:, None, :] - wg) ** 2).sum(axis=1))
    errs = np.stack(errs)
    tie = np.zeros(amax.shape, bool)
    for i in range(len(errs)):
        for j in range(i + 1, len(errs)):
            tie |= np.abs(errs[i] - errs[j]) <= 1e-6 * np.maximum(errs[i], 1e-30)
    return tie


@pytest.fixture(scope="module")
def cfg():
    return tiny_asr_config()


@pytest.fixture(scope="module")
def tcfg(cfg):
    return port_config(cfg)


@pytest.fixture(scope="module")
def dense(cfg):
    return jax_tree(cfg, quantize=False)


def test_int8pc_bit_equal(tcfg, dense):
    dec_t = tparams.from_jax_params(dense, tcfg)["decoder"]
    q_t = tparams.quantize_decoder_params(dec_t, "int8pc")
    q_j = jax.tree.map(np.asarray, jparams.quantize_decoder_params(
        dense["decoder"], "int8pc"))
    for key in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"):
        for sub in ("i8pc:q", "i8pc:s"):
            np.testing.assert_array_equal(q_t["layers"][key][sub].numpy(),
                                          q_j["layers"][key][sub], err_msg=key)
    for sub in ("i8pc:q", "i8pc:s"):
        np.testing.assert_array_equal(q_t["lm_head_pc"][sub].numpy(),
                                      q_j["lm_head_pc"][sub])


def test_fuse_matches(cfg, tcfg, dense):
    dec_t = tparams.fuse_decoder_params(tparams.quantize_decoder_params(
        tparams.from_jax_params(dense, tcfg)["decoder"]))
    want = jax_tree(cfg)["decoder"]["layers"]
    assert set(dec_t["layers"]) == set(want)
    for key in ("wqkv", "w_gate_up"):
        for sub in ("i8pc:q", "i8pc:s"):
            np.testing.assert_array_equal(dec_t["layers"][key][sub].numpy(),
                                          want[key][sub])


@pytest.mark.parametrize("shape,seed", [((64, 128), 0), ((96, 64), 1),
                                        ((1024, 256), 2), ((3072, 64), 3)])
def test_int4_quant_matches(shape, seed):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal(shape) * 0.02).astype(np.float32)
    w[rng.integers(0, shape[0], 4), rng.integers(0, shape[1], 4)] *= 8.0
    G = jmk._int4_group_for(shape[0])
    assert tmk._int4_group_for(shape[0]) == G
    q_j, s_j = jmk._quant_int4_groups(w, G)
    q_t, s_t = tmk._quant_int4_groups(torch.from_numpy(w), G)
    tie = near_tie_mask(w, G)
    ok_s = (s_t.numpy() == s_j) | tie
    assert ok_s.all(), np.argwhere(~ok_s)[:5]
    tie_rows = np.repeat(tie, G, axis=0)
    ok_q = (q_t.numpy() == q_j) | tie_rows
    assert ok_q.all()


def test_pack_nibbles_matches():
    rng = np.random.default_rng(4)
    q = rng.integers(-7, 8, (32, 48)).astype(np.int8)
    want = jmk._pack_nibbles(q).view(np.uint8)
    got = tmk.pack_nibbles(torch.from_numpy(q)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        tmk.unpack_nibbles(torch.from_numpy(got)).numpy(), q)


def test_pack_codes_match_jax_pack(cfg, tcfg):
    """The port's [L, in/2, out] pack holds the same int4 codes and group
    scales as the JAX tile pack, read back through its tile layout."""
    tree = jax_tree(cfg)
    dcfg = cfg.decoder
    pack_t = tparams.from_jax_params(tree, tcfg)["decoder"]["mega"]
    mega_j = jmk.pack_megakernel_params(tree["decoder"], dcfg, int4=True)
    for name, key in (("qkv", "wqkv"), ("wd", "w_down")):
        qt = np.asarray(mega_j[f"{name}_q"]).view(np.uint8)  # [L, n_oc, in/2, co]
        L, n_oc, half, co = qt.shape
        bytes_j = qt.transpose(0, 2, 1, 3).reshape(L, half, n_oc * co)
        leaf = tree["decoder"]["layers"][key]
        G = jmk._int4_group_for(2 * half)
        for l in range(L):
            w = leaf["i8pc:q"][l].astype(np.float32) * leaf["i8pc:s"][l][None, :]
            tie = np.repeat(near_tie_mask(w, G), G // 2, axis=0)
            same = bytes_j[l] == pack_t[f"{name}_q"][l].numpy()
            assert (same | tie).all(), name
    assert pack_t["head_q"].shape[1] % tmk.HEAD_PAD == 0
    assert pack_t["embd"].dtype == torch.bfloat16


def test_from_jax_params_roundtrip(tcfg, dense):
    t = tparams.from_jax_params(dense, tcfg)
    enc = t["encoder"]
    assert enc["conv1_w"].dtype == torch.float32
    assert enc["layers"]["wq"].dtype == torch.bfloat16
    got = enc["layers"]["wq"].float().numpy()
    np.testing.assert_array_equal(
        got, dense["encoder"]["layers"]["wq"].astype(np.float32))
    assert "mega" not in t["decoder"]  # a dense tree gets no decode pack


def test_init_asr_params_shapes(tcfg, dense):
    t = tparams.init_asr_params(tcfg, seed=0)

    def shapes(tree, prefix=""):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out.update(shapes(v, f"{prefix}{k}/"))
            elif v is not None:
                out[prefix + k] = tuple(v.shape)
        return out

    assert shapes(t) == shapes(dense)
    again = tparams.init_asr_params(tcfg, seed=0)
    assert torch.equal(again["decoder"]["token_embd"], t["decoder"]["token_embd"])


def test_assert_on_device(tcfg):
    t = tparams.init_asr_params(tcfg, seed=0)
    tparams.assert_on_device(t, "cpu")
    with pytest.raises(RuntimeError, match="not on cuda"):
        tparams.assert_on_device(t, "cuda")


def test_q8_0_quantize_bit_equal(tcfg, dense):
    """quantize_decoder_params('q8_0'): every layer's codes and scales and
    the padded lm_head_q8 bit-equal to the JAX package's."""
    q_t = tparams.quantize_decoder_params(
        tparams.from_jax_params(dense, tcfg)["decoder"], "q8_0")
    q_j = jax.tree.map(np.asarray, jparams.quantize_decoder_params(
        dense["decoder"], "q8_0"))
    for key in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"):
        for sub in ("q8:q", "q8:s"):
            np.testing.assert_array_equal(q_t["layers"][key][sub].numpy(),
                                          q_j["layers"][key][sub], err_msg=key)
    assert q_t["lm_head_q8"]["q8:q"].shape[1] % 4096 == 0
    for sub in ("q8:q", "q8:s"):
        np.testing.assert_array_equal(q_t["lm_head_q8"][sub].numpy(),
                                      q_j["lm_head_q8"][sub])
    fused = tparams.fuse_decoder_params(q_t)["layers"]
    want = jax.tree.map(np.asarray, jparams.fuse_decoder_params(q_j))["layers"]
    for key in ("wqkv", "w_gate_up"):
        for sub in ("q8:q", "q8:s"):
            np.testing.assert_array_equal(fused[key][sub].numpy(), want[key][sub])


def test_from_jax_params_carries_q8_leaves(cfg, tcfg, dense):
    dec = jparams.fuse_decoder_params(jparams.quantize_decoder_params(
        dense["decoder"], "q8_0"))
    tree = dict(dense, decoder=jax.tree.map(np.asarray, dec))
    t = tparams.from_jax_params(tree, tcfg)["decoder"]
    assert "mega" not in t      # no int4 pack without the int8pc layout
    for key in ("wqkv", "wo", "w_gate_up", "w_down"):
        assert t["layers"][key]["q8:q"].dtype == torch.int8
        np.testing.assert_array_equal(t["layers"][key]["q8:s"].numpy(),
                                      tree["decoder"]["layers"][key]["q8:s"])
    np.testing.assert_array_equal(t["lm_head_q8"]["q8:q"].numpy(),
                                  tree["decoder"]["lm_head_q8"]["q8:q"])


def test_native_q8_gguf_load_bit_equal(tmp_path, cfg):
    """A Q8_0 GGUF (written as tests/test_quant.py's native-load test writes
    it) loads GGML's blocks as Q8_0 leaves, bit-equal to the JAX loader's."""
    from helpers import make_byte_vocab, write_tiny_gguf
    from qwen3_asr_tpu.runtime.gguf import GGML_TYPE_Q8_0

    params = jax.tree.map(np.asarray, jparams.init_asr_params(cfg, 17, jnp.float32))
    path = str(tmp_path / "q8.gguf")
    write_tiny_gguf(path, cfg, params, vocab=make_byte_vocab(cfg.decoder.vocab_size, {}),
                    merges=[], weight_type=GGML_TYPE_Q8_0)
    tcfg_l, t, vocab, _ = tparams.load_asr_model(path)
    jcfg, j, _, _ = jparams.load_asr_model(path)
    assert tcfg_l == port_config(jcfg) and len(vocab) == cfg.decoder.vocab_size
    j = jax.tree.map(np.asarray, j)
    for key in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down"):
        for sub in ("q8:q", "q8:s"):
            got, want = t["decoder"]["layers"][key][sub], j["decoder"]["layers"][key][sub]
            assert got.dtype == (torch.int8 if sub == "q8:q" else torch.float32)
            np.testing.assert_array_equal(got.numpy(), want, err_msg=key)
    np.testing.assert_array_equal(t["decoder"]["token_embd"].float().numpy(),
                                  j["decoder"]["token_embd"].astype(np.float32))
