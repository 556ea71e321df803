"""Planted faults against `chip_smoke.py`'s checks of the per-layer decode
path, on the card, at Qwen3-ASR-0.6B's full width (random Q8_0 weights,
seed 0).

Each case plants one fault at run time (a slice of a weight dropped, the
dequant dtype flipped, a cache row dropped, RoPE one position off, the fresh
row stored one row early, a kernel replaced by its twin, a kernel launched
inside `twins()`) and asserts that the phase of `chip_smoke.py` that guards
against it raises. The phases print their readings before they raise; run
with `-s` to see them beside the bounds:

    python3 -m pytest tests/test_torch_chip_faults.py -m cuda -q -s --noconftest -p no:cacheprovider

Marked `cuda`: skipped without an sm_90 device. Imports no JAX.
"""

import contextlib
import dataclasses

import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def q8_asr():
    """(chip_smoke, the q8_0 model with a bf16 cache, EOS off); skips only
    without an sm_90 device."""
    from qwen3_asr_tpu_torch.ops import build
    from qwen3_asr_tpu_torch.ops.support import has_sm90

    if not has_sm90():
        pytest.skip("needs a CUDA device of compute capability 9.0")
    build.library()
    import chip_smoke as cs
    from qwen3_asr_tpu_torch.config import ASRModelConfig
    from qwen3_asr_tpu_torch.pipeline.asr import Qwen3ASR

    asr = Qwen3ASR(quantize="q8_0", kv_cache="bf16", device="cuda")
    asr.load_random(ASRModelConfig(), seed=0)
    asr.cfg = dataclasses.replace(asr.cfg, decoder=dataclasses.replace(
        asr.cfg.decoder, eos_token_id=-1))
    return cs, asr


@contextlib.contextmanager
def patched(mod, name, fn):
    old = getattr(mod, name)
    setattr(mod, name, fn)
    try:
        yield old
    finally:
        setattr(mod, name, old)


def caught(what, fn):
    with pytest.raises(AssertionError) as e:
        fn()
    print(f"FAULT {what}: CAUGHT -> {str(e.value)[:200]}", flush=True)


def drop_rows(q, lo=8, hi=16):
    q = q.clone()
    q[lo:hi] = 0
    return q


@pytest.mark.parametrize("short", [True, False], ids=["T1", "Tprompt"])
@pytest.mark.parametrize("fault", ["weight_rows", "dequant_dtype", "down_rows",
                                   "norm_weight"])
def test_q8_phase_catches(q8_asr, fault, short):
    """K5 / K6 with rows 8..15 of the weight dropped or the dequant dtype
    flipped; K7 with rows 8..15 of W_down dropped or one norm weight one
    bf16 step off; at T = 1 and at a 5 s prompt's T."""
    from qwen3_asr_tpu_torch.ops import q8_matmul as q8

    cs, asr = q8_asr
    T = 1 if short else cs.prompt_rows(5)
    launch, k7, deq = q8._launch_matmul, q8.q8_mlp, q8.deq_bf16_for

    def f_rows(x, q, s, nw, eps):
        return launch(x, drop_rows(q), s, nw, eps)

    def f_flip(x, q, s, nw, eps):
        with patched(q8, "deq_bf16_for", lambda n: not deq(n)):
            return launch(x, q, s, nw, eps)

    def f_down(x, gu, dn, nw, eps, n_ffn):
        return k7(x, gu, {"q8:q": drop_rows(dn["q8:q"]), "q8:s": dn["q8:s"]},
                  nw, eps, n_ffn)

    def f_norm(x, gu, dn, nw, eps, n_ffn):
        nw = nw.clone()
        nw[7] = (nw[7].float() * (1 + 2 ** -7)).to(nw.dtype)
        return k7(x, gu, dn, nw, eps, n_ffn)

    name, fn = {"weight_rows": ("_launch_matmul", f_rows),
                "dequant_dtype": ("_launch_matmul", f_flip),
                "down_rows": ("q8_mlp", f_down),
                "norm_weight": ("q8_mlp", f_norm)}[fault]
    if name == "q8_mlp":
        fn.launches = 0
    with patched(q8, name, fn):
        caught(f"{fault} T={T}", lambda: cs.phase_q8(
            asr.params["decoder"], asr.cfg.decoder, (T,)))


def _k4_faults():
    return {"last_row_dropped": lambda o, p: (o - 1 if o else o, p),
            "rope_pos_plus_1": lambda o, p: (o, p + 1)}


@pytest.mark.parametrize("fault", list(_k4_faults()))
@pytest.mark.parametrize("phase", ["decode_attention", "one_layer"])
def test_decode_attention_faults_caught(q8_asr, phase, fault):
    """K4 reading one cache row too few, or rotating at pos + 1: caught by
    K4 against its twin and by each q8_0 layer alone on the twins' input."""
    from qwen3_asr_tpu_torch.models import decoder as dmod
    from qwen3_asr_tpu_torch.ops import decode_attention as da

    cs, asr = q8_asr
    k4, change = da.decode_attention, _k4_faults()[fault]

    def f_da(qkv, k, v, qn, kn, offset, pos, **kw):
        return k4(qkv, k, v, qn, kn, *change(offset, pos), **kw)

    f_da.launches = 0
    if phase == "decode_attention":
        with patched(da, "decode_attention", f_da):
            caught(f"K4 {fault}", lambda: cs.phase_decode_attention(
                asr.cfg.decoder, 1248, 1664))
    else:
        with patched(dmod, "decode_attention", f_da):
            caught(f"one layer, K4 {fault}", lambda: cs.phase_q8_layers(asr, 1248))


def test_store_one_row_early_caught(q8_asr):
    """The kernel path's fresh K/V row stored at pos - 1."""
    from qwen3_asr_tpu_torch.models import decoder as dmod
    from qwen3_asr_tpu_torch.ops import decode_attention as da

    cs, asr = q8_asr
    store = dmod._store

    def early(cache, l, rows, k, v):
        if dmod.decode_attention is not da.decode_attention_ref and isinstance(rows, int):
            rows -= 1
        return store(cache, l, rows, k, v)

    with patched(dmod, "_store", early):
        caught("fresh row stored at pos - 1", lambda: cs.phase_q8_layers(asr, 1248))


def test_kernel_replaced_by_twin_caught(q8_asr):
    """K7 on a CUDA tensor silently running its twin: the request's launch
    counts fall short of chip_smoke.slice_launches."""
    from qwen3_asr_tpu_torch.models import decoder as dmod
    from qwen3_asr_tpu_torch.ops import q8_matmul as q8
    from qwen3_asr_tpu_torch.pipeline.asr import TranscribeParams

    cs, asr = q8_asr

    def f_twin(x, gu, dn, nw, eps, n_ffn):
        return q8.q8_mlp_ref(x, gu["q8:q"], gu["q8:s"], dn["q8:q"], dn["q8:s"],
                             nw, eps, n_ffn)

    f_twin.launches = 0

    def run():
        cs.reset_counts()
        asr.transcribe(cs.pcm(5), TranscribeParams(max_tokens=8))
        got = cs.counts()
        want = cs.slice_launches("q8_0", cs.prompt_rows(5), 8, asr.cfg.decoder.n_layers)
        assert got == want, f"launch counts {got} != {want}"

    with patched(q8, "q8_mlp", f_twin), patched(dmod, "q8_mlp", f_twin):
        caught("K7 replaced by its twin on the card", run)


def test_kernel_inside_twins_caught(q8_asr):
    """A call site that twins() leaves unpatched launches its kernel inside
    the block, so the comparison would hold a kernel against itself."""
    from qwen3_asr_tpu_torch.ops import flash_attention as fa

    cs, _ = q8_asr
    q = torch.randn(1, 64, 2, 64, device="cuda").to(torch.bfloat16)
    vl = torch.tensor([64], dtype=torch.int32, device="cuda")

    def run():
        with cs.twins():
            fa.flash_attention_batch(q, q, q, vl, causal=True, scale=0.125)
        torch.cuda.synchronize()

    caught("a kernel launched inside twins()", run)
