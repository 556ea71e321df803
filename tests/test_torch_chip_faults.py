"""Planted faults against `chip_smoke.py`'s checks, on the card, at
Qwen3-ASR-0.6B's and Qwen3-ForcedAligner-0.6B's full width (random weights,
seed 0): the per-layer decode path (Q8_0 weights, one row and B rows), K1 /
K3 on the int8 pack (`quantize="auto"`; K3 over both caches), sampled
decoding and greedy self-speculation, the
weight-stream microbenchmarks and the aligner.

Each case plants one fault at run time (a slice of a weight dropped, the
dequant dtype flipped, a cache row dropped, RoPE one position off, the fresh
row stored one row early, a kernel replaced by its twin, a kernel launched
inside `twins()`, the int8 scales one column off, a bf16 fresh row one row
early, a K3 row given its neighbour's position, the int4 cache's
neighbour nibble cleared or its nibbles swapped, the unpack probe's nibbles
swapped, flash attention's causal mask one key late or its last partial key
tile skipped, K1's graph replayed without advancing the position, K1's
GEMV prologue reading no attn_norm weight, the aligner's NAR pass or K2 at
its shape ignoring the prompt's valid length, the aligner's encoder window
one row off or its bucketed attention ignoring n_audio, the sampled loop
fed K1's argmax through the greedy GraphStep's shortcut, the sampled head
given the post-norm h, top-p dropping its cutoff element, the speculative
verify reading the drafts' cache rows, a spec round emitting the draft at
its first mismatch, K4's batched mode reading row 0's offset for every
row, K3's bf16 mode writing the fresh rows into slab 0, K3's product built
with rows 8-15 reading rows 0-7's codes or with two output columns of an
MMA tile swapped (a copy of the sources with one line changed), K3's
prologue reading no attn_norm weight, the Q8_0 body (K5-K7) built with a
later row group reading the first group's x rows, its split-K meeting
dropping the last slice, the SwiGLU pairing gate column j with up column
j + 1 or two rows' results swapped, the per-layer step
at B rows storing every row at row 0's position, its attention output
alone with q roped one position late or the newest 64 cache rows skipped,
K4 built with its store one row early or late, its int8 store's scale from
a divide by 127, its weighted V's chunks met in arrival order or one of
them skipped, the int8pc prefill's fused passes built with one of the
eager chain's bf16 roundings skipped: RMSNorm's of x * r, the QK-norm's of
y * r, or the residual's sum before its norm)
and asserts that the phase of
`chip_smoke.py` that guards against it raises. The phases print their readings before they raise; run
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


K4_STORE_ROW = "const size_t h = slab + (size_t)offset * NKV + kvh;"


def test_store_one_row_early_caught(q8_asr, tmp_path):
    """The kernel path's fresh K/V row stored at pos - 1: K4 built with its
    store one row early (its own slab; row 0 at offset 0). Each q8_0 layer
    alone on the twins' input compares the fresh rows at pos."""
    cs, asr = q8_asr
    with mutated_kernels(tmp_path, "decode_attention.cu", K4_STORE_ROW,
                         K4_STORE_ROW.replace("(size_t)offset",
                                              "(size_t)(offset > 0 ? offset - 1 : 0)")):
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


@pytest.fixture(scope="module")
def auto_asr(q8_asr):
    """The CLI's default model, Qwen3ASR(quantize="auto") (the int8 pack),
    random weights seed 0, EOS off."""
    from qwen3_asr_tpu_torch.config import ASRModelConfig
    from qwen3_asr_tpu_torch.pipeline.asr import Qwen3ASR

    cs, _ = q8_asr
    asr = Qwen3ASR(quantize="auto", device="cuda")
    asr.load_random(ASRModelConfig(), seed=0)
    return cs, cs.eos_off(asr)


def test_int8_scale_column_shifted_caught(auto_asr):
    """K1 on the int8 pack reading the QKV scales one column off (the twin
    reads them right): the int8-weight K1 phase raises."""
    from qwen3_asr_tpu_torch.ops import megakernel as mk

    cs, asr = auto_asr
    init = mk.DecodeStep.__init__

    def shifted(self, pack, cfg, *a, **k):
        init(self, pack, cfg, *a, **k)
        self._shifted = torch.roll(pack["qkv_s"], 1, dims=-1).contiguous()
        self.ptrs.qkv_s = self._shifted.data_ptr()

    with patched(mk.DecodeStep, "__init__", shifted):
        caught("int8 scale column shifted by one", lambda: cs.phase_mega(
            asr.cfg, asr.params["decoder"], "int8", steps=4, floor_steps=0))


def test_bf16_fresh_row_one_early_caught(auto_asr):
    """K1 over the bf16 cache with its fresh row landing at pos - 1: the
    bf16-KV phase raises."""
    from qwen3_asr_tpu_torch.ops import megakernel as mk

    cs, asr = auto_asr
    call = mk.DecodeStep.__call__

    def early(self, token_or_x, pos, out):
        call(self, token_or_x, pos, out)
        for c in self.cache[:2]:
            c[:, pos - 1] = c[:, pos]
            c[:, pos] = 0

    with patched(mk.DecodeStep, "__call__", early):
        caught("bf16 fresh row stored at pos - 1", lambda: cs.phase_mega(
            asr.cfg, asr.params["decoder"], "bf16", steps=4, floor_steps=0))


@pytest.mark.parametrize("fault", ["neighbour_cleared", "nibbles_swapped"])
def test_int4_nibble_faults_caught(auto_asr, fault):
    """K1 over the int4 cache with byte row pos // 2 spoiled after each step:
    the fresh row's neighbour nibble cleared (at an odd pos that is the live
    row pos - 1), or the byte's two nibbles swapped (the fresh codes in the
    other row's place): the int4-KV phase raises."""
    from qwen3_asr_tpu_torch.ops import megakernel as mk

    cs, asr = auto_asr
    call = mk.DecodeStep.__call__

    def spoiled(self, token_or_x, pos, out):
        call(self, token_or_x, pos, out)
        for c in self.cache[:2]:
            b = c[:, pos // 2]
            if fault == "nibbles_swapped":
                c[:, pos // 2] = (b << 4) | (b >> 4)
            else:
                c[:, pos // 2] = b & (0xF0 if pos % 2 else 0x0F)

    with patched(mk.DecodeStep, "__call__", spoiled):
        caught(f"int4 cache, {fault}", lambda: cs.phase_mega(
            asr.cfg, asr.params["decoder"], "int4", steps=4, floor_steps=0))


def test_k3_int8_row_neighbour_position_caught(auto_asr):
    """K3 on the int8 pack with row 3 given row 2's position: the K3 phase's
    rows-equal-K1 check raises."""
    from qwen3_asr_tpu_torch.ops import megakernel_batch as mbt

    cs, asr = auto_asr
    call = mbt.BatchDecodeStep.__call__

    def neighbour(self, tokens_or_x, pos, out, bounds):
        pos = pos.clone()
        pos[3] = pos[2]
        call(self, tokens_or_x, pos, out, bounds)

    with patched(mbt.BatchDecodeStep, "__call__", neighbour):
        caught("K3 int8 row 3 given row 2's position", lambda: cs.phase_mega_batch(
            asr.cfg.decoder, asr.params["decoder"]["mega"]))


def test_unpack_nibbles_swapped_caught(q8_asr):
    """The unpack probe with its two nibbles swapped: the microbenchmark
    phase raises."""
    from qwen3_asr_tpu_torch import microbench_stream as ms

    cs, _ = q8_asr
    probe = ms.unpack_probe

    def swapped(b):
        out = probe(b)
        return torch.stack([out[1::2], out[0::2]], dim=1).reshape(out.shape)

    swapped.launches = 0
    with patched(ms, "unpack_probe", swapped):
        caught("unpack probe nibbles swapped", cs.phase_microbench)


@pytest.fixture(scope="module")
def smoke():
    """chip_smoke; skips only without an sm_90 device."""
    from qwen3_asr_tpu_torch.ops import build
    from qwen3_asr_tpu_torch.ops.support import has_sm90

    if not has_sm90():
        pytest.skip("needs a CUDA device of compute capability 9.0")
    build.library()
    import chip_smoke as cs

    return cs


def test_flash_causal_mask_one_key_late_caught(smoke):
    """K2 whose causal mask lets row t see key t + 1 (the kernel fed q one
    row later, out read one row earlier: its own mask then admits one key
    past the diagonal): the causal flash phase raises."""
    from qwen3_asr_tpu_torch.ops import flash_attention as fa

    kernel = fa.flash_attention_batch

    def late(q, k, v, valid_lens, *, causal, scale):
        if not causal:
            return kernel(q, k, v, valid_lens, causal=causal, scale=scale)
        q1 = torch.cat([torch.zeros_like(q[:, :1]), q], dim=1)
        return kernel(q1, k, v, valid_lens, causal=True, scale=scale)[:, 1:]

    late.launches = 0   # the kernel's wrapper counts on its module's name

    with patched(fa, "flash_attention_batch", late):
        caught("flash causal mask one key late", lambda: smoke.phase_flash(
            True, 1280, 16, 8, 128, [1216]))


@pytest.mark.parametrize("phase", [(False, 1196, 14, 14, 64, [1196]),
                                   (True, 1280, 16, 8, 128, [1216, 904, 512, 77])],
                         ids=["bidirectional", "causal_batch"])
def test_flash_last_partial_tile_skipped_caught(smoke, phase):
    """K2 stopping at the last whole 64-key tile (its valid lengths rounded
    down to the tile: the keys of the partial tile never read): the flash
    phases raise."""
    from qwen3_asr_tpu_torch.ops import flash_attention as fa

    kernel = fa.flash_attention_batch

    def whole_tiles(q, k, v, valid_lens, *, causal, scale):
        vl = torch.as_tensor(valid_lens, device=q.device)
        return kernel(q, k, v, (vl // 64) * 64, causal=causal, scale=scale)

    whole_tiles.launches = 0

    with patched(fa, "flash_attention_batch", whole_tiles):
        caught(f"flash last partial tile skipped ({phase[-1]})",
               lambda: smoke.phase_flash(*phase))


def test_k1_graph_replayed_without_pos_advance_caught(auto_asr):
    """K1's graph captured without its last node, the position's advance:
    consecutive replays decode at a stale position, and the graph phase
    (graphed steps torch.equal to eager) raises."""
    from qwen3_asr_tpu_torch.ops import megakernel as mk

    cs, asr = auto_asr
    with patched(mk.GraphStep, "_advance", lambda self: None):
        caught("K1 graph without the position's advance", lambda: cs.phase_mega_graph(
            asr.cfg, asr.params["decoder"]))


def test_k1_prologue_without_attn_norm_caught(auto_asr):
    """K1's QKV GEMV prologue reading an all-ones attn_norm (the weight
    dropped) on a pack whose attn_norm is not ones (the random model's is,
    so the pack's copy takes 1 + N(0, 0.25) per element, the twin reading
    it too): the K1 phase raises."""
    from qwen3_asr_tpu_torch.ops import megakernel as mk

    cs, asr = auto_asr
    g = torch.Generator(device="cuda").manual_seed(11)
    pack = dict(asr.params["decoder"]["mega"])
    pack["attn_norm"] = (1 + 0.5 * torch.randn(pack["attn_norm"].shape, generator=g,
                                               device="cuda")).contiguous()
    dec = dict(asr.params["decoder"], mega=pack)
    init = mk.DecodeStep.__init__

    def dropped(self, pk, cfg, *a, **k):
        init(self, pk, cfg, *a, **k)
        self._ones = torch.ones_like(pk["attn_norm"])
        self.ptrs.attn_norm = self._ones.data_ptr()

    with patched(mk.DecodeStep, "__init__", dropped):
        caught("K1 prologue without attn_norm", lambda: cs.phase_mega(
            asr.cfg, dec, "bf16", steps=4, floor_steps=0))


@pytest.fixture(scope="module")
def aligner(smoke):
    """(chip_smoke, Qwen3-ForcedAligner-0.6B on the card (dense bf16, random
    weights, seed 0), bench_align.py's 92 s audio and its mel, n_frames,
    features, n_audio and 183-word prompt)."""
    cs = smoke
    fa = cs.load_aligner(False)
    audio = cs.align_pcm(cs.ALIGN_SECONDS)
    mel, nf = fa.frontend(audio)
    feats, na = fa.encode(mel, nf)
    prompt, _ = fa.prompt(cs.align_text(cs.ALIGN_WORDS), "", nf)
    return cs, fa, nf, feats, na, prompt


def test_nar_pass_with_n_valid_ignored_caught(aligner):
    """The NAR pass's K2 given the bucketed length in place of each
    prompt's real length (padding keys attended): the prompt's own rows
    never see them (causal), but the padding rows past the prompt do, and
    the per-layer check against the twins raises."""
    from qwen3_asr_tpu_torch.models import decoder as dmod

    cs, fa, _, feats, na, prompt = aligner
    kernel = dmod.flash_attention_batch

    def ignored(q, k, v, valid_lens, *, causal, scale):
        full = torch.full_like(torch.as_tensor(valid_lens), q.shape[1])
        return kernel(q, k, v, full, causal=causal, scale=scale)

    with patched(dmod, "flash_attention_batch", ignored):
        caught("NAR pass with n_valid ignored",
               lambda: cs.phase_nar_layers(fa, prompt, feats, na))


@pytest.mark.parametrize("shift", [1, -1], ids=["plus_one", "minus_one"])
def test_encoder_window_off_by_one_caught(aligner, shift):
    """The windowed encoder with its window one row longer or shorter (105
    or 103 rows, not 13 x 800 / 100): the windowed-attention check raises,
    on the exact shape and on the 500-frame bucket."""
    from qwen3_asr_tpu_torch.models import encoder as emod

    cs, fa, nf, _, _, _ = aligner
    window = emod.attention_window
    with patched(emod, "attention_window", lambda cfg: window(cfg) + shift):
        caught(f"encoder window {shift:+d} row (exact)",
               lambda: cs.check_window_attention(fa, cs.random_mel(fa, nf), nf, 0))
        bucket = -(-nf // cs.ALIGN_BUCKET) * cs.ALIGN_BUCKET
        caught(f"encoder window {shift:+d} row (bucketed)",
               lambda: cs.check_window_attention(fa, cs.random_mel(fa, nf, bucket), nf,
                                                 cs.ALIGN_BUCKET))


def test_flash_n_valid_ignored_at_aligner_shape_caught(smoke):
    """K2 at the aligner's shape (causal T 2,944, valid 2,845, and the batch
    of four) ignoring the valid lengths: the flash phases raise."""
    from qwen3_asr_tpu_torch.ops import flash_attention as fa

    kernel = fa.flash_attention_batch

    def ignored(q, k, v, valid_lens, *, causal, scale):
        full = torch.full_like(torch.as_tensor(valid_lens, device=q.device), q.shape[1])
        return kernel(q, k, v, full, causal=causal, scale=scale)

    ignored.launches = 0
    with patched(fa, "flash_attention_batch", ignored):
        for valid in ([2845], [2845, 1900, 950, 300]):
            caught(f"flash n_valid ignored {valid}",
                   lambda: smoke.phase_flash(True, 2944, 16, 8, 128, valid))


def test_windowed_attention_ignoring_n_audio_caught(aligner):
    """The encoder's windowed attention ignoring each item's n_audio on the
    bucketed path (the zero frames past the audio attended as keys): the
    windowed-attention check raises."""
    from qwen3_asr_tpu_torch.models import encoder as emod

    cs, fa, nf, _, _, _ = aligner
    attn = emod.block_diagonal_attention_batch
    bucket = -(-nf // cs.ALIGN_BUCKET) * cs.ALIGN_BUCKET
    with patched(emod, "block_diagonal_attention_batch",
                 lambda q, k, v, w, scale, n_valid=None: attn(q, k, v, w, scale)):
        caught("windowed attention ignoring n_audio",
               lambda: cs.check_window_attention(fa, cs.random_mel(fa, nf, bucket), nf,
                                                 cs.ALIGN_BUCKET))


# -- sampled decoding and greedy self-speculation -----------------------------

def sampling_phase(cs, asr):
    """phase_sampling on the auto model (K1, int8 pack, bf16 cache) with a
    64-token window."""
    return cs.phase_sampling(asr, "auto", 8, "mega_bf16", cs.SAMPLE_CHECK, 4)


def test_sampled_loop_with_the_greedy_shortcut_caught(auto_asr):
    """The sampled loop's GraphStep left in the greedy mode (own_tokens), so
    each replay consumes K1's own argmax instead of the drawn token: the
    sampling phase raises."""
    from qwen3_asr_tpu_torch.models import generate as gen
    from qwen3_asr_tpu_torch.ops import megakernel as mk

    cs, asr = auto_asr
    with patched(gen, "GraphStep", lambda step, own_tokens=True: mk.GraphStep(step)):
        caught("sampled loop fed K1's argmax", lambda: sampling_phase(cs, asr))


def test_sampling_from_the_post_norm_h_caught(auto_asr):
    """The sampled head given the hidden state after the final norm (the
    head then normalizes it again) instead of K1's pre-norm h_out: the
    sampling phase raises."""
    from qwen3_asr_tpu_torch.models import generate as gen
    from qwen3_asr_tpu_torch.models.decoder import rms_norm

    cs, asr = auto_asr
    real = gen.mega_sample_runner

    def post_norm(pack, cfg, kvs):
        run = real(pack, cfg, kvs)
        return lambda out, i, pos: rms_norm(run(out, i, pos), pack["out_norm"],
                                            cfg.rms_norm_eps)

    with patched(gen, "mega_sample_runner", post_norm):
        caught("sampling from the post-norm h", lambda: sampling_phase(cs, asr))


def test_top_p_dropping_the_cutoff_caught(auto_asr):
    """filter_logits' nucleus with an inclusive cumsum (the element that
    reaches top_p dropped): the sampling phase raises."""
    from qwen3_asr_tpu_torch.models import generate as gen

    cs, asr = auto_asr
    real = gen.filter_logits

    def inclusive(logits, temperature, top_k=0, top_p=1.0):
        x = real(logits, temperature, top_k, 1.0)
        if top_p >= 1.0:
            return x
        srt = torch.sort(x, descending=True).values
        keep = torch.cumsum(torch.softmax(srt, -1), -1) < top_p
        cut = torch.where(keep, srt, float("inf")).min()
        return torch.where(x < cut, gen.NEG, x)

    with patched(gen, "filter_logits", inclusive):
        caught("top-p without its cutoff element", lambda: sampling_phase(cs, asr))


@pytest.fixture(scope="module")
def int4_asr(q8_asr):
    """The int4 pack over an int8 cache (random weights seed 0, EOS off):
    its drafts differ from the int8pc verify more often than the int8
    pack's."""
    from qwen3_asr_tpu_torch.config import ASRModelConfig
    from qwen3_asr_tpu_torch.pipeline.asr import Qwen3ASR

    cs, _ = q8_asr
    asr = Qwen3ASR(quantize="int4", kv_cache="int8", device="cuda")
    asr.load_random(ASRModelConfig(), seed=0)
    return cs.eos_off(asr)


def test_verify_reading_the_drafts_rows_caught(auto_asr, int4_asr):
    """The verify pass reading the cache rows from cache_offset on (the
    drafts' stale rows) as cache columns: the spec phase raises."""
    from qwen3_asr_tpu_torch.models import decoder as dmod

    cs, asr = auto_asr
    with patched(dmod, "_cache_rows_read", lambda offset, valid: valid):
        caught("verify reading the drafts' rows", lambda: cs.phase_spec(asr, int4_asr))


def test_acceptance_taking_the_draft_caught(auto_asr, int4_asr):
    """A spec round emitting the draft, not the verify's token, at the first
    mismatch: the spec phase raises."""
    from qwen3_asr_tpu_torch.models import generate as gen

    cs, asr = auto_asr
    real = gen.accept

    def drafts_win(drafts, verified, room, eos):
        emitted, n_acc, kept, done = real(drafts, verified, room, eos)
        emitted = emitted.copy()
        emitted[n_acc - 1] = drafts[n_acc - 1]
        return emitted, n_acc, kept, done

    with patched(gen, "accept", drafts_win):
        caught("acceptance taking the draft", lambda: cs.phase_spec(asr, int4_asr))


def test_k4_batch_reading_row0_offset_caught(q8_asr):
    """K4's batched mode reading row 0's offset for every row: the K4
    batched phase's rows-equal-one-row-launches check raises."""
    from qwen3_asr_tpu_torch.ops import decode_attention as da

    cs, asr = q8_asr
    real = da.decode_attention_batch

    def row0(qkv, kc, vc, qn, kn, offsets, pos, bound, **kw):
        return real(qkv, kc, vc, qn, kn, offsets[:1].expand_as(offsets).contiguous(), pos,
                    bound, **kw)

    row0.launches = 0
    with patched(da, "decode_attention_batch", row0):
        caught("K4 batched reading row 0's offset", lambda: cs.phase_decode_attention_batch(
            asr.cfg.decoder))


def test_k3_bf16_fresh_row_into_slab0_caught(auto_asr):
    """K3's bf16 mode writing each row's fresh K/V rows into slab 0 (its own
    slab's row left as it was): the K3 phase's rows-equal-K1 check raises."""
    from qwen3_asr_tpu_torch.ops import megakernel_batch as mbt

    cs, asr = auto_asr
    init, call = mbt.BatchDecodeStep.__init__, mbt.BatchDecodeStep.__call__

    def keeping(self, pack, cfg, k, v, k_s=None, v_s=None):
        init(self, pack, cfg, k, v, k_s, v_s)
        self.planted_kv = (k, v)

    def into_slab0(self, tokens_or_x, pos, out, bounds):
        p = pos.tolist()
        old = [[t[b, :, p[b]].clone() for b in range(len(p))] for t in self.planted_kv]
        call(self, tokens_or_x, pos, out, bounds)
        if self.planted_kv[0].dtype == torch.bfloat16:
            for t, rows in zip(self.planted_kv, old):
                for b in range(1, len(p)):
                    t[0, :, p[b]] = t[b, :, p[b]]
                    t[b, :, p[b]] = rows[b]

    with patched(mbt.BatchDecodeStep, "__init__", keeping), \
            patched(mbt.BatchDecodeStep, "__call__", into_slab0):
        caught("K3 bf16 writing the fresh rows into slab 0", lambda: cs.phase_mega_batch(
            asr.cfg.decoder, asr.params["decoder"]["mega"], "bf16"))


@contextlib.contextmanager
def mutated_kernels(tmp_path, file: str, old: str, new: str):
    """The kernel library built from a copy of the sources (under tmp_path)
    with the one line `old` of `file` replaced by `new`, in place of the
    checkout's library while the block runs; the checkout's sources are
    not touched. The copy's library is keyed by its own source hash."""
    import shutil

    from qwen3_asr_tpu_torch.ops import build

    src = tmp_path / "csrc"
    shutil.copytree(build.CSRC, src)
    text = (src / file).read_text()
    assert text.count(old) == 1, f"{file}: the line to mutate is not there once"
    (src / file).write_text(text.replace(old, new))
    saved = build.CSRC, build._lib
    build.CSRC, build._lib = src, None
    try:
        build.library()
        yield
    finally:
        build.CSRC, build._lib = saved


K3_FAULTS = {
    # the second n-tile's MMAs read the first n-tile's rows of codes
    "rows 8-15 given rows 0-7's codes": (
        "const int* crow = c32 + ((g + 8 * nt) * kcp + BMMA_ROUND * r) / 4;",
        "const int* crow = c32 + (g * kcp + BMMA_ROUND * r) / 4;"),
    # the sums of columns 0 and 1 of each 128-column tile written to each other's place
    "two output columns of an MMA tile swapped": (
        "const int c = ((nn & 1) << 1) | (b & 1),",
        "const int c = (((nn & 1) ^ (nn < 2)) << 1) | (b & 1),"),
}


@pytest.mark.parametrize("fault", list(K3_FAULTS))
def test_k3_product_faults_caught(auto_asr, tmp_path, fault):
    """K3's tensor-core product on the int8 pack, built with one line
    changed: batch rows 8-15 multiplied by rows 0-7's codes (B <= 8 is
    unaffected, so only the checks at B 13 and 16 can see it), or two
    output columns of one MMA tile swapped in the epilogue. The K3 phase's
    rows-equal-K1 check raises."""
    cs, asr = auto_asr
    old, new = K3_FAULTS[fault]
    with mutated_kernels(tmp_path, "megakernel_batch.cu", old, new):
        caught(f"K3 {fault}", lambda: cs.phase_mega_batch(
            asr.cfg.decoder, asr.params["decoder"]["mega"]))


Q8_FAULTS = {
    # the row groups past the first (16 rows each) multiplied by the first
    # group's x rows (their norm factors still their own)
    "a later row group reading the first group's x rows": (
        "xv[j] = load8(a.x, (size_t)(t0 + r) * a.in + kk, a.x_bf16);",
        "xv[j] = load8(a.x, (size_t)r * a.in + kk, a.x_bf16);", "p5"),
    # the cluster's last slice of `in` left out of every output's sum
    "the split-K meeting dropping its last slice": (
        "for (int s = 1; s < S; ++s) m += *cl.map_shared_rank(part + i, s);",
        "for (int s = 1; s < S - 1; ++s) m += *cl.map_shared_rank(part + i, s);", 8),
    # K7's gate column j multiplied by up column j + 1 of the tile
    "the SwiGLU pairing gate column j with up column j + 1": (
        "silu_mul(meet(r * COLS + j), meet(r * COLS + half + j))",
        "silu_mul(meet(r * COLS + j), meet(r * COLS + half + (j + 1) % half))", 8),
    # rows 0 and 1 of each group stored in each other's place
    "two rows' results swapped in the epilogue": (
        "o[(size_t)(t0 + r) * a.N + blockIdx.x * COLS + c] = meet(i);",
        "o[(size_t)(t0 + (nrows > 1 && r < 2 ? r ^ 1 : r)) * a.N + blockIdx.x * COLS + c] = "
        "meet(i);", 8),
}


@pytest.mark.parametrize("fault", list(Q8_FAULTS))
def test_q8_body_faults_caught(q8_asr, tmp_path, fault):
    """The Q8_0 body (K5-K7), built with one line changed: a later row
    group reading the first group's x rows (seen only past 16 rows: a 5 s
    prompt's T), the split-K meeting dropping its last slice, the SwiGLU
    pairing gate column j with up column j + 1, or two rows' results swapped
    in the epilogue (T 8). phase_q8 raises (the twin or the one-row
    launches)."""
    cs, asr = q8_asr
    old, new, T = Q8_FAULTS[fault]
    T = cs.prompt_rows(5) if T == "p5" else T
    with mutated_kernels(tmp_path, "q8_matmul.cu", old, new):
        caught(f"Q8_0 body: {fault} (T={T})", lambda: cs.phase_q8(
            asr.params["decoder"], asr.cfg.decoder, (T,)))


def test_k3_prologue_without_attn_norm_caught(auto_asr):
    """K3's QKV products making their input codes with an all-ones attn_norm
    (the weight dropped) on a pack whose attn_norm is not ones (the random
    model's is, so the pack's copy takes 1 + N(0, 0.25) per element, K1 and
    the twin reading it too): the K3 phase's rows-equal-K1 check raises."""
    from qwen3_asr_tpu_torch.ops import megakernel_batch as mbt

    cs, asr = auto_asr
    g = torch.Generator(device="cuda").manual_seed(12)
    pack = dict(asr.params["decoder"]["mega"])
    pack["attn_norm"] = (1 + 0.5 * torch.randn(pack["attn_norm"].shape, generator=g,
                                               device="cuda")).contiguous()
    init = mbt.BatchDecodeStep.__init__

    def dropped(self, pk, cfg, *a, **k):
        init(self, pk, cfg, *a, **k)
        self._ones = torch.ones_like(pk["attn_norm"])
        self.ptrs.attn_norm = self._ones.data_ptr()

    with patched(mbt.BatchDecodeStep, "__init__", dropped):
        caught("K3 prologue without attn_norm", lambda: cs.phase_mega_batch(
            asr.cfg.decoder, pack))


def test_batched_step_storing_at_row0_position_caught(q8_asr, tmp_path):
    """The per-layer step at B rows storing every row's fresh K/V rows at row
    0's position (each in its own slab): K4 built with its store row read
    from offsets[0]. The batched-step phase's cache check raises."""
    cs, asr = q8_asr
    with mutated_kernels(tmp_path, "decode_attention.cu", K4_STORE_ROW,
                         K4_STORE_ROW.replace("(size_t)offset",
                                              "(size_t)(a.offs ? a.offs[0] : offset)")):
        caught("batched step storing at row 0's position",
               lambda: cs.phase_step_batch(asr, "bf16"))


def _attn_from(fault):
    """decode_step_batch's K4 batched call with the attention output from a
    launch whose arguments `fault` changed (its store off), and the fresh
    K/V rows and the store from the right launch: a fault on the q side
    alone."""
    from qwen3_asr_tpu_torch.ops import decode_attention as da

    real = da.decode_attention_batch

    def call(qkv, kc, vc, qn, kn, offsets, pos, bound, **kw):
        _, k_new, v_new = real(qkv, kc, vc, qn, kn, offsets, pos, bound, **kw)
        offsets, pos = fault(offsets, pos)
        kw["store"] = False   # the faulted launch stores nothing
        return real(qkv, kc, vc, qn, kn, offsets, pos, bound, **kw)[0], k_new, v_new
    return call


@pytest.mark.parametrize("what,fault", [
    ("q roped one position late", lambda offs, pos: (offs, pos + 1)),
    ("the newest 64 cache rows skipped", lambda offs, pos: ((offs - 64).clamp(min=0), pos)),
])
def test_batched_step_q_side_fault_caught(q8_asr, what, fault):
    """The per-layer step at B rows with a fault in its attention output
    alone (the fresh K/V rows right, so the cache rule is silent): the
    batched-step phase's h bound (STEP_BATCH_H_REL) or its near-tie rule
    raises."""
    from qwen3_asr_tpu_torch.models import decoder as dmod

    cs, asr = q8_asr
    with patched(dmod, "decode_attention_batch", _attn_from(fault)):
        caught(f"batched step: {what}", lambda: cs.phase_step_batch(asr, "bf16"))


K4_MERGE_ORDER = "const int cc = n;   // chunk order"
K4_MERGE_TERM = "o = fmaf(__ldcg(src + cc * cstep), w[cc * GROUP + j], o);"
K4_FAULTS = {
    # the fresh K/V rows written one cache row past `offset` (row offset kept
    # at S - 1, where the slab ends)
    "the store one row late": (
        K4_STORE_ROW,
        K4_STORE_ROW.replace("(size_t)offset",
                             "(size_t)(offset + 1 < a.S ? offset + 1 : offset)"),
        "decode_attention"),
    # the int8 store's scale amax / 127 instead of amax * f32(1 / 127)
    "the int8 scale computed with a divide by 127": (
        "const float s = fmaxf(amax * (1.f / 127.f), 1e-12f);",
        "const float s = fmaxf(amax / 127.f, 1e-12f);", "decode_attention"),
    # the weighted V sum met from the chunk after the merging block's own:
    # the last to arrive picks the order
    "the chunks met in arrival order": (
        K4_MERGE_ORDER, "const int cc = (n + c + 1) % nch;",
        "decode_attention_batch"),
    # chunk 0's weighted V left out of the merge (its weight kept in the sum)
    "one chunk skipped": (
        K4_MERGE_TERM, "if (cc != 0) " + K4_MERGE_TERM,
        "decode_attention"),
}


@pytest.mark.parametrize("fault", list(K4_FAULTS))
def test_k4_kernel_faults_caught(q8_asr, tmp_path, fault):
    """K4 built with one line changed: its store one row late, the int8
    store's scale from a divide by 127 (the last bit of some scales), the
    weighted V's chunks met in an order the last arrival picks, or one
    chunk's weighted V skipped. The K4 phase raises: the in-kernel store
    against _store, the rows against one-row launches, or the twin."""
    cs, asr = q8_asr
    old, new, phase = K4_FAULTS[fault]
    dcfg = asr.cfg.decoder
    run = (lambda: cs.phase_decode_attention(dcfg, 1248, 1664)) \
        if phase == "decode_attention" else (lambda: cs.phase_decode_attention_batch(dcfg))
    with mutated_kernels(tmp_path, "decode_attention.cu", old, new):
        caught(f"K4 {fault}", run)


PF_FAULTS = {
    # RMSNorm's product with w taken on the unrounded x * r (both normed passes)
    "RMSNorm's rounding of x * r skipped": (
        "v[k][i] = bf16_round(__fmul_rn(bf16_round(__fmul_rn(v[k][i], r)), wk[i]));",
        "v[k][i] = bf16_round(__fmul_rn(__fmul_rn(v[k][i], r), wk[i]));"),
    # the first half of each q / k head normed with w on the unrounded y * r
    "the QK-norm's rounding of y * r skipped": (
        "const float z1 = bf16_round(__fmul_rn(bf16_round(__fmul_rn(y1[t], r)), bf2f(w[j])));",
        "const float z1 = bf16_round(__fmul_rn(__fmul_rn(y1[t], r), bf2f(w[j])));"),
    # the residual's sum normed before its bf16 rounding (its store still rounds)
    "the residual's rounding before its norm skipped": (
        "r.v[k][i] = bf16_round(__fadd_rn(r.v[k][i], deq(a[i], sxr, sc[i])));",
        "r.v[k][i] = __fadd_rn(r.v[k][i], deq(a[i], sxr, sc[i]));"),
}


@pytest.mark.parametrize("fault", list(PF_FAULTS))
def test_prefill_pass_rounding_faults_caught(auto_asr, tmp_path, fault):
    """The int8pc prefill's fused passes built with one of the eager chain's
    bf16 roundings skipped, each in a pass whose codes (q / k values) the
    sum order alone may move: the passes' phase raises, its share of moved
    codes or values beyond PF_MOVED."""
    cs, asr = auto_asr
    old, new = PF_FAULTS[fault]
    with mutated_kernels(tmp_path, "prefill_fused.cu", old, new):
        caught(f"fused prefill pass: {fault}", lambda: cs.phase_prefill_passes(asr))
