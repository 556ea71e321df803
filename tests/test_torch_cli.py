"""The port's CLI (`qwen3-asr-cuda-cli`, qwen3_asr_tpu_torch/cli.py) on the
CPU against the JAX package's (qwen3_asr_tpu/cli.py), mirroring the
transcription cases of tests/test_cli.py on a tiny GGUF: the same flags and
defaults, the transcript (or the -o notice) on stdout and diagnostics on
stderr, exit 1 on errors. `--spec-k` prints the JAX CLI's `--kv-int8`
transcript (the int8pc greedy sequence), and `--temperature` with `--seed`
is reproducible. The alignment modes (`--align`, `-a`) print the JAX
CLI's stdout byte for byte in json, srt and vtt, on a tiny aligner GGUF. The tokens (`--tokens`, printed on stderr) of the
default configuration (`--quantize auto`: int8pc weights, the int8 decode
pack, a bf16 cache) and of `--kv-int8` equal the JAX CLI's; with `--kv-int4`
(the int4 cache) and `--progress` (the streaming path) they equal the
port's pipeline in that mode, and `--progress` prints the JAX CLI's
"Generated N tokens..." lines on stderr only. (The JAX CLI on the CPU runs
its XLA step, not the megakernel, so its `--kv-int4` decodes over int8.)"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from qwen3_asr_tpu.audio import write_wav
from qwen3_asr_tpu.cli import main as jax_main
from qwen3_asr_tpu.config import tiny_asr_config
from qwen3_asr_tpu.runtime.params import init_asr_params
from qwen3_asr_tpu_torch.cli import build_parser, main

from helpers import make_byte_vocab, write_tiny_gguf


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """(tiny ASR GGUF, a 1 s 440 Hz WAV, an 8 kHz WAV), as tests/test_cli.py
    writes them."""
    d = tmp_path_factory.mktemp("cli")
    cfg = tiny_asr_config()
    params = jax.tree.map(np.asarray, init_asr_params(cfg, 3, jnp.float32))
    vocab = make_byte_vocab(cfg.decoder.vocab_size, {
        cfg.decoder.eos_token_id: "<|im_end|>",
        cfg.decoder.audio_pad_token_id: "<|audio_pad|>",
    })
    model = str(d / "asr.gguf")
    write_tiny_gguf(model, cfg, params, vocab=vocab, merges=[])
    t = np.arange(16000) / 16000
    wav = str(d / "a.wav")
    write_wav(wav, (0.3 * np.sin(2 * np.pi * 440 * t)).astype(np.float32))
    wav8k = str(d / "b.wav")
    write_wav(wav8k, np.zeros(8000, np.float32), sample_rate=8000)
    return model, wav, wav8k


def tokens(err: str) -> list[int]:
    return [int(x) for x in re.findall(r"^  \[\d+\] (\d+)$", err, re.M)]


@pytest.mark.parametrize("extra", [[], ["--kv-int8"]], ids=["default", "kv-int8"])
def test_tokens_equal_jax_cli(files, capsys, extra):
    model, wav, _ = files
    args = ["-m", model, "-f", wav, "--max-tokens", "6", "--no-timing", "--tokens", *extra]
    assert jax_main(args + ["--platform", "cpu"]) == 0
    want = capsys.readouterr()
    assert main(args + ["--platform", "cpu"]) == 0
    got = capsys.readouterr()
    assert tokens(got.err) == tokens(want.err) and tokens(want.err)
    assert got.out == want.out and got.out.endswith("\n")


def test_stdout_holds_only_the_transcript(files, capsys, tmp_path):
    model, wav, _ = files
    assert main(["-m", model, "-f", wav, "--max-tokens", "4", "--platform", "cpu",
                 "-t", "2", "--no-fused", "--profile"]) == 0
    cap = capsys.readouterr()
    assert cap.out.count("\n") == 1 and "Timing" not in cap.out
    assert "Threads: 2" in cap.err and "Audio encoding:" in cap.err
    assert "=== Timing Profile ===" in cap.err and "decode.generate" in cap.err
    out = tmp_path / "out.txt"
    assert main(["-m", model, "-f", wav, "--max-tokens", "4", "--platform", "cpu",
                 "--no-timing", "-o", str(out)]) == 0
    cap2 = capsys.readouterr()
    assert cap2.out == "" and "Output written to" in cap2.err
    assert out.read_text() == cap.out


def test_bad_inputs_exit_1(files, capsys, tmp_path):
    model, wav, wav8k = files
    for args, msg in ((["-f", wav8k], "Audio must be 16kHz"),
                      (["-f", str(tmp_path / "nope.wav")], "Failed to load audio"),
                      (["-f", wav, "-m", str(tmp_path / "none.gguf")], "Failed to load model")):
        argv = ["-m", model, "--no-timing", "--platform", "cpu"] + args
        assert main(argv) == 1
        cap = capsys.readouterr()
        assert cap.out == "" and msg in cap.err


def test_truncated_gguf_exits_1_without_traceback(files, capsys, tmp_path):
    """A 9-byte GGUF (magic and version 3, then nothing) fails to load as in
    the JAX CLI: `Error: Failed to load model: ...` on stderr, exit 1, no
    traceback; the port's server start-up fails the same way."""
    import struct

    from qwen3_asr_tpu_torch.serve import main as serve_main

    _, wav, _ = files
    bad = tmp_path / "short.gguf"
    bad.write_bytes(b"GGUF" + struct.pack("<I", 3) + b"\x00")
    for run, argv in ((jax_main, ["-m", str(bad), "-f", wav, "--no-timing"]),
                      (main, ["-m", str(bad), "-f", wav, "--no-timing",
                              "--platform", "cpu"]),
                      (serve_main, ["-m", str(bad), "--device", "cpu"])):
        assert run(argv) == 1
        cap = capsys.readouterr()
        assert cap.out == "" and "Error: Failed to load model:" in cap.err
        assert "Traceback" not in cap.err


def test_save_mel_matches_the_oracle(files, capsys, tmp_path):
    """--save-mel writes the golden-layout [n_mels, n_frames] f32 .npy within
    1e-4 of the JAX package's oracle, then transcribes."""
    from qwen3_asr_tpu.audio import load_wav, log_mel_spectrogram_ref

    model, wav, _ = files
    path = str(tmp_path / "mel.npy")
    assert main(["-m", model, "-f", wav, "--max-tokens", "2", "--no-timing",
                 "--platform", "cpu", "--save-mel", path]) == 0
    got = np.load(path)
    stored, _ = load_wav(wav)
    want = log_mel_spectrogram_ref(stored)
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    assert capsys.readouterr().out.endswith("\n")


@pytest.fixture(scope="module")
def fa_files(tmp_path_factory):
    """(a tiny aligner GGUF of tests/test_torch_aligner.py's wide weights, a
    4.3 s WAV whose words' timestamps are not all clamped to its end)."""
    from qwen3_asr_tpu.config import tiny_aligner_config
    from test_torch_aligner import AUDIO, jax_tree

    d = tmp_path_factory.mktemp("cli_fa")
    cfg = tiny_aligner_config()
    fa = str(d / "fa.gguf")
    write_tiny_gguf(fa, cfg, jax_tree(), aligner=True,
                    vocab=make_byte_vocab(cfg.decoder.vocab_size, {}), merges=[])
    wav = str(d / "long.wav")
    write_wav(wav, AUDIO[0].astype(np.float32) / 32768.0)
    return fa, wav


@pytest.mark.parametrize("flags", [
    ["--align", "--text", "hello bucketed world", "-m", "FA"],
    ["-a", "--aligner-model", "FA"], ["--kv-int4"],
    ["--spec-k", "2"], ["--temperature", "0.7"], ["--progress"]],
    ids=["align", "transcribe-align", "kv-int4", "spec-k", "temperature", "progress"])
def test_unported_flags_exit_1(files, fa_files, capsys, flags):
    """Every flag here once exited 1 with "not ported"; each now runs.
    --kv-int4 and --progress: exit 0, the transcript alone on stdout and the
    tokens of the port's own Qwen3ASR in that mode (the int4 cache; the
    streaming path, which gives the fused path's tokens). --align and
    --transcribe-align, since the aligner was ported: exit 0 and stdout
    equal to the JAX CLI's (f32 weights, on a tiny aligner GGUF). --spec-k,
    since speculation was ported: exit 0, stdout and tokens equal to the JAX
    CLI's int8pc greedy transcript over an int8 cache (`--kv-int8`, its XLA
    path on the CPU). --temperature (with --seed), since sampling was
    ported: exit 0, and a second run with the same seed prints the same
    transcript and tokens."""
    from qwen3_asr_tpu_torch.pipeline.asr import Qwen3ASR, TranscribeParams

    model, wav, _ = files
    fa, long_wav = fa_files
    if flags[0] in ("--align", "-a"):
        argv = ["-m", model, "-f", long_wav, "--dtype", "float32", "--no-timing",
                "--max-tokens", "6"] + [fa if f == "FA" else f for f in flags]
        assert jax_main(argv + ["--platform", "cpu"]) == 0
        want = capsys.readouterr()
        assert main(argv + ["--platform", "cpu"]) == 0
        got = capsys.readouterr()
        assert got.out == want.out and '"words"' in got.out
        return
    argv = ["-m", model, "-f", wav, "--platform", "cpu"] + flags
    run = ["--max-tokens", "6", "--no-timing", "--tokens"]
    if flags[0] == "--spec-k":
        assert jax_main(["-m", model, "-f", wav, "--platform", "cpu", "--kv-int8"] + run) == 0
        want = capsys.readouterr()
        assert main(argv + run) == 0
        got = capsys.readouterr()
        assert got.out == want.out and tokens(got.err) == tokens(want.err)
        assert len(tokens(got.err)) == 6
        return
    if flags[0] == "--temperature":
        outs = []
        for _ in range(2):
            assert main(argv + ["--seed", "3"] + run) == 0
            outs.append(capsys.readouterr())
        assert outs[0].out == outs[1].out and len(tokens(outs[0].err)) >= 1
        assert tokens(outs[0].err) == tokens(outs[1].err)
        return
    assert main(argv + run) == 0
    cap = capsys.readouterr()
    asr = Qwen3ASR(quantize="auto", kv_cache="int4" if flags[0] == "--kv-int4" else None,
                   device="cpu")
    assert asr.load_model(model)
    want = asr.transcribe(wav, TranscribeParams(max_tokens=6, fused=True, print_timing=False))
    assert tokens(cap.err) == want.tokens and cap.out == want.text + "\n"


@pytest.mark.parametrize("fmt", ["json", "srt", "vtt"])
@pytest.mark.parametrize("mode", [["--align", "--text", "one two three four five six"],
                                  ["--align", "--text", "ab cd", "--no-fused", "--quantize", "q8_0"],
                                  ["-a", "--aligner-model", "FA", "--mel-bucket", "300"]],
                         ids=["align", "align-staged-q8_0", "transcribe-align-bucketed"])
def test_align_output_formats_equal_jax_cli(files, fa_files, capsys, tmp_path, fmt, mode):
    """--output-format json / srt / vtt: stdout byte-equal to the JAX CLI's
    in align mode (fused, and staged with q8_0 weights) and in
    transcribe-align mode (bucketed); the timing block on stderr only; -o
    writes the same bytes."""
    model, _, _ = files
    fa, wav = fa_files
    argv = ["-f", wav, "--dtype", "float32", "--max-tokens", "6", "--platform", "cpu",
            "--output-format", fmt, "-m", fa if mode[0] == "--align" else model]
    argv += [fa if f == "FA" else f for f in mode]
    assert jax_main(argv) == 0
    want = capsys.readouterr()
    assert main(argv) == 0
    got = capsys.readouterr()
    assert got.out == want.out and "Timing" not in got.out and "Timing" in got.err
    if mode[0] == "--align":   # the tiny ASR model's transcript is empty
        head = {"json": '{\n  "words"', "srt": "1\n", "vtt": "WEBVTT\n"}[fmt]
        assert got.out.startswith(head)
    out = tmp_path / f"out.{fmt}"
    assert main(argv + ["-o", str(out)]) == 0
    assert capsys.readouterr().out == "" and out.read_text() == got.out


@pytest.mark.parametrize("flags,msg", [
    (["--align"], "Reference text is required for alignment mode (--text)"),
    (["--align", "--text", "hi", "-a"], "--align and --transcribe-align cannot be used together"),
    (["-a"], "--aligner-model is required for --transcribe-align")],
    ids=["no-text", "both-modes", "no-aligner-model"])
def test_align_argument_errors(files, capsys, flags, msg):
    """The JAX CLI's three argument errors, with its messages: exit 1,
    nothing on stdout, before any model loads."""
    model, wav, _ = files
    for run in (jax_main, main):
        assert run(["-m", model, "-f", wav, "--platform", "cpu"] + flags) == 1
        cap = capsys.readouterr()
        assert cap.out == "" and cap.err.strip() == f"Error: {msg}"


def test_progress_lines_on_stderr(files, capsys):
    """--progress: "Generated 10 tokens..." on stderr once ten tokens are
    out (the tiny model runs to the 12-token budget), as the JAX CLI prints
    it; stdout holds the transcript alone and equals the JAX CLI's."""
    model, wav, _ = files
    got = _run(main, model, wav, ["--max-tokens", "12", "--progress", "--tokens"], capsys)
    want = _run(jax_main, model, wav, ["--max-tokens", "12", "--progress", "--tokens"], capsys)
    assert len(tokens(got.err)) == 12 and tokens(got.err) == tokens(want.err)
    assert got.out == want.out and "Generated" not in got.out
    assert "Generated 10 tokens..." in got.err and "Generated 10 tokens..." in want.err


def _run(fn, model, wav, extra, capsys):
    assert fn(["-m", model, "-f", wav, "--no-timing", "--platform", "cpu", *extra]) == 0
    return capsys.readouterr()


def test_defaults_and_device(files, capsys, tmp_path):
    """The JAX CLI's defaults; --trace-dir writes a torch.profiler trace;
    without --platform cpu the card is required (no quiet CPU run)."""
    import torch

    a = build_parser().parse_args(["-f", "x.wav"])
    assert (a.quantize, a.kv_int8, a.fused, a.dtype, a.threads, a.max_tokens) == \
        ("auto", False, True, "bfloat16", 4, 1024)
    model, wav, _ = files
    trace = tmp_path / "trace"
    assert main(["-m", model, "-f", wav, "--max-tokens", "2", "--no-timing",
                 "--platform", "cpu", "--trace-dir", str(trace)]) == 0
    assert (trace / "trace.json").stat().st_size > 0
    capsys.readouterr()
    if not torch.cuda.is_available():
        assert main(["-m", model, "-f", wav, "--max-tokens", "2"]) == 1
        cap = capsys.readouterr()
        assert cap.out == "" and "no CUDA device" in cap.err
