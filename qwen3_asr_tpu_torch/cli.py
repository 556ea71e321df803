"""qwen3-asr-cuda-cli — the port's command-line interface.

    python -m qwen3_asr_tpu_torch.cli -m model.gguf -f audio.wav [--platform cpu]
    python -m qwen3_asr_tpu_torch.cli -m fa.gguf -f audio.wav --align --text "..."
    python -m qwen3_asr_tpu_torch.cli -m asr.gguf --aligner-model fa.gguf -f audio.wav -a

Port of qwen3_asr_tpu/cli.py: its three modes (transcription, `--align`
with `--text`, and `-a/--transcribe-align` with `--aligner-model`), flags,
defaults, argument checks and messages, and its contract (the transcript or
the alignment, `--output-format json | srt | vtt`, or the `-o` file's
notice, on stdout; diagnostics on stderr; exit 1 on any error). It runs on
the CUDA card; `--platform cpu` runs the port's plain PyTorch versions on
the CPU instead, and no other value falls back to the CPU. `--progress`
takes the streaming decode path and prints "Generated N tokens..." on
stderr every 10 tokens; `--kv-int4` decodes over the int4 KV cache;
`--language korean` splits an alignment's words with the repo's Korean
dictionary. `--temperature` (with `--top-k`, `--top-p`, `--seed`) decodes
by sampling and `--spec-k` by greedy self-speculation (the int8pc greedy
transcript, drafted through the decode pack). `--threads` is accepted and
printed, and has no effect.
"""

from __future__ import annotations

import argparse
import sys


def _eprint(*args):
    print(*args, file=sys.stderr, flush=True)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="qwen3-asr-cuda-cli",
        description="Qwen3-ASR speech-to-text (PyTorch / CUDA)",
    )
    p.add_argument("-m", "--model", default="models/qwen3-asr-0.6b-f16.gguf",
                   help="Path to GGUF model")
    p.add_argument("-f", "--audio", required=True,
                   help="Path to audio file (WAV, 16kHz mono)")
    p.add_argument("-o", "--output", default="", help="Output file (default stdout)")
    p.add_argument("-l", "--language", "--lang", default="",
                   help="Language (e.g. 'korean' for the Korean word split of "
                        "an alignment); transcription detects it")
    p.add_argument("-t", "--threads", type=int, default=4,
                   help="Host thread count (accepted for parity; no effect)")
    p.add_argument("--max-tokens", type=int, default=1024)
    p.add_argument("--progress", action="store_true", dest="print_progress",
                   help="Decode through the streaming path (8 tokens per host "
                        "read) and print 'Generated N tokens...' on stderr "
                        "every 10 tokens")
    p.add_argument("--no-timing", action="store_false", dest="print_timing")
    p.add_argument("--tokens", action="store_true", dest="print_tokens")
    p.add_argument("--profile", action="store_true",
                   help="Print the named-section timing profile")
    p.add_argument("--align", action="store_true", dest="align_mode",
                   help="Forced alignment of --text against the audio (-m is "
                        "the aligner GGUF)")
    p.add_argument("--text", default="", dest="align_text",
                   help="Reference transcript for alignment")
    p.add_argument("-a", "--transcribe-align", action="store_true",
                   dest="transcribe_align_mode",
                   help="Transcribe, then align the transcript's words")
    p.add_argument("--aligner-model", default="",
                   help="Forced aligner GGUF (required with --transcribe-align)")
    p.add_argument("--dtype", default="bfloat16", choices=["bfloat16", "float32"],
                   help="Compute dtype of the weights and activations")
    p.add_argument("--quantize", default="auto",
                   choices=["auto", "none", "q8_0", "int8pc", "int4"],
                   help="Decoder weight quantization. 'auto' (default) picks "
                        "int8pc (per-channel int8) for dense GGUFs and leaves "
                        "Q8_0 files on their int8 blocks; 'none' forces dense; "
                        "'int4' nibble-packs the decode weights (prefill stays "
                        "int8)")
    p.add_argument("--kv-int8", action="store_true",
                   help="int8 KV cache (per-row, per-head scales) instead of bf16")
    p.add_argument("--kv-int4", action="store_true",
                   help="int4 KV cache: the decode step reads nibble-packed "
                        "cache rows (a quarter of bf16's cache bytes). ~4x "
                        "int8's KV quantization error; overrides --kv-int8; "
                        "runs as int8 without the decode pack (q8_0, none)")
    p.add_argument("--spec-k", type=int, default=0,
                   help="Greedy self-speculation: draft K tokens per round "
                        "through the decode megakernel's weight stream, verify "
                        "the block in one int8pc pass. Output is exactly the "
                        "int8pc greedy sequence; speed follows the acceptance "
                        "rate. Needs a decode pack (--quantize auto / int8pc / "
                        "int4) and runs over an int8 KV cache; use only when "
                        "int8pc-exact output is required. 0 = off (default)")
    p.add_argument("--temperature", type=float, default=0.0,
                   help="Sampled decoding temperature (0 = greedy, the "
                        "reference's only mode). >0 draws tokens from the "
                        "softmax, as the OpenAI transcription API's "
                        "temperature does")
    p.add_argument("--top-k", type=int, default=0,
                   help="With --temperature: keep only the K most likely "
                        "tokens before sampling (0 = no filter)")
    p.add_argument("--top-p", type=float, default=1.0,
                   help="With --temperature: nucleus sampling, keep the "
                        "smallest set of tokens whose probability mass "
                        "reaches P (1.0 = no filter)")
    p.add_argument("--seed", type=int, default=0,
                   help="Seed for --temperature sampling (same seed and device "
                        "=> same transcript)")
    p.add_argument("--fused", action="store_true", default=True,
                   help="Mel, encoder and decode in one call (default)")
    p.add_argument("--no-fused", action="store_false", dest="fused",
                   help="Staged: mel, encoder and decode timed separately")
    p.add_argument("--mel-bucket", type=int, default=0,
                   help="Pad mel frames to this bucket (rounded to the "
                        "100-frame chunk); 0 = exact shapes")
    p.add_argument("--platform", default="",
                   help="'cpu' runs on the CPU; anything else (or nothing) on "
                        "the CUDA card")
    p.add_argument("--trace-dir", default="",
                   help="Write a torch.profiler trace (Chrome JSON) here")
    p.add_argument("--output-format", default="json", choices=["json", "srt", "vtt"],
                   help="Alignment output (--align / --transcribe-align): the "
                        "words JSON (default), or SubRip / WebVTT subtitles "
                        "built from the word timestamps")
    p.add_argument("--save-mel", default="", metavar="PATH",
                   help="Debug hook: also write the input's log-mel spectrogram "
                        "as a .npy ([n_mels, n_frames] f32, the golden-file "
                        "layout) before transcribing")
    return p


def _write_output(text: str, output_path: str) -> int:
    if not output_path:
        print(text, flush=True)
        return 0
    try:
        with open(output_path, "w", encoding="utf-8") as f:
            f.write(text + "\n")
    except OSError:
        _eprint(f"Error: Failed to open output file: {output_path}")
        return 1
    _eprint(f"Output written to: {output_path}")
    return 0


def _finish(args, text: str) -> int:
    """The result on stdout (or the -o file), then --profile's report."""
    from qwen3_asr_tpu_torch.runtime.profiler import profiler

    rc = _write_output(text, args.output)
    if args.profile:
        _eprint(profiler.report())
    return rc


def _check_args(args) -> str:
    """The JAX CLI's argument errors, or ""."""
    if args.align_mode and not args.align_text:
        return "Reference text is required for alignment mode (--text)"
    if args.align_mode and args.transcribe_align_mode:
        return "--align and --transcribe-align cannot be used together"
    if args.transcribe_align_mode and not args.aligner_model:
        return "--aligner-model is required for --transcribe-align"
    return ""


def _render_alignment(args, result) -> str:
    from qwen3_asr_tpu_torch.pipeline.combined import alignment_to_json
    from qwen3_asr_tpu_torch.text.subtitles import words_to_srt, words_to_vtt

    if args.output_format == "srt":
        return words_to_srt(result.words)
    if args.output_format == "vtt":
        return words_to_vtt(result.words)
    return alignment_to_json(result)


def _run_transcribe_align(args, tp, asr, aligner) -> int:
    from qwen3_asr_tpu_torch.pipeline.combined import transcribe_and_align

    _eprint("qwen3-asr-cuda-cli (Transcribe + Align Mode)")
    _eprint(f"  ASR Model: {args.model}")
    _eprint(f"  Aligner Model: {args.aligner_model}")
    _eprint(f"  Audio: {args.audio}\n")
    if not asr.load_model(args.model):
        _eprint(f"Error (ASR): {asr.error_msg}")
        return 1
    if not aligner.load_model(args.aligner_model):
        _eprint(f"Error (Aligner): {aligner.error_msg}")
        return 1
    combined = transcribe_and_align(asr, aligner, args.audio, tp,
                                    language_override=args.language)
    if not combined.success:
        _eprint(f"Error: {combined.error_msg}")
        return 1
    _eprint(f"  Detected language: {combined.detected_language or '(none)'}")
    _eprint(f"  Transcript: {combined.transcript}")
    if args.print_timing:
        asr_ms, align_ms = combined.asr.t_total_ms, combined.alignment.t_total_ms
        _eprint(f"\nCombined Timing:\n"
                f"  ASR:           {asr_ms:.0f} ms\n"
                f"  Alignment:     {align_ms:.0f} ms\n"
                f"  Total:         {asr_ms + align_ms:.0f} ms\n"
                f"  Words aligned: {len(combined.alignment.words)}")
    return _finish(args, _render_alignment(args, combined.alignment))


def _run_align(args, aligner) -> int:
    from qwen3_asr_tpu_torch.text.korean import find_korean_dict

    _eprint("qwen3-asr-cuda-cli (Forced Alignment Mode)")
    _eprint(f"  Model: {args.model}")
    _eprint(f"  Audio: {args.audio}")
    _eprint(f"  Text: {args.align_text}")
    if args.language:
        _eprint(f"  Language: {args.language}")
    _eprint("")
    if not aligner.load_model(args.model):
        _eprint(f"Error: {aligner.error_msg}")
        return 1
    if args.language == "korean":
        dict_path = find_korean_dict(args.model)
        if not dict_path:
            _eprint("Warning: Korean dictionary not found. "
                    "Falling back to whitespace splitting.")
        elif not aligner.load_korean_dict(dict_path):
            _eprint(f"Warning: Failed to load Korean dictionary from {dict_path}")
    _eprint("Model loaded. Running alignment...")
    result = aligner.align(args.audio, args.align_text, args.language,
                           mel_bucket=args.mel_bucket,
                           fused=args.fused and args.mel_bucket == 0)
    if not result.success:
        _eprint(f"Error: {result.error_msg}")
        return 1
    if args.print_timing:
        _eprint(f"\nTiming:\n"
                f"  Mel spectrogram: {result.t_mel_ms:.0f} ms\n"
                f"  Audio encoding:  {result.t_encode_ms:.0f} ms\n"
                f"  Text decoding:   {result.t_decode_ms:.0f} ms\n"
                f"  Total:           {result.t_total_ms:.0f} ms\n"
                f"  Words aligned:   {len(result.words)}")
    return _finish(args, _render_alignment(args, result))


def _run_transcribe(args, tp, asr) -> int:
    _eprint("qwen3-asr-cuda-cli")
    _eprint(f"  Model: {args.model}")
    _eprint(f"  Audio: {args.audio}")
    _eprint(f"  Threads: {args.threads}\n")
    if not asr.load_model(args.model):
        _eprint(f"Error: {asr.error_msg}")
        return 1
    result = asr.transcribe(args.audio, tp)
    if not result.success:
        _eprint(f"Error: {result.error_msg}")
        return 1
    if args.print_tokens:
        _eprint(f"\nTokens ({len(result.tokens)}):")
        for i, t in enumerate(result.tokens):
            _eprint(f"  [{i}] {t}")
    return _finish(args, result.text)


def _save_mel(args, device) -> int:
    """The input's log-mel [n_mels, n_frames] f32 as .npy, computed by the
    port's mel on `device`."""
    import numpy as np
    import torch

    from qwen3_asr_tpu_torch.audio.mel import filters_t, generate_mel_filters, mel_device
    from qwen3_asr_tpu_torch.audio.wav import load_wav
    from qwen3_asr_tpu_torch.config import SAMPLE_RATE
    from qwen3_asr_tpu_torch.models.e2e import _pad_pcm

    try:
        samples, sr = load_wav(args.audio, raw_int16=True)
    except (OSError, ValueError) as e:
        _eprint(f"Error: Failed to load audio file: {e}")
        return 1
    if sr != SAMPLE_RATE:
        _eprint(f"Error: Audio must be 16kHz, got {sr} Hz")
        return 1
    buf, n_frames = _pad_pcm(samples)
    mel = mel_device(torch.from_numpy(buf).to(device),
                     filters_t(generate_mel_filters(), device), n_frames).T
    np.save(args.save_mel, mel.cpu().numpy().astype(np.float32))
    _eprint(f"Mel spectrogram saved: {args.save_mel} "
            f"(shape {mel.shape[0]}x{mel.shape[1]})")
    return 0


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    err = _check_args(args)
    if err:
        _eprint(f"Error: {err}")
        return 1
    import torch

    from qwen3_asr_tpu_torch.pipeline.aligner import ForcedAligner
    from qwen3_asr_tpu_torch.pipeline.asr import Qwen3ASR, TranscribeParams

    tp = TranscribeParams(
        max_tokens=args.max_tokens, language=args.language,
        print_progress=args.print_progress, print_timing=args.print_timing,
        fused=args.fused, mel_bucket=args.mel_bucket, spec_k=args.spec_k,
        temperature=args.temperature, top_k=args.top_k, top_p=args.top_p,
        seed=args.seed)

    device = "cpu" if args.platform == "cpu" else "cuda"
    dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
    quantize = "" if args.quantize == "none" else args.quantize
    try:
        asr = aligner = None
        if not args.align_mode:
            asr = Qwen3ASR(quantize=quantize, kv_int8=args.kv_int8,
                           kv_cache="int4" if args.kv_int4 else None,
                           device=device, dtype=dtype)
        if args.align_mode or args.transcribe_align_mode:
            aligner = ForcedAligner(quantize=quantize, device=device, dtype=dtype)
    except RuntimeError as e:   # no CUDA device: never a quiet CPU run
        _eprint(f"Error: {e}")
        return 1
    if args.save_mel and _save_mel(args, (asr or aligner).device):
        return 1

    trace = None
    if args.trace_dir:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                         if device == "cuda" else [])
        trace = profile(activities=acts)
        trace.__enter__()
    try:
        if args.transcribe_align_mode:
            rc = _run_transcribe_align(args, tp, asr, aligner)
        elif args.align_mode:
            rc = _run_align(args, aligner)
        else:
            rc = _run_transcribe(args, tp, asr)
    finally:
        if trace is not None:
            trace.__exit__(None, None, None)
            import os

            os.makedirs(args.trace_dir, exist_ok=True)
            path = os.path.join(args.trace_dir, "trace.json")
            trace.export_chrome_trace(path)
            _eprint(f"Trace written to: {path}")
    return rc


if __name__ == "__main__":
    sys.exit(main())
