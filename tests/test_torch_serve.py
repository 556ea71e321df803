"""The port's server (serve.py) on the CPU at the tiny config: ASRServer in
both worker modes against the functions it drives, and the HTTP front end
on 127.0.0.1, port 0: /v1/transcribe, /healthz, /v1/audio/transcriptions
(json, text, verbose_json, SSE on the continuous pool and, alone through
the streaming decode path, outside it), `--kv-cache int4` (lone requests
over the int4 cache, batches over int8), sampled requests (`temperature`,
`seed`: alone, outside the greedy batch and the pool, with the JAX
package's 400s for a temperature outside [0, 2], a seed that is no integer
and a sampled stream) and, without an aligner, the JAX package's
no-aligner 400s. With an aligner
(`--aligner-model`): /v1/align in its three encodings, concurrent aligns in
one `align_batch`, mixed ASR + align traffic in same-kind batches, and the
OpenAI route's word timestamps, srt and vtt. The models are the wide-init
ones of tests/test_torch_batch.py and tests/test_torch_aligner.py; their
tokens and words are held equal to the functions the worker calls on the
same requests."""

import io
import json
import struct
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

from qwen3_asr_tpu_torch.pipeline.asr import TranscribeParams
from qwen3_asr_tpu_torch.pipeline.engine import ContinuousEngine
from qwen3_asr_tpu_torch.serve import (
    NO_ALIGNER,
    NO_ALIGNER_WORDS,
    ASRServer,
    serve_http,
)
from test_torch_batch import AUDIO, GAIN, jax_and_port
from test_torch_engine import KW, drive

PARAMS = TranscribeParams(max_tokens=KW["max_tokens"], prompt_bucket=KW["prompt_bucket"],
                          mel_bucket=KW["mel_bucket"])


@pytest.fixture(scope="module")
def model():
    return jax_and_port(gain=GAIN)[1]


def wav_bytes(samples: np.ndarray, sr: int = 16000) -> bytes:
    pcm = np.asarray(samples, "<i2")
    buf = io.BytesIO()
    buf.write(b"RIFF" + struct.pack("<I", 36 + pcm.nbytes) + b"WAVEfmt ")
    buf.write(struct.pack("<IHHIIHH", 16, 1, 1, sr, sr * 2, 2, 16))
    buf.write(b"data" + struct.pack("<I", pcm.nbytes) + pcm.tobytes())
    return buf.getvalue()


def multipart(fields: dict) -> tuple[bytes, str]:
    boundary = "torchserveboundary"
    out = b""
    for name, value in fields.items():
        for v in value if isinstance(value, list) else [value]:
            fn = '; filename="a.wav"' if name == "file" else ""
            out += (f"--{boundary}\r\nContent-Disposition: form-data; "
                    f'name="{name}"{fn}\r\n\r\n').encode()
            out += (v if isinstance(v, bytes) else str(v).encode()) + b"\r\n"
    out += f"--{boundary}--\r\n".encode()
    return out, f"multipart/form-data; boundary={boundary}"


def test_closed_batches_match_transcribe_batch(model):
    """Requests arriving together form one closed batch: the server's
    tokens are transcribe_batch's; a lone request goes to transcribe."""
    srv = ASRServer(model, PARAMS, max_batch=4, max_wait_ms=2000)
    try:
        futs = [srv.submit(a) for a in AUDIO]
        got = [f.result(timeout=300).tokens for f in futs]
        lone = srv.submit(AUDIO[0]).result(timeout=300)
    finally:
        srv.close()
    assert got == [r.tokens for r in model.transcribe_batch(AUDIO, PARAMS)]
    assert lone.tokens == model.transcribe(AUDIO[0], PARAMS).tokens
    assert srv.n_served == 4 and srv.n_batches == 2


def test_server_transcribe_waits_on_submit(model):
    """ASRServer.transcribe(samples) is submit(samples).result(), the JAX
    server's contract: the lone request's result, as transcribe gives it."""
    srv = ASRServer(model, PARAMS, max_batch=2, max_wait_ms=1.0)
    try:
        r = srv.transcribe(AUDIO[0])
    finally:
        srv.close()
    assert r.success
    assert r.tokens == model.transcribe(AUDIO[0], PARAMS).tokens
    assert srv.n_served == 1


def test_continuous_server_matches_engine(model):
    srv = ASRServer(model, PARAMS, continuous=True, pool=2,
                    round_tokens=KW["round_tokens"], engine_context=KW["s_pool"])
    try:
        futs = [srv.submit(a) for a in AUDIO]
        got = [f.result(timeout=300).tokens for f in futs]
        q = srv.submit_stream(AUDIO[1])
        events = []
        while not events or events[-1][0] not in ("done", "error"):
            events.append(q.get(timeout=300))
    finally:
        srv.close()
    want = drive(ContinuousEngine(model, pool=2, **KW), list(enumerate(AUDIO)))
    assert got == [want[i] for i in range(len(AUDIO))]
    assert events[-1][0] == "done"
    assert events[-1][1].tokens == want[1]
    deltas = "".join(v for k, v in events if k == "delta")
    assert deltas == events[-1][1].text


def events_of(q) -> list:
    events = []
    while not events or events[-1][0] not in ("done", "error"):
        events.append(q.get(timeout=300))
    return events


def test_stream_outside_the_pool_reports_error(model):
    """A stream on the closed-batch server runs alone through the streaming
    decode path (it reported a not-ported error before that path was
    ported): its deltas add up to the done event's text and its tokens are
    transcribe's; a stream arriving inside a batch's window waits for the
    next round and the batch stays whole."""
    srv = ASRServer(model, PARAMS, max_batch=2, max_wait_ms=2000)
    try:
        futs = [srv.submit(AUDIO[0])]
        q = srv.submit_stream(AUDIO[1])
        futs.append(srv.submit(AUDIO[2]))
        got = [f.result(timeout=300).tokens for f in futs]
        events = events_of(q)
    finally:
        srv.close()
    assert events[-1][0] == "done"
    assert events[-1][1].tokens == model.transcribe(AUDIO[1], PARAMS).tokens
    assert "".join(v for k, v in events if k == "delta") == events[-1][1].text
    assert got == [r.tokens for r in model.transcribe_batch([AUDIO[0], AUDIO[2]], PARAMS)]
    assert srv.n_batches == 2


@pytest.fixture(scope="module")
def http(model):
    srv = ASRServer(model, PARAMS, continuous=True, pool=2,
                    round_tokens=KW["round_tokens"], engine_context=KW["s_pool"])
    httpd = serve_http(srv, "127.0.0.1", 0)
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    yield srv, f"http://127.0.0.1:{httpd.server_address[1]}"
    httpd.shutdown()
    httpd.server_close()
    srv.close()


def post(url, body, ctype="application/octet-stream"):
    req = urllib.request.Request(url, data=body, headers={"Content-Type": ctype})
    try:
        with urllib.request.urlopen(req, timeout=300) as r:
            return r.status, r.headers.get("Content-Type"), r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Content-Type"), e.read()


def test_http_transcribe_and_health(http, model):
    srv, base = http
    code, _, body = post(base + "/v1/transcribe", wav_bytes(AUDIO[0]))
    assert code == 200
    want = drive(ContinuousEngine(model, pool=2, **KW), [(0, AUDIO[0])])[0]
    assert json.loads(body)["text"] == model.tokenizer.decode(want)
    with urllib.request.urlopen(base + "/healthz", timeout=60) as r:
        health = json.loads(r.read())
    assert health["status"] == "ok" and health["engine"]["completed"] >= 1
    assert health["engine"]["pool"] == 2
    code, _, body = post(base + "/v1/transcribe", wav_bytes(AUDIO[0], sr=8000))
    assert code == 400 and "16kHz" in json.loads(body)["error"]


@pytest.mark.parametrize("fmt", ["json", "text", "verbose_json"])
def test_http_openai_formats(http, fmt):
    _, base = http
    body, ctype = multipart({"file": wav_bytes(AUDIO[1]), "response_format": fmt,
                             "model": "qwen3-asr"})
    code, rtype, out = post(base + "/v1/audio/transcriptions", body, ctype)
    assert code == 200
    if fmt == "text":
        assert rtype.startswith("text/plain") and out.decode().endswith("\n")
        return
    payload = json.loads(out)
    assert isinstance(payload["text"], str)
    if fmt == "verbose_json":
        assert payload["task"] == "transcribe"
        assert payload["duration"] == round(len(AUDIO[1]) / 16000, 3)
        assert len(payload["segments"]) == (1 if payload["text"].strip() else 0)


def test_http_sse_stream(http):
    _, base = http
    body, ctype = multipart({"file": wav_bytes(AUDIO[2]), "stream": "true"})
    code, rtype, out = post(base + "/v1/audio/transcriptions", body, ctype)
    assert code == 200 and rtype.startswith("text/event-stream")
    data = [line[len("data: "):] for line in out.decode().split("\n")
            if line.startswith("data: ")]
    assert data[-1] == "[DONE]"
    events = [json.loads(d) for d in data[:-1]]
    assert events[-1]["type"] == "transcript.text.done"
    deltas = "".join(e["delta"] for e in events if e["type"] == "transcript.text.delta")
    assert deltas == events[-1]["text"]


@pytest.mark.parametrize("fields,path,msg", [
    ({"timestamp_granularities[]": "word", "response_format": "verbose_json"},
     "/v1/audio/transcriptions", NO_ALIGNER_WORDS),
    ({"response_format": "srt"}, "/v1/audio/transcriptions", NO_ALIGNER_WORDS),
    ({"temperature": "3"}, "/v1/audio/transcriptions", "temperature must be in [0, 2]"),
    ({"temperature": "0.5", "seed": "x"}, "/v1/audio/transcriptions",
     "seed must be an integer"),
    ({"temperature": "0.5", "stream": "true"}, "/v1/audio/transcriptions",
     "stream=true is greedy-only (sampled decoding runs as one whole-loop program)"),
    ({"text": "hello"}, "/v1/align", NO_ALIGNER),
])
def test_http_unported_answer_400(http, fields, path, msg):
    """The JAX package's 400s: a temperature outside [0, 2] (sampled
    decoding itself answered 400 before it was ported), a sampled request
    whose seed is no integer, a sampled stream; word timestamps, srt and
    /v1/align on a server started without --aligner-model answer the
    no-aligner messages."""
    _, base = http
    body, ctype = multipart({"file": wav_bytes(AUDIO[0]), **fields})
    code, _, out = post(base + path, body, ctype)
    assert code == 400
    err = json.loads(out)["error"]
    assert (err["message"] if isinstance(err, dict) else err) == msg


def test_http_sampled_requests(http, model):
    """temperature=0.7, seed=3 on the OpenAI route, twice, on the continuous
    server: 200 both times, the same text, that of transcribe with those
    parameters (the request ran alone, outside the pool)."""
    import dataclasses

    from qwen3_asr_tpu_torch.text.prompt import extract_transcript

    srv, base = http
    body, ctype = multipart({"file": wav_bytes(AUDIO[1]), "temperature": "0.7",
                             "seed": "3"})
    replies = [post(base + "/v1/audio/transcriptions", body, ctype) for _ in range(2)]
    assert [r[0] for r in replies] == [200, 200]
    texts = [json.loads(r[2])["text"] for r in replies]
    want = model.transcribe(AUDIO[1], dataclasses.replace(srv.params, temperature=0.7,
                                                          seed=3))
    assert texts[0] == texts[1] == extract_transcript(want.text)


def test_solo_sampled_request_beside_a_greedy_batch(model):
    """A request with its own params arriving inside a greedy batch's
    window runs alone, with them: the two greedy requests still get
    transcribe_batch's tokens, the sampled one transcribe's with its
    params (two rounds)."""
    import dataclasses

    sampled = dataclasses.replace(PARAMS, temperature=0.9, top_k=20, seed=5)
    srv = ASRServer(model, PARAMS, max_batch=4, max_wait_ms=2000)
    try:
        futs = [srv.submit(AUDIO[0]), srv.submit(AUDIO[1], params=sampled),
                srv.submit(AUDIO[2])]
        got = [f.result(timeout=300).tokens for f in futs]
    finally:
        srv.close()
    assert [got[0], got[2]] == [r.tokens for r in
                                model.transcribe_batch([AUDIO[0], AUDIO[2]], PARAMS)]
    assert got[1] == model.transcribe(AUDIO[1], sampled).tokens
    assert srv.n_batches == 2


def test_http_stream_needs_the_pool(model):
    """SSE on the closed-batch server (no pool, which it needed before the
    streaming decode path was ported): 200, deltas, done, [DONE]."""
    srv = ASRServer(model, PARAMS, max_batch=2, max_wait_ms=1)
    httpd = serve_http(srv, "127.0.0.1", 0)
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    try:
        body, ctype = multipart({"file": wav_bytes(AUDIO[0]), "stream": "true"})
        code, _, out = post(f"http://127.0.0.1:{httpd.server_address[1]}"
                            "/v1/audio/transcriptions", body, ctype)
    finally:
        httpd.shutdown()
        httpd.server_close()
        srv.close()
    assert code == 200
    data = [line[len("data: "):] for line in out.decode().split("\n")
            if line.startswith("data: ")]
    events = [json.loads(d) for d in data[:-1]]
    assert data[-1] == "[DONE]" and events[-1]["type"] == "transcript.text.done"
    assert "".join(e["delta"] for e in events[:-1]) == events[-1]["text"]


def test_main_rejects_unported_modes(model, tmp_path, capsys):
    """The JAX server's modes are offered (--quantize auto by default, --kv-cache
    int8; --kv-cache int4 and --engine-kv-stream, which changes no kernel, are
    accepted): an unknown one fails in argparse; a missing model fails at
    start-up with exit 1; the continuous pool refuses a bf16 and an int4
    cache; a closed batch over a bf16 cache runs as one transcribe_batch
    (K3's bf16 mode), whose tokens the server returns."""
    from qwen3_asr_tpu_torch.serve import build_parser, main

    args = build_parser().parse_args(["-m", "x.gguf"])
    assert (args.quantize, args.kv_cache, args.engine_kv_stream) == ("auto", "int8", False)
    args = build_parser().parse_args(["-m", "x.gguf", "--kv-cache", "int4",
                                      "--engine-kv-stream"])
    assert (args.kv_cache, args.engine_kv_stream) == ("int4", True)
    with pytest.raises(SystemExit) as e:
        main(["-m", str(tmp_path / "none.gguf"), "--quantize", "q4", "--device", "cpu"])
    assert e.value.code == 2 and "invalid choice" in capsys.readouterr().err
    assert main(["-m", str(tmp_path / "none.gguf"), "--kv-cache", "int4",
                 "--device", "cpu"]) == 1
    assert "Failed to load model" in capsys.readouterr().err
    assert main(["-m", str(tmp_path / "none.gguf"), "--device", "cpu"]) == 1
    import copy

    bf16 = copy.copy(model)
    bf16.kv_cache = "bf16"
    with pytest.raises(NotImplementedError, match="int8 KV cache"):
        ASRServer(bf16, PARAMS, continuous=True, pool=2, engine_context=KW["s_pool"])
    int4 = copy.copy(model)
    int4.kv_cache = "int4"
    with pytest.raises(NotImplementedError, match="int8 KV cache"):
        ASRServer(int4, PARAMS, continuous=True, pool=2, engine_context=KW["s_pool"])
    srv = ASRServer(bf16, PARAMS, max_batch=2, max_wait_ms=2000)
    batches = []
    run = bf16.transcribe_batch
    bf16.transcribe_batch = lambda audios, params: batches.append(len(audios)) or run(
        audios, params)
    single = bf16.transcribe
    bf16.transcribe = lambda *a, **k: batches.append("transcribe") or single(*a, **k)
    try:
        got = [f.result(timeout=300) for f in [srv.submit(a) for a in AUDIO[:2]]]
    finally:
        srv.close()
        del bf16.transcribe_batch, bf16.transcribe
    assert batches == [2]
    want = bf16.transcribe_batch(AUDIO[:2], PARAMS)
    assert all(g.success for g in got)
    assert [g.tokens for g in got] == [w.tokens for w in want]


def test_kv_cache_int4_lone_and_batch(model):
    """--kv-cache int4: a lone request decodes over the int4 cache
    (transcribe's tokens in that mode, through K1's int4 step), a batch
    over int8 (transcribe_batch's tokens, the same as the int8 model's)."""
    import copy

    int4 = copy.copy(model)
    int4.kv_cache = "int4"
    srv = ASRServer(int4, PARAMS, max_batch=2, max_wait_ms=2000)
    try:
        batch = [f.result(timeout=300).tokens for f in [srv.submit(a) for a in AUDIO[:2]]]
        lone = srv.submit(AUDIO[2]).result(timeout=300)
    finally:
        srv.close()
    assert batch == [r.tokens for r in model.transcribe_batch(AUDIO[:2], PARAMS)]
    assert lone.tokens == int4.transcribe(AUDIO[2], PARAMS).tokens


# -- with an aligner ---------------------------------------------------------

ALIGN_TEXTS = ["hello bucketed world", "one two three", "zeta eta"]


@pytest.fixture(scope="module")
def fa():
    """The port's aligner of tests/test_torch_aligner.py (f32, CPU), with
    the repo's Korean dictionary loaded as `serve.py main` loads it."""
    from qwen3_asr_tpu_torch.text.korean import find_korean_dict
    from test_torch_aligner import aligners

    aligner = aligners(False)[1]
    assert aligner.load_korean_dict(find_korean_dict())
    return aligner


def _words(r):
    assert r.success, r.error_msg
    return [(w.word, w.start, w.end) for w in r.words]


def _want_words(fa, samples, text, language=""):
    return _words(fa.align_batch([samples], [text], language=language,
                                 mel_bucket=PARAMS.mel_bucket)[0])


@pytest.fixture(scope="module")
def http_fa(model, fa):
    srv = ASRServer(model, PARAMS, max_batch=4, max_wait_ms=5, aligner=fa)
    httpd = serve_http(srv, "127.0.0.1", 0)
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    yield srv, f"http://127.0.0.1:{httpd.server_address[1]}"
    httpd.shutdown()
    httpd.server_close()
    srv.close()


@pytest.mark.parametrize("encoding", ["multipart", "json", "header"])
def test_http_align_encodings(http_fa, fa, encoding):
    """/v1/align in multipart (Korean text, language korean: the dictionary
    split), JSON (audio_b64) and a WAV body with the X-Align-Text header:
    200 and the words of align_batch on the same request."""
    import base64
    import urllib.request as ur

    from qwen3_asr_tpu_torch.text.korean import tokenize_korean

    _, base = http_fa
    samples = AUDIO[1]
    wav = wav_bytes(samples)
    text, lang = ALIGN_TEXTS[0], ""
    if encoding == "multipart":
        text, lang = "안녕하세요 여러분", "korean"
        body, ctype = multipart({"audio": wav, "text": text, "language": lang})
        code, _, out = post(base + "/v1/align", body, ctype)
    elif encoding == "json":
        body = json.dumps({"audio_b64": base64.b64encode(wav).decode(),
                           "text": text}).encode()
        code, _, out = post(base + "/v1/align", body, "application/json")
    else:
        req = ur.Request(base + "/v1/align", data=wav,
                         headers={"X-Align-Text": text, "Content-Type": "audio/wav"})
        with ur.urlopen(req, timeout=300) as r:
            code, out = r.status, r.read()
    assert code == 200
    got = [(w["word"], w["start"], w["end"]) for w in json.loads(out)["words"]]
    assert got == _want_words(fa, samples, text, lang)
    if lang == "korean":
        assert [w for w, _, _ in got] == tokenize_korean(text, fa.ko_dict) and len(got) >= 3
    code, _, out = post(base + "/v1/align", b"no text here")
    assert code == 400 and "X-Align-Text" in json.loads(out)["error"]


def test_concurrent_aligns_one_batch(model, fa):
    """Three alignments arriving together run as one align_batch, with its
    words."""
    calls = []
    run = fa.align_batch
    srv = ASRServer(model, PARAMS, max_batch=4, max_wait_ms=2000, aligner=fa)
    fa.align_batch = lambda *a, **k: calls.append(len(a[0])) or run(*a, **k)
    try:
        futs = [srv.submit_align(AUDIO[i], t) for i, t in enumerate(ALIGN_TEXTS)]
        got = [_words(f.result(timeout=300)) for f in futs]
    finally:
        fa.align_batch = run
        srv.close()
    assert calls == [3]
    want = fa.align_batch(AUDIO, ALIGN_TEXTS, mel_bucket=PARAMS.mel_bucket)
    assert got == [_words(r) for r in want]


def test_mixed_asr_align_traffic(model, fa):
    """Interleaved ASR and align requests: one batch of each kind (the
    other kind is stashed for the next round), tokens equal to
    transcribe_batch's and words to align_batch's."""
    srv = ASRServer(model, PARAMS, max_batch=4, max_wait_ms=2000, aligner=fa)
    kinds = []
    run_t, run_a = srv._run_transcribe, srv._run_align
    srv._run_transcribe = lambda b: kinds.append(("asr", len(b))) or run_t(b)
    srv._run_align = lambda b: kinds.append(("align", len(b))) or run_a(b)
    try:
        futs = []
        for i in range(2):
            futs.append(srv.submit(AUDIO[i]))
            futs.append(srv.submit_align(AUDIO[i], ALIGN_TEXTS[i]))
        res = [f.result(timeout=300) for f in futs]
    finally:
        srv.close()
    assert sorted(kinds) == [("align", 2), ("asr", 2)]
    want_t = model.transcribe_batch(AUDIO[:2], PARAMS)
    want_a = fa.align_batch(AUDIO[:2], ALIGN_TEXTS[:2], mel_bucket=PARAMS.mel_bucket)
    assert [res[0].tokens, res[2].tokens] == [r.tokens for r in want_t]
    assert [_words(res[1]), _words(res[3])] == [_words(r) for r in want_a]


@pytest.mark.parametrize("fmt", ["verbose_json", "srt", "vtt"])
def test_http_openai_words_and_subtitles(http_fa, model, fa, fmt):
    """The OpenAI route with an aligner: verbose_json with
    timestamp_granularities[]=word carries the aligner's words on the
    transcript (and one segment per cue); srt and vtt render them as the
    subtitle functions do. An ISO language code names the language."""
    from qwen3_asr_tpu_torch.text import extract_transcript
    from qwen3_asr_tpu_torch.text.subtitles import (
        group_words_into_cues,
        words_to_srt,
        words_to_vtt,
    )

    class Spoken:
        """The tiny model's tokens decode to an empty transcript: this
        tokenizer gives every decode a fixed one, so the aligner has words
        to place."""

        def decode(self, ids):
            return "language English hello bucketed world"

    _, base = http_fa
    samples = AUDIO[0]
    fields = {"file": wav_bytes(samples), "response_format": fmt, "language": "en"}
    if fmt == "verbose_json":
        fields["timestamp_granularities[]"] = "word"
    body, ctype = multipart(fields)
    tok, model.tokenizer = model.tokenizer, Spoken()
    try:
        code, rtype, out = post(base + "/v1/audio/transcriptions", body, ctype)
        transcript = extract_transcript(model.transcribe(samples, PARAMS).text)
    finally:
        model.tokenizer = tok
    assert code == 200 and transcript == "hello bucketed world"
    want = _want_words(fa, samples, transcript, "english")
    assert len(want) == 3
    if fmt == "verbose_json":
        payload = json.loads(out)
        assert payload["text"] == transcript and payload["language"] == "english"
        assert [(w["word"], w["start"], w["end"]) for w in payload["words"]] == want
        assert len(payload["segments"]) == len(group_words_into_cues(want))
        return
    assert rtype.startswith("text/plain")
    render = words_to_srt if fmt == "srt" else words_to_vtt
    assert out.decode() == render(want)
    code, _, _ = post(base + "/v1/audio/transcriptions",
                      *multipart({"file": wav_bytes(samples), "response_format": fmt,
                                  "timestamp_granularities[]": "word"}))
    assert code == 400   # granularities need verbose_json


def test_main_loads_the_aligner(tmp_path, capsys):
    """serve.py main with --aligner-model: a missing aligner file fails at
    start-up with the JAX server's message, exit 1."""
    import jax
    import jax.numpy as jnp

    from qwen3_asr_tpu.config import tiny_asr_config
    from qwen3_asr_tpu.runtime.params import init_asr_params
    from qwen3_asr_tpu_torch.serve import build_parser, main
    from helpers import make_byte_vocab, write_tiny_gguf

    cfg = tiny_asr_config()
    asr = str(tmp_path / "asr.gguf")
    write_tiny_gguf(asr, cfg, jax.tree.map(np.asarray, init_asr_params(cfg, 3, jnp.float32)),
                    vocab=make_byte_vocab(cfg.decoder.vocab_size, {}), merges=[])
    assert build_parser().parse_args(["-m", "x"]).aligner_model == ""
    assert main(["-m", asr, "--device", "cpu",
                 "--aligner-model", str(tmp_path / "none.gguf")]) == 1
    err = capsys.readouterr().err
    assert "Error (aligner): Failed to load model" in err
