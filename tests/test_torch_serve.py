"""The port's server (serve.py) on the CPU at the tiny config: ASRServer in
both worker modes against the functions it drives, and the HTTP front end
on 127.0.0.1, port 0: /v1/transcribe, /healthz, /v1/audio/transcriptions
(json, text, verbose_json, SSE on the continuous pool and, alone through
the streaming decode path, outside it), `--kv-cache int4` (lone requests
over the int4 cache, batches over int8) and the 400s for what is not
ported. The model is the wide-init one of tests/test_torch_batch.py; its
tokens are held equal to the functions the worker calls on the same
requests."""

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
from qwen3_asr_tpu_torch.serve import NOT_PORTED, ASRServer, serve_http
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
     "/v1/audio/transcriptions", NOT_PORTED["words"]),
    ({"response_format": "srt"}, "/v1/audio/transcriptions", NOT_PORTED["subtitles"]),
    ({"temperature": "0.5"}, "/v1/audio/transcriptions", NOT_PORTED["sampling"]),
    ({"text": "hello"}, "/v1/align", NOT_PORTED["align"]),
])
def test_http_unported_answer_400(http, fields, path, msg):
    _, base = http
    body, ctype = multipart({"file": wav_bytes(AUDIO[0]), **fields})
    code, _, out = post(base + path, body, ctype)
    assert code == 400
    err = json.loads(out)["error"]
    assert (err["message"] if isinstance(err, dict) else err) == msg


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
    cache; in a mode transcribe_batch refuses (here a bf16 cache) a closed
    batch is answered one request at a time with transcribe's tokens, as
    the JAX server answers a one-item group."""
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
    with pytest.raises(NotImplementedError, match="int8 KV"):
        bf16.transcribe_batch(AUDIO[:2], PARAMS)
    srv = ASRServer(bf16, PARAMS, max_batch=2, max_wait_ms=2000)
    batches = []
    run = srv._run_transcribe
    srv._run_transcribe = lambda batch: batches.append(len(batch)) or run(batch)
    try:
        got = [f.result(timeout=300) for f in [srv.submit(a) for a in AUDIO[:2]]]
    finally:
        srv.close()
    assert batches == [2]
    want = [bf16.transcribe(a, PARAMS) for a in AUDIO[:2]]
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
