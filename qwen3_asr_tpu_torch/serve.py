"""Serving: batched transcription behind a thread-safe queue, and HTTP.

Port of qwen3_asr_tpu/serve.py:89-1080 on one device, with its defaults
(`--quantize auto`: int8pc weights for a dense GGUF; `--kv-cache int8`;
`--kv-cache int4` runs lone requests over the int4 cache and batches over
int8).
`ASRServer` owns the model and, with `--aligner-model`, a `ForcedAligner`;
a single worker thread does all device work, in one of two modes:

- closed batches (the default): the worker groups up to `max_batch`
  requests arriving within `max_wait_ms` and runs them as one
  `Qwen3ASR.transcribe_batch` call in any weight and cache mode (a batch
  of one goes to `transcribe`); a
  streaming request runs alone through the pipeline's token callback
  (`_run_stream`: the streaming decode path, 8 tokens per host read);
  alignments arriving together run as one `align_batch` per language, and
  a request of another kind arriving in the window is stashed for the
  next round (mixed traffic does not split batches); a request with
  parameters of its own (`submit(samples, params)`: the OpenAI route's
  sampled requests) runs alone through `transcribe`, outside the greedy
  batch;
- continuous (`continuous=True`): greedy requests join a slot pool
  (`pipeline/engine.py::ContinuousEngine`) between decode rounds, and
  streaming requests get their text deltas from the pool's per-round
  progress hook; what the pool cannot take (alignments, requests with
  their own parameters, requests too long for its context) takes the
  closed-batch path between rounds, streams and own-parameter requests
  alone.

`serve_http()` is a stdlib `ThreadingHTTPServer` front end:

    GET  /healthz                  -> {"status": "ok", ...} (+ engine stats)
    POST /v1/transcribe            (body: 16 kHz mono WAV) -> {"text": ...}
    POST /v1/align                 (multipart `audio` + `text` [+ `language`],
                                   JSON {"audio_b64", "text", "language"},
                                   or a WAV body + X-Align-Text header)
                                   -> {"words": [...], "latency_ms": ...}
    POST /v1/audio/transcriptions  OpenAI-compatible (multipart `file`,
                                   `response_format` json | text |
                                   verbose_json | srt | vtt,
                                   `timestamp_granularities[]=word`, both
                                   through the aligner; `stream=true` as
                                   SSE; `temperature` in [0, 2] with
                                   `seed`: sampled decoding, greedy-only
                                   under `stream=true`)

Without an aligner, alignment, word timestamps and srt / vtt answer 400
with the JAX package's messages.
"""

from __future__ import annotations

import argparse
import base64
import dataclasses
import json
import queue
import sys
import threading
import time
from collections import deque
from concurrent.futures import Future
from dataclasses import dataclass

import numpy as np

from qwen3_asr_tpu_torch.config import SAMPLE_RATE
from qwen3_asr_tpu_torch.text.prompt import (
    StreamingTranscriptCleaner,
    detect_language,
    extract_transcript,
)
from qwen3_asr_tpu_torch.audio.wav import load_wav_bytes
from qwen3_asr_tpu_torch.pipeline.asr import Qwen3ASR, TranscribeParams
from qwen3_asr_tpu_torch.text.subtitles import (
    group_words_into_cues,
    words_to_srt,
    words_to_vtt,
)

NO_ALIGNER_WORDS = ("word timestamps need an aligner model "
                    "(start the server with --aligner-model)")
NO_ALIGNER = "no aligner model loaded"

# ISO-639-1 -> the language names the pipeline uses (detect_language emits
# lowercase full names). OpenAI clients send the ISO codes.
_ISO_LANG = {
    "ko": "korean", "en": "english", "zh": "chinese", "ja": "japanese",
    "de": "german", "fr": "french", "es": "spanish", "ru": "russian",
    "pt": "portuguese", "it": "italian", "ar": "arabic", "hi": "hindi",
    "id": "indonesian", "vi": "vietnamese", "th": "thai", "tr": "turkish",
    "nl": "dutch", "pl": "polish", "sv": "swedish", "ms": "malay",
}


def _normalize_language(lang: str) -> str:
    lang = lang.strip().lower()
    return _ISO_LANG.get(lang, lang)


class _StreamDelta:
    """Incremental token ids -> text deltas for streaming responses:
    re-decodes the accumulated ids, holds back partial UTF-8 at the token
    boundary (a trailing U+FFFD from the byte decoder) and strips the
    'language Xxx' prefix incrementally."""

    def __init__(self, tokenizer):
        self._tok = tokenizer
        self._ids: list[int] = []
        self._prev = ""
        self._cleaner = StreamingTranscriptCleaner()

    def feed(self, new_ids) -> str:
        """Absorb newly decoded token ids; return the text delta ready to
        emit ("" while the decode is not yet prefix-stable)."""
        self._ids.extend(int(t) for t in new_ids)
        text = self._tok.decode(self._ids)
        while text.endswith("�"):
            text = text[:-1]  # partial UTF-8: wait for the next token
        if text.startswith(self._prev) and len(text) > len(self._prev):
            delta = self._cleaner.feed(text[len(self._prev):])
            self._prev = text
            return delta
        return ""

    def finish(self, full: str) -> str:
        """Reconcile against the full decode: the final tail delta."""
        tail = self._cleaner.feed(full[len(self._prev):]) if (
            full.startswith(self._prev) and len(full) > len(self._prev)) else ""
        return tail + self._cleaner.flush()


@dataclass
class _Request:
    samples: np.ndarray
    future: Future
    stream_q: queue.Queue | None = None     # set: SSE streaming request
    delta: object = None                    # worker-side _StreamDelta (pool streams)
    align_text: str | None = None           # set: forced-alignment request
    language: str = ""
    params: TranscribeParams | None = None  # set: runs alone with these params


def _request_kind(req: _Request) -> str:
    if req.align_text is not None:
        return "align"
    if req.stream_q is not None:
        return "stream"
    return "asr" if req.params is None else "solo"


class ASRServer:
    """Batching wrapper around a loaded `Qwen3ASR`, and an optional loaded
    `ForcedAligner` for alignments (one worker thread owns the device)."""

    def __init__(self, asr: Qwen3ASR, params: TranscribeParams | None = None,
                 max_batch: int = 8, max_wait_ms: float = 5.0,
                 continuous: bool = False, round_tokens: int = 64,
                 pool: int | None = None, engine_context: int | None = None,
                 aligner=None):
        self.asr = asr
        self.aligner = aligner
        # mel_bucket=500 (5 s granularity): same-bucket requests share one
        # batched frontend pass
        self.params = params or TranscribeParams(mel_bucket=500)
        self.max_batch = max_batch
        self.max_wait_ms = max_wait_ms
        self._queue: queue.Queue = queue.Queue()
        self._pending: deque = deque()  # streams stashed from a window; the pool's leftovers
        self._stop = threading.Event()
        self._engine = None
        if continuous:
            from qwen3_asr_tpu_torch.pipeline.engine import ContinuousEngine

            self._engine = ContinuousEngine(
                asr, pool=pool or max_batch, round_tokens=round_tokens,
                max_tokens=self.params.max_tokens,
                prompt_bucket=self.params.prompt_bucket,
                mel_bucket=self.params.mel_bucket or 500,
                s_pool=engine_context)
        self.n_served = 0
        self.n_batches = 0
        self._worker = threading.Thread(
            target=self._run_continuous if continuous else self._run, daemon=True)
        self._worker.start()

    # -- client side ---------------------------------------------------------

    def submit(self, samples: np.ndarray,
               params: TranscribeParams | None = None) -> Future:
        """Enqueue one utterance (float32/int16 16 kHz samples) -> Future
        of a TranscribeResult. `params` overrides the server's
        TranscribeParams for this request (sampling): such a request runs
        alone through `transcribe`, never in the greedy batch or the
        pool."""
        fut: Future = Future()
        self._queue.put(_Request(np.asarray(samples), fut, params=params))
        return fut

    def transcribe(self, samples: np.ndarray):
        """One utterance through the server's queue, waited on:
        submit(samples).result()."""
        return self.submit(samples).result()

    def submit_align(self, samples: np.ndarray, text: str,
                     language: str = "") -> Future:
        """Enqueue a forced alignment -> Future of an AlignmentResult.
        Alignments arriving together run as one `ForcedAligner.align_batch`
        per language."""
        fut: Future = Future()
        self._queue.put(_Request(np.asarray(samples), fut, align_text=text,
                                 language=language))
        return fut

    def submit_stream(self, samples: np.ndarray) -> queue.Queue:
        """Enqueue a streaming transcription: returns a queue of events
        ("delta", text) as tokens decode, then ("done", result) (result.text
        prefix-stripped) or ("error", msg). In continuous mode a stream the
        pool can take rides it (deltas per decode round); otherwise it runs
        alone on the worker (deltas per 8-token chunk)."""
        q: queue.Queue = queue.Queue()
        self._queue.put(_Request(np.asarray(samples), Future(), stream_q=q))
        return q

    def warmup(self, seconds: tuple = (5, 15, 30)) -> None:
        """Run one silent request per length before taking traffic (builds
        the CUDA kernels and warms the allocator)."""
        t0 = time.perf_counter()
        futs = [self.submit(np.zeros(int(s * SAMPLE_RATE), dtype=np.int16))
                for s in seconds]
        for f in futs:
            f.result()
        print(f"warmup: {len(futs)} requests in {time.perf_counter() - t0:.1f}s",
              file=sys.stderr, flush=True)

    def close(self):
        self._stop.set()
        self._queue.put(None)  # wake the worker
        self._worker.join(timeout=10)

    # -- closed-batch worker -----------------------------------------------

    def _take_pending(self, batch: list[_Request]) -> None:
        """Move stashed requests of the batch's kind into it (up to
        max_batch), in arrival order."""
        kind = _request_kind(batch[0])
        i = 0
        while i < len(self._pending) and len(batch) < self.max_batch:
            if _request_kind(self._pending[i]) == kind:
                batch.append(self._pending[i])
                del self._pending[i]
            else:
                i += 1

    def _collect(self) -> list[_Request]:
        """Block for the first request (a stashed one first), then batch
        same-kind requests, stashed ones first, then those arriving within
        the window (up to max_batch); a stream or a request with its own
        params runs alone, at once. A request of another kind arriving in
        the window is stashed for the next round."""
        if self._pending:
            first = self._pending.popleft()
        else:
            first = self._queue.get()
            if first is None:
                return []
        batch = [first]
        kind = _request_kind(first)
        if kind in ("stream", "solo"):
            return batch
        self._take_pending(batch)
        deadline = time.perf_counter() + self.max_wait_ms / 1e3
        while len(batch) < self.max_batch:
            timeout = deadline - time.perf_counter()
            if timeout <= 0:
                break
            try:
                req = self._queue.get(timeout=timeout)
            except queue.Empty:
                break
            if req is None:
                break
            if _request_kind(req) != kind:
                self._pending.append(req)
                continue
            batch.append(req)
        return batch

    def _run(self):
        while not self._stop.is_set():
            batch = self._collect()
            if batch:
                self._process_batch(batch)

    def _process_batch(self, batch: list[_Request]) -> None:
        """Run one closed batch, or one stream or own-params request alone,
        and deliver its results."""
        try:
            if batch[0].stream_q is not None:
                self._run_stream(batch[0])
                results = []
            elif batch[0].align_text is not None:
                results = self._run_align(batch)
            elif batch[0].params is not None:
                results = [self.asr.transcribe(batch[0].samples, batch[0].params)]
            elif len(batch) == 1:
                results = [self.asr.transcribe(batch[0].samples, self.params)]
            else:
                results = self._run_transcribe(batch)
            for req, res in zip(batch, results):
                req.future.set_result(res)
        except Exception as e:  # noqa: BLE001 - propagate to all waiters
            for req in batch:
                if req.stream_q is not None:
                    req.stream_q.put(("error", str(e)))
                elif not req.future.done():
                    req.future.set_exception(e)
        self.n_served += len(batch)
        self.n_batches += 1

    def _run_transcribe(self, batch: list[_Request]) -> list:
        """One batched transcription of a closed batch, in every weight and
        cache mode. Unlike the JAX server there is no split by context
        length or padding to a power of two: the batched steps take any
        context and batch size on the card."""
        return self.asr.transcribe_batch([r.samples for r in batch], self.params)

    def _run_align(self, batch: list[_Request]) -> list:
        """One align_batch per language group (usually one), its mel bucket
        the server's (500 frames when the server has none)."""
        if self.aligner is None:
            raise RuntimeError(NO_ALIGNER)
        results: list = [None] * len(batch)
        groups: dict[str, list[int]] = {}
        for i, req in enumerate(batch):
            groups.setdefault(req.language, []).append(i)
        for language, idxs in groups.items():
            outs = self.aligner.align_batch(
                [batch[i].samples for i in idxs], [batch[i].align_text for i in idxs],
                language=language, mel_bucket=self.params.mel_bucket or 500)
            for i, out in zip(idxs, outs):
                results[i] = out
        return results

    def _run_stream(self, req: _Request) -> None:
        """One streaming transcription outside the pool: ride the
        pipeline's token callback, turn the ids into text deltas
        (_StreamDelta) on the request's queue, then ("done", result) with
        result.text prefix-stripped, or ("error", msg)."""
        sd = _StreamDelta(self.asr.tokenizer)

        def on_id(tok: int):
            delta = sd.feed([tok])
            if delta:
                req.stream_q.put(("delta", delta))

        self.asr.set_token_callback(on_id)
        try:
            result = self.asr.transcribe(req.samples, self.params)
        finally:
            self.asr.set_token_callback(None)
        if not result.success:
            req.stream_q.put(("error", result.error_msg))
            return
        tail = sd.finish(result.text)
        if tail:
            req.stream_q.put(("delta", tail))
        result.text = extract_transcript(result.text)
        req.stream_q.put(("done", result))

    # -- continuous worker --------------------------------------------------

    def _drain_queue(self, block: bool) -> None:
        """Move queued arrivals onto `_pending`; block=True waits for the
        first one (pool idle, nothing pending)."""
        if block:
            req = self._queue.get()
            if req is None:
                return
            self._pending.append(req)
        while True:
            try:
                req = self._queue.get_nowait()
            except queue.Empty:
                return
            if req is None:
                return
            self._pending.append(req)

    def _collect_pending_batch(self) -> list[_Request]:
        """One closed batch from `_pending` (the continuous worker's path
        for what the pool cannot take): a stream or an own-params request
        alone, or the first request and the pending ones of its kind, up to
        max_batch."""
        batch = [self._pending.popleft()]
        if _request_kind(batch[0]) not in ("stream", "solo"):
            self._take_pending(batch)
        return batch

    def _engine_progress(self, req: _Request, new_ids) -> None:
        """Engine on_progress hook: per-round text deltas for streaming
        requests riding the pool."""
        if req.stream_q is None or req.delta is None:
            return
        text = req.delta.feed(new_ids)
        if text:
            req.stream_q.put(("delta", text))

    def _run_continuous(self):
        """Continuous worker: requests (plain or streaming) prefill into
        the slot pool between decode rounds; alignments, own-params and
        too-long requests take the closed-batch path between rounds. One
        thread, one device owner."""
        eng = self._engine
        eng.on_progress = self._engine_progress
        backlog: deque = deque()  # pool-eligible requests awaiting a slot
        while not self._stop.is_set():
            self._drain_queue(block=eng.n_active() == 0 and not backlog
                              and not self._pending)
            if self._stop.is_set():
                break
            rest: deque = deque()
            for req in self._pending:
                if (_request_kind(req) in ("asr", "stream")
                        and eng.eligible(len(req.samples))):
                    if req.stream_q is not None:
                        req.delta = _StreamDelta(self.asr.tokenizer)
                    backlog.append(req)
                else:
                    rest.append(req)
            self._pending = rest
            n = min(len(eng.free_slots()), len(backlog))
            admit = [backlog.popleft() for _ in range(n)]
            if admit:
                try:
                    eng.admit(admit, [r.samples for r in admit])
                except Exception as e:  # noqa: BLE001
                    for r in admit:
                        if r.stream_q is not None:
                            r.stream_q.put(("error", str(e)))
                        if not r.future.done():
                            r.future.set_exception(e)
            if eng.n_active():
                try:
                    completed = eng.run_round()
                except Exception as e:  # noqa: BLE001 - fail the slots, not the worker
                    for ticket, err in eng.fail_active(e):
                        if ticket.stream_q is not None:
                            ticket.stream_q.put(("error", str(err)))
                        if not ticket.future.done():
                            ticket.future.set_exception(err)
                    continue
                for req, res in completed:
                    if req.stream_q is not None:
                        tail = req.delta.finish(res.text) if req.delta is not None else ""
                        if tail:
                            req.stream_q.put(("delta", tail))
                        res.text = extract_transcript(res.text)
                        req.stream_q.put(("done", res))
                    req.future.set_result(res)
                    self.n_served += 1
                self.n_batches += 1
            if self._pending:   # what the pool cannot take: one closed batch
                self._process_batch(self._collect_pending_batch())


# ---------------------------------------------------------------------------
# HTTP front end (stdlib only)
# ---------------------------------------------------------------------------

def _parse_multipart(data: bytes, content_type: str) -> dict[str, list[bytes]]:
    """Minimal multipart/form-data parser: {field name: [raw bytes, ...]},
    repeated fields in arrival order."""
    boundary = ""
    for token in content_type.split(";"):
        token = token.strip()
        if token.startswith("boundary="):
            boundary = token[len("boundary="):].strip('"')
    if not boundary:
        raise ValueError("multipart body without boundary")
    fields: dict[str, list[bytes]] = {}
    for part in data.split(b"--" + boundary.encode()):
        part = part.strip(b"\r\n")
        if not part or part == b"--":
            continue
        head, sep, body = part.partition(b"\r\n\r\n")
        if not sep:
            continue
        name = ""
        for line in head.split(b"\r\n"):
            if not line.lower().startswith(b"content-disposition"):
                continue
            # parameter by parameter: 'name=' also occurs inside 'filename='
            for param in line.split(b";"):
                param = param.strip()
                if param.lower().startswith(b"name="):
                    name = param[len(b"name="):].strip(b'" ').decode("utf-8", "replace")
        if name:
            fields.setdefault(name, []).append(body)
    return fields


def _parse_align_request(headers, body: bytes) -> tuple[bytes, str, str]:
    """-> (WAV bytes, text, language) of a /v1/align request: multipart
    fields `audio`, `text` and optional `language`; JSON {"audio_b64",
    "text", "language"}; or a raw WAV body with the text in the
    X-Align-Text header (latin-1 only: headers cannot carry Korean)."""
    ctype = headers.get("Content-Type", "")
    if ctype.startswith("multipart/form-data"):
        fields = _parse_multipart(body, ctype)
        if "audio" not in fields or "text" not in fields:
            raise ValueError("multipart fields 'audio' and 'text' required")
        return (fields["audio"][-1], fields["text"][-1].decode("utf-8"),
                fields.get("language", [b""])[-1].decode("utf-8"))
    if ctype.startswith("application/json"):
        req = json.loads(body.decode("utf-8"))
        if "audio_b64" not in req or "text" not in req:
            raise ValueError("JSON fields 'audio_b64' and 'text' required")
        return base64.b64decode(req["audio_b64"]), req["text"], req.get("language", "")
    text = headers.get("X-Align-Text", "")
    if not text:
        raise ValueError("align request needs multipart (audio+text fields), JSON "
                         "(audio_b64+text), or the legacy X-Align-Text header")
    return body, text, headers.get("X-Align-Language", "")


def _make_handler(server: ASRServer):
    from http.server import BaseHTTPRequestHandler

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def _reply(self, code: int, payload: dict):
            body = json.dumps(payload, ensure_ascii=False).encode("utf-8")
            self.send_response(code)
            self.send_header("Content-Type", "application/json; charset=utf-8")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _reply_text(self, code: int, text: str):
            body = text.encode("utf-8")
            self.send_response(code)
            self.send_header("Content-Type", "text/plain; charset=utf-8")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _openai_error(self, code: int, message: str,
                          err_type: str = "invalid_request_error"):
            self._reply(code, {"error": {"message": message, "type": err_type,
                                         "param": None, "code": None}})

        def do_GET(self):  # noqa: N802 (stdlib API)
            if self.path != "/healthz":
                self._reply(404, {"error": "not found"})
                return
            health = {"status": "ok", "served": server.n_served,
                      "batches": server.n_batches}
            if server._engine is not None:
                health["engine"] = server._engine.stats()
            self._reply(200, health)

        def _openai_transcription(self, data: bytes):
            """OpenAI-compatible `POST /v1/audio/transcriptions`: multipart
            `file` required; `response_format` json | text | verbose_json |
            srt | vtt; `timestamp_granularities[]=word` (with verbose_json);
            `stream=true` (json or text) as SSE; `language` names the
            language (ISO codes map to the pipeline's names, so `ko` gets
            the Korean word split); `temperature` in [0, 2] (> 0: sampled
            decoding with the integer `seed`, a request of its own; not
            with `stream=true`); `model` / `prompt` are accepted and
            ignored. Word timestamps and the srt / vtt cues come from the
            aligner run on the transcript."""
            ctype = self.headers.get("Content-Type", "")
            if not ctype.startswith("multipart/form-data"):
                self._openai_error(400, "multipart/form-data with a 'file' field required")
                return
            fields = _parse_multipart(data, ctype)
            if "file" not in fields:
                self._openai_error(400, "missing required field 'file'")
                return

            def field(name: str, default: str = "") -> str:
                return fields.get(name, [default.encode()])[-1].decode().strip()

            fmt = field("response_format", "json")
            if fmt not in ("json", "text", "verbose_json", "srt", "vtt"):
                self._openai_error(400, f"response_format '{fmt}' not supported "
                                        "(json, text, verbose_json, srt, vtt)")
                return
            stream = field("stream").lower() in ("true", "1")
            grans = [g.decode().strip() for g in fields.get("timestamp_granularities[]", [])]
            want_words = "word" in grans
            if stream:
                if fmt not in ("json", "text"):
                    self._openai_error(400, "stream=true supports response_format json "
                                            "or text (timestamps need the full result)")
                    return
                if want_words:
                    self._openai_error(400, "stream=true cannot carry word timestamps")
                    return
            if want_words and fmt != "verbose_json":
                self._openai_error(400, "timestamp_granularities requires "
                                        "response_format=verbose_json")
                return
            if (want_words or fmt in ("srt", "vtt")) and server.aligner is None:
                self._openai_error(400, NO_ALIGNER_WORDS)
                return
            samples, sr = load_wav_bytes(fields["file"][-1], raw_int16=True)
            if sr != SAMPLE_RATE:
                self._openai_error(400, f"Audio must be 16kHz, got {sr} Hz")
                return
            try:
                temp = float(field("temperature", "0") or "0")
            except ValueError:
                self._openai_error(400, "temperature must be a number")
                return
            if not 0.0 <= temp <= 2.0:
                self._openai_error(400, "temperature must be in [0, 2]")
                return
            if stream:
                if temp > 0:
                    self._openai_error(400, "stream=true is greedy-only (sampled "
                                            "decoding runs as one whole-loop program)")
                    return
                self._sse_transcription(samples)
                return
            req_params = None
            if temp > 0:
                try:
                    seed = int(field("seed", "0") or "0")
                except ValueError:
                    self._openai_error(400, "seed must be an integer")
                    return
                req_params = dataclasses.replace(server.params, temperature=temp,
                                                 seed=seed)
            result = server.submit(samples, params=req_params).result()
            if not result.success:
                self._openai_error(500, result.error_msg, "server_error")
                return
            transcript = extract_transcript(result.text)
            # a language the client names wins over the detected one
            language = _normalize_language(field("language")) or detect_language(result.text)
            if fmt == "text":
                self._reply_text(200, transcript + "\n")
                return
            if fmt == "json":
                self._reply(200, {"text": transcript})
                return
            aligned = None
            if (want_words or fmt in ("srt", "vtt")) and transcript.strip():
                aligned = server.submit_align(samples, transcript, language).result()
                if not aligned.success:
                    self._openai_error(500, aligned.error_msg, "server_error")
                    return
            words = aligned.words if aligned is not None else []
            if fmt in ("srt", "vtt"):
                self._reply_text(200, (words_to_srt if fmt == "srt" else words_to_vtt)(words))
                return
            duration = round(len(samples) / SAMPLE_RATE, 3)

            def segment(i, start, end, text):
                return {"id": i, "seek": 0, "start": start, "end": end, "text": text,
                        "tokens": [], "temperature": 0.0, "avg_logprob": 0.0,
                        "compression_ratio": 1.0, "no_speech_prob": 0.0}

            if aligned is not None:   # one segment per subtitle cue
                segments = [segment(i, c.start, c.end, c.text)
                            for i, c in enumerate(group_words_into_cues(words))]
            else:                     # the transcript as one segment
                segments = [] if not transcript.strip() else [
                    segment(0, 0.0, duration, transcript)]
            payload = {"task": "transcribe", "language": language, "duration": duration,
                       "text": transcript, "segments": segments}
            if want_words:
                payload["words"] = [{"word": w.word, "start": w.start, "end": w.end}
                                    for w in words]
            self._reply(200, payload)

        def _sse_transcription(self, samples):
            """Server-sent events (OpenAI `stream=true`): one
            `transcript.text.delta` per decoded text chunk, then
            `transcript.text.done` with the full transcript, then [DONE],
            in chunked transfer encoding."""
            q = server.submit_stream(samples)
            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream; charset=utf-8")
            self.send_header("Cache-Control", "no-cache")
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()

            def emit(payload: str):
                data = f"data: {payload}\n\n".encode("utf-8")
                self.wfile.write(f"{len(data):X}\r\n".encode() + data + b"\r\n")
                self.wfile.flush()

            while True:
                kind, value = q.get()
                if kind == "delta":
                    emit(json.dumps({"type": "transcript.text.delta", "delta": value},
                                    ensure_ascii=False))
                    continue
                if kind == "done":
                    emit(json.dumps({"type": "transcript.text.done", "text": value.text},
                                    ensure_ascii=False))
                else:
                    emit(json.dumps({"type": "error", "error": {
                        "message": value, "type": "server_error"}}, ensure_ascii=False))
                break
            emit("[DONE]")
            self.wfile.write(b"0\r\n\r\n")  # chunked terminator

        def _align(self, data: bytes, t0: float):
            """`POST /v1/align` -> {"words": [{"word", "start", "end"}],
            "latency_ms"}."""
            if server.aligner is None:
                self._reply(400, {"error": NO_ALIGNER})
                return
            wav, text, language = _parse_align_request(self.headers, data)
            samples, sr = load_wav_bytes(wav, raw_int16=True)
            if sr != SAMPLE_RATE:
                self._reply(400, {"error": f"Audio must be 16kHz, got {sr} Hz"})
                return
            result = server.submit_align(samples, text, language).result()
            if not result.success:
                self._reply(500, {"error": result.error_msg})
                return
            self._reply(200, {
                "words": [{"word": w.word, "start": w.start, "end": w.end}
                          for w in result.words],
                "latency_ms": round((time.perf_counter() - t0) * 1e3, 1)})

        def do_POST(self):  # noqa: N802
            if self.path not in ("/v1/transcribe", "/v1/align",
                                 "/v1/audio/transcriptions"):
                self._reply(404, {"error": "not found"})
                return
            try:
                data = self.rfile.read(int(self.headers.get("Content-Length", "0")))
                t0 = time.perf_counter()
                if self.path == "/v1/align":
                    self._align(data, t0)
                    return
                if self.path == "/v1/audio/transcriptions":
                    self._openai_transcription(data)
                    return
                samples, sr = load_wav_bytes(data, raw_int16=True)
                if sr != SAMPLE_RATE:
                    self._reply(400, {"error": f"Audio must be 16kHz, got {sr} Hz"})
                    return
                result = server.submit(samples).result()
                if not result.success:
                    self._reply(500, {"error": result.error_msg})
                    return
                self._reply(200, {"text": result.text,
                                  "latency_ms": round((time.perf_counter() - t0) * 1e3, 1)})
            except Exception as e:  # noqa: BLE001
                if self.path == "/v1/audio/transcriptions":
                    self._openai_error(400, str(e))
                else:
                    self._reply(400, {"error": str(e)})

        def log_message(self, fmt, *args):  # stderr; stdout stays data-only
            print("serve: " + fmt % args, file=sys.stderr, flush=True)

    return Handler


def serve_http(server: ASRServer, host: str = "127.0.0.1", port: int = 8000):
    """A ThreadingHTTPServer bound to (host, port) (port 0: any free
    port); the caller runs serve_forever()."""
    from http.server import ThreadingHTTPServer

    httpd = ThreadingHTTPServer((host, port), _make_handler(server))
    print(f"serving on http://{host}:{httpd.server_address[1]}", file=sys.stderr,
          flush=True)
    return httpd


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="qwen3-asr serving daemon (PyTorch / CUDA)")
    p.add_argument("-m", "--model", required=True, help="ASR GGUF model")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--device", default="cuda", help="cuda (the kernels) or cpu "
                   "(their plain PyTorch versions)")
    p.add_argument("--max-batch", type=int, default=8)
    p.add_argument("--max-wait-ms", type=float, default=5.0)
    p.add_argument("--max-tokens", type=int, default=1024)
    p.add_argument("--quantize", default="auto",
                   choices=["auto", "none", "q8_0", "int8pc", "int4"],
                   help="decoder weights: auto = int8pc (per-channel int8) for "
                        "a dense GGUF, a Q8_0 GGUF as loaded; int4 nibble-packs "
                        "the decode weights. --continuous needs the decode pack "
                        "(auto/int8pc/int4)")
    p.add_argument("--kv-cache", default="int8", choices=["int8", "bf16", "int4"],
                   help="KV cache dtype: int8 (default), bf16 or int4 (the "
                        "decode pack's nibble-packed cache for lone requests; "
                        "batches run int8, and --continuous needs int8)")
    p.add_argument("--warmup", default="",
                   help="comma-separated audio lengths (s) to run before serving")
    p.add_argument("--continuous", action="store_true",
                   help="continuous batching: greedy requests join and leave a "
                        "slot pool between decode rounds")
    p.add_argument("--round-tokens", type=int, default=64,
                   help="continuous mode: decode steps per round")
    p.add_argument("--engine-context", type=int, default=0,
                   help="continuous mode: KV rows per slot (a multiple of 128); "
                        "0 = a 92 s prompt bucket plus --max-tokens, capped by "
                        "device memory")
    p.add_argument("--aligner-model", default="",
                   help="forced-aligner GGUF: enables POST /v1/align (multipart "
                        "audio+text, JSON audio_b64+text, or a WAV body + "
                        "X-Align-Text header) and word timestamps / srt / vtt on "
                        "/v1/audio/transcriptions")
    p.add_argument("--engine-kv-stream", action="store_true",
                   help="continuous mode: the streamed-KV slot pool (accepted "
                        "for parity; no effect: the batched step reads any "
                        "context with one attention path)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    try:
        asr = Qwen3ASR(quantize="" if args.quantize == "none" else args.quantize,
                       kv_cache=args.kv_cache, device=args.device)
    except (NotImplementedError, RuntimeError) as e:
        print(f"Error: {e}", file=sys.stderr)
        return 1
    if not asr.load_model(args.model):
        print(f"Error: {asr.error_msg}", file=sys.stderr)
        return 1
    aligner = None
    if args.aligner_model:
        from qwen3_asr_tpu_torch.pipeline.aligner import ForcedAligner
        from qwen3_asr_tpu_torch.text.korean import find_korean_dict

        aligner = ForcedAligner(quantize="" if args.quantize == "none" else args.quantize,
                                device=args.device)
        if not aligner.load_model(args.aligner_model):
            print(f"Error (aligner): {aligner.error_msg}", file=sys.stderr)
            return 1
        dict_path = find_korean_dict(args.aligner_model)
        if dict_path:   # language=korean requests get the dictionary split
            aligner.load_korean_dict(dict_path)
    try:
        server = ASRServer(asr, TranscribeParams(max_tokens=args.max_tokens,
                                                 mel_bucket=500),
                           max_batch=args.max_batch, max_wait_ms=args.max_wait_ms,
                           continuous=args.continuous, round_tokens=args.round_tokens,
                           engine_context=args.engine_context or None, aligner=aligner)
    except (ValueError, NotImplementedError) as e:   # the continuous pool's settings
        print(f"Error: {e}", file=sys.stderr)
        return 1
    if args.warmup:
        server.warmup(tuple(float(s) for s in args.warmup.split(",")))
    httpd = serve_http(server, args.host, args.port)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
