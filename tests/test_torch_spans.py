"""The port's spans (runtime/profiler.py::span) on the CPU at the tiny
config: under torch.profiler each path opens its qwen3.* ranges, nested in
its qwen3.request, a fixed count a request whatever the token budget (none
a decode step); the tokens and classes are the same with the profiler on
and off; with no profiler and no --profile a span opens no range and
records nothing; the server's collect and batch spans come from its
worker thread, and its queue_wait_s counts the time requests wait."""

import collections
import json
import threading
import time
import urllib.request
from unittest import mock

import numpy as np
import pytest
import torch
from torch._C._profiler import _ExperimentalConfig
from torch.profiler import ProfilerActivity, profile, record_function

from helpers import make_byte_vocab
from qwen3_asr_tpu_torch.config import tiny_aligner_config, tiny_asr_config
from qwen3_asr_tpu_torch.ops import megakernel
from qwen3_asr_tpu_torch.pipeline.aligner import ForcedAligner
from qwen3_asr_tpu_torch.pipeline.asr import Qwen3ASR, TranscribeParams, TranscribeResult
from qwen3_asr_tpu_torch.runtime import profiler as prof_mod
from qwen3_asr_tpu_torch.serve import ASRServer, serve_http


def pcm(seconds, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * 16000)) / 16000
    a = 0.3 * np.sin(2 * np.pi * (220 + 90 * seed) * t) + 0.05 * rng.standard_normal(t.shape)
    return (a * 32768.0).clip(-32768, 32767).astype(np.int16)


AUDIO = [pcm(1.2, 0), pcm(2.6, 1)]


@pytest.fixture(scope="module")
def asr():
    cfg = tiny_asr_config()
    m = Qwen3ASR(quantize="auto", device="cpu")
    m.load_random(cfg, seed=3, vocab=make_byte_vocab(cfg.decoder.vocab_size, {}))
    return m


@pytest.fixture(scope="module")
def fa():
    cfg = tiny_aligner_config()
    m = ForcedAligner(quantize="auto", device="cpu", dtype=torch.float32)
    m.load_random(cfg, seed=5, vocab=make_byte_vocab(cfg.decoder.vocab_size, {}))
    return m


def traced(fn, all_threads=False):
    """fn() under torch.profiler (CPU) -> (its result, the qwen3.* ranges
    as (name, start_ns, end_ns, thread))."""
    cfg = _ExperimentalConfig(profile_all_threads=True) if all_threads else None
    with profile(activities=[ProfilerActivity.CPU], experimental_config=cfg) as p:
        out = fn()
    spans = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns(), e.start_thread_id())
             for e in p.profiler.kineto_results.events() if e.name().startswith("qwen3.")]
    return out, sorted(spans, key=lambda s: s[1])


def counts(spans) -> dict:
    return dict(collections.Counter(s[0] for s in spans))


def assert_nested(spans):
    """Every span lies inside a qwen3.request of its thread."""
    reqs = [s for s in spans if s[0] == "qwen3.request"]
    for name, s, e, th in spans:
        assert any(rs <= s and e <= re_ and rt == th for _, rs, re_, rt in reqs), name


ASR_STAGES = {"qwen3.request": 1, "qwen3.upload": 1, "qwen3.mel": 1, "qwen3.encode": 1,
              "qwen3.prefill": 1, "qwen3.decode": 1, "qwen3.detokenize": 1}


@pytest.mark.parametrize("fused", [True, False])
def test_transcribe_spans(asr, fused):
    params = TranscribeParams(max_tokens=12, fused=fused, print_timing=False)
    r, spans = traced(lambda: asr.transcribe(AUDIO[0], params))
    assert r.success and counts(spans) == ASR_STAGES
    assert_nested(spans)
    if fused:
        assert r.t_mel_ms == r.t_encode_ms == r.t_decode_ms == 0.0 < r.t_total_ms
    else:
        assert 0.0 < r.t_mel_ms and 0.0 < r.t_encode_ms and 0.0 < r.t_decode_ms
        assert r.t_mel_ms + r.t_encode_ms + r.t_decode_ms <= r.t_total_ms


@pytest.mark.parametrize("mel_bucket,groups", [(500, 1), (0, 2)])
def test_transcribe_batch_spans(asr, mel_bucket, groups):
    """One frontend pass per mel bucket (per file at exact shapes), one
    batched prefill and decode for the batch."""
    params = TranscribeParams(max_tokens=8, mel_bucket=mel_bucket)
    rs, spans = traced(lambda: asr.transcribe_batch(AUDIO, params))
    assert all(r.success for r in rs)
    want = {"qwen3.request": 1, "qwen3.mel": groups, "qwen3.encode": groups,
            "qwen3.prefill": 1, "qwen3.decode": 1, "qwen3.detokenize": 1}
    if not mel_bucket:
        want["qwen3.upload"] = groups
    assert counts(spans) == want
    assert_nested(spans)


@pytest.mark.parametrize("path", ["greedy", "streaming", "sampled", "spec"])
def test_one_decode_span_whatever_the_budget(asr, path):
    """The decode loop is one span, as is the prefill: the count of spans
    a request does not grow with its tokens."""
    kw = {"streaming": dict(print_progress=True), "sampled": dict(temperature=0.8, seed=2),
          "spec": dict(spec_k=2), "greedy": {}}[path]
    seen = []
    for n in (3, 24):
        params = TranscribeParams(max_tokens=n, print_timing=False, **kw)
        r, spans = traced(lambda: asr.transcribe(AUDIO[0], params))
        assert r.success
        seen.append((len(r.tokens), counts(spans)))
    (n_short, short), (n_long, long_) = seen
    assert n_short < n_long
    assert short == long_ and short["qwen3.decode"] == 1 and short["qwen3.prefill"] == 1


def test_graph_capture_span_once_a_graph():
    """GraphStep's first call (the eager step and the capture) is one
    qwen3.graph_capture span; its replays open none."""

    class Step:
        S, dev = 64, torch.device("cpu")
        counter = type("C", (), {"launches": 0})()

        def __call__(self, tok, pos, out):
            out.copy_(tok + 1)

    class Graph:
        def replay(self):
            pass

    g = megakernel.GraphStep(Step())
    out = torch.zeros(8, dtype=torch.int32)
    with mock.patch.object(megakernel.GraphStep, "_capture",
                           lambda self: setattr(self, "graph", Graph())):
        _, spans = traced(lambda: [g(out, i, i) for i in range(1, 8)])
    assert counts(spans) == {"qwen3.graph_capture": 1}


@pytest.mark.parametrize("fused", [True, False])
def test_align_spans(fa, fused):
    r, spans = traced(lambda: fa.align(AUDIO[1], "hello big world", fused=fused))
    assert r.success and len(r.words) == 3
    assert counts(spans) == {"qwen3.request": 1, "qwen3.upload": 1, "qwen3.mel": 1,
                             "qwen3.encode": 1, "qwen3.nar": 1, "qwen3.words": 1}
    assert_nested(spans)
    stages = (r.t_mel_ms, r.t_encode_ms, r.t_decode_ms)
    assert all(t == 0.0 for t in stages) if fused else all(t > 0.0 for t in stages)


def test_align_batch_spans(fa):
    rs, spans = traced(lambda: fa.align_batch(AUDIO, ["one two", "three"]))
    assert [len(r.words) for r in rs] == [2, 1]
    assert counts(spans) == {"qwen3.request": 1, "qwen3.mel": 1, "qwen3.encode": 1,
                             "qwen3.nar": 1, "qwen3.words": 2}
    assert_nested(spans)
    assert rs[0].t_decode_ms > 0.0


def test_outputs_equal_with_profiler_on_and_off(asr, fa):
    params = TranscribeParams(max_tokens=16, fused=True, print_timing=False)
    off = asr.transcribe(AUDIO[1], params).tokens
    on, _ = traced(lambda: asr.transcribe(AUDIO[1], params))
    assert on.tokens == off

    classes = {}

    def align():
        with mock.patch.object(ForcedAligner, "words",
                               lambda self, p, c, w, d: classes.setdefault(len(classes), c)):
            fa.align(AUDIO[0], "alpha beta gamma", fused=True)

    align()
    traced(align)
    np.testing.assert_array_equal(classes[0], classes[1])


def test_span_is_free_when_off(asr):
    """No profiler and no --profile: every span is the one shared no-op
    context, no RecordFunction is entered, no section is recorded."""
    assert not prof_mod.Profiler().enabled
    prof_mod.profiler.reset()
    params = TranscribeParams(max_tokens=6, fused=True, print_timing=False)
    with mock.patch.object(prof_mod.profiler, "enabled", False), \
            mock.patch("torch.autograd.profiler.record_function") as rf:
        assert prof_mod.span("qwen3.a") is prof_mod.span("qwen3.b")
        asr.transcribe(AUDIO[0], params)
    assert rf.call_count == 0 and prof_mod.profiler.sections == {}


def test_profile_table_names_are_span_names(asr):
    """--profile (profiler.enabled) fills the table under the span names,
    with no profiler session and no range."""
    prof_mod.profiler.reset()
    try:
        with mock.patch.object(prof_mod.profiler, "enabled", True), \
                mock.patch("torch.autograd.profiler.record_function") as rf:
            asr.transcribe(AUDIO[0], TranscribeParams(max_tokens=6, fused=True,
                                                      print_timing=False))
        names = set(prof_mod.profiler.sections)
        report = prof_mod.profiler.report()
    finally:
        prof_mod.profiler.reset()
    assert rf.call_count == 0 and names == set(ASR_STAGES)
    assert all(n in report for n in names)


class Held:
    """A stand-in for Qwen3ASR whose transcribe blocks until released."""

    def __init__(self):
        self.release = threading.Event()
        self.started = threading.Event()

    def transcribe(self, samples, params):
        self.started.set()
        assert self.release.wait(timeout=60)
        return TranscribeResult(success=True, tokens=[len(samples)])


def test_server_spans_on_the_worker_thread():
    held = Held()
    held.release.set()
    srv = ASRServer(held, TranscribeParams(), max_batch=1, max_wait_ms=1)
    try:
        def run():
            with record_function("qwen3.client"):
                return [srv.submit(a).result(timeout=60) for a in AUDIO]

        rs, spans = traced(run, all_threads=True)
    finally:
        srv.close()
    assert [r.tokens for r in rs] == [[len(a)] for a in AUDIO]
    client = {s[3] for s in spans if s[0] == "qwen3.client"}
    batch = {s[3] for s in spans if s[0] == "qwen3.batch"}
    collect = {s[3] for s in spans if s[0] == "qwen3.collect"}
    assert counts(spans)["qwen3.batch"] == 2 and counts(spans)["qwen3.collect"] >= 2
    assert batch == collect and not batch & client


def test_queue_wait_counts_a_held_worker():
    """The worker is held on the first request for HOLD seconds while the
    second waits in the queue: queue_wait_s grows by about HOLD, and
    /healthz reports its mean a served request."""
    hold = 0.3
    held = Held()
    srv = ASRServer(held, TranscribeParams(), max_batch=1, max_wait_ms=1)
    httpd = serve_http(srv, "127.0.0.1", 0)
    th = threading.Thread(target=httpd.serve_forever, daemon=True)
    th.start()
    try:
        first = srv.submit(AUDIO[0])
        assert held.started.wait(timeout=60)
        second = srv.submit(AUDIO[1])
        time.sleep(hold)
        held.release.set()
        first.result(timeout=60)
        second.result(timeout=60)
        url = f"http://127.0.0.1:{httpd.server_address[1]}/healthz"
        with urllib.request.urlopen(url, timeout=60) as r:
            health = json.loads(r.read())
    finally:
        httpd.shutdown()
        httpd.server_close()
        srv.close()
    assert srv.n_served == 2 and hold <= srv.queue_wait_s < hold + 5.0
    assert health["served"] == 2
    assert health["queue_wait_ms"] == pytest.approx(1e3 * srv.queue_wait_s / 2, abs=1e-3)


class FakeEngine:
    """A stand-in for ContinuousEngine: one slot; the first admission
    fails, later ones finish in the next round."""

    def __init__(self, asr, **kw):
        self.on_progress = None
        self.active = []
        self.admissions = 0

    def n_active(self):
        return len(self.active)

    def eligible(self, n):
        return True

    def free_slots(self):
        return [0] if not self.active else []

    def admit(self, reqs, samples):
        self.admissions += 1
        if self.admissions == 1:
            raise RuntimeError("admission failed")
        self.active = list(reqs)

    def run_round(self):
        done, self.active = self.active, []
        return [(r, TranscribeResult(success=True, tokens=[len(r.samples)])) for r in done]

    def stats(self):
        return {}


def test_queue_wait_counts_only_served_continuous_requests():
    """Continuous mode: a request whose admission fails is not served and
    adds nothing to queue_wait_s; a served one adds its submit → admission
    time, so /healthz's mean stays a served request's."""
    with mock.patch("qwen3_asr_tpu_torch.pipeline.engine.ContinuousEngine", FakeEngine):
        srv = ASRServer(object(), TranscribeParams(), continuous=True, pool=1)
    try:
        failed = srv.submit(AUDIO[0])
        with pytest.raises(RuntimeError, match="admission failed"):
            failed.result(timeout=60)
        assert srv.queue_wait_s == 0.0
        t0 = time.perf_counter()
        served = srv.submit(AUDIO[1]).result(timeout=60)
        waited = time.perf_counter() - t0
    finally:
        srv.close()
    assert served.tokens == [len(AUDIO[1])]
    assert srv.n_served == 1 and 0.0 < srv.queue_wait_s <= waited
