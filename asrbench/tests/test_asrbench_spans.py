"""The readers of the program's spans (`asrbench/spans.py`,
`metrics/k1_graph_captures.py`) on synthetic profiles with known kernels
and span ranges; and the metrics the benchmark already had read the same
on a profile whether or not the program's spans are in it."""

from __future__ import annotations

import json
import types

import pytest
from conftest import ROOT

from asrbench import layers, registry
from asrbench import spans as sp
from asrbench.trace import WINDOW_SPAN, Trace
from asrbench.traffic import Request

CPU, CUDA = "cpu", "cuda"


class Ev:
    """A kineto event as Trace reads it (times in ms)."""

    def __init__(self, name, device, start_ms, end_ms, annotation=False):
        self._n, self._d, self._a = name, device, annotation
        self._s, self._e = int(start_ms * 1e6), int(end_ms * 1e6)

    def name(self):
        return self._n

    def device_type(self):
        from torch.autograd import DeviceType

        return DeviceType.CUDA if self._d == CUDA else DeviceType.CPU

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._e - self._s

    def is_user_annotation(self):
        return self._a


def prof(events):
    return types.SimpleNamespace(profiler=types.SimpleNamespace(
        kineto_results=types.SimpleNamespace(events=lambda: events)))


# Two K1 requests of 3 s audio, 4 tokens: the front end and prefill
# kernels, then a graph capture (idle) and three K1 steps; a K3 batch.
KERNELS = [("elementwise_kernel", 1, 3), ("cutlass::Kernel2", 3, 6), ("flash_fwd", 6, 7),
           ("gemv_i8", 10, 12), ("attn_step", 12, 13), ("gemv_i8", 14, 16),
           ("argmax_partial", 16, 17), ("gemv_i8", 18, 20),
           ("elementwise_kernel", 31, 33), ("gemv_i8", 40, 42), ("attn_step", 42, 43),
           ("gemv_i8", 44, 46),
           ("prod_batch", 50, 53), ("attn_step", 53, 54), ("prod_batch", 55, 58)]
SPANS = [("qwen3.request", 0, 22), ("qwen3.upload", 0.2, 0.8), ("qwen3.mel", 0.8, 2),
         ("qwen3.encode", 2, 5), ("qwen3.prefill", 5, 6.5), ("qwen3.decode", 6.5, 21),
         ("qwen3.graph_capture", 7, 9.5), ("qwen3.detokenize", 21, 21.5),
         ("qwen3.request", 30, 48), ("qwen3.mel", 30.5, 31), ("qwen3.encode", 31, 32),
         ("qwen3.prefill", 32, 33), ("qwen3.decode", 33, 47),
         ("qwen3.graph_capture", 34, 39)]
HOST_OPS = [("aten::mm", 3, 4), ("cudaGraphInstantiateWithFlags", 8, 9.3)]


def events(with_spans: bool):
    evs = [Ev(WINDOW_SPAN, CPU, 0, 60)]
    evs += [Ev(n, CUDA, s, e) for n, s, e in KERNELS]
    evs += [Ev(n, CPU, s, e) for n, s, e in HOST_OPS]
    if with_spans:
        evs += [Ev(n, CPU, s, e) for n, s, e in SPANS]
        evs += [Ev(n, CUDA, s + 0.5, e + 0.5, annotation=True) for n, s, e in SPANS]
    return evs


def requests(n=3):
    return [Request(seq=i, kind=0, n_samples=48000, max_tokens=4, t_sent=0.0, t_done=1.0)
            for i in range(n)]


def trace(with_spans=True, batches=None):
    return Trace(prof(events(with_spans)), requests(), batches or [[0], [1, 2]])


@pytest.fixture(scope="module")
def asr_config():
    bench = registry.benchmark(ROOT)
    entry = next(c for c in bench["configs"] if c["name"] == "qwen3-asr-0.6b")
    return json.loads((ROOT / entry["file"]).read_text())


def run_of(tr, cfg, kind="asr"):
    return types.SimpleNamespace(trace=tr, kind=kind, config=cfg, kv="bf16", counters={},
                                 family=registry.family(cfg))


def test_k1_graph_captures_counts_spans_per_request(asr_config):
    read = registry.reader("k1_graph_captures").read
    assert read(run_of(trace(), asr_config)) == pytest.approx(2 / 3)
    assert read(run_of(trace(with_spans=False), asr_config)) is None
    assert read(run_of(None, asr_config)) is None


# (span, its host ranges in ms): a span that starts before the window
# opens is left out.
RANGES = [("qwen3.decode", [(6.5, 21), (33, 47)]), ("qwen3.graph_capture", [(7, 9.5), (34, 39)]),
          ("qwen3.mel", [(0.8, 2), (30.5, 31)]), ("qwen3.upload", [(0.2, 0.8)]),
          ("qwen3.nar", []), ("qwen3.early", [])]


@pytest.mark.parametrize("name,want", RANGES, ids=[n for n, _ in RANGES])
def test_host_ranges_keep_the_window_and_order(name, want):
    evs = events(True) + [Ev("qwen3.early", CPU, -2, 1)]
    tr = Trace(prof(evs[::-1]), requests(), [[0], [1, 2]])
    got = [t for r in sp.host_ranges(tr, name) for t in r]
    assert got == pytest.approx([1e-3 * t for r in want for t in r])
    assert sp.per_request(tr, name) == pytest.approx(len(want) / 3)


def test_per_request_needs_requests_and_their_spans():
    assert sp.per_request(trace(), sp.REQUEST) == pytest.approx(2 / 3)
    assert sp.per_request(trace(False), "qwen3.decode") is None
    assert sp.per_request(Trace(prof(events(True)), []), sp.REQUEST) is None
    assert sp.per_request(None, sp.REQUEST) is None


def test_existing_metrics_read_the_same_with_spans(asr_config):
    """The program's spans (host ranges and their mirror on the device's
    timeline) move none of the benchmark's earlier readings: busy, the
    gaps and their lengths, the busiest device operations, mfu, the K1
    and K3 rooflines and the idle share."""
    with_, without = trace(True), trace(False)
    assert with_.kernels == without.kernels and with_.busy_s == without.busy_s
    assert with_.gaps() == without.gaps()
    b1, b0 = with_.breakdown(), without.breakdown()
    assert b1["device_ops"] == b0["device_ops"]
    assert [g[1] for g in b1["idle_gaps"]] == [g[1] for g in b0["idle_gaps"]]
    r1, r0 = run_of(with_, asr_config), run_of(without, asr_config)
    for read in (layers.mfu, layers.idle_share, lambda r: layers.decode_roofline(r, "k1"),
                 lambda r: layers.decode_roofline(r, "k3")):
        assert read(r1) == read(r0) and read(r0) is not None


def test_gaps_are_named_by_spans():
    """With the spans in the trace a gap the host spends inside the
    program is named by its innermost span, not as time outside any
    operation."""
    names = {n for n, _ in trace().breakdown()["idle_gaps"]}
    assert "qwen3.graph_capture" in names and "qwen3.decode" in names
    assert "host outside any recorded operation" in {
        n for n, _ in trace(False).breakdown()["idle_gaps"]}
