"""The port's continuous-batching engine (pipeline/engine.py) at the tiny
config: against the JAX engine (the batched megakernel in interpret mode,
s_pool=128) on the same requests, tokens equal (the wide-init model of
tests/test_torch_batch.py, seed 7, whose paths hold no near tie); and the
slot rules on the port alone: staggered admission equals admitting
together, a reused slot keeps nothing of its previous occupant, EOS and
budget end a request, the stats count, and fail_active reallocates the
pool."""

import dataclasses

import numpy as np
import pytest
import torch

from qwen3_asr_tpu.pipeline.engine import ContinuousEngine as JaxEngine
from qwen3_asr_tpu_torch.pipeline.engine import ContinuousEngine, default_context
from test_torch_batch import AUDIO, GAIN, jax_and_port

MAX_TOKENS = 6
KW = dict(round_tokens=2, max_tokens=MAX_TOKENS, prompt_bucket=32,
          mel_bucket=200, s_pool=128)


@pytest.fixture(scope="module")
def wide():
    return jax_and_port(gain=GAIN)


def drive(eng, items, admit_first=None):
    """Admit items (ticket, samples) as slots free up, run rounds until all
    complete. admit_first: how many to admit before the first round (the
    rest wait at least one round). -> {ticket: tokens}."""
    queue, done = list(items), {}
    first = True
    for _ in range(100):
        n = len(eng.free_slots())
        if first and admit_first is not None:
            n = min(n, admit_first)
        take, queue = queue[:n], queue[n:]
        if take:
            eng.admit([t for t, _ in take], [s for _, s in take])
        first = False
        for ticket, res in eng.run_round():
            assert res.success
            done[ticket] = res.tokens
        if not queue and not eng.n_active():
            return done
    raise AssertionError("engine did not finish")


def test_engine_matches_jax_engine(wide):
    j, t = wide
    items = list(enumerate(AUDIO))
    want = drive(JaxEngine(j, pool=2, interpret=True, **KW), items)
    got = drive(ContinuousEngine(t, pool=2, **KW), items)
    assert got == want
    assert all(len(v) == MAX_TOKENS for v in got.values())
    assert len({tuple(v) for v in got.values()}) > 1


def test_staggered_admission_matches_together(wide):
    """A request decodes to the same tokens whether it starts with the pool
    or is admitted mid-flight, two rounds later, beside a running one."""
    _, t = wide
    together = drive(ContinuousEngine(t, pool=3, **KW), list(enumerate(AUDIO)))
    eng = ContinuousEngine(t, pool=3, **KW)
    eng.admit([0], [AUDIO[0]])
    done = {}
    for _ in range(2):
        done.update({k: r.tokens for k, r in eng.run_round()})
    eng.admit([1, 2], AUDIO[1:])
    while eng.n_active():
        done.update({k: r.tokens for k, r in eng.run_round()})
    assert done == together


def test_slot_reuse_leaves_no_stale_state(wide):
    """Pool of one: each request after the first lands in a slot whose
    slab a longer request filled; its tokens equal a fresh engine's."""
    _, t = wide
    order = [(1, AUDIO[1]), (0, AUDIO[0]), (2, AUDIO[2])]
    reused = drive(ContinuousEngine(t, pool=1, **KW), order)
    for k, s in order:
        assert reused[k] == drive(ContinuousEngine(t, pool=1, **KW), [(k, s)])[k]


def test_eos_budget_progress_and_stats(wide):
    _, t = wide
    free = drive(ContinuousEngine(t, pool=2, **KW), list(enumerate(AUDIO)))
    # an EOS that request 0 first emits at step 3
    eos = free[0][3]
    assert eos not in free[0][:3]
    t2 = dataclasses.replace(t.cfg, decoder=dataclasses.replace(
        t.cfg.decoder, eos_token_id=eos))
    orig = t.cfg
    t.cfg = t2
    try:
        eng = ContinuousEngine(t, pool=2, **KW)
        seen = {}
        eng.on_progress = lambda k, ids: seen.setdefault(k, []).extend(ids)
        got = drive(eng, list(enumerate(AUDIO)))
    finally:
        t.cfg = orig
    for k, toks in free.items():
        stop = toks.index(eos) if eos in toks else MAX_TOKENS
        assert got[k] == toks[:stop]          # EOS ends it and is dropped
        assert seen.get(k, []) == got[k]       # progress carried every token
    st = eng.stats()
    assert st["admitted"] == st["completed"] == 3 and st["active"] == 0
    assert st["rounds"] == eng.n_rounds > 0
    assert 0 < st["slot_utilization"] <= 1
    assert st["context"] == 128 and st["pool"] == 2


def test_fail_active_reallocates(wide):
    _, t = wide
    eng = ContinuousEngine(t, pool=2, **KW)
    eng.admit(["a", "b"], AUDIO[:2])
    eng.run_round()
    old = eng._kv[0]
    failed = eng.fail_active(RuntimeError("boom"))
    assert sorted(k for k, _ in failed) == ["a", "b"]
    assert all(isinstance(e, RuntimeError) for _, e in failed)
    assert eng.n_active() == 0 and eng._kv[0] is not old
    assert not any(p.any() for p in eng._kv)
    assert (eng._pos == 1).all() and not eng._cur.any()
    fresh = drive(ContinuousEngine(t, pool=2, **KW), [(0, AUDIO[0])])
    assert drive(eng, [(0, AUDIO[0])]) == fresh


def test_eligibility_and_limits(wide):
    _, t = wide
    eng = ContinuousEngine(t, pool=2, **KW)
    assert eng.eligible(16000) and not eng.eligible(16000, max_tokens=200)
    with pytest.raises(ValueError, match="pool must be"):
        ContinuousEngine(t, pool=17, **KW)
    with pytest.raises(ValueError, match="multiple of 128"):
        ContinuousEngine(t, pool=2, **dict(KW, s_pool=100))
    # the default context: a 92 s prompt bucket plus the budget, rounded to 128
    S = default_context(t, 2, 1024, 128)
    assert S % 128 == 0 and S >= 1024 + 128
    assert ContinuousEngine(t, pool=2, round_tokens=2).S == S
    assert isinstance(eng._kv[0], torch.Tensor) and eng._kv[0].shape[:3] == (2, 2, 128)
    np.testing.assert_array_equal(eng._pos, 1)
