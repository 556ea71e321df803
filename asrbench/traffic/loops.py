"""The loops that drive a front door with a plan's requests, on the host
clock (`time.perf_counter`), each request's result waited for.

A closed loop sends requests one after another until `seconds` have passed
and counts the last one to its end; its window runs from the first send to
the last result. An open loop sends each request at its due time whether
or not earlier ones are done, then waits for every result, at most
LATE_S past the close; its window runs from the first due time to the
last result, and a request with no result by then has failed.
"""

from __future__ import annotations

import sys
import threading
import time

from asrbench.traffic import Plan, Request

LATE_S = 60.0


class Window:
    """The requests of one window and its span on the host clock."""

    def __init__(self, requests: list[Request], t0: float, t1: float, lateness: float = 0.0):
        self.requests = requests
        self.t0, self.t1 = t0, t1
        self.lateness = lateness   # the open loop's latest send past its due time

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0

    @property
    def done(self) -> list[Request]:
        return [r for r in self.requests if r.ok]


def _fail(req: Request, err: BaseException) -> None:
    req.error = f"{type(err).__name__}: {err}"
    print(f"request {req.seq} failed: {req.error}", file=sys.stderr, flush=True)


def closed(door, plan: Plan, seconds: float | None, count: int | None = None,
           stream: int | None = None) -> Window:
    """Send plan.closed() requests back to back for `seconds` (or exactly
    `count` requests)."""
    reqs = []
    gen = plan.closed() if stream is None else plan.closed(stream)
    t0 = time.perf_counter()
    now = t0
    for req in gen:
        if (count is not None and len(reqs) == count) or (
                count is None and reqs and now - t0 >= seconds):
            break
        pcm = plan.pcm(req)
        req.t_sent = time.perf_counter() - t0
        try:
            req.output = door.call(req, pcm)
            now = time.perf_counter()
            req.t_done = now - t0
        except Exception as e:  # noqa: BLE001 - a failed request is counted, the run goes on
            now = time.perf_counter()
            _fail(req, e)
        reqs.append(req)
    return Window(reqs, t0, now)


def open_loop(door, plan: Plan, reqs: list[Request]) -> Window:
    """Send each request at its due time through door.submit(req, pcm) -> a
    Future; wait for all."""
    done = threading.Event()
    left = [len(reqs)]
    lock = threading.Lock()
    t0 = time.perf_counter() + 0.05
    last = [t0]

    def finish(req: Request, fut) -> None:
        now = time.perf_counter()
        err = fut.exception()
        if err is None:
            req.output = door.result(req, fut.result())
            req.t_done = now - t0
        else:
            _fail(req, err)
        with lock:
            last[0] = max(last[0], now)
            left[0] -= 1
            if left[0] == 0:
                done.set()

    lateness = 0.0
    for req in reqs:
        pcm = plan.pcm(req)
        wait = t0 + req.t_due - time.perf_counter()
        if wait > 0:
            time.sleep(wait)
        now = time.perf_counter()
        req.t_sent = now - t0
        lateness = max(lateness, req.t_sent - req.t_due)
        fut = door.submit(req, pcm)
        fut.add_done_callback(lambda f, r=req: finish(r, f))
    close = t0 + (reqs[-1].t_due if reqs else 0.0)
    done.wait(timeout=max(0.0, close + LATE_S - time.perf_counter()))
    for req in reqs:
        if req.t_done is None and not req.error:
            req.error = "no result within the wait"
    return Window(reqs, t0, last[0], lateness)
