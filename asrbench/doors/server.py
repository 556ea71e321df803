"""`qwen3-asr-cuda-serve`'s batching server driven in the process, with no
HTTP: `Qwen3ASR(quantize=..., kv_cache=...)` behind `ASRServer(max_batch,
max_wait_ms)` with closed batches and one `TranscribeParams(max_tokens,
mel_bucket)` for every request, each request through `ASRServer.submit`.

The door keeps, for each batch the server's worker takes, its requests
(`batches`: lists of the benchmark's request numbers), to count the
batched decode steps' work. It records through the server's
`_process_batch`, which it overrides: the door refuses to build where the
server has no such method, and its counters raise where the server ran
batches that the door did not see."""

from __future__ import annotations

import threading


kind = "asr"


class Door:
    def __init__(self, family, cfg: dict, mix: dict, seed: int, device,
                 quantize: str | None = None):
        from qwen3_asr_tpu_torch.pipeline.asr import Qwen3ASR, TranscribeParams
        from qwen3_asr_tpu_torch.serve import ASRServer

        door = self
        if not callable(getattr(ASRServer, "_process_batch", None)):
            raise RuntimeError("ASRServer has no _process_batch for the door to record")

        class Recording(ASRServer):
            """The server, noting the requests of each batch it runs."""

            def _process_batch(self, batch):
                with door._lock:
                    door.batches.append([door._seq.get(id(r.future)) for r in batch])
                return super()._process_batch(batch)

        args = mix["door_args"]
        self.batches: list[list] = []
        self._seq: dict[int, int] = {}
        self._lock = threading.Lock()
        self.asr = Qwen3ASR(quantize=quantize or args["quantize"], kv_cache=args["kv_cache"],
                            device=device)
        family.load(self.asr, cfg, seed, device)
        params = TranscribeParams(max_tokens=mix["max_tokens"], mel_bucket=args["mel_bucket"],
                                  print_timing=False)
        self.server = Recording(self.asr, params, max_batch=args["max_batch"],
                                max_wait_ms=args["max_wait_ms"])

    def submit(self, req, pcm):
        with self._lock:
            fut = self.server.submit(pcm)
            self._seq[id(fut)] = req.seq
        return fut

    def result(self, req, value) -> list[int]:
        if not value.success:
            raise RuntimeError(value.error_msg)
        return value.tokens

    def call(self, req, pcm) -> list[int]:
        return self.result(req, self.submit(req, pcm).result())

    def warm_batch(self, reqs, pcms) -> None:
        """The requests submitted at once, so the worker runs them as one
        batch (up to max_batch); waits for all."""
        futs = [self.submit(r, p) for r, p in zip(reqs, pcms)]
        for r, f in zip(reqs, futs):
            self.result(r, f.result())

    def counters(self) -> dict:
        n = self.server.n_batches
        if n and not self.batches:
            raise RuntimeError(f"the server ran {n} batches and the door recorded none")
        return {"n_served": self.server.n_served, "n_batches": n}

    def close(self) -> None:
        self.server.close()
        self.server = self.asr = None
