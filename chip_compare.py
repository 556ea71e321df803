"""Holds one checkout's serving paths against another's on one card, each
checked by the phases of its own `chip_smoke.py`: K4 alone
(`phase_decode_attention`, one row at offset 1,248, and
`phase_decode_attention_batch`, B 8 at offsets 64..1,600, on a bf16 and an
int8 cache: graphed ms), the per-layer q8_0 step at T 1 (`single_step`
below: wall, enqueue, device-busy ms and kernels a step on each cache) and
at B 8 (`phase_step_batch` on each cache), the closed batch of 4
(`phase_batch_requests`: auto + bf16 KV and q8_0 + bf16 KV, batched and
serial decode ms/step), the server default's closed batch
(`phase_server_default`, auto + int8 KV: decode ms/step), the continuous
engine's pool tokens/s (`phase_engine`, int4 + int8 KV), the Q8_0 products
K5-K7 at T 1 / 4 / 8 / 16 and a 5 s prompt's rows (`phase_q8`: graphed ms)
run on the package of the checkout at TREE (its kernels built from its own
sources):

    python3 chip_compare.py TREE

Run it on the parent's checkout and on the change's in one call, in turns
(parent, change, change, parent). Prints the phases' lines, then one JSON
line. Needs a CUDA device.
"""

import importlib.util
import json
import statistics
import sys
import time
from pathlib import Path

Q8_ROWS = (1, 4, 8, 16)   # besides a 5 s prompt's rows
STEP_POS, STEP_S, STEP_N = 1248, 1664, 20   # the T 1 step: its row, cache rows, timed steps


def single_step(cs, asr, kv: str) -> dict:
    """The per-layer decode step at T 1 (`decoder_forward`, one row at
    STEP_POS over a cache of STEP_S rows whose rows < STEP_POS are drawn
    from N(0, 0.25)) on the tree's package: the median wall and enqueue ms
    of STEP_N steps (host clock; the step rewrites the same row), and one
    step under torch.profiler (device-busy ms, kernels)."""
    import torch

    from qwen3_asr_tpu_torch.models import decoder as dmod

    dcfg, dec = asr.cfg.decoder, asr.params["decoder"]
    g = torch.Generator(device="cuda").manual_seed(5)
    cache = dmod.init_kv_cache(dcfg, STEP_S, "cuda",
                               torch.int8 if kv == "int8" else torch.bfloat16)
    for n in ("k", "v"):
        rows = torch.randn(dcfg.n_layers, STEP_POS, dcfg.n_kv_heads, dcfg.head_dim,
                           generator=g, device="cuda") * 0.5
        if kv == "int8":
            cache[n][:, :STEP_POS], cache[n + "_s"][:, :STEP_POS] = dmod._quantize_kv_rows(rows)
        else:
            cache[n][:, :STEP_POS] = rows.to(torch.bfloat16)
    x = dec["token_embd"][torch.tensor([1000], device="cuda")]

    def step():
        return dmod.decoder_forward(dec, dcfg, x, cache, STEP_POS + 1, prefill=False,
                                    cache_offset=STEP_POS)

    for _ in range(3):
        step()
    walls, enqs = [], []
    for _ in range(STEP_N):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        enqs.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    _, kernels = cs.profiled(step)
    out = {"wall_ms": statistics.median(walls), "enqueue_ms": statistics.median(enqs),
           "busy_ms": sum(k[0] for k in kernels), "kernels": sum(k[1] for k in kernels)}
    print(f"per-layer q8_0 step, T 1, {kv} KV, pos {STEP_POS}: wall {out['wall_ms']:.4f} "
          f"ms, enqueue {out['enqueue_ms']:.4f} ms (medians of {STEP_N}), device busy "
          f"{out['busy_ms']:.4f} ms, {out['kernels']} kernels a step", flush=True)
    return out


def main(tree: str) -> int:
    root = Path(tree).resolve()
    sys.path.insert(0, str(root))
    spec = importlib.util.spec_from_file_location("chip_smoke", root / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    sys.modules["chip_smoke"] = cs
    spec.loader.exec_module(cs)

    from qwen3_asr_tpu_torch.config import ASRModelConfig
    from qwen3_asr_tpu_torch.ops import build
    from qwen3_asr_tpu_torch.pipeline.asr import Qwen3ASR

    build.library()
    auto = Qwen3ASR(quantize="auto", device="cuda")
    auto.load_random(ASRModelConfig(), seed=0)
    cs.eos_off(auto)
    q8 = Qwen3ASR(quantize="q8_0", kv_cache="bf16", device="cuda")
    q8.load_random(ASRModelConfig(), seed=0)
    cs.eos_off(q8)
    dec, dcfg = q8.params["decoder"], q8.cfg.decoder
    k4 = cs.phase_decode_attention(dcfg, STEP_POS, STEP_S)
    k4b = cs.phase_decode_attention_batch(dcfg)
    t1 = {kv: single_step(cs, q8, kv) for kv in ("bf16", "int8")}
    b8 = {kv: cs.phase_step_batch(q8, kv) for kv in ("bf16", "int8")}
    rows = Q8_ROWS + (cs.prompt_rows(5),)
    products = {f"{name} T={T}": v[1]
                for (name, T), v in cs.phase_q8(dec, dcfg, rows).items()}
    cs.BATCH_MODES = (("auto", "bf16"), ("q8_0", "bf16"))
    batch = cs.phase_batch_requests({("auto", "bf16"): cs.like(auto, "bf16"),
                                     ("q8_0", "bf16"): q8})
    server_ms = cs.phase_server_default(auto)
    asr4 = Qwen3ASR(quantize="int4", kv_cache="int8", device="cuda")
    asr4.load_random(ASRModelConfig(), seed=0)
    cs.eos_off(asr4)
    tps, _ = cs.phase_engine(asr4)
    row = batch["transcribe_batch auto + bf16 KV"]
    q8_row = batch["transcribe_batch q8_0 + bf16 KV"]
    print(json.dumps({"tree": tree, "kernels": str(build.CSRC),
                      "batch_auto_bf16_ms_step": row["decode_ms_step"],
                      "serial_auto_bf16_ms_step": row["serial_decode_ms_step"],
                      "batch_q8_0_bf16_ms_step": q8_row["decode_ms_step"],
                      "serial_q8_0_bf16_ms_step": q8_row["serial_decode_ms_step"],
                      "k4_one_row_ms": {kv: k4[(kv, STEP_POS)][1] for kv in ("bf16", "int8")},
                      "k4_b8_ms": {kv: k4b[kv][1] for kv in ("bf16", "int8")},
                      "step_t1": t1,
                      "step_b8": {kv: {n: b8[kv]["batched"][n] for n in
                                       ("wall_ms", "enqueue_ms", "busy_ms", "kernels")}
                                  for kv in ("bf16", "int8")},
                      "step_b8_k4_busy_ms": {kv: b8[kv]["batched"]["k4_ms"]
                                             for kv in ("bf16", "int8")},
                      "step_8_single_busy_ms": b8["bf16"]["8 single"]["busy_ms"],
                      "q8_products_ms": products,
                      "server_default_batch_ms_step": server_ms,
                      "pool_tokens_s": tps}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1]))
