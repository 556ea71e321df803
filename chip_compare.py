"""Holds one checkout's serving paths against another's on one card, each
checked by the phases of its own `chip_smoke.py`: the closed batch of 4
(`phase_batch_requests`: auto + bf16 KV and q8_0 + bf16 KV, batched and
serial decode ms/step), the server default's closed batch
(`phase_server_default`, auto + int8 KV: decode ms/step), the continuous
engine's pool tokens/s (`phase_engine`, int4 + int8 KV), the Q8_0 products
K5-K7 at T 1 / 4 / 8 / 16 and a 5 s prompt's rows (`phase_q8`: graphed ms)
and the per-layer step at B 8 (`phase_step_batch`, q8_0 + bf16 KV:
device-busy ms), run on the package of the checkout at TREE (its kernels
built from its own sources):

    python3 chip_compare.py TREE

Run it on the parent's checkout and on the change's in one call, in turns
(parent, change, change, parent). Prints the phases' lines, then one JSON
line. Needs a CUDA device.
"""

import importlib.util
import json
import sys
from pathlib import Path

Q8_ROWS = (1, 4, 8, 16)   # besides a 5 s prompt's rows


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
    rows = Q8_ROWS + (cs.prompt_rows(5),)
    products = {f"{name} T={T}": v[1]
                for (name, T), v in cs.phase_q8(dec, dcfg, rows).items()}
    step = cs.phase_step_batch(q8, "bf16")
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
                      "step_batch_b8_busy_ms": step["batched"]["busy_ms"],
                      "step_8_single_busy_ms": step["8 single"]["busy_ms"],
                      "q8_products_ms": products,
                      "server_default_batch_ms_step": server_ms,
                      "pool_tokens_s": tps}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1]))
