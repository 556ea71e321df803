"""Holds one checkout's serving paths against another's on one card:
`chip_smoke.py`'s closed batch of 4 (`phase_batch_requests`, auto + bf16
KV: batched and serial decode ms/step), the server default's closed batch
(`phase_server_default`, auto + int8 KV: decode ms/step) and the
continuous engine's pool tokens/s (`phase_engine`, int4 + int8 KV), run
with the phases of the `chip_smoke.py` beside this script on the package
of the checkout at TREE (its kernels built from its own sources):

    python3 chip_compare.py TREE

Run it on the parent's checkout and on the change's in one call, in turns
(parent, change, change, parent). Prints the phases' lines, then one JSON
line. Needs a CUDA device.
"""

import importlib.util
import json
import sys
from pathlib import Path


def main(tree: str) -> int:
    sys.path.insert(0, str(Path(tree).resolve()))
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parent / "chip_smoke.py")
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
    cs.BATCH_MODES = (("auto", "bf16"),)
    batch = cs.phase_batch_requests({("auto", "bf16"): cs.like(auto, "bf16")})
    server_ms = cs.phase_server_default(auto)
    asr4 = Qwen3ASR(quantize="int4", kv_cache="int8", device="cuda")
    asr4.load_random(ASRModelConfig(), seed=0)
    cs.eos_off(asr4)
    tps, _ = cs.phase_engine(asr4)
    row = batch["transcribe_batch auto + bf16 KV"]
    print(json.dumps({"tree": tree, "kernels": str(build.CSRC),
                      "batch_auto_bf16_ms_step": row["decode_ms_step"],
                      "serial_auto_bf16_ms_step": row["serial_decode_ms_step"],
                      "server_default_batch_ms_step": server_ms,
                      "pool_tokens_s": tps}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1]))
