"""chip_smoke 4k (c) on in-memory llama2-7b dummies (seed 0), INT8 then
INT4, at prefill chunks of 512 and 1024: whether the scheduler's greedy
ids with and without the slot PrefixStore differ only when a prompt
takes two chunks. Runs on the card, about 80 s:

    python3 tools/prefix_chunk_probe.py
"""
import sys, time
from pathlib import Path
ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import numpy as np, torch
import chip_smoke as cs
from llm_inference_engine_tpu_torch.ops import _native
_native.build(); _native.library()
from llm_inference_engine_tpu_torch.config import EngineConfig, get_config
from llm_inference_engine_tpu_torch.models import weights as W
from llm_inference_engine_tpu_torch.runtime.engine import InferenceEngine
dev = torch.device("cuda", 0)
cfg = get_config("llama2-7b")
for mode in ("int8", "int4"):
    p = W.quantize_params(W.init_dummy_params(cfg, seed=0, device=dev), mode, 128)
    torch.cuda.empty_cache()
    eng = InferenceEngine(cfg, EngineConfig(quant_mode=mode, max_batch_size=8, max_seq_len=2048), p, device=dev)
    prefix = cs.prefix_prompts(np.random.default_rng(0))
    for C in (512, 1024):
        eng.engine_config = eng.engine_config.replace(max_prefill_len=C)
        print(f"== {mode} max_prefill_len {C}", flush=True)
        try:
            cs.prefix_store_rows(torch, eng, prefix, hold_ids=False)
        except AssertionError as e:
            print("ASSERT", e, flush=True)
    del eng, p
    torch.cuda.empty_cache()
