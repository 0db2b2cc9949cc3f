"""Context-parallel engine: ``EngineConfig(cp=2, dp=2)`` splits the KV
cache's token capacity over the seq axis of the mesh (each rank an
append log of its own rows), runs prefill as ring attention and decode
as split-KV attention; ranks are copies of the CPU, or four ranks on
cuda:0. Its greedy tokens must be the one-device engine's (on the card,
up to near-ties of the teacher-forced reference).

    python -m examples_torch.run_context_parallel [--device cpu]
"""

import numpy as np

from llm_inference_engine_tpu_torch.config import EngineConfig, SamplingParams
from llm_inference_engine_tpu_torch.models.weights import init_dummy_params
from llm_inference_engine_tpu_torch.parallel import make_mesh
from llm_inference_engine_tpu_torch.runtime.engine import InferenceEngine

from examples_torch._common import check_greedy, model_config, parse

PROMPTS = [[1, 17, 93, 5], [7, 9, 23], [2, 4, 6, 8, 10], [11]]


def main(argv=None) -> None:
    dev = parse(argv, __doc__)
    cfg = model_config(dev)
    params = init_dummy_params(cfg, seed=0, device=dev)
    sp = SamplingParams(greedy=True, max_new_tokens=8)
    eng = EngineConfig(max_batch_size=4, max_seq_len=64, max_prefill_len=16)
    want = InferenceEngine(cfg, eng, params).generate(
        PROMPTS, sp, eos_token_id=None).token_ids
    cp, dp = 2, 2
    cpe = InferenceEngine(cfg, eng.replace(cp=cp, dp=dp), params,
                          mesh=make_mesh(dp, 1, cp, devices=[dev] * 4))
    got = cpe.generate(PROMPTS, sp, eos_token_id=None).token_ids
    print("one device  :", want)
    print("cp=2 x dp=2 :", got)
    print("per-rank KV rows used (llen):")
    print(np.asarray(cpe._llen))
    check_greedy("context-parallel engine token parity (cp=2 x dp=2)", dev,
                 cfg, params, PROMPTS, got, want)


if __name__ == "__main__":
    main()
