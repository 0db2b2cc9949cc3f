"""Speculative decoding driver: a draft model proposes 3 tokens a round,
the target verifies them in one forward. With the draft's weights equal
to the target's, most drafts are accepted, and the greedy output is the
target's own (held against a teacher-forced forward; on the CPU also
equal to plain greedy decoding).

    python -m examples_torch.run_speculative [--device cpu]
"""

from llm_inference_engine_tpu_torch.config import EngineConfig, SamplingParams
from llm_inference_engine_tpu_torch.models.weights import init_dummy_params
from llm_inference_engine_tpu_torch.runtime.engine import InferenceEngine
from llm_inference_engine_tpu_torch.runtime.speculative import (
    SpeculativeDecoder)

from examples_torch._common import check_greedy, model_config, parse, report

PROMPT = [[1, 17, 93, 5]]


def main(argv=None) -> None:
    dev = parse(argv, __doc__)
    cfg = model_config(dev)
    eng = EngineConfig(max_batch_size=1, max_seq_len=96)
    params = init_dummy_params(cfg, seed=0, scale=0.3, device=dev)
    target = InferenceEngine(cfg, eng, params)
    draft = InferenceEngine(cfg, eng, init_dummy_params(
        cfg, seed=0, scale=0.3, device=dev))
    want = target.generate(PROMPT, SamplingParams(greedy=True,
                                                  max_new_tokens=12),
                           eos_token_id=None).token_ids
    target.reset()
    spec = SpeculativeDecoder(target, draft, num_draft=3)
    res = spec.generate(PROMPT, max_new_tokens=12, eos_token_id=None)
    print("  greedy:", want[0])
    print("  spec:  ", res.token_ids[0],
          f"(acceptance {res.acceptance_rate:.0%})")
    report("speculative decoding", res.acceptance_rate > 0.5,
           f"acceptance {res.acceptance_rate:.0%}, "
           f"{res.num_accepted}/{res.num_drafted} drafts accepted")
    check_greedy("speculative tokens are the target's greedy tokens", dev,
                 cfg, params, PROMPT, res.token_ids, want)


if __name__ == "__main__":
    main()
