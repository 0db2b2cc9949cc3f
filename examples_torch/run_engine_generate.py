"""Engine API driver: batched greedy generation with a streaming callback,
and the same tokens again after ``reset()``. Every generated token is
held against the greedy choice of a teacher-forced forward over the whole
sequence (the plain route on the card).

    python -m examples_torch.run_engine_generate [--device cpu]
"""

from llm_inference_engine_tpu_torch.config import EngineConfig, SamplingParams
from llm_inference_engine_tpu_torch.models.weights import init_dummy_params
from llm_inference_engine_tpu_torch.runtime.engine import InferenceEngine

from examples_torch._common import check_greedy, model_config, parse, report

PROMPTS = [[1, 17, 93, 5], [1, 9], [1, 200, 3, 77, 4]]


def main(argv=None) -> None:
    dev = parse(argv, __doc__)
    cfg = model_config(dev)
    params = init_dummy_params(cfg, seed=0, scale=0.3, device=dev)
    engine = InferenceEngine(cfg, EngineConfig(max_batch_size=3,
                                               max_seq_len=64), params)
    sp = SamplingParams(greedy=True, max_new_tokens=8)
    streamed = []
    res = engine.generate(PROMPTS, sp, eos_token_id=None,
                          stream_callback=lambda i, t: streamed.append((i, t)))
    print("generated:", res.token_ids)
    report("batched greedy generation",
           all(len(s) == 8 for s in res.token_ids)
           and sorted(streamed) == sorted(
               (i, t) for i, s in enumerate(res.token_ids) for t in s),
           f"{sum(res.num_generated)} tokens streamed in {len(streamed)} "
           "callbacks")
    check_greedy("greedy tokens vs a teacher-forced forward", dev, cfg,
                 params, PROMPTS, res.token_ids)

    # determinism: same prompts after reset -> same tokens
    engine.reset()
    res2 = engine.generate(PROMPTS, sp, eos_token_id=None)
    report("deterministic after reset", res2.token_ids == res.token_ids)


if __name__ == "__main__":
    main()
