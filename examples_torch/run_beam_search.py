"""Beam-search driver: four beams over a prompt, best first; each beam's
score is held against the log-probability of its tokens under a
teacher-forced forward over the whole sequence (the plain route on the
card).

    python -m examples_torch.run_beam_search [--device cpu]
"""

import torch

from llm_inference_engine_tpu_torch.config import EngineConfig
from llm_inference_engine_tpu_torch.models.weights import init_dummy_params
from llm_inference_engine_tpu_torch.runtime.beam_search import beam_search

from examples_torch._common import (
    model_config, on_card, parse, report, teacher_forced_logits)

PROMPT = [1, 9, 41, 7]


def main(argv=None) -> None:
    dev = parse(argv, __doc__)
    cfg = model_config(dev)
    params = init_dummy_params(cfg, seed=3, scale=0.35, device=dev)
    res = beam_search(cfg, EngineConfig(max_batch_size=4, max_seq_len=64),
                      params, PROMPT, num_beams=4, max_new_tokens=8,
                      eos_token_id=None, length_penalty=0.0)
    for seq, score in zip(res.sequences, res.scores):
        print(f"  score {score:8.3f}  tokens {seq}")
    report("beam search (4 beams)",
           res.scores == sorted(res.scores, reverse=True)
           and len(res.sequences) == 4
           and all(len(s) == 8 for s in res.sequences),
           "beams sorted best-first")
    worst = 0.0
    for seq, score in zip(res.sequences, res.scores):
        full = PROMPT + seq
        lp = torch.log_softmax(
            teacher_forced_logits(cfg, params, full[:-1]).double(), -1)
        total = sum(float(lp[len(PROMPT) - 1 + i, t])
                    for i, t in enumerate(seq))
        worst = max(worst, abs(total - score))
    # bf16 on the card: 5.7e-2 nats on an H100
    tol = 0.2 if on_card(dev) else 1e-3
    report("beam scores vs teacher-forced log-probs", worst < tol,
           f"largest |difference| {worst:.2e} nats")


if __name__ == "__main__":
    main()
