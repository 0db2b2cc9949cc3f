"""Full decoder driver: a multi-layer prefill, then the same tokens decoded
one at a time over the KV cache; the incremental decode must reproduce
the all-at-once forward's last-token logits. On the card both run the
kernels (C, D2 and A/B in prefill, D's fused decode) and each is also
held against the plain route (``kernels="torch"``).

    python -m examples_torch.run_decoder [--device cpu]
"""

from llm_inference_engine_tpu_torch.config import EngineConfig
from llm_inference_engine_tpu_torch.models import llama
from llm_inference_engine_tpu_torch.models.weights import init_dummy_params
from llm_inference_engine_tpu_torch.ops import kv_cache as kvc

from examples_torch._common import (
    ints, max_err, model_config, on_card, parse, rel_l2, report)

TOKENS = [1, 7, 42, 99, 5, 13, 27, 3]
# card limits (relative L2 of the last-token logits), twice what an H100
# gave: prefill against decode 2.01e-2, the kernel route against the
# plain one 2.01e-2 in prefill (D2's sums in another order) and 0 in
# decode
DECODE_REL_L2 = 4e-2
ROUTE_REL_L2 = 4e-2


def run(cfg, params, kernels: str, dev):
    """(prefill logits, last incremental decode step's logits) [1, V]."""
    eng = EngineConfig(max_batch_size=1, max_seq_len=32, kernels=kernels)
    T = len(TOKENS)

    def cache():
        return kvc.new_kv_cache(cfg.num_layers, 1, cfg.num_kv_heads, 32,
                                cfg.head_dim, dtype=cfg.dtype, device=dev)
    full, _ = llama.forward_hidden(cfg, eng, params, ints([TOKENS], dev),
                                   cache(), ints([0], dev), ints([T], dev))
    c = cache()
    for t in range(T):
        step, c = llama.forward_hidden(cfg, eng, params,
                                       ints([TOKENS[t:t + 1]], dev), c,
                                       ints([t], dev), ints([t + 1], dev))
    return full, step


def main(argv=None) -> None:
    dev = parse(argv, __doc__)
    cfg = model_config(dev)
    params = init_dummy_params(cfg, seed=0, scale=0.3, device=dev)
    full, step = run(cfg, params, "auto", dev)
    if not on_card(dev):
        err = max_err(full, step)
        report("prefill == incremental decode (last-token logits)",
               err < 1e-3, f"max logits err {err:.2e} over {cfg.num_layers} "
               "layers")
        return
    # bf16: the two paths round at other points (D2 and D, one query row
    # against a chunk), so they are held by relative L2
    err = rel_l2(step, full)
    report("prefill == incremental decode (last-token logits)",
           err < DECODE_REL_L2, f"rel L2 {err:.3e} (limit {DECODE_REL_L2}) "
           f"over {cfg.num_layers} layers, bf16 on the card")
    p_full, p_step = run(cfg, params, "torch", dev)
    errs = rel_l2(full, p_full), rel_l2(step, p_step)
    report("kernel route vs plain route (prefill, decode)",
           max(errs) < ROUTE_REL_L2, f"rel L2 {errs[0]:.3e}, {errs[1]:.3e} "
           f"(limit {ROUTE_REL_L2})")

if __name__ == "__main__":
    main()
