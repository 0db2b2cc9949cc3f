"""Tensor-parallel forward: Megatron-style TP (qkv and gate|up
column-sharded, o and down row-sharded, one cross-rank sum each) times
data parallelism, TP4 x DP2 over eight ranks (copies of the CPU, or eight
ranks on cuda:0), against the one-device forward on the same weights.

    python -m examples_torch.run_sharded_tp [--device cpu]
"""

import torch

from llm_inference_engine_tpu_torch.config import EngineConfig
from llm_inference_engine_tpu_torch.models import llama
from llm_inference_engine_tpu_torch.models.weights import init_dummy_params
from llm_inference_engine_tpu_torch.ops import kv_cache as kvc
from llm_inference_engine_tpu_torch.parallel import make_mesh, sharding

from examples_torch._common import (
    ints, max_err, model_config, on_card, parse, rel_l2, report)

# card limit: relative L2 of the logits against one device (bf16 partial
# products rounded per rank before the cross-rank sum), twice the 1.74e-2
# an H100 gave
MESH_REL_L2 = 4e-2


def main(argv=None) -> None:
    dev = parse(argv, __doc__)
    cfg = model_config(dev, num_kv_heads=4, num_heads=8)
    dp, tp, B = 2, 4, 4
    eng = EngineConfig(max_batch_size=B, max_seq_len=32, dp=dp, tp=tp)
    mesh = make_mesh(dp=dp, tp=tp, devices=[dev] * (dp * tp))
    params = init_dummy_params(cfg, seed=0, scale=0.3, device=dev)
    ids = torch.ones((B, 6), dtype=torch.int32, device=dev)
    q0, lens = ints([0] * B, dev), ints([6] * B, dev)

    def cache():
        return kvc.new_kv_cache(cfg.num_layers, B, cfg.num_kv_heads, 32,
                                cfg.head_dim, dtype=cfg.dtype, device=dev)
    # one-device golden
    want, _ = llama.forward_hidden(cfg, eng, params, ids, cache(), q0, lens)
    # sharded
    sparams = sharding.shard_params(params, mesh)
    fwd = sharding.make_sharded_forward(cfg, eng, mesh)
    got, _ = fwd(sparams, sharding.shard_cache(cache(), mesh), ids, q0, lens)

    if on_card(dev):
        err, tol, what = rel_l2(got, want), MESH_REL_L2, "rel L2"
    else:
        err, tol, what = max_err(got, want), 1e-3, "max err"
    report(f"TP{tp} x DP{dp} sharded forward == one device", err < tol,
           f"{what} {err:.3e} (limit {tol}) on a mesh of {dp * tp} ranks "
           f"of {dev}")

if __name__ == "__main__":
    main()
