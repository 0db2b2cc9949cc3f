"""Quantization driver: INT8 and INT4 fused dequant-matmuls (kernels F and
E on the card) against ``x @ dequant(w)`` (CPU) or their plain versions
(card), then a quantized model end to end: INT8 prefill logits must track
the fp model's on the same prefix (the logit gap is what a ppl delta
measures; token trajectories of a random model are chaotic).

    python -m examples_torch.run_quantized [--device cpu]
"""

import torch

from llm_inference_engine_tpu_torch.config import EngineConfig
from llm_inference_engine_tpu_torch.models.weights import (
    init_dummy_params, quantize_params)
from llm_inference_engine_tpu_torch.ops.quant import (
    add_decode_layout, dequantize_tensor, quantize_tensor, quantized_linear,
    quantized_linear_torch)
from llm_inference_engine_tpu_torch.runtime.engine import InferenceEngine

from examples_torch._common import (
    max_err, model_config, on_card, parse, randn, report)

PROMPT = [[1, 17, 93, 5]]


def main(argv=None) -> None:
    dev = parse(argv, __doc__)
    # --- kernel level ---
    x = randn((16, 256), 0, dev)
    w = randn((256, 512), 1, dev, scale=0.1)
    for mode in ("int8", "int4"):
        # on the card kernel E reads INT4 at m <= 16 in fragment order, a
        # copy an engine builds for its weights and this weight needs too
        t = add_decode_layout(quantize_tensor(w, mode, group_size=128),
                              x.dtype)
        y = quantized_linear(x, t)
        golden = x.float() @ dequantize_tensor(t)
        qerr = max_err(x.float() @ w.float(), golden)
        if on_card(dev):
            want = quantized_linear_torch(x, t)
            what, tol = "plain version", 1e-2 * float(want.abs().max())
        else:
            want, what, tol = golden, "x @ dequant(w)", 1e-3
        err = max_err(y, want)
        report(f"{mode} fused dequant-matmul vs {what}", err < tol,
               f"err {err:.2e} (quantization err {qerr:.2e}), m 16, "
               f"{x.dtype} on {dev.type}")

    # --- model level ---
    cfg = model_config(dev)
    params = init_dummy_params(cfg, seed=0, scale=0.3, device=dev)
    p_int8 = quantize_params(params, "int8", group_size=32)

    def prefill(p, **kw):
        engine = InferenceEngine(cfg, EngineConfig(max_batch_size=1,
                                                   max_seq_len=64, **kw), p)
        return torch.softmax(engine.prefill(PROMPT).float(), -1)

    pa, pb = prefill(params), prefill(p_int8, quant_mode="int8")
    tv = float(0.5 * (pa - pb).abs().sum(-1).max())
    report("int8 model logits track fp", tv < 0.2,
           f"max TV distance {tv:.4f}, argmax agree: "
           f"{bool((pa.argmax(-1) == pb.argmax(-1)).all())}")
    if on_card(dev):
        pc = prefill(p_int8, quant_mode="int8", kernels="torch")
        tv = float(0.5 * (pb - pc).abs().sum(-1).max())
        report("int8 model: kernel route vs plain route", tv < 0.02,
               f"max TV distance {tv:.4f}")


if __name__ == "__main__":
    main()
