"""SwiGLU FFN driver: packed gate|up matmul -> ``silu_and_mul`` (kernel B
on the card) -> down matmul, held against an einsum golden (CPU) or the
plain version of the activation (card).

    python -m examples_torch.run_ffn [--device cpu]
"""

import torch
import torch.nn.functional as F

from llm_inference_engine_tpu_torch.ops.activations import (
    silu_and_mul, silu_and_mul_torch)
from llm_inference_engine_tpu_torch.ops.linear import linear

from examples_torch._common import max_err, on_card, parse, randn, report


def main(argv=None) -> None:
    dev = parse(argv, __doc__)
    T, Hd, I = 24, 128, 256
    x = randn((1, T, Hd), 2, dev, scale=0.5)
    w_gate_up = randn((Hd, 2, I), 3, dev, scale=0.05)
    w_down = randn((I, Hd), 4, dev, scale=0.05)

    gate_up = linear(x, w_gate_up)            # [1, T, 2I]: gate | up
    y = linear(silu_and_mul(gate_up), w_down)  # [1, T, Hd]
    if on_card(dev):
        want = linear(silu_and_mul_torch(gate_up), w_down)
        what, tol = "the plain activation", 1e-2
    else:
        xf, wf = x.float(), w_gate_up.float()
        g = torch.einsum("bth,hi->bti", xf, wf[:, 0])
        u = torch.einsum("bth,hi->bti", xf, wf[:, 1])
        want = torch.einsum("bti,ih->bth", F.silu(g) * u, w_down.float())
        what, tol = "einsum golden", 1e-4
    err = max_err(y, want)
    report(f"SwiGLU FFN block vs {what}", err < tol,
           f"max err {err:.2e}, {x.dtype} on {dev.type}")


if __name__ == "__main__":
    main()
