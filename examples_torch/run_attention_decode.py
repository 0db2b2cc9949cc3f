"""Decode (single-token) attention driver: the port's fused decode (kernel
D on the card: write the new token's K/V at q_start, then attend) over a
history of different lengths per sequence, in a bf16/f32 cache and in an
INT8 cache (quantize on write, dequantize in the kernel), held against a
dense masked softmax golden (CPU) or the plain versions (card).

    python -m examples_torch.run_attention_decode [--device cpu]
"""

import torch

from llm_inference_engine_tpu_torch.ops import kv_cache as kvc
from llm_inference_engine_tpu_torch.ops.attention import (
    attention_decode_fused, attention_decode_fused_torch)

from examples_torch._common import (
    dense_attention, dtype_of, ints, max_err, on_card, parse, randn, report)


def main(argv=None) -> None:
    dev = parse(argv, __doc__)
    B, H, K, D, S = 4, 8, 2, 64, 128
    hist_len = [17, 0, 63, 5]
    q = randn((B, 1, H, D), 1, dev)
    k_new = randn((B, 1, K, D), 2, dev)
    v_new = randn((B, 1, K, D), 3, dev)
    hist_k = randn((B, max(hist_len), K, D), 4, dev)
    hist_v = randn((B, max(hist_len), K, D), 5, dev)
    q_start = ints(hist_len, dev)
    kv_len = q_start + 1

    # golden inputs: each row's history, then its new token at q_start
    k_all = torch.zeros(B, S, K, D)
    v_all = torch.zeros(B, S, K, D)
    for b, n in enumerate(hist_len):
        k_all[b, :n], v_all[b, :n] = hist_k[b, :n].cpu(), hist_v[b, :n].cpu()
        k_all[b, n], v_all[b, n] = k_new[b, 0].cpu(), v_new[b, 0].cpu()
    golden = dense_attention(q, k_all, v_all, q_start, kv_len)

    def cache(quantized):
        c = kvc.new_kv_cache(1, B, K, S, D, dtype=dtype_of(dev), device=dev,
                             quantized=quantized)
        kvc.update_cache_at_layer(c, 0, hist_k, hist_v, ints([0] * B, dev),
                                  q_start)
        return c

    for quantized in (False, True):
        tag = "INT8 " if quantized else ""
        c = cache(quantized)
        scales = (dict(k_scale=c.k_scale, v_scale=c.v_scale,
                       snapped=c.snapped) if quantized else {})
        out, _, _ = attention_decode_fused(q, k_new, v_new, c.k, c.v,
                                           q_start, kv_len, 0, **scales)
        if quantized:
            err = max_err(out, golden)
            report("decode attention with an INT8 KV cache vs the fp golden",
                   err < 0.05, f"max err {err:.2e}")
        if on_card(dev):
            # the plain version on a second cache: output and every row
            ref = cache(quantized)
            ref_scales = (dict(k_scale=ref.k_scale, v_scale=ref.v_scale,
                               snapped=ref.snapped) if quantized else {})
            want, _, _ = attention_decode_fused_torch(
                q, k_new, v_new, ref.k, ref.v, q_start, kv_len, 0,
                **ref_scales)
            written = torch.equal(c.k, ref.k) and torch.equal(c.v, ref.v)
            err = max_err(out, want)
            report(f"{tag}decode attention vs the plain version",
                   err < 2e-2 and written,
                   f"max err {err:.2e}, cache rows equal: {written}")
            continue
        new = (kvc.quantize_rows(k_new, c.snapped)[0] if quantized
               else k_new)
        written = all(torch.equal(c.k[0, b, n], new[b, 0])
                      for b, n in enumerate(hist_len))
        if quantized:
            report(f"{tag}new rows quantized and written at q_start",
                   written)
            continue
        err = max_err(out, golden)
        report("decode attention vs dense golden", err < 2e-5 and written,
               f"max err {err:.2e}, new rows written at q_start: {written}")


if __name__ == "__main__":
    main()
