"""Prefill (context) attention driver: the port's prefill attention
(kernel D2 on the card) on ragged batched sequences with history, held
against a dense masked softmax golden (CPU) or the plain version (card).

    python -m examples_torch.run_attention_prefill [--device cpu]
"""

from llm_inference_engine_tpu_torch.ops.attention import (
    attention, attention_torch)

from examples_torch._common import (
    dense_attention, ints, max_err, on_card, parse, randn, report)


def main(argv=None) -> None:
    dev = parse(argv, __doc__)
    B, Sq, H, K, Skv = 2, 16, 8, 4, 64
    D = 64 if on_card(dev) else 32
    q = randn((B, Sq, H, D), 0, dev)
    k_cache = randn((B, Skv, K, D), 1, dev)
    v_cache = randn((B, Skv, K, D), 2, dev)
    # ragged: sequence 0 has 5 tokens of history + 16 new; sequence 1 has
    # 0 + 9
    q_start = ints([5, 0], dev)
    kv_len = ints([5 + 16, 9], dev)

    out = attention(q, k_cache, v_cache, q_start, kv_len)
    if on_card(dev):
        want = attention_torch(q, k_cache, v_cache, q_start, kv_len)
        what, tol = "plain version", 2e-2
    else:
        want = dense_attention(q, k_cache, v_cache, q_start, kv_len)
        what, tol = "dense golden", 2e-5
    err = max_err(out[:, :9], want[:, :9])
    err = max(err, max_err(out[0], want[0]))
    report(f"prefill attention vs {what}", err < tol,
           f"max abs err {err:.2e}, q{tuple(q.shape)} "
           f"kv{tuple(k_cache.shape)} {q.dtype} on {dev.type}")


if __name__ == "__main__":
    main()
