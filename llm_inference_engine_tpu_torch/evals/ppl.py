"""Teacher-forced perplexity evaluation (WikiText-2 style).

Port of ``llm_inference_engine_tpu/evals/ppl.py``, the quality gate of
weight quantization (BASELINE.md: WikiText-2 PPL within +0.1 of the
full-precision model for INT8 weight-only, +0.5 for INT4).

Method: the token stream is scored in fixed windows of ``window`` tokens
with the last token of each window re-used as the first (context) token of
the next, so every corpus token except the very first is predicted exactly
once (stride == window-1). Each batch of windows is one prefill forward
into a slot cache of the window's length (``kv_cache_dtype`` honoured:
an int8 cache is scored through the int8 kernels) and the lm head on
every position; the NLL is the log-sum-exp of each position's logits
minus its target's logit, taken a row at a time so that no second
[B, W, V] tensor is made. The sums stay on the device; the host reads two
scalars a batch (sum NLL, token count).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch

from llm_inference_engine_tpu_torch.config import EngineConfig, ModelConfig
from llm_inference_engine_tpu_torch.models import llama as llama_model
from llm_inference_engine_tpu_torch.ops import kv_cache as kvc

__all__ = ["Scorer", "perplexity", "quant_ppl_report", "load_text_tokens"]


class Scorer:
    """Windowed log-likelihood scorer for one (config, params) pair, on
    the device of ``params`` unless ``device`` says otherwise."""

    def __init__(self, config: ModelConfig, params,
                 engine_config: Optional[EngineConfig] = None,
                 window: int = 512, batch: int = 4, device=None):
        from llm_inference_engine_tpu_torch.runtime.engine import (
            add_decode_layouts, check_kernel_dtypes)
        self.config = config
        self.window = window
        self.batch = batch
        eng = engine_config or EngineConfig()
        # scoring is one prefill per window: cache sized to the window
        self.eng = eng.replace(max_batch_size=batch, max_seq_len=window)
        self.params = params
        self.device = torch.device(device if device is not None
                                   else params["embed"].device)
        check_kernel_dtypes(config, self.eng, self.device)
        add_decode_layouts(config, self.eng, params, self.device)
        self._cache = kvc.new_kv_cache(
            config.num_layers, batch, config.num_kv_heads, window,
            config.head_dim, dtype=config.dtype, device=self.device,
            quantized=self.eng.kv_cache_dtype == torch.int8)

    def _score(self, tokens: torch.Tensor, n_valid: torch.Tensor):
        """tokens [B, W] int32, n_valid [B] -> (sum_nll f32, n_pred) on the
        device. Scores tokens[:, 1:W] given their prefixes; row b
        contributes n_valid[b]-1 predictions (rows with n_valid<=1
        contribute 0)."""
        B, W = tokens.shape
        q_start = torch.zeros((B,), dtype=torch.int32, device=self.device)
        hidden, _ = llama_model.decoder_forward(
            self.config, self.eng, self.params, tokens, self._cache, q_start,
            n_valid)
        logits = llama_model.lm_head_logits(self.config, self.eng,
                                            self.params, hidden)
        tgt = tokens[:, 1:].long()                                  # [B, W-1]
        lp = torch.stack([
            logits[b, :-1].gather(-1, tgt[b, :, None])[:, 0]
            - torch.logsumexp(logits[b, :-1], dim=-1) for b in range(B)])
        mask = (torch.arange(W - 1, device=self.device)[None, :]
                < (n_valid[:, None] - 1))                           # [B, W-1]
        sum_nll = -torch.where(mask, lp, 0.0).sum()
        return sum_nll, mask.sum()

    def score(self, token_ids: Sequence[int]) -> tuple[float, int]:
        """(total negative log-likelihood, number of predicted tokens)."""
        toks = np.asarray(token_ids, np.int32)
        W, B = self.window, self.batch
        stride = W - 1
        n_windows = max(1, -(-(len(toks) - 1) // stride))
        total_nll, total_n = 0.0, 0
        for wb in range(0, n_windows, B):
            rows = np.zeros((B, W), np.int32)
            n_valid = np.zeros((B,), np.int32)
            for i in range(B):
                w = wb + i
                if w >= n_windows:
                    break
                s = w * stride
                chunk = toks[s:s + W]
                rows[i, :len(chunk)] = chunk
                n_valid[i] = len(chunk)
            nll, n = self._score(torch.from_numpy(rows).to(self.device),
                                 torch.from_numpy(n_valid).to(self.device))
            nll, n = torch.stack([nll.double(), n.double()]).tolist()
            total_nll += nll
            total_n += int(n)
        return total_nll, total_n


def perplexity(config: ModelConfig, params, token_ids: Sequence[int],
               engine_config: Optional[EngineConfig] = None,
               window: int = 512, batch: int = 4) -> float:
    """exp(mean NLL) over the token stream."""
    nll, n = Scorer(config, params, engine_config, window, batch).score(
        token_ids)
    return math.exp(nll / max(n, 1))


def quant_ppl_report(config: ModelConfig, params_fp, token_ids,
                     modes: Sequence[str] = ("int8", "int4"),
                     group_size: int = 128, window: int = 512,
                     batch: int = 4,
                     engine_config: Optional[EngineConfig] = None) -> dict:
    """PPL of the full-precision params and each quantized variant, with
    deltas — the BASELINE.md acceptance table (<=0.1 INT8, <=0.5 INT4)."""
    from llm_inference_engine_tpu_torch.models.weights import quantize_params
    report = {}
    base = perplexity(config, params_fp, token_ids, engine_config, window,
                      batch)
    report["fp"] = base
    for mode in modes:
        qp = quantize_params(params_fp, mode, group_size)
        p = perplexity(config, qp, token_ids, engine_config, window, batch)
        del qp
        report[mode] = p
        report[f"{mode}_delta"] = p - base
    return report


def load_text_tokens(data_path: str, tokenizer) -> list[int]:
    """Tokenize a raw text file (e.g. WikiText-2 test split) into one
    stream. ``.npy``/``.npz`` files of pre-tokenized ids are accepted
    directly (key 'tokens' for npz)."""
    if data_path.endswith(".npy"):
        return np.load(data_path).astype(np.int64).tolist()
    if data_path.endswith(".npz"):
        return np.load(data_path)["tokens"].astype(np.int64).tolist()
    with open(data_path, encoding="utf-8") as f:
        text = f.read()
    return tokenizer.encode(text, add_bos=True)


def main(argv: Optional[Sequence[str]] = None) -> None:
    import argparse
    import json

    ap = argparse.ArgumentParser(
        description="Windowed perplexity eval (WikiText-2 style)")
    ap.add_argument("--model", default="llama2-7b",
                    help="preset name or config JSON path")
    ap.add_argument("--checkpoint", help="HF safetensors dir")
    ap.add_argument("--tokenizer", help="tokenizer file/dir "
                    "(default: checkpoint dir)")
    ap.add_argument("--data", required=True,
                    help="text file, .npy/.npz token ids")
    ap.add_argument("--quant", default="none",
                    choices=["none", "int8", "int4", "compare"])
    ap.add_argument("--group-size", type=int, default=128)
    ap.add_argument("--window", type=int, default=512)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--dummy-weights", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the weights and the scoring "
                         "(default cuda)")
    args = ap.parse_args(argv)

    from llm_inference_engine_tpu_torch.models.registry import (
        _on_device, _resolve_config)
    from llm_inference_engine_tpu_torch.models.weights import (
        init_dummy_params, load_hf_safetensors, quantize_params)

    device = _on_device(args.device)
    cfg = _resolve_config(args.model)
    if args.dummy_weights:
        params = init_dummy_params(cfg, seed=0, device=device)
    else:
        params = load_hf_safetensors(cfg, args.checkpoint, device=device)

    if args.data.endswith((".npy", ".npz")):
        tokens = load_text_tokens(args.data, None)
    else:
        from llm_inference_engine_tpu_torch.tokenizer import load_tokenizer
        tok = load_tokenizer(args.tokenizer or args.checkpoint)
        tokens = load_text_tokens(args.data, tok)

    if args.quant == "compare":
        rep = quant_ppl_report(cfg, params, tokens,
                               group_size=args.group_size,
                               window=args.window, batch=args.batch)
        print(json.dumps({"model": args.model, "n_tokens": len(tokens),
                          **rep}))
        return
    if args.quant != "none":
        params = quantize_params(params, args.quant, args.group_size)
    ppl = perplexity(cfg, params, tokens, window=args.window,
                     batch=args.batch)
    print(json.dumps({"model": args.model, "quant": args.quant,
                      "n_tokens": len(tokens), "ppl": ppl}))


if __name__ == "__main__":
    main()
