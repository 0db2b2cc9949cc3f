"""Llama-class decoder forward pass over the slot KV cache.

Port of ``llm_inference_engine_tpu/models/llama.py`` for one device and
the slot cache. Each layer runs: rmsnorm -> packed QKV matmul -> split +
RoPE -> cache write -> attention (kernel C then kernel D at prefill; the
fused write+attend decode mode of kernel D at T == 1 on a bf16 cache) ->
o-proj -> fused add-residual + rmsnorm -> gate|up matmul -> silu_and_mul
-> down-proj -> residual add. The layer loop is a Python loop over
``w[layer]`` views of the stacked weights (the JAX package's
``lax.scan``); the KV cache is updated in place.

Not ported: the TPU tile-padded cache adapter, context parallelism, the
paged branch, tensor-parallel partial sums and debug taps (ROADMAP.md,
queue 1).
"""

from __future__ import annotations

import dataclasses
import math

import torch

from llm_inference_engine_tpu_torch.config import EngineConfig, ModelConfig
from llm_inference_engine_tpu_torch.ops import kv_cache as kvc
from llm_inference_engine_tpu_torch.ops.activations import (
    add_residual, silu_and_mul)
from llm_inference_engine_tpu_torch.ops.attention import (
    attention, attention_decode_fused, can_fuse_decode)
from llm_inference_engine_tpu_torch.ops.embedding import embedding_lookup
from llm_inference_engine_tpu_torch.ops.linear import linear
from llm_inference_engine_tpu_torch.ops.rmsnorm import (
    add_residual_rmsnorm, rmsnorm)
from llm_inference_engine_tpu_torch.ops.rope import (
    rope_cos_sin, rotate, split_qkv)

__all__ = ["decoder_forward", "forward_hidden", "lm_head_logits",
           "run_layers"]


def _layer_step(cfg: ModelConfig, eng: EngineConfig, x: torch.Tensor,
                layer: dict, layer_idx: int, cache: kvc.KVCache, cos, sin,
                q_start: torch.Tensor, kv_len: torch.Tensor) -> torch.Tensor:
    """One decoder layer. x: [B, T, hidden]; ``layer`` holds this layer's
    weight views; the cache is written in place at ``layer_idx``."""
    kernels = eng.kernels
    B, T, _ = x.shape

    h_norm = rmsnorm(x, layer["attn_norm"], cfg.rms_norm_eps, kernels=kernels)
    qkv = linear(h_norm, layer["wqkv"])
    if "bqkv" in layer:
        qkv = qkv + layer["bqkv"].to(qkv.dtype)
    q, k_new, v_new = split_qkv(qkv, cfg.num_heads, cfg.num_kv_heads,
                                cfg.head_dim)
    q = rotate(q, cos, sin)
    k_new = rotate(k_new, cos, sin)
    v_new = v_new.contiguous()
    sm_scale = 1.0 / math.sqrt(cfg.head_dim)

    if can_fuse_decode(q.shape, cache):
        # decode: one kernel writes the token's K/V and attends
        attn_out, _, _ = attention_decode_fused(
            q, k_new, v_new, cache.k, cache.v, q_start, kv_len, layer_idx,
            sm_scale=sm_scale, window=cfg.sliding_window, kernels=kernels)
    else:
        # write before attend
        kvc.update_cache_at_layer(cache, layer_idx, k_new, v_new, q_start,
                                  new_len=kv_len - q_start, kernels=kernels)
        attn_out = attention(q, cache.k, cache.v, q_start, kv_len,
                             sm_scale=sm_scale, kernels=kernels,
                             layer=layer_idx, window=cfg.sliding_window)
    attn_out = linear(attn_out.reshape(B, T, cfg.q_size), layer["wo"])

    ffn_in, resid = add_residual_rmsnorm(
        attn_out, x, layer["ffn_norm"], cfg.rms_norm_eps, kernels=kernels)
    gate_up = linear(ffn_in, layer["w_gate_up"])
    act = silu_and_mul(gate_up, kernels=kernels)
    down = linear(act, layer["w_down"])
    return add_residual(down, resid)


def run_layers(cfg: ModelConfig, eng: EngineConfig, layers_params: dict,
               x: torch.Tensor, cache: kvc.KVCache, cos, sin,
               q_start: torch.Tensor, kv_len: torch.Tensor) -> torch.Tensor:
    """The decoder layer loop over ``w[i]`` views of the stacked weights."""
    for i in range(cache.num_layers):
        layer = {name: w[i] for name, w in layers_params.items()}
        x = _layer_step(cfg, eng, x, layer, i, cache, cos, sin, q_start,
                        kv_len)
    return x


def decoder_forward(cfg: ModelConfig, eng: EngineConfig, params: dict,
                    token_ids: torch.Tensor, cache: kvc.KVCache,
                    q_start: torch.Tensor, kv_len: torch.Tensor):
    """Run all decoder layers. Returns (hidden [B, T, H], cache) with the
    cache's K/V updated in place and its lengths set to ``kv_len``.

    token_ids: [B, T] int (prefill: padded prompt chunk; decode: T=1)
    q_start:   [B] int32 write/attend offset (history length per slot)
    kv_len:    [B] int32 total valid kv after this call (q_start + new)
    """
    B, T = token_ids.shape
    positions = (q_start[:, None]
                 + torch.arange(T, dtype=torch.int32,
                                device=token_ids.device)[None, :])
    # RoPE angles once per forward, shared by every layer
    cos, sin = rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta,
                            cfg.rope_scaling)
    cos, sin = cos[:, :, None, :], sin[:, :, None, :]

    x = embedding_lookup(params["embed"], token_ids).to(cfg.dtype)
    x = run_layers(cfg, eng, params["layers"], x, cache, cos, sin, q_start,
                   kv_len)
    cache = dataclasses.replace(cache, lengths=kv_len)
    x = rmsnorm(x, params["final_norm"], cfg.rms_norm_eps,
                kernels=eng.kernels)
    return x, cache


def lm_head_logits(cfg: ModelConfig, eng: EngineConfig, params: dict,
                   hidden_last: torch.Tensor) -> torch.Tensor:
    """hidden_last: [B, H] -> logits [B, V] (f32, never rounded through
    the model dtype)."""
    return linear(hidden_last, params["lm_head"], out_dtype=torch.float32)


def forward_hidden(cfg: ModelConfig, eng: EngineConfig, params: dict,
                   token_ids: torch.Tensor, cache: kvc.KVCache,
                   q_start: torch.Tensor, kv_len: torch.Tensor):
    """decoder_forward + last-valid-token slice -> (logits [B, V], cache).

    The last valid token of sequence b sits at padded index
    kv_len[b] - q_start[b] - 1."""
    hidden, cache = decoder_forward(cfg, eng, params, token_ids, cache,
                                    q_start, kv_len)
    B, T, _ = hidden.shape
    last_idx = torch.clamp(kv_len - q_start - 1, 0, T - 1).long()
    hidden_last = hidden[torch.arange(B, device=hidden.device), last_idx]
    return lm_head_logits(cfg, eng, params, hidden_last), cache
