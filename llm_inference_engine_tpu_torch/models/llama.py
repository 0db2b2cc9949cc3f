"""Llama-class decoder forward pass over the slot or the paged KV cache.

Port of ``llm_inference_engine_tpu/models/llama.py`` for one device.
Each layer runs: rmsnorm -> packed QKV matmul -> split + RoPE -> cache
write -> attention -> o-proj -> fused add-residual + rmsnorm -> gate|up
matmul -> silu_and_mul -> down-proj -> residual add. The layer's final
residual add is handed to the norm that reads its sum next: each layer
returns (down, residual), and the next layer's first norm (or the final
norm) is ``add_residual_rmsnorm(down, residual)``, whose stored sum is
bit for bit ``add_residual(down, residual)`` (kernel A, one launch in
place of four eager ops). The cache write and
attention, by layout: slot, kernel C (int8: kernel I) then kernel D at
T > 1, and the fused write+attend decode mode of kernel D at T == 1;
paged (the JAX package's paged branch), kernel H through the block table,
then kernel D's paged prefill mode at T > 1 or its attend-only paged
decode at T == 1. An int8 cache or pool passes its scale planes (the
slot cache also its ``snapped`` numerics) to the same calls, which run
the kernels' int8 modes. The layer loop is a Python loop over ``w[layer]``
views of the stacked weights (the JAX package's ``lax.scan``; a stacked
quantized weight gives a ``QuantizedTensor`` of views, the counterpart of
its scalar-prefetched layer index); every projection, the lm_head
included, goes through ``linear``, which runs the quantized kernels for
quantized weights. The KV cache is updated in place, its lengths
included: a captured decode program (``runtime/decode_graph.py``)
replays fixed addresses.

Intermediate dumping (``utils/debug.py``) fires at the JAX package's tap
points, with its names and shapes: ``embedding``, per layer
``attn_norm``, ``qkv_proj``, ``q_rope`` [B, T, H, D], ``k_rope``
[B, T, K, D], ``attn_ctx``, ``attn_out``, ``ffn_in``, ``ffn_act`` and
``layer_out``, then ``final_norm``. The layer's output is never stored
on the main path (the next norm adds it), so ``layer_out`` is computed
for the dump only, by the plain ``add_residual``, whose bits equal kernel
A's stored sum. With the tap disabled the forward calls none of it.

Not ported: the TPU tile-padded cache adapter, context parallelism and
tensor-parallel partial sums (ROADMAP.md, queue 1).
"""

from __future__ import annotations

import math

import torch

from llm_inference_engine_tpu_torch.config import EngineConfig, ModelConfig
from llm_inference_engine_tpu_torch.ops import kv_cache as kvc
from llm_inference_engine_tpu_torch.ops.activations import (
    add_residual, silu_and_mul)
from llm_inference_engine_tpu_torch.ops import paged_kv as pkv
from llm_inference_engine_tpu_torch.ops.attention import (
    attention, attention_decode, attention_decode_fused, can_fuse_decode)
from llm_inference_engine_tpu_torch.ops.embedding import embedding_lookup
from llm_inference_engine_tpu_torch.ops.linear import linear
from llm_inference_engine_tpu_torch.ops.rmsnorm import (
    add_residual_rmsnorm, rmsnorm)
from llm_inference_engine_tpu_torch.ops.rope import (
    rope_cos_sin, rotate, split_qkv)
from llm_inference_engine_tpu_torch.utils import debug as _debug

__all__ = ["decoder_forward", "forward_all_logits", "forward_hidden",
           "lm_head_logits", "run_layers"]


def _layer_step(cfg: ModelConfig, eng: EngineConfig, h_norm: torch.Tensor,
                x: torch.Tensor, layer: dict, layer_idx: int, cache, cos,
                sin, q_start: torch.Tensor, kv_len: torch.Tensor):
    """One decoder layer from its normed input ``h_norm`` and its residual
    stream ``x`` ([B, T, hidden] each); ``layer`` holds this layer's weight
    views; the cache is written in place at ``layer_idx``. Returns (down,
    residual): the layer's output is their sum, which the next norm adds."""
    kernels = eng.kernels
    B, T, _ = x.shape
    # the dump hook (utils/debug.py), None unless it keeps this layer
    tap = _debug.tap if _debug.tap.wants(layer_idx) else None
    if tap:
        tap("attn_norm", h_norm, layer_idx)

    qkv = linear(h_norm, layer["wqkv"], kernels=kernels)
    if "bqkv" in layer:
        qkv = qkv + layer["bqkv"].to(qkv.dtype)
    q, k_new, v_new = split_qkv(qkv, cfg.num_heads, cfg.num_kv_heads,
                                cfg.head_dim)
    q = rotate(q, cos, sin)
    k_new = rotate(k_new, cos, sin)
    if tap:
        tap("qkv_proj", qkv, layer_idx)
        tap("q_rope", q, layer_idx)
        tap("k_rope", k_new, layer_idx)
    v_new = v_new.contiguous()
    sm_scale = 1.0 / math.sqrt(cfg.head_dim)

    # an int8 cache's scale planes (None for bf16)
    scales = dict(k_scale=cache.k_scale, v_scale=cache.v_scale)
    if isinstance(cache, pkv.PagedKVCache):
        # paged: write through the block table, then attend through it
        pkv.paged_update_at_layer(cache, layer_idx, k_new, v_new, q_start,
                                  new_len=kv_len - q_start, kernels=kernels)
        attend = attention_decode if T == 1 else attention
        attn_out = attend(q, cache.k, cache.v, q_start, kv_len,
                          layer=layer_idx, table=cache.block_table,
                          sm_scale=sm_scale, window=cfg.sliding_window,
                          kernels=kernels, **scales)
    elif can_fuse_decode(q.shape, cache):
        # decode: one kernel writes the token's K/V and attends
        attn_out, _, _ = attention_decode_fused(
            q, k_new, v_new, cache.k, cache.v, q_start, kv_len, layer_idx,
            sm_scale=sm_scale, window=cfg.sliding_window, kernels=kernels,
            snapped=cache.snapped, **scales)
    else:
        # write before attend
        kvc.update_cache_at_layer(cache, layer_idx, k_new, v_new, q_start,
                                  new_len=kv_len - q_start, kernels=kernels)
        attn_out = attention(q, cache.k, cache.v, q_start, kv_len,
                             sm_scale=sm_scale, kernels=kernels,
                             layer=layer_idx, window=cfg.sliding_window,
                             **scales)
    attn_ctx = attn_out.reshape(B, T, cfg.q_size)
    attn_out = linear(attn_ctx, layer["wo"], kernels=kernels)

    ffn_in, resid = add_residual_rmsnorm(
        attn_out, x, layer["ffn_norm"], cfg.rms_norm_eps, kernels=kernels)
    gate_up = linear(ffn_in, layer["w_gate_up"], kernels=kernels)
    act = silu_and_mul(gate_up, kernels=kernels)
    down = linear(act, layer["w_down"], kernels=kernels)
    if tap:
        tap("attn_ctx", attn_ctx, layer_idx)
        tap("attn_out", attn_out, layer_idx)
        tap("ffn_in", ffn_in, layer_idx)
        tap("ffn_act", act, layer_idx)
        tap("layer_out", add_residual(down, resid), layer_idx)
    return down, resid


def run_layers(cfg: ModelConfig, eng: EngineConfig, layers_params: dict,
               x: torch.Tensor, cache: kvc.KVCache, cos, sin,
               q_start: torch.Tensor, kv_len: torch.Tensor):
    """The decoder layer loop over ``w[i]`` views of the stacked weights
    (quantized or not). Returns the last layer's (down, residual): the
    caller's final norm adds them."""
    kernels, eps = eng.kernels, cfg.rms_norm_eps
    down = None
    for i in range(cache.num_layers):
        layer = {name: w[i] for name, w in layers_params.items()}
        if down is None:
            h_norm = rmsnorm(x, layer["attn_norm"], eps, kernels=kernels)
        else:
            # the previous layer's residual add, fused into this norm
            h_norm, x = add_residual_rmsnorm(down, x, layer["attn_norm"], eps,
                                             kernels=kernels)
        down, x = _layer_step(cfg, eng, h_norm, x, layer, i, cache, cos, sin,
                              q_start, kv_len)
    return down, x


def decoder_forward(cfg: ModelConfig, eng: EngineConfig, params: dict,
                    token_ids: torch.Tensor, cache: kvc.KVCache,
                    q_start: torch.Tensor, kv_len: torch.Tensor):
    """Run all decoder layers. Returns (hidden [B, T, H], cache) with the
    cache's K/V updated in place and ``kv_len`` copied into its lengths
    (in place, after every layer has read ``q_start``, which may be that
    same buffer).

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
    if _debug.tap.enabled:
        _debug.tap("embedding", x)
    down, resid = run_layers(cfg, eng, params["layers"], x, cache, cos, sin,
                             q_start, kv_len)
    cache.lengths.copy_(kv_len)
    # the last layer's residual add, fused into the final norm
    x, _ = add_residual_rmsnorm(down, resid, params["final_norm"],
                                cfg.rms_norm_eps, kernels=eng.kernels)
    if _debug.tap.enabled:
        _debug.tap("final_norm", x)
    return x, cache


def lm_head_logits(cfg: ModelConfig, eng: EngineConfig, params: dict,
                   hidden_last: torch.Tensor) -> torch.Tensor:
    """hidden_last: [B, H] -> logits [B, V] (f32, never rounded through
    the model dtype)."""
    return linear(hidden_last, params["lm_head"], out_dtype=torch.float32,
                  kernels=eng.kernels)


def forward_all_logits(cfg: ModelConfig, eng: EngineConfig, params: dict,
                       token_ids: torch.Tensor, cache: kvc.KVCache,
                       q_start: torch.Tensor, kv_len: torch.Tensor):
    """decoder_forward + the lm head on EVERY position -> (logits
    [B, T, V] f32, cache): the verify forward of speculative decoding.
    The head sees B * T rows (40 at B = 8, T = 5: a quantized head runs
    kernel E's or F's prefill mode)."""
    hidden, cache = decoder_forward(cfg, eng, params, token_ids, cache,
                                    q_start, kv_len)
    return lm_head_logits(cfg, eng, params, hidden), cache


def forward_hidden(cfg: ModelConfig, eng: EngineConfig, params: dict,
                   token_ids: torch.Tensor, cache: kvc.KVCache,
                   q_start: torch.Tensor, kv_len: torch.Tensor):
    """decoder_forward + last-valid-token slice -> (logits [B, V], cache).

    The last valid token of sequence b sits at padded index
    kv_len[b] - q_start[b] - 1."""
    B, T = token_ids.shape
    # before the forward: it overwrites the lengths, which q_start may be
    last_idx = torch.clamp(kv_len - q_start - 1, 0, T - 1).long()
    hidden, cache = decoder_forward(cfg, eng, params, token_ids, cache,
                                    q_start, kv_len)
    hidden_last = hidden[torch.arange(B, device=hidden.device), last_idx]
    return lm_head_logits(cfg, eng, params, hidden_last), cache
