"""Llama-class decoder forward pass over the slot or the paged KV cache.

Port of ``llm_inference_engine_tpu/models/llama.py`` (one rank's body).
Each layer runs: rmsnorm -> packed QKV matmul -> split + RoPE (kernel
J, one launch; it adds a Qwen2-style qkv bias first) -> cache write ->
attention -> o-proj -> fused add-residual + rmsnorm -> gate|up matmul ->
silu_and_mul -> down-proj -> residual add. The layer's final
residual add is handed to the norm that reads its sum next: each layer
returns (down, residual), and the next layer's first norm (or the final
norm) is ``add_residual_rmsnorm(down, residual)``, whose stored sum is
bit for bit ``add_residual(down, residual)`` (kernel A, one launch in
place of four eager ops). The cache write and
attention, by layout: slot, kernel C (int8: kernel I) then kernel D at
T > 1, and the fused write+attend decode mode of kernel D at T == 1;
paged (the JAX package's paged branch), kernel H through the block table,
then kernel D's paged prefill mode at T > 1, and at T == 1 kernel D's
fused paged decode (a bf16 pool: the write through the table and the
attention in one launch) or H's int8 mode then D's attend-only paged
decode (an int8 pool). An int8 cache or pool passes its scale planes (the
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

Tensor parallelism (the JAX package's ``model_axis``): the layer loop is
a generator (:func:`layers`, :func:`decoder`) that yields the partial
products of the row-sharded ``wo`` and ``w_down`` and is sent back their
sum over the model ranks (the JAX ``psum``). On one device,
:func:`decoder_forward` sends each partial back as it is (:func:`whole`):
it is already whole. Over a mesh, ``parallel/sharding.py`` runs
one generator per rank in lockstep and sums in between. The taps are a
no-op there (``tapped=False``), as under the JAX package's mesh.

Context parallelism (the JAX package's ``cp`` argument,
``parallel/cp_engine.py``): a seq rank's body gets a ``CPSpec``
(``parallel/cp_cache.py``) and its local append log as the cache. It
writes its new rows at its log's tail (kernel C, or I for an int8 log,
with the plan's ragged counts: 0 on most ranks in decode), then attends
through a third kind of yield, beside the two sums: ring attention in
prefill (it yields its KV chunk and is sent every seq rank's), split-KV
in decode (it yields its partials and is sent the combined output),
``parallel/context_parallel.py``.

Pipeline parallelism (``parallel/pipeline.py``) runs :func:`decoder` on a
stage's slice of the layers, handing the (down, residual) pair from one
stage to the next (``carry``, ``final``).

Not ported: the TPU tile-padded cache adapter.
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
    attention, attention_decode, attention_decode_fused,
    attention_decode_paged_fused, can_fuse_decode, can_fuse_paged_decode)
from llm_inference_engine_tpu_torch.ops.embedding import embedding_lookup
from llm_inference_engine_tpu_torch.ops.linear import linear
from llm_inference_engine_tpu_torch.ops.rmsnorm import (
    add_residual_rmsnorm, rmsnorm)
from llm_inference_engine_tpu_torch.ops.rope import (
    rope_cos_sin, split_qkv_rope_fused)
from llm_inference_engine_tpu_torch.parallel.context_parallel import (
    ring_attention, split_kv_decode_attention)
from llm_inference_engine_tpu_torch.utils import debug as _debug

__all__ = ["decoder", "decoder_forward", "forward_all_logits",
           "forward_hidden", "layers", "lm_head_logits", "rope_tables",
           "whole"]


def whole(gen):
    """Run a layer generator on one device: every partial product it
    yields is already the whole product, so it is sent back as it is.
    Returns the generator's value."""
    try:
        part = next(gen)
        while True:
            part = gen.send(part)
    except StopIteration as stop:
        return stop.value


def _layer_gen(cfg: ModelConfig, eng: EngineConfig, h_norm: torch.Tensor,
               x: torch.Tensor, layer: dict, layer_idx: int, cache, cos,
               sin, q_start: torch.Tensor, kv_len: torch.Tensor,
               tapped: bool, cp=None):
    """One decoder layer from its normed input ``h_norm`` and its residual
    stream ``x`` ([B, T, hidden] each); ``layer`` holds this layer's weight
    views; the cache is written in place at ``layer_idx``. A generator: it
    yields the ``wo`` and ``w_down`` products and is sent back their sums
    over the model ranks (and, with ``cp``, a seq-axis request, see the
    module docstring). Returns (down, residual): the layer's output is
    their sum, which the next norm adds."""
    kernels = eng.kernels
    B, T, _ = x.shape
    # the dump hook (utils/debug.py), None unless it keeps this layer
    tap = _debug.tap if tapped and _debug.tap.wants(layer_idx) else None
    if tap:
        tap("attn_norm", h_norm, layer_idx)

    qkv = linear(h_norm, layer["wqkv"], kernels=kernels)
    # kernel J: Qwen2's qkv bias added, q and k rotated, v, each
    # contiguous, in one pass
    bias = layer.get("bqkv")
    q, k_new, v_new = split_qkv_rope_fused(
        qkv, cos, sin, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
        bias=bias, kernels=kernels)
    if tap:
        # J never stores the biased projection: the dump gets the plain
        # add, whose rounding J's bias mode repeats
        tap("qkv_proj", qkv if bias is None else qkv + bias.to(qkv.dtype),
            layer_idx)
        tap("q_rope", q, layer_idx)
        tap("k_rope", k_new, layer_idx)
    sm_scale = 1.0 / math.sqrt(cfg.head_dim)

    # an int8 cache's scale planes (None for bf16)
    scales = dict(k_scale=cache.k_scale, v_scale=cache.v_scale)
    if cp is not None:
        # a seq rank: write at the local log's tail, then the ring
        # (prefill) or the split-KV combine (decode) over the seq ranks
        kvc.update_cache_at_layer(cache, layer_idx, k_new, v_new, cp.start,
                                  new_len=cp.count, kernels=kernels)
        rows = cp.kv_valid.shape[1]
        k_loc = cache.k[layer_idx, :, :rows]
        v_loc = cache.v[layer_idx, :, :rows]
        if cache.quantized:
            scales = dict(k_scale=cache.k_scale[layer_idx, :, :rows],
                          v_scale=cache.v_scale[layer_idx, :, :rows])
        if T == 1:
            attn_out = yield from split_kv_decode_attention(
                q, k_loc, v_loc, cp.q_pos, cp.kv_pos, cp.kv_valid,
                sm_scale=sm_scale, window=cfg.sliding_window,
                out_dtype=x.dtype, **scales)
        else:
            attn_out = yield from ring_attention(
                q, k_loc, v_loc, cp.q_pos, cp.kv_pos, cp.kv_valid, cp.me,
                cp.n, sm_scale=sm_scale, window=cfg.sliding_window,
                out_dtype=x.dtype, **scales)
    elif can_fuse_paged_decode(q.shape, cache):
        # paged decode over a pool of the model's dtype or int8: one kernel
        # writes the token's K/V through the block table and attends
        attn_out, _, _ = attention_decode_paged_fused(
            q, k_new, v_new, cache.k, cache.v, q_start, kv_len, layer_idx,
            table=cache.block_table, sm_scale=sm_scale,
            window=cfg.sliding_window, kernels=kernels, **scales)
    elif isinstance(cache, pkv.PagedKVCache):
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
    attn_out = yield linear(attn_ctx, layer["wo"], kernels=kernels)

    ffn_in, resid = add_residual_rmsnorm(
        attn_out, x, layer["ffn_norm"], cfg.rms_norm_eps, kernels=kernels)
    gate_up = linear(ffn_in, layer["w_gate_up"], kernels=kernels)
    act = silu_and_mul(gate_up, kernels=kernels)
    down = yield linear(act, layer["w_down"], kernels=kernels)
    if tap:
        tap("attn_ctx", attn_ctx, layer_idx)
        tap("attn_out", attn_out, layer_idx)
        tap("ffn_in", ffn_in, layer_idx)
        tap("ffn_act", act, layer_idx)
        tap("layer_out", add_residual(down, resid), layer_idx)
    return down, resid


def layers(cfg: ModelConfig, eng: EngineConfig, layers_params: dict,
           x: torch.Tensor, cache: kvc.KVCache, cos, sin,
           q_start: torch.Tensor, kv_len: torch.Tensor, tapped: bool = True,
           cp=None, carry=None):
    """The decoder layer loop over ``w[i]`` views of the stacked weights
    (quantized or not), as a generator of the row-sharded products (see
    the module docstring). ``carry``: the (down, residual) pair of the
    layer before the first (a pipeline stage's input; ``x`` is then
    unused). Returns the last layer's (down, residual): the caller's
    final norm adds them."""
    kernels, eps = eng.kernels, cfg.rms_norm_eps
    down = None
    if carry is not None:
        down, x = carry
    for i in range(cache.num_layers):
        layer = {name: w[i] for name, w in layers_params.items()}
        if down is None:
            h_norm = rmsnorm(x, layer["attn_norm"], eps, kernels=kernels)
        else:
            # the previous layer's residual add, fused into this norm
            h_norm, x = add_residual_rmsnorm(down, x, layer["attn_norm"], eps,
                                             kernels=kernels)
        down, x = yield from _layer_gen(cfg, eng, h_norm, x, layer, i, cache,
                                        cos, sin, q_start, kv_len, tapped,
                                        cp)
    return down, x


def rope_tables(cfg: ModelConfig, positions: torch.Tensor):
    """RoPE angles [B, T, 1, D/2] for ``positions`` [B, T], once per
    forward, shared by every layer."""
    cos, sin = rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta,
                            cfg.rope_scaling)
    return cos[:, :, None, :], sin[:, :, None, :]


def decoder(cfg: ModelConfig, eng: EngineConfig, params: dict,
            token_ids: torch.Tensor, cache: kvc.KVCache,
            q_start: torch.Tensor, kv_len: torch.Tensor, tapped: bool = True,
            cp=None, carry=None, final: bool = True):
    """:func:`decoder_forward` as a generator of the row-sharded products
    (see the module docstring). Returns hidden [B, T, H]. With ``cp`` (a
    ``CPSpec``) this is a seq rank's body: ``token_ids`` are its query
    rows, at positions ``cp.q_pos``, and ``cache`` its local log, whose
    lengths become the log's row count. A pipeline stage's body:
    ``carry``, the stage before's (down, residual) pair, enters in place
    of the embedding (``token_ids`` then give only the chunk's shape), and
    ``final`` False returns this stage's last pair in place of the final
    norm's hidden states."""
    B, T = token_ids.shape
    if cp is not None:
        positions = cp.q_pos
    else:
        positions = (q_start[:, None]
                     + torch.arange(T, dtype=torch.int32,
                                    device=token_ids.device)[None, :])
    cos, sin = rope_tables(cfg, positions)

    tapped = tapped and _debug.tap.enabled
    x = None
    if carry is None:
        x = embedding_lookup(params["embed"], token_ids).to(cfg.dtype)
        if tapped:
            _debug.tap("embedding", x)
    down, resid = yield from layers(cfg, eng, params["layers"], x, cache,
                                    cos, sin, q_start, kv_len, tapped, cp,
                                    carry)
    cache.lengths.copy_(kv_len if cp is None else cp.start + cp.count)
    if not final:
        return down, resid
    # the last layer's residual add, fused into the final norm
    x, _ = add_residual_rmsnorm(down, resid, params["final_norm"],
                                cfg.rms_norm_eps, kernels=eng.kernels)
    if tapped:
        _debug.tap("final_norm", x)
    return x


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
    hidden = whole(decoder(cfg, eng, params, token_ids, cache, q_start,
                           kv_len))
    return hidden, cache


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
