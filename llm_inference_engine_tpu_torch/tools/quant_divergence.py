"""Quantization quality proxy at real 7B shapes: fp-vs-quant logits divergence.

    python -m llm_inference_engine_tpu_torch.tools.quant_divergence \
        [--model llama2-7b] [--batch 4] [--window 512] [--group-size 128] \
        [--modes int8,int4,int4cal] [--calib-tokens 64] [--device cuda]

Port of the JAX system's ``tools/quant_divergence.py``: no checkpoint and
no corpus are needed. The weights are synthesized in numpy from
``--seed`` exactly as the JAX tool draws them (the same values for the
same seed):

- body: w[i, j] ~ N(0, s_j^2) with per-output-channel scales
  s_j ~ LogNormal(ln(base), 0.35), base = 1/sqrt(fan_in);
- outliers: 0.5% of output channels get 8x scale;
- norms at 1.0, embeddings at 0.02 std.

The stacked layer weights are drawn one layer at a time (numpy's
generator gives the same values drawn in pieces as drawn whole) and each
layer goes to the device as f32 at once, so the host holds one layer,
not the whole f32 model (~27 GB at 7B).

Variants, all built on the device from the f32 weights by the package's
own functions: ``fp`` (the weights rounded to bf16), ``int8`` and
``int4`` (``models.weights.quantize_params``), ``int4cal`` (int4 with
the clip search weighted by ``calibrate_act_sq`` over ``--calib-tokens``
random tokens, run on the fp variant's bf16 params through the device's
kernels; the lm_head gets plain MSE clipping) and ``int4cal_f32`` (the
same with ``calibrate_act_sq`` run in f32 over the f32 weights on the
plain route: the JAX tool's f32 calibration, for comparison). Every
variant's embedding and norms are the fp variant's bf16 ones.

Each variant runs ``models.llama.forward_all_logits`` over the same
[batch, window] teacher-forced random tokens into a fresh slot cache
(q_start 0, kv_len window) and returns f32 logits [B, T, V]; the
divergence of each quantized variant from fp is computed on the host in
f64 exactly as the JAX tool does: mean KL(fp || quant), its 99th
percentile, top-1 agreement, mean and max |delta logit| beside the fp
logit std, and the mean |delta log p| of the fp top-1 token. The last
thing printed is the JSON report: the JAX tool's keys, plus the device,
the times, the peaks and what calibrated.

Synthetic weights amplify quantization noise through a random deep
stack: the numbers bound what trained weights would show from above and
say nothing of a real checkpoint's perplexity.
"""

from __future__ import annotations

import argparse
import gc
import json
import resource
import sys
import time
from typing import Optional, Sequence

import numpy as np

MODES = ("int8", "int4", "int4cal", "int4cal_f32")


def channel_scales(rng: np.random.Generator, fan_in: int, out: int,
                   outlier_frac: float = 0.005,
                   outlier_gain: float = 8.0) -> np.ndarray:
    """[out] f32 lognormal per-channel scales with a share of outlier
    channels (the JAX tool's ``synth_weight`` draws, in its order)."""
    base = 1.0 / np.sqrt(fan_in)
    s = np.exp(rng.normal(np.log(base), 0.35, size=out)).astype(np.float32)
    n_out = max(1, int(out * outlier_frac))
    idx = rng.choice(out, size=n_out, replace=False)
    s[idx] *= outlier_gain
    return s


def synth_weight(rng: np.random.Generator, fan_in: int, shape,
                 outlier_frac: float = 0.005,
                 outlier_gain: float = 8.0) -> np.ndarray:
    """[..., out] f32 weight with lognormal per-channel scales and
    outliers, drawn whole."""
    s = channel_scales(rng, fan_in, shape[-1], outlier_frac, outlier_gain)
    w = rng.standard_normal(shape, dtype=np.float32)
    w *= s
    return w


def synth_stack(rng: np.random.Generator, fan_in: int, layers: int, shape,
                device):
    """A [layers, *shape] f32 tensor on ``device`` equal to
    ``synth_weight(rng, fan_in, (layers, *shape))``, drawn and moved one
    layer at a time."""
    import torch
    s = channel_scales(rng, fan_in, shape[-1])
    out = torch.empty((layers, *shape), dtype=torch.float32, device=device)
    for l in range(layers):
        w = rng.standard_normal(shape, dtype=np.float32)
        w *= s
        out[l].copy_(torch.from_numpy(w))
    return out


def synth_params(cfg, seed: int = 0, device=None) -> dict:
    """The JAX tool's ``synth_params_np(cfg, seed)`` as f32 tensors on
    ``device``, in the port's parameter layout (the same layout)."""
    import torch
    rng = np.random.default_rng(seed)
    L, Hd = cfg.num_layers, cfg.hidden_size

    def put(a):
        return torch.from_numpy(a).to(device)

    def ones(*shape):
        return torch.ones(shape, dtype=torch.float32, device=device)
    embed = put(rng.standard_normal((cfg.vocab_size, Hd), dtype=np.float32)
                * 0.02)
    layers = {
        "attn_norm": ones(L, Hd),
        "wqkv": synth_stack(rng, Hd, L, (Hd, cfg.qkv_size), device),
        "wo": synth_stack(rng, cfg.q_size, L, (cfg.q_size, Hd), device),
        "ffn_norm": ones(L, Hd),
        "w_gate_up": synth_stack(rng, Hd, L, (Hd, 2, cfg.intermediate_size),
                                 device),
        "w_down": synth_stack(rng, cfg.intermediate_size, L,
                              (cfg.intermediate_size, Hd), device),
    }
    return {"embed": embed, "layers": layers, "final_norm": ones(Hd),
            "lm_head": put(synth_weight(rng, Hd, (Hd, cfg.vocab_size)))}


def eval_tokens(cfg, seed: int, batch: int, window: int) -> np.ndarray:
    """The JAX tool's teacher-forced tokens [batch, window]."""
    rng = np.random.default_rng(seed + 1)
    return rng.integers(0, cfg.vocab_size,
                        size=(batch, window)).astype(np.int32)


def calib_tokens(cfg, seed: int, n: int) -> np.ndarray:
    """The JAX tool's calibration tokens [1, n]."""
    rng = np.random.default_rng(seed + 1)
    return rng.integers(0, cfg.vocab_size, size=(1, n)).astype(np.int32)


def fp_variant(cfg, params32: dict) -> dict:
    """The f32 weights rounded to bf16 (the JAX tool's fp leaves), held in
    the model dtype (an f32 model then computes on the rounded values, as
    JAX promotes a bf16 weight against f32 activations)."""
    import torch

    def cast(t):
        return t.to(torch.bfloat16).to(cfg.dtype)
    return {k: ({n: cast(w) for n, w in v.items()} if isinstance(v, dict)
                else cast(v)) for k, v in params32.items()}


def quant_variant(params32: dict, fp: dict, mode: str, group_size: int,
                  act_sq: Optional[dict] = None) -> dict:
    """``mode`` "int8" / "int4" (``quantize_params``) or "int4cal"
    (``quantize_params_calibrated`` over ``act_sq``; None gives plain MSE
    clipping), quantized from the f32 weights, with the fp variant's
    embedding and norms."""
    from llm_inference_engine_tpu_torch.models import weights as W
    if mode == "int4cal":
        q = W.quantize_params_calibrated(params32, act_sq or {}, "int4",
                                         group_size)
    else:
        q = W.quantize_params(params32, mode, group_size)
    layers = dict(q["layers"], attn_norm=fp["layers"]["attn_norm"],
                  ffn_norm=fp["layers"]["ffn_norm"])
    return dict(q, embed=fp["embed"], final_norm=fp["final_norm"],
                layers=layers)


def calibrate(cfg, params: dict, tokens: np.ndarray,
              kernels: str = "auto") -> dict:
    """``calibrate_act_sq`` over ``tokens`` [1, n] on ``params``' device
    (``kernels`` "torch": the plain route)."""
    from llm_inference_engine_tpu_torch.config import EngineConfig
    from llm_inference_engine_tpu_torch.models import weights as W
    n = tokens.shape[1]
    eng = EngineConfig(max_batch_size=1, max_seq_len=max(2 * n, 64),
                       kernels=kernels)
    return W.calibrate_act_sq(cfg, params, [tokens], eng)


def run_variant(cfg, params: dict, tokens: np.ndarray,
                kernels: str = "auto", warmup: bool = True):
    """``forward_all_logits`` over ``tokens`` [B, T] into a fresh slot
    cache of T (q_start 0, kv_len T) -> (f32 logits [B, T, V] on the host,
    the forward's ms: CUDA events on a card, after one warm-up forward when
    ``warmup``; the host clock on the CPU)."""
    import torch

    from llm_inference_engine_tpu_torch.config import EngineConfig
    from llm_inference_engine_tpu_torch.models import llama
    from llm_inference_engine_tpu_torch.ops import kv_cache as kvc

    device = params["embed"].device
    B, T = tokens.shape
    eng = EngineConfig(max_batch_size=B, max_seq_len=T, kernels=kernels)
    # kernel E reads INT4 at m <= 16 in fragment order (a B x T of 16 or
    # fewer rows, the lm_head of such a batch): built once, as an engine
    # does
    from llm_inference_engine_tpu_torch.runtime.engine import (
        add_decode_layouts)
    add_decode_layouts(cfg, eng, params, device)
    cache = kvc.new_kv_cache(cfg.num_layers, B, cfg.num_kv_heads, T,
                             cfg.head_dim, dtype=cfg.dtype, device=device)
    toks = torch.from_numpy(tokens).to(device)
    q_start = torch.zeros((B,), dtype=torch.int32, device=device)
    kv_len = torch.full((B,), T, dtype=torch.int32, device=device)

    def forward():
        return llama.forward_all_logits(cfg, eng, params, toks, cache,
                                        q_start, kv_len)[0]
    if device.type != "cuda":
        t0 = time.perf_counter()
        logits = forward()
        return logits.numpy(), (time.perf_counter() - t0) * 1e3
    if warmup:
        forward()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    logits = forward()
    end.record()
    end.synchronize()
    return logits.cpu().numpy(), start.elapsed_time(end)


def divergence(fp: np.ndarray, q: np.ndarray):
    """fp, q: [B, T, V] fp32 logits -> metric dict."""
    d = np.abs(q - fp)
    fp_arg = fp.argmax(-1)
    q_arg = q.argmax(-1)

    # log-softmax on host in float64 for a stable KL
    def logsoft(x):
        x = x.astype(np.float64)
        m = x.max(-1, keepdims=True)
        z = x - m
        return z - np.log(np.exp(z).sum(-1, keepdims=True))
    lp_fp = logsoft(fp)
    lp_q = logsoft(q)
    kl = (np.exp(lp_fp) * (lp_fp - lp_q)).sum(-1)        # [B, T]
    take = np.take_along_axis
    dlogp_top1 = np.abs(
        take(lp_fp, fp_arg[..., None], -1)
        - take(lp_q, fp_arg[..., None], -1))[..., 0]
    return {
        "mean_abs_dlogit": float(d.mean()),
        "max_abs_dlogit": float(d.max()),
        "fp_logit_std": float(fp.std()),
        "top1_agreement": float((fp_arg == q_arg).mean()),
        "mean_kl_nats": float(kl.mean()),
        "p99_kl_nats": float(np.percentile(kl, 99)),
        "mean_abs_dlogp_top1": float(dlogp_top1.mean()),
    }


def act_sq_distance(a: dict, b: dict) -> dict:
    """{matmul: relative L2 distance of ``a``'s act_sq from ``b``'s}."""
    return {k: float((a[k].double() - b[k].double()).norm()
                     / b[k].double().norm()) for k in a}


def _sync(device) -> None:
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize()


def build_variants(cfg, params32: dict, modes: Sequence[str],
                   group_size: int, calib: np.ndarray, say=print):
    """(``{"fp": ..., mode: ...}``, ``{mode: act_sq}`` of the calibrated
    modes, calibration info, build seconds, calibration seconds): every
    variant built from ``params32`` on its device."""
    device = params32["embed"].device
    t0 = time.perf_counter()
    out = {"fp": fp_variant(cfg, params32)}
    cal_s = 0.0
    info = {}
    act = {}
    for mode in modes:
        if mode in ("int4cal", "int4cal_f32"):
            _sync(device)
            c0 = time.perf_counter()
            if mode == "int4cal":
                act[mode] = calibrate(cfg, out["fp"], calib)
                info[mode] = (f"calibrate_act_sq over {calib.shape[1]} "
                              f"tokens on the fp variant's {cfg.dtype_name}"
                              f" params, kernels 'auto' on {device.type}")
            else:
                act[mode] = calibrate(cfg.replace(dtype_name="float32"),
                                      params32, calib, kernels="torch")
                info[mode] = (f"calibrate_act_sq over {calib.shape[1]} "
                              f"tokens on the f32 weights in f32, the plain "
                              f"route on {device.type}")
            _sync(device)
            cal_s += time.perf_counter() - c0
            say(f"# {mode}: {info[mode]} ({time.perf_counter() - c0:.1f} s)")
            out[mode] = quant_variant(params32, out["fp"], "int4cal",
                                      group_size, act[mode])
        else:
            out[mode] = quant_variant(params32, out["fp"], mode, group_size)
    if len(act) == 2:
        info["act_sq_rel_l2_bf16_vs_f32"] = act_sq_distance(
            act["int4cal"], act["int4cal_f32"])
    _sync(device)
    return out, act, info, time.perf_counter() - t0 - cal_s, cal_s


def _device(name: str):
    import torch
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("quant_divergence: --device cuda but no CUDA device "
                         "is available (pass --device cpu to run on the CPU)")
    return device


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="llm-torch-quant-divergence",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", default="llama2-7b",
                    help="preset name or config JSON path")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--window", type=int, default=512)
    ap.add_argument("--group-size", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--modes", default="int8,int4,int4cal",
                    help=f"comma-separated, of {', '.join(MODES)}")
    ap.add_argument("--calib-tokens", type=int, default=64,
                    help="calibration forward length of int4cal")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda)")
    args = ap.parse_args(argv)
    modes = args.modes.split(",")
    bad = [m for m in modes if m not in MODES]
    if bad:
        ap.error(f"unknown modes {bad}; have {list(MODES)}")

    import torch

    from llm_inference_engine_tpu_torch.models.registry import (
        _resolve_config)

    device = _device(args.device)
    cfg = _resolve_config(args.model)
    cuda = device.type == "cuda"
    name = torch.cuda.get_device_name(device) if cuda else "cpu"
    print(f"# quant divergence proxy: {args.model} shapes, B={args.batch} "
          f"T={args.window}, group {args.group_size}, device {name}",
          flush=True)
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    params32 = synth_params(cfg, args.seed, device)
    _sync(device)
    synth_s = time.perf_counter() - t0
    print(f"# synthesized f32 weights (lognormal channel scales, 0.5% "
          f"outlier channels at 8x) in {synth_s:.1f} s", flush=True)
    variants, _, info, build_s, cal_s = build_variants(
        cfg, params32, modes, args.group_size,
        calib_tokens(cfg, args.seed, args.calib_tokens),
        say=lambda s: print(s, flush=True))
    del params32
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    print(f"# variants {['fp'] + modes} built in {build_s:.1f} s", flush=True)

    tokens = eval_tokens(cfg, args.seed, args.batch, args.window)
    report = {"model": args.model, "batch": args.batch,
              "window": args.window, "group_size": args.group_size,
              "positions": int(tokens.size), "backend": device.type}
    forward_ms = {}
    fp_logits, forward_ms["fp"] = run_variant(cfg, variants.pop("fp"),
                                              tokens)
    for mode in modes:
        q_logits, forward_ms[mode] = run_variant(cfg, variants.pop(mode),
                                                 tokens)
        report[mode] = divergence(fp_logits, q_logits)
        print(f"# {mode} forward {forward_ms[mode]:.2f} ms", flush=True)
    report.update(
        device=name, calibration=info,
        seconds={"synthesis": synth_s, "build": build_s,
                 "calibration": cal_s},
        forward_ms=forward_ms,
        device_peak_gib=(torch.cuda.max_memory_allocated(device) / 2**30
                         if cuda else None),
        host_peak_rss_gib=resource.getrusage(
            resource.RUSAGE_SELF).ru_maxrss / 2**20)
    print(json.dumps(report, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
