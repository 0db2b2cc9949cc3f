"""Shared setup of the port's example drivers.

Each driver runs on the card by default (``--device cuda``) and on the
CPU with ``--device cpu``. On the CPU the model is the ``debug`` preset
(f32) and the layer drivers take the JAX drivers' f32 shapes; on the card
it is ``debug`` made bf16 with 4 layers, hidden 256, 4 heads of 64 and
intermediate 512, the kernels' dtype and a head dim they take, and the
layer drivers take bf16 at head_dim 64.

Every check holds the code under test against a reference independent of
it: on the card, the plain PyTorch version of the kernels
(``kernels="torch"``); on the CPU, where the op under test already is
its plain version, a golden written here or in the driver (a dense
masked softmax attention, ``x @ dequant(w)``, a teacher-forced forward
over the whole sequence). :func:`report` exits 1 on a failure.
"""

from __future__ import annotations

import argparse
import math
from typing import Optional, Sequence

import torch

from llm_inference_engine_tpu_torch.config import EngineConfig, get_config

# A greedy token is accepted when its logit under the reference forward
# is within this share of that position's logit std of the largest (a
# near-tie): exact up to f32 sums on the CPU; on the card the kernel route
# and the plain bf16 route round at other points (the largest shortfall an
# H100 gave over the drivers: 5.6e-3).
GREEDY_TOL = {"cpu": 1e-4, "cuda": 0.05}


def parse(argv: Optional[Sequence[str]], doc: str) -> torch.device:
    """The driver's device from ``--device`` (default cuda); a card that
    is asked for and missing exits, nothing falls back to the CPU."""
    ap = argparse.ArgumentParser(description=doc.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain "
                         "versions)")
    device = torch.device(ap.parse_args(argv).device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device is available (pass --device cpu "
                         "to run on the CPU)")
    return device


def on_card(device: torch.device) -> bool:
    return device.type == "cuda"


def dtype_of(device: torch.device) -> torch.dtype:
    """The layer drivers' dtype: bf16 on the card, f32 on the CPU."""
    return torch.bfloat16 if on_card(device) else torch.float32


def model_config(device: torch.device, **kw):
    """The ``debug`` preset on the CPU; on the card its bf16 counterpart at
    head_dim 64 (4 layers, hidden 256, 4 heads, intermediate 512)."""
    cfg = get_config("debug")
    if on_card(device):
        cfg = cfg.replace(dtype_name="bfloat16", num_layers=4,
                          hidden_size=256, num_heads=4, head_dim=64,
                          intermediate_size=512)
    return cfg.replace(**kw) if kw else cfg


def randn(shape, seed: int, device: torch.device, dtype=None,
          scale: float = 1.0) -> torch.Tensor:
    """Normal draws from a seeded CPU generator (the same values on any
    device), rounded to ``dtype`` on ``device``."""
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(shape, generator=gen) * scale
    return x.to(device=device, dtype=dtype or dtype_of(device))


def ints(vals, device: torch.device) -> torch.Tensor:
    return torch.tensor(vals, dtype=torch.int32, device=device)


def dense_attention(q, k, v, q_start, kv_len) -> torch.Tensor:
    """Golden causal GQA attention in f32 (q [B, Sq, H, D], k/v
    [B, Skv, K, D]): query i of row b sees keys j < kv_len[b] with
    j <= q_start[b] + i, through a masked softmax."""
    B, Sq, H, D = q.shape
    K = k.shape[2]
    out = torch.zeros(B, Sq, H, D)
    for b in range(B):
        for h in range(H):
            qh = q[b, :, h].float().cpu()
            kh = k[b, :, h // (H // K)].float().cpu()
            vh = v[b, :, h // (H // K)].float().cpu()
            s = qh @ kh.T / math.sqrt(D)
            j = torch.arange(kh.shape[0])[None, :]
            i = torch.arange(Sq)[:, None] + int(q_start[b])
            s = s.masked_fill((j >= int(kv_len[b])) | (j > i), -math.inf)
            out[b, :, h] = torch.softmax(s, dim=-1) @ vh
    return out


def max_err(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got.float().cpu() - want.float().cpu()).abs().max())


def rel_l2(got: torch.Tensor, want: torch.Tensor) -> float:
    """||got - want|| / ||want|| in f64."""
    g, w = got.double().cpu(), want.double().cpu()
    return float((g - w).norm() / w.norm())


def report(name: str, ok: bool, detail: str = "") -> None:
    status = "OK" if ok else "FAIL"
    print(f"[{status}] {name}" + (f" — {detail}" if detail else ""),
          flush=True)
    if not ok:
        raise SystemExit(1)


def teacher_forced_logits(cfg, params, seq: Sequence[int],
                          kernels: str = "torch") -> torch.Tensor:
    """[len(seq), V] f32 logits of one sequence from one fresh forward over
    all of it (no cache reused), on ``params``' device."""
    from llm_inference_engine_tpu_torch.models import llama
    from llm_inference_engine_tpu_torch.ops import kv_cache as kvc
    dev = params["embed"].device
    T = len(seq)
    cache = kvc.new_kv_cache(cfg.num_layers, 1, cfg.num_kv_heads, T,
                             cfg.head_dim, dtype=cfg.dtype, device=dev)
    eng = EngineConfig(max_batch_size=1, max_seq_len=T, kernels=kernels)
    logits, _ = llama.forward_all_logits(cfg, eng, params, ints([seq], dev),
                                         cache, ints([0], dev),
                                         ints([T], dev))
    return logits[0].float().cpu()


def greedy_shortfall(cfg, params, prompts, outputs) -> float:
    """The largest (top logit - chosen token's logit) / the logits' std
    over every generated token, under the plain teacher-forced forward: 0
    when every token is the reference's greedy choice."""
    worst = 0.0
    for prompt, gen in zip(prompts, outputs):
        if not gen:
            continue
        seq = list(prompt) + list(gen)
        lg = teacher_forced_logits(cfg, params, seq[:-1])
        for i, tok in enumerate(gen):
            row = lg[len(prompt) - 1 + i]
            worst = max(worst, float((row.max() - row[tok]) / row.std()))
    return worst


def check_greedy(name: str, device: torch.device, cfg, params, prompts,
                 got, want=None) -> None:
    """Report that every greedy token of ``got`` is the reference's
    choice up to GREEDY_TOL, and, on the CPU, that ``got`` equals
    ``want`` (the JAX driver's check) where one is given. On the card
    ``got`` may leave ``want`` only at such a near-tie."""
    worst = greedy_shortfall(cfg, params, prompts, got)
    ok = worst <= GREEDY_TOL[device.type]
    if want is not None and not on_card(device):
        ok = ok and got == want
    report(name, ok, f"largest shortfall from the teacher-forced greedy "
           f"choice {worst:.3e} logit std (limit {GREEDY_TOL[device.type]})"
           + ("" if want is None else f"; equal to the reference ids: "
              f"{got == want}"))
