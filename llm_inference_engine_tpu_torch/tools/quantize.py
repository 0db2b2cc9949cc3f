"""Offline quantizer: HF/reference checkpoint -> one pre-fused .npz.

    python -m llm_inference_engine_tpu_torch.tools.quantize \
        --model llama2-7b --checkpoint /path/to/hf_dir \
        --mode int4 --out llama2-7b-int4.npz

Port of ``llm_inference_engine_tpu.tools.quantize``. The output is the
``.npz`` format 1 that both packages load as it is
(``create_engine("llama2-7b", "llama2-7b-int4.npz")``, or ``--checkpoint``
on the chat CLI and the server): no bf16 staging and no re-quantization
at engine start. The checkpoint loads and quantizes on ``--device``
(default ``cuda``; ``cpu`` works for any size that fits the host).
Calibration-aware quantization (``--calibrate``) waits for ROADMAP.md,
queue 1, "Evals, tools and utils".
"""

from __future__ import annotations

import argparse
import os
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="llm-torch-quantize",
                                 description=__doc__)
    ap.add_argument("--model", required=True,
                    help="preset name or config JSON path")
    ap.add_argument("--checkpoint", required=True,
                    help="HF safetensors dir or reference .bin dir")
    ap.add_argument("--mode", choices=["int8", "int4", "none"],
                    default="int8")
    ap.add_argument("--group-size", type=int, default=128)
    ap.add_argument("--out", required=True, help="output .npz path")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the load and quantization pass "
                         "(default cuda)")
    ap.add_argument("--calibrate", default=None, metavar="TOKENS",
                    help="calibration-aware clip search: not ported yet")
    args = ap.parse_args(argv)
    if args.calibrate:
        raise NotImplementedError(
            "--calibrate (calibrate_act_sq, quantize_params_calibrated) is "
            "not ported yet (ROADMAP.md, queue 1, 'Evals, tools and utils')")

    import torch

    from llm_inference_engine_tpu_torch.models import weights as W
    from llm_inference_engine_tpu_torch.models.registry import (
        _resolve_config, load_checkpoint_dir)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available "
                           "(pass --device cpu to quantize on the CPU)")
    cfg = _resolve_config(args.model)
    print(f"loading {args.checkpoint} onto {device} ...", flush=True)
    params = load_checkpoint_dir(cfg, args.checkpoint, device)
    if args.mode != "none":
        print(f"quantizing to {args.mode} (group {args.group_size}) ...",
              flush=True)
        params = W.quantize_params(params, args.mode, args.group_size)
    W.save_params(params, args.out)
    sz = os.path.getsize(args.out) / 1e9
    print(f"wrote {args.out} ({sz:.2f} GB)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
