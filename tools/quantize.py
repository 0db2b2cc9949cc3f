#!/usr/bin/env python3
"""The PyTorch port's offline quantizer, run from a checkout:

    python3 tools/quantize.py --model llama2-7b --checkpoint /path/to/hf_dir \
        --mode int4 --out llama2-7b-int4.npz [--device cpu]

The same as ``python -m llm_inference_engine_tpu_torch.tools.quantize``
(an HF safetensors or reference ``.bin`` directory in, the ``.npz``
format 1 that both packages load out); the JAX package's quantizer is
``python -m llm_inference_engine_tpu.tools.quantize``.
"""

import sys
from pathlib import Path

if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    from llm_inference_engine_tpu_torch.tools.quantize import main
    sys.exit(main())
