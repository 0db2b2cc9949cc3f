"""Interactive chat CLI.

Port of ``llm_inference_engine_tpu/cli.py``: the reference's REPL (read a
line; ``s`` or /quit exits; the reply streams through the index-protocol
callback, ``:`` before the first chunk and a newline at the end; history
carries over rounds), with /reset, sampling controls, dummy-weight mode
and the id tokenizer (whitespace-separated ints) for dummy weights and a
``.npz`` given without ``--tokenizer``.

Run: python -m llm_inference_engine_tpu_torch.cli --model llama2-7b \
         --checkpoint /path/to/hf_dir_or.npz [--tokenizer tokenizer.model]
     python -m llm_inference_engine_tpu_torch.cli --model debug \
         --dummy-weights --device cpu

``--device`` (default ``cuda``) replaces the JAX CLI's ``--platform``;
with no card present, ``cuda`` raises. ``--beams`` > 1 decodes each turn
with beam search (``ChatSession.response_beam``, no streaming).
``--dp``/``--tp`` build a mesh (``parallel/mesh.py``): over
``cuda:0 ... cuda:n-1`` (too few cards raise), or with ``--device cpu``
over n copies of the CPU; with ``--beams`` the search runs over the mesh
engine's sharded weights.
"""

from __future__ import annotations

import argparse
import os
import sys

__all__ = ["build_parser", "main", "load_tokenizer_for", "_IdTokenizer"]


class _IdTokenizer:
    """Fallback for dummy mode: tokens are whitespace-separated ints."""

    bos_id = 1
    eos_id = 2

    def __init__(self, vocab_size: int):
        self.vocab_size = vocab_size

    def encode(self, text: str, add_bos: bool = True, add_eos: bool = False):
        ids = [int(t) % self.vocab_size for t in text.split() if
               t.lstrip("-").isdigit()]
        if not ids:
            ids = [(abs(hash(t)) % (self.vocab_size - 3)) + 3
                   for t in text.split()]
        return ([self.bos_id] if add_bos else []) + ids

    def decode(self, ids):
        return " ".join(str(int(i)) for i in ids)

    def decode_incremental(self, prev_ids, new_id):
        return (" " if prev_ids else "") + str(int(new_id))


def load_tokenizer_for(tokenizer: str | None, checkpoint: str | None,
                       vocab_size: int):
    """``--tokenizer`` if given, else a checkpoint directory's own
    tokenizer; a ``.npz`` (which holds none) or dummy weights get the id
    tokenizer."""
    path = tokenizer or (checkpoint if checkpoint and os.path.isdir(checkpoint)
                         else None)
    if path is None:
        return _IdTokenizer(vocab_size)
    from llm_inference_engine_tpu_torch.tokenizer import load_tokenizer
    return load_tokenizer(path)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="llm-inference-engine-torch",
                                description=__doc__)
    p.add_argument("--model", default="llama2-7b",
                   help="preset name or config JSON path")
    p.add_argument("--checkpoint", default=None,
                   help="checkpoint: HF safetensors dir, reference .bin dir "
                        "or save_params .npz")
    p.add_argument("--tokenizer", default=None,
                   help="tokenizer file/dir (json/model/bin); default: "
                        "the checkpoint directory's, else token ids as "
                        "text")
    p.add_argument("--dummy-weights", action="store_true")
    p.add_argument("--max-new-tokens", type=int, default=256)
    p.add_argument("--temperature", type=float, default=1.0)
    p.add_argument("--top-k", type=int, default=5)
    p.add_argument("--top-p", type=float, default=1.0)
    p.add_argument("--greedy", action="store_true")
    p.add_argument("--beams", type=int, default=0,
                   help="beam-search width (0 = sampling; beams>1 decodes "
                        "each turn with beam search, no streaming)")
    p.add_argument("--length-penalty", type=float, default=1.0)
    p.add_argument("--max-seq-len", type=int, default=2048)
    p.add_argument("--max-batch-size", type=int, default=1)
    p.add_argument("--quant", choices=["none", "int8", "int4"],
                   default="none")
    p.add_argument("--kv-cache-dtype", choices=["", "int8"], default="")
    p.add_argument("--kv-layout", choices=["slot", "paged"], default="slot")
    p.add_argument("--page-size", type=int, default=64)
    p.add_argument("--num-pages", type=int, default=0)
    p.add_argument("--dp", type=int, default=1)
    p.add_argument("--tp", type=int, default=1)
    p.add_argument("--system-prompt", default="")
    p.add_argument("--chat-template", default="auto",
                   help="plain | llama2 | llama3 | chatml | auto "
                        "(auto picks by model name; plain = reference-"
                        "parity concatenation)")
    p.add_argument("--device", default="cuda",
                   help="torch device of the engine (default cuda)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    import torch

    from llm_inference_engine_tpu_torch.config import (
        EngineConfig, SamplingParams)
    from llm_inference_engine_tpu_torch.models.registry import create_engine
    from llm_inference_engine_tpu_torch.runtime.chat_template import (
        template_for_model)
    from llm_inference_engine_tpu_torch.runtime.session import ChatSession

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available "
                           "(pass --device cpu to chat on the CPU)")
    if not args.dummy_weights and not args.checkpoint:
        print("either --checkpoint or --dummy-weights is required",
              file=sys.stderr)
        return 2

    eng = EngineConfig(
        max_batch_size=args.max_batch_size, max_seq_len=args.max_seq_len,
        quant_mode=args.quant, kv_cache_dtype_name=args.kv_cache_dtype,
        dp=args.dp, tp=args.tp, kv_layout=args.kv_layout,
        page_size=args.page_size, num_pages=args.num_pages)
    print(f"loading {args.model} "
          f"({'dummy weights' if args.dummy_weights else args.checkpoint}, "
          f"quant={args.quant}, {device}) ...", flush=True)
    engine = create_engine(args.model, args.checkpoint, eng, device=device)

    tokenizer = load_tokenizer_for(args.tokenizer, args.checkpoint,
                                   engine.config.vocab_size)

    sampling = SamplingParams(
        temperature=args.temperature, top_k=args.top_k, top_p=args.top_p,
        greedy=args.greedy, max_new_tokens=args.max_new_tokens)
    if args.chat_template == "auto":
        template = ("plain" if isinstance(tokenizer, _IdTokenizer)
                    else template_for_model(args.model))   # ids: no template
    else:
        template = args.chat_template
    session = ChatSession(engine, tokenizer,
                          system_prompt=args.system_prompt,
                          template=template)

    # reference CallBack print protocol (user_entry.cpp:25-37)
    def cb(index: int, content: str) -> None:
        if index == 0:
            print(":" + content, end="", flush=True)
        elif index > 0:
            print(content, end="", flush=True)
        else:
            print()

    print("ready. 's' or '/quit' exits, '/reset' clears history.")
    while True:
        try:
            line = input("please input the question: ")
        except (EOFError, KeyboardInterrupt):
            print()
            break
        if line.strip() in ("s", "/quit", "/exit"):
            break
        if line.strip() == "/reset":
            session.reset()
            print("(history cleared)")
            continue
        if not line.strip():
            continue
        if args.beams > 1:
            session.response_beam(line, num_beams=args.beams,
                                  max_new_tokens=args.max_new_tokens,
                                  length_penalty=args.length_penalty,
                                  callback=cb)
        else:
            session.response(line, sampling, cb)
    return 0


if __name__ == "__main__":
    sys.exit(main())
