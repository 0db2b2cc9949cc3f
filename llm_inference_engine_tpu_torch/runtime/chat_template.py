"""Chat templates for the supported model families.

A copy of ``llm_inference_engine_tpu/runtime/chat_template.py``, which is
framework-free.

The reference's makeInput/makeHistory concatenated raw text with no
formatting (llama.cpp:137-155); real chat checkpoints expect their
training template. Because history lives in the KV cache (session.py),
a template renders only the NEW round's text — round 0 additionally
carries the system block.

Templates: ``plain`` (reference-parity concatenation), ``llama2``
([INST]/<<SYS>>), ``llama3`` (header-id format), ``chatml``
(Qwen2-style <|im_start|> blocks).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

__all__ = ["ChatTemplate", "get_chat_template", "template_for_model",
           "resolve_stop_ids"]


@dataclasses.dataclass(frozen=True)
class ChatTemplate:
    name: str
    first: str          # round 0: {system}, {user} placeholders
    next: str           # later rounds: {user}
    no_system: str = "" # round 0 without a system prompt ("" = use `first`
                        # with system="")
    assistant_suffix: str = ""  # closes an assistant turn when rendering a
                                # full stateless conversation
    stop_strings: tuple = ()   # template-level stop tokens (besides eos)
    add_bos: bool = True       # prepend the tokenizer's BOS on round 0

    def render(self, round_idx: int, system: str, user: str) -> str:
        if round_idx > 0:
            return self.next.format(user=user)
        if not system and self.no_system:
            return self.no_system.format(user=user)
        return self.first.format(system=system, user=user)

    def render_conversation(self, messages) -> str:
        """Render a full stateless conversation (OpenAI-style message
        list: dicts with role system|user|assistant) ending at an open
        assistant turn. Used by the HTTP chat endpoint, where history
        arrives per request rather than living in a session's KV cache."""
        system = ""
        out = []
        round_idx = 0
        pending_user = None

        def flush_user():
            nonlocal round_idx, pending_user
            if pending_user is None:
                return
            out.append(self.render(round_idx, system, pending_user))
            round_idx += 1
            pending_user = None

        for m in messages:
            role, content = m.get("role"), m.get("content", "")
            if role == "system":
                system = content
            elif role == "user":
                flush_user()
                pending_user = content
            elif role == "assistant":
                flush_user()
                out.append(content + self.assistant_suffix)
            else:
                raise ValueError(f"unknown chat role {role!r}")
        flush_user()
        return "".join(out)


_TEMPLATES = {
    # reference-parity: plain concatenation (llama.cpp:137-144)
    "plain": ChatTemplate(
        name="plain", first="{system}{user}", next="{user}"),
    "llama2": ChatTemplate(
        name="llama2",
        first="[INST] <<SYS>>\n{system}\n<</SYS>>\n\n{user} [/INST] ",
        no_system="[INST] {user} [/INST] ",
        next="[INST] {user} [/INST] ",
        assistant_suffix=" </s>"),
    "llama3": ChatTemplate(
        name="llama3",
        first=("<|start_header_id|>system<|end_header_id|>\n\n{system}"
               "<|eot_id|><|start_header_id|>user<|end_header_id|>\n\n"
               "{user}<|eot_id|><|start_header_id|>assistant"
               "<|end_header_id|>\n\n"),
        no_system=("<|start_header_id|>user<|end_header_id|>\n\n{user}"
                   "<|eot_id|><|start_header_id|>assistant"
                   "<|end_header_id|>\n\n"),
        next=("<|start_header_id|>user<|end_header_id|>\n\n{user}<|eot_id|>"
              "<|start_header_id|>assistant<|end_header_id|>\n\n"),
        assistant_suffix="<|eot_id|>",
        stop_strings=("<|eot_id|>", "<|end_of_text|>")),
    "chatml": ChatTemplate(
        name="chatml",
        first=("<|im_start|>system\n{system}<|im_end|>\n"
               "<|im_start|>user\n{user}<|im_end|>\n"
               "<|im_start|>assistant\n"),
        no_system=("<|im_start|>user\n{user}<|im_end|>\n"
                   "<|im_start|>assistant\n"),
        next=("<|im_start|>user\n{user}<|im_end|>\n"
              "<|im_start|>assistant\n"),
        assistant_suffix="<|im_end|>\n",
        stop_strings=("<|im_end|>", "<|endoftext|>"),
        add_bos=False),       # Qwen2 has no BOS
}


def get_chat_template(name: str) -> ChatTemplate:
    if name not in _TEMPLATES:
        raise KeyError(f"unknown chat template {name!r}; "
                       f"have {sorted(_TEMPLATES)}")
    return _TEMPLATES[name]


def template_for_model(model_name: str) -> ChatTemplate:
    """Best-guess template from the model/preset name; ``plain`` when
    unrecognized (reference-parity default)."""
    n = model_name.lower()
    if "qwen" in n:
        return _TEMPLATES["chatml"]
    if "llama3" in n or "llama-3" in n:
        return _TEMPLATES["llama3"]
    if "llama2" in n or "llama-2" in n or "tinyllama" in n:
        return _TEMPLATES["llama2"]
    if "mistral" in n:
        return _TEMPLATES["llama2"]    # Mistral-instruct uses [INST]
    return _TEMPLATES["plain"]


def resolve_stop_ids(tokenizer, names: Sequence[str]) -> list[int]:
    """Map stop-token strings to ids across the tokenizer implementations
    (byte-level added tokens, SP piece vocab, HF wrapper); silently skips
    names the vocabulary lacks."""
    ids = []
    for name in names:
        tid = None
        added = getattr(tokenizer, "added", None)
        if added and name in added:
            tid = added[name]
        if tid is None:
            vocab = getattr(tokenizer, "vocab", None)
            if isinstance(vocab, dict):
                tid = vocab.get(name)
        if tid is None:
            pieces = getattr(tokenizer, "pieces", None)
            if isinstance(pieces, dict) and name in pieces:
                tid = pieces[name][0]
        if tid is None and hasattr(tokenizer, "_tok"):   # HF wrapper
            tid = tokenizer._tok.token_to_id(name)
        if tid is not None:
            ids.append(int(tid))
    return ids
