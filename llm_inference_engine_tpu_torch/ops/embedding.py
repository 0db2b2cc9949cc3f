"""Token-embedding gather (plain torch, as the JAX package leaves it to XLA)."""

from __future__ import annotations

import torch

__all__ = ["embedding_lookup"]


def embedding_lookup(table: torch.Tensor,
                     token_ids: torch.Tensor) -> torch.Tensor:
    """table: [vocab, hidden]; token_ids: int[...] -> [..., hidden]."""
    return table[token_ids.long()]
