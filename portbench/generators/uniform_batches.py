"""Training batches: token ids drawn uniformly from the vocabulary, a
fresh batch every step from ``(seed, step)``, targets the tokens rolled
by one.

Keys of a traffic file read here: ``batch`` and ``seq_len``.
"""
from typing import Dict, Tuple

import numpy as np
import torch


def batch(traffic: Dict, seed: int, step: int, vocab: int,
          device) -> Tuple[torch.Tensor, torch.Tensor]:
    """Step ``step``'s ``(tokens, targets)``, int64 [batch, seq_len], on
    ``device``. Every step and every row differ."""
    rng = np.random.default_rng(
        np.random.SeedSequence([int(seed) % 2**64, 7, step]))
    toks = rng.integers(0, vocab, (traffic['batch'], traffic['seq_len']),
                        dtype=np.int64)
    tokens = torch.as_tensor(toks, device=device)
    return tokens, torch.roll(tokens, -1, dims=1)


def tokens_per_step(traffic: Dict) -> int:
    return int(traffic['batch']) * int(traffic['seq_len'])
