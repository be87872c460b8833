"""Training data: memmap token shards with deterministic, resume-safe
batching.

The port's own copy of ``skypilot_tpu/models/data.py`` (numpy only, so
both trainers read identical batches from one file): a flat binary file
of token ids is memmapped and sliced into [batch, seq+1] windows on the
host, then moved to the device by the train loop. Determinism contract
(shared with ``train_loop``'s synthetic stream): batch contents are a
pure function of ``(seed, step)``, so a preempted run that resumes at
step N sees exactly the stream it would have seen unpreempted — no
sampler state in the checkpoint.

Dataset format: a raw little-endian token file (uint16 for vocab
< 65536, else uint32) with an optional sidecar ``<name>.json`` carrying
``{"dtype": "uint16", "vocab_size": N}``. Building such a file is left
to the reference's tooling (``python -m skypilot_tpu.models.data
encode``).
"""
import dataclasses
import json
import os
from typing import Optional, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class TokenDataset:
    """Memmapped token file + (seed, step) → batch windows."""

    tokens: np.ndarray  # 1-D memmap of token ids
    vocab_size: int

    @classmethod
    def open(cls, path: str,
             vocab_size: Optional[int] = None) -> 'TokenDataset':
        path = os.path.expanduser(path)
        dtype = np.uint16
        sidecar = f'{os.path.splitext(path)[0]}.json'
        if os.path.exists(sidecar):
            with open(sidecar, encoding='utf-8') as f:
                meta = json.load(f)
            dtype = np.dtype(meta.get('dtype', 'uint16'))
            vocab_size = vocab_size or meta.get('vocab_size')
        tokens = np.memmap(path, dtype=dtype, mode='r')
        if tokens.size == 0:
            raise ValueError(f'Empty token file: {path}')
        if vocab_size is None:
            # One pass over the (memmapped) file; cheap at smoke scale,
            # and exact — a wrong vocab guess would crash the embedding
            # gather on-device with a far worse error.
            vocab_size = int(tokens.max()) + 1
        return cls(tokens=tokens, vocab_size=int(vocab_size))

    def num_windows(self, seq_len: int) -> int:
        return max(0, (self.tokens.size - 1) // seq_len)

    def batch(self, step: int, batch_size: int, seq_len: int,
              seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
        """(tokens [B,S], targets [B,S]) for ``step`` — pure in
        (seed, step), sampling windows without replacement per epoch.

        Epoch ordering is a seeded permutation of window indices;
        consecutive steps walk it, wrapping to a re-seeded permutation
        per epoch.
        """
        windows = self.num_windows(seq_len)
        if windows == 0:
            raise ValueError(
                f'Dataset too small for seq_len={seq_len} '
                f'({self.tokens.size} tokens).')
        steps_per_epoch = max(1, windows // batch_size)
        epoch, pos = divmod(step, steps_per_epoch)
        rng = np.random.default_rng(np.random.SeedSequence([seed, epoch]))
        perm = rng.permutation(windows)
        idx = perm[(pos * batch_size + np.arange(batch_size)) % windows]
        rows = np.stack([
            self.tokens[i * seq_len:i * seq_len + seq_len + 1].astype(
                np.int32) for i in idx
        ])
        return rows[:, :-1], rows[:, 1:]

