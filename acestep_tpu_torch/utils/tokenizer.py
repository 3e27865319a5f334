"""Text tokenization: HF tokenizer when a checkpoint is available, byte-level
fallback for checkpoint-free development and testing.

A copy of `acestep_tpu/utils/tokenizer.py`; a checkpoint directory counts as
holding a tokenizer only when it has one of the tokenizer's files.
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

import numpy as np


class ByteFallbackTokenizer:
    """Deterministic byte-level tokenizer (ids = byte + 3). Dev/test only."""

    pad_token_id = 0
    bos_token_id = 1
    eos_token_id = 2
    vocab_size = 259

    def encode(self, text: str, max_length: Optional[int] = None) -> List[int]:
        ids = [b + 3 for b in text.encode("utf-8")]
        if max_length is not None:
            ids = ids[:max_length]
        return ids

    def decode(self, ids) -> str:
        return bytes(int(i) - 3 for i in ids if 2 < int(i) < 259).decode("utf-8", "ignore")

    def __call__(self, text: str, max_length: Optional[int] = None):
        return self.encode(text, max_length)


# Files an HF tokenizer is read from; a directory without any has none (some
# `transformers` versions would build one with an empty vocabulary from it).
TOKENIZER_FILES = ("tokenizer.json", "tokenizer_config.json", "vocab.json", "tokenizer.model")


def load_tokenizer(checkpoint_dir: Optional[str]):
    """AutoTokenizer from checkpoint if present, else byte fallback."""
    if checkpoint_dir and any(os.path.isfile(os.path.join(checkpoint_dir, f)) for f in TOKENIZER_FILES):
        try:
            from transformers import AutoTokenizer

            return AutoTokenizer.from_pretrained(checkpoint_dir)
        except Exception:  # no transformers, or no tokenizer files in the directory
            pass
    return ByteFallbackTokenizer()


def tokenize_padded(
    tokenizer,
    texts: List[str],
    max_length: int,
    bucket: Optional[int] = None,
    buckets=None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Tokenize a batch, truncate to max_length, right-pad to a bucket.

    Returns (ids (B, L), mask (B, L)) with L = bucket or the padded batch max.
    Passing `buckets` picks the bucket from the longest sequence.
    """
    seqs = []
    for t in texts:
        if hasattr(tokenizer, "encode") and not hasattr(tokenizer, "pad_token"):
            ids = tokenizer.encode(t, max_length=max_length)
        else:  # HF tokenizer
            ids = tokenizer(t, truncation=True, max_length=max_length)["input_ids"]
        seqs.append(ids[:max_length])
    longest = max(len(s) for s in seqs) if seqs else 1
    if buckets is not None:
        bucket = pick_bucket(longest, buckets)
    if bucket is None:
        bucket = longest
    l = max(bucket, 1)
    pad_id = getattr(tokenizer, "pad_token_id", 0) or 0
    ids = np.full((len(seqs), l), pad_id, np.int32)
    mask = np.zeros((len(seqs), l), np.int32)
    for i, s in enumerate(seqs):
        n = min(len(s), l)
        ids[i, :n] = s[:n]
        mask[i, :n] = 1
    return ids, mask


def pick_bucket(n: int, buckets) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]
