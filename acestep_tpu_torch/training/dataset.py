"""Preprocessed tensor dataset for decoder fine-tuning (the reader half).

Port of the reader half of `acestep_tpu/training/dataset.py`: `save_sample`,
`write_manifest` and `PreprocessedDataset`, plain numpy as in the JAX
package. Training consumes precomputed tensors (no encoders at train time),
one .npz a sample plus manifest.json:

    target_latents         (T, 64)   float32, the song's VAE latents
    encoder_hidden_states  (L, D)    float32, the packed condition encoder output
    encoder_attention_mask (L,)      int32
    context_latents        (T, 128)  float32, [source latents | chunk mask]
    attention_mask         (T,)      int32

Batches are zero-padded to (T_max, L_max) rounded up to `pad_multiple`.
`preprocess_audio_to_sample` (the VAE encode and the condition encoder of a
song) is not ported yet.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Iterator, List, Optional

import numpy as np


def save_sample(path: str, sample: Dict[str, np.ndarray]) -> None:
    np.savez_compressed(path, **sample)


def write_manifest(dataset_dir: str, entries: List[Dict[str, Any]]) -> str:
    path = os.path.join(dataset_dir, "manifest.json")
    with open(path, "w") as f:
        json.dump({"samples": entries}, f, indent=2)
    return path


class PreprocessedDataset:
    """Loads the .npz samples that manifest.json lists (else every .npz of the
    directory, sorted); iterates padded batches."""

    REQUIRED = (
        "target_latents",
        "encoder_hidden_states",
        "encoder_attention_mask",
        "context_latents",
        "attention_mask",
    )

    def __init__(self, dataset_dir: str):
        self.dataset_dir = dataset_dir
        manifest = os.path.join(dataset_dir, "manifest.json")
        if os.path.exists(manifest):
            with open(manifest) as f:
                self.entries = json.load(f)["samples"]
        else:
            self.entries = [{"file": f} for f in sorted(os.listdir(dataset_dir)) if f.endswith(".npz")]
        if not self.entries:
            raise ValueError(f"no samples found in {dataset_dir}")

    def __len__(self) -> int:
        return len(self.entries)

    def load(self, idx: int) -> Dict[str, np.ndarray]:
        path = os.path.join(self.dataset_dir, self.entries[idx]["file"])
        with np.load(path) as z:
            sample = {k: z[k] for k in z.files}
        missing = [k for k in self.REQUIRED if k not in sample]
        if missing:
            raise KeyError(f"sample {path} missing keys {missing}")
        return sample

    def batches(
        self,
        batch_size: int,
        *,
        shuffle: bool = True,
        seed: int = 0,
        epochs: Optional[int] = None,
        pad_multiple: int = 64,
    ) -> Iterator[Dict[str, np.ndarray]]:
        """Yield padded batches indefinitely (or for `epochs` passes), in the
        JAX package's order for the same seed (numpy's generator)."""
        if not self.entries:
            raise ValueError("dataset is empty — nothing to train on")
        # A batch larger than the dataset would yield nothing while looping
        # forever; train on the whole set instead.
        batch_size = min(batch_size, len(self.entries))
        rng = np.random.default_rng(seed)
        epoch = 0
        while epochs is None or epoch < epochs:
            order = np.arange(len(self.entries))
            if shuffle:
                rng.shuffle(order)
            for i in range(0, len(order) - batch_size + 1, batch_size):
                samples = [self.load(int(j)) for j in order[i : i + batch_size]]
                yield self._collate(samples, pad_multiple)
            epoch += 1

    @staticmethod
    def _collate(samples: List[Dict[str, np.ndarray]], pad_multiple: int) -> Dict[str, np.ndarray]:
        def ceil_to(n):
            return -(-n // pad_multiple) * pad_multiple

        t_max = ceil_to(max(s["target_latents"].shape[0] for s in samples))
        l_max = ceil_to(max(s["encoder_hidden_states"].shape[0] for s in samples))
        b = len(samples)
        d_lat = samples[0]["target_latents"].shape[1]
        d_ctx = samples[0]["context_latents"].shape[1]
        d_enc = samples[0]["encoder_hidden_states"].shape[1]

        batch = {
            "target_latents": np.zeros((b, t_max, d_lat), np.float32),
            "context_latents": np.zeros((b, t_max, d_ctx), np.float32),
            "attention_mask": np.zeros((b, t_max), np.int32),
            "encoder_hidden_states": np.zeros((b, l_max, d_enc), np.float32),
            "encoder_attention_mask": np.zeros((b, l_max), np.int32),
        }
        for i, s in enumerate(samples):
            t = s["target_latents"].shape[0]
            l = s["encoder_hidden_states"].shape[0]
            batch["target_latents"][i, :t] = s["target_latents"]
            batch["context_latents"][i, :t] = s["context_latents"][:t]
            batch["attention_mask"][i, :t] = s["attention_mask"][:t]
            batch["encoder_hidden_states"][i, :l] = s["encoder_hidden_states"]
            batch["encoder_attention_mask"][i, :l] = s["encoder_attention_mask"][:l]
        return batch
