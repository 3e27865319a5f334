"""Preprocessed tensor dataset for decoder fine-tuning.

Port of `acestep_tpu/training/dataset.py`: `save_sample`, `write_manifest`
and `PreprocessedDataset`, plain numpy as in the JAX package, and
`preprocess_audio_to_sample`, which runs a song through the encoders once.
Training consumes precomputed tensors (no encoders at train time), one .npz
a sample plus manifest.json:

    target_latents         (T, 64)   float32, the song's VAE latents
    encoder_hidden_states  (L, D)    float32, the packed condition encoder output
    encoder_attention_mask (L,)      int32
    context_latents        (T, 128)  float32, [source latents | chunk mask]
    attention_mask         (T,)      int32

Batches are zero-padded to (T_max, L_max) rounded up to `pad_multiple`.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Iterator, List, Optional, Union

import numpy as np
import torch

from acestep_tpu_torch.models import dit
from acestep_tpu_torch.utils.constants import DEFAULT_DIT_INSTRUCTION, SFT_GEN_PROMPT
from acestep_tpu_torch.utils.tokenizer import tokenize_padded


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


@torch.inference_mode()
def preprocess_audio_to_sample(
    handler,
    audio: np.ndarray,  # (2, L) float at 48 kHz
    caption: str,
    lyrics: str,
    *,
    metas: Optional[Union[str, Dict[str, Any]]] = None,
    vocal_language: str = "unknown",
) -> Dict[str, np.ndarray]:
    """Audio + text -> one sample's training tensors, fp32 numpy in the JAX
    package's layout: the VAE encode, the text and lyric embeddings, and the
    condition encoder on a silence timbre reference, run once so training
    touches only the decoder. `metas` is a metadata string or dict
    (`handler.parse_metas`). On the card every attention over 256 tokens or
    more takes kernel 1's bf16 route (`ops/attention.flash_wanted`): the
    timbre encoder's reference frames, and a long lyric or prompt."""
    z = handler.encode_reference_audio(audio)  # (T, 64)
    t = z.shape[0]

    metas_str = handler.parse_metas([metas], 1)[0]
    text_prompt = SFT_GEN_PROMPT.format(handler.format_instruction(DEFAULT_DIT_INSTRUCTION), caption, metas_str)
    lyric_text = handler.format_lyrics(lyrics, vocal_language)
    text_ids, text_mask = tokenize_padded(handler.text_tokenizer, [text_prompt], 256)
    lyric_ids, lyric_mask = tokenize_padded(handler.text_tokenizer, [lyric_text], 2048)

    text_hidden = handler.infer_text_embeddings(text_ids)
    lyric_hidden = handler.infer_lyric_embeddings(lyric_ids)

    silence = handler._silence_tiled(max(t, handler.config.timbre_fix_frame))
    refer_packed = handler._tensor(silence[None, : handler.config.timbre_fix_frame], handler.dtype)
    enc, enc_mask = dit.condition_encoder(
        handler.params["encoder"], handler.config,
        text_hidden.to(handler.dtype), handler._tensor(text_mask),
        lyric_hidden.to(handler.dtype), handler._tensor(lyric_mask),
        refer_packed, handler._tensor(np.zeros((1,), np.int32)), 1,
    )

    chunk = np.ones((t, z.shape[1]), np.float32)
    return {
        "target_latents": z.astype(np.float32),
        "encoder_hidden_states": enc[0].float().cpu().numpy(),
        "encoder_attention_mask": enc_mask[0].to(torch.int32).cpu().numpy(),
        "context_latents": np.concatenate([silence[:t], chunk], axis=-1).astype(np.float32),
        "attention_mask": np.ones((t,), np.int32),
    }
