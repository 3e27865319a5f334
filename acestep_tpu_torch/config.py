"""Model configurations for the PyTorch/CUDA port of ACE-Step 1.5.

A copy of `acestep_tpu/config.py` (the port imports nothing of `acestep_tpu`);
keep the two in step.

Mirrors the capability surface of the reference configs
(`acestep/models/turbo/configuration_acestep_v15.py:148-255` in the reference
tree) but as plain frozen dataclasses — no HF PretrainedConfig machinery.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class AceStepConfig:
    """DiT + condition-encoder + FSQ tokenizer/detokenizer configuration.

    Defaults reproduce the reference turbo config
    (reference `configuration_acestep_v15.py:148-255`).
    """

    # Core transformer
    hidden_size: int = 2048
    intermediate_size: int = 6144
    num_hidden_layers: int = 24
    num_attention_heads: int = 16
    num_key_value_heads: int = 8
    head_dim: int = 128
    rms_norm_eps: float = 1e-6
    rope_theta: float = 1_000_000.0
    attention_bias: bool = False
    use_sliding_window: bool = True
    sliding_window: int = 128
    # "sliding_attention" on odd layer indices 0,2,.. per reference default:
    # layer i is sliding iff (i + 1) % 2 == 1  (i.e. even i).
    layer_types: Optional[Tuple[str, ...]] = None

    # Text encoder interface
    text_hidden_dim: int = 1024

    # Lyric encoder
    num_lyric_encoder_hidden_layers: int = 8

    # Audio latents
    audio_acoustic_hidden_dim: int = 64
    pool_window_size: int = 5
    in_channels: int = 192  # 64 noisy + 64 src + 64 chunk-mask
    patch_size: int = 2

    # Flow-matching training
    data_proportion: float = 0.5
    timestep_mu: float = -0.4
    timestep_sigma: float = 1.0

    # FSQ
    fsq_dim: int = 2048
    fsq_levels: Tuple[int, ...] = (8, 8, 8, 5, 5, 5)
    fsq_num_quantizers: int = 1
    vocab_size: int = 64003

    # Timbre encoder
    timbre_hidden_dim: int = 64
    num_timbre_encoder_hidden_layers: int = 4
    timbre_fix_frame: int = 750

    # Pooler / detokenizer
    num_attention_pooler_hidden_layers: int = 2

    model_version: str = "turbo"

    def layer_type(self, layer_idx: int) -> str:
        if self.layer_types is not None:
            return self.layer_types[layer_idx]
        return "sliding_attention" if (layer_idx + 1) % 2 else "full_attention"

    @property
    def num_kv_groups(self) -> int:
        return self.num_attention_heads // self.num_key_value_heads

    @property
    def codebook_size(self) -> int:
        n = 1
        for lvl in self.fsq_levels:
            n *= lvl
        return n


@dataclasses.dataclass(frozen=True)
class OobleckConfig:
    """Stable-Audio-style waveform VAE config.

    The reference loads this from the checkpoint's `vae/config.json`
    (diffusers AutoencoderOobleck). The ACE-Step latent math requires the
    total hop to be 1920 (48 kHz / 1920 = 25 latent frames per second,
    reference `conditioning_masks.py:42`), so the default ratios multiply
    to 1920. Real checkpoints override these fields at load time.
    """

    encoder_hidden_size: int = 128
    downsampling_ratios: Tuple[int, ...] = (2, 4, 4, 6, 10)
    channel_multiples: Tuple[int, ...] = (1, 2, 4, 8, 16)
    decoder_channels: int = 128
    decoder_input_channels: int = 64  # latent dim
    audio_channels: int = 2
    sampling_rate: int = 48_000

    @property
    def hop_length(self) -> int:
        n = 1
        for r in self.downsampling_ratios:
            n *= r
        return n

    @property
    def latent_dim(self) -> int:
        return self.decoder_input_channels


@dataclasses.dataclass(frozen=True)
class Qwen3Config:
    """Qwen3 causal/embedding model config (text encoder + 5 Hz planner LM).

    Defaults correspond to Qwen3-0.6B (the text-encoder backbone and the
    smallest planner LM in the reference model zoo).
    """

    vocab_size: int = 151_936
    hidden_size: int = 1024
    intermediate_size: int = 3072
    num_hidden_layers: int = 28
    num_attention_heads: int = 16
    num_key_value_heads: int = 8
    head_dim: int = 128
    rms_norm_eps: float = 1e-6
    rope_theta: float = 1_000_000.0
    tie_word_embeddings: bool = True
    max_position_embeddings: int = 32_768

    @property
    def num_kv_groups(self) -> int:
        return self.num_attention_heads // self.num_key_value_heads


# Latent timing constants shared across the stack (reference SURVEY §0).
SAMPLE_RATE = 48_000
LATENT_HOP = 1920
LATENT_FPS = SAMPLE_RATE // LATENT_HOP  # 25 Hz
CODE_FPS = 5  # FSQ pool window 5 → 5 Hz audio codes
