"""Oobleck waveform VAE (Stable-Audio style).

Port of `acestep_tpu/models/vae.py`: `snake`, `residual_unit`,
`decoder_block` (with the JAX package's dispatch and gates), `decode` and the
overlap-discard `tiled_decode`; the encoder half, `encoder_block`,
`encode_raw`, `encode_mean`, `encode_sample` and `tiled_encode`; and
`convert_torch_vae_state` for the reference (diffusers) checkpoint. Tensors
are NLC (channels last), kernels (K, C_in, C_out); Snake runs in fp32 with the
`sin2_f32` polynomial.

The JAX package computes the encoder outside any Pallas kernel, so it runs
here on `ops/conv.conv1d` (strided convs through `F.conv1d`), in fp32 as the
handler calls it, with TF32 off through the process-wide guard
(`utils/precision.strict_fp32`): an fp32 encode on the card agrees with the
CPU's to fp32 round-off, also while another thread trains.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from acestep_tpu_torch.config import OobleckConfig
from acestep_tpu_torch.ops.conv import conv1d, conv_transpose1d
from acestep_tpu_torch.ops.oobleck_kernels import (
    BLOCK_MAX_CHANNELS,
    CHAIN_MAX_CHANNELS,
    DILATIONS,
    TOTAL_HALO,
    _upsample_halo,
    decoder_block_kernel,
    res_units_kernel,
    snake_f32,
)
from acestep_tpu_torch.params import leaf, np32
from acestep_tpu_torch.utils.precision import strict_fp32

Params = Dict[str, Any]


def snake(p: Params, x: torch.Tensor) -> torch.Tensor:
    """Snake x + sin²(αx)/β with α, β stored as logs; fp32 inside."""
    return snake_f32(x.float(), p).to(x.dtype)


def residual_unit(p: Params, x: torch.Tensor, dilation: int) -> torch.Tensor:
    pad = ((7 - 1) * dilation) // 2
    h = snake(p["snake1"], x)
    h = conv1d(h, p["conv1"]["kernel"], p["conv1"].get("bias"), padding=pad, dilation=dilation)
    h = snake(p["snake2"], h)
    h = conv1d(h, p["conv2"]["kernel"], p["conv2"].get("bias"))
    return x + h


def encoder_block(p: Params, x: torch.Tensor, stride: int) -> torch.Tensor:
    for name, d in zip(("res_unit1", "res_unit2", "res_unit3"), DILATIONS):
        x = residual_unit(p[name], x, d)
    x = snake(p["snake1"], x)
    return conv1d(x, p["conv1"]["kernel"], p["conv1"].get("bias"), stride=stride, padding=-(-stride // 2))


def _fused_block_supports(l_in: int, stride: int) -> bool:
    """The JAX package's gate for the fused decoder block (input halo fits a tile)."""
    return -(-l_in // 8) * 8 >= _upsample_halo(stride)


def _res_units_supports(l: int) -> bool:
    """The JAX package's gate for the fused residual chain (tile >= halo)."""
    return -(-l // 8) * 8 >= TOTAL_HALO


def decoder_block(p: Params, x: torch.Tensor, stride: int) -> torch.Tensor:
    """Dispatch as `acestep_tpu/models/vae.decoder_block`: c_out <= 512 takes
    the fused block kernel, else Snake and the transposed conv run here and
    c <= 1024 takes the residual-chain kernel; sequences too short for the
    TPU kernels' halos run here, as they run in XLA in the JAX package. On
    the card each kernel wrapper takes every width the gate sends it: its
    Hopper route where it has one, its narrow route elsewhere."""
    c_out = p["conv_t1"]["kernel"].shape[2]
    if stride % 2 == 0 and c_out <= BLOCK_MAX_CHANNELS and _fused_block_supports(x.shape[1], stride):
        return decoder_block_kernel(x, p, stride)
    x = snake(p["snake1"], x)
    x = conv_transpose1d(
        x, p["conv_t1"]["kernel"], p["conv_t1"].get("bias"),
        stride=stride, padding=-(-stride // 2),
    )
    units = (p["res_unit1"], p["res_unit2"], p["res_unit3"])
    if x.shape[-1] <= CHAIN_MAX_CHANNELS and _res_units_supports(x.shape[1]):
        return res_units_kernel(x, units)
    for u, d in zip(units, DILATIONS):
        x = residual_unit(u, x, d)
    return x


def decode(p: Params, cfg: OobleckConfig, latents: torch.Tensor) -> torch.Tensor:
    """(B, L_latent, latent_dim) -> (B, L_audio, C_audio)."""
    d = p["decoder"]
    x = conv1d(latents, d["conv1"]["kernel"], d["conv1"].get("bias"), padding=3)
    for i, stride in enumerate(reversed(cfg.downsampling_ratios)):
        x = decoder_block(d["block"][i], x, stride)
    x = snake(d["snake1"], x)
    return conv1d(x, d["conv2"]["kernel"], d["conv2"].get("bias"), padding=3)


def _encode_raw(p: Params, cfg: OobleckConfig, audio: torch.Tensor) -> torch.Tensor:
    """`encode_raw`'s body under the caller's precision flags."""
    e = p["encoder"]
    x = conv1d(audio, e["conv1"]["kernel"], e["conv1"].get("bias"), padding=3)
    for i, stride in enumerate(cfg.downsampling_ratios):
        x = encoder_block(e["block"][i], x, stride)
    x = snake(e["snake1"], x)
    return conv1d(x, e["conv2"]["kernel"], e["conv2"].get("bias"), padding=1)


def encode_raw(p: Params, cfg: OobleckConfig, audio: torch.Tensor) -> torch.Tensor:
    """(B, L_audio, C_audio) -> (B, L_latent, 2 * latent_dim) mean and scale.
    cuDNN may run fp32 convolutions in TF32 (PyTorch's default); the encoder
    runs in strict fp32 under the shared guard."""
    with strict_fp32():
        return _encode_raw(p, cfg, audio)


def encode_mean(p: Params, cfg: OobleckConfig, audio: torch.Tensor) -> torch.Tensor:
    return encode_raw(p, cfg, audio).chunk(2, dim=-1)[0]


def encode_sample(
    p: Params,
    cfg: OobleckConfig,
    audio: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    *,
    noise: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """mean + (softplus(scale) + 1e-4) * noise, the noise drawn from
    `generator` (fp32 normal) unless given (the tests' injection hook)."""
    mean, scale = encode_raw(p, cfg, audio).chunk(2, dim=-1)
    std = F.softplus(scale.float()) + 1e-4
    if noise is None:
        noise = torch.randn(mean.shape, generator=generator, dtype=torch.float32, device=mean.device)
    return (mean.float() + std * noise.to(mean.device, torch.float32)).to(mean.dtype)


def tiled_decode(
    p: Params,
    cfg: OobleckConfig,
    latents: torch.Tensor,  # (B, T, latent_dim)
    *,
    chunk_frames: int = 512,
    overlap_frames: int = 16,
) -> torch.Tensor:
    """Decode long latents chunk by chunk with overlap-discard stitching."""
    b, t, _ = latents.shape
    hop = cfg.hop_length
    if t <= chunk_frames:
        return decode(p, cfg, latents)
    core = chunk_frames - 2 * overlap_frames
    n_chunks = -(-t // core)
    pad_t = n_chunks * core - t
    padded = F.pad(
        latents.transpose(1, 2), (overlap_frames, pad_t + overlap_frames), mode="replicate"
    ).transpose(1, 2)
    outs = []
    for ci in range(n_chunks):
        chunk = padded[:, ci * core : ci * core + core + 2 * overlap_frames]
        wav = decode(p, cfg, chunk)
        outs.append(wav[:, overlap_frames * hop : (overlap_frames + core) * hop, :])
    return torch.cat(outs, dim=1)[:, : t * hop, :]


def tiled_encode(
    p: Params,
    cfg: OobleckConfig,
    audio: torch.Tensor,  # (B, L, C)
    *,
    chunk_seconds: int = 20,
    overlap_seconds: int = 2,
    encode_fn: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
) -> torch.Tensor:
    """Encode long audio with overlap-discard: mean latents (B, L // hop, latent_dim).

    Chunks of `chunk_seconds` with `overlap_seconds` of zero-padded context
    on each side; each keeps its core frames."""
    b, l, _ = audio.shape
    sr, hop = cfg.sampling_rate, cfg.hop_length
    chunk_len = chunk_seconds * sr
    if encode_fn is None:
        encode_fn = lambda a: encode_mean(p, cfg, a)
    if l <= chunk_len:
        return encode_fn(audio)
    ov = overlap_seconds * sr
    core = chunk_len - 2 * ov
    n_chunks = -(-l // core)
    pad_l = n_chunks * core - l
    padded = F.pad(audio, (0, 0, ov, pad_l + ov))
    ov_frames, core_frames = ov // hop, core // hop
    outs = []
    for ci in range(n_chunks):
        z = encode_fn(padded[:, ci * core : ci * core + core + 2 * ov])
        outs.append(z[:, ov_frames : ov_frames + core_frames])
    return torch.cat(outs, dim=1)[:, : l // hop]


# ---------------------------------------------------------------------------
# The reference checkpoint (diffusers AutoencoderOobleck)
# ---------------------------------------------------------------------------


def convert_torch_vae_state(state: Dict[str, Any], cfg: OobleckConfig, dtype=torch.float32, device="cpu") -> Params:
    """A diffusers AutoencoderOobleck state_dict -> the port's tree, with
    weight norm folded (``weight_v``/``weight_g`` or
    ``parametrizations.weight.original0/1``: w = g v / max(|v|, 1e-12), the
    norm over all but the first axis) in numpy float32, as the JAX package
    folds it. Conv weights (out, in, K) and conv_t weights (in, out, K)
    become (K, in, out)."""

    def conv(prefix, transpose=False):
        if prefix + ".weight" in state:
            w = np32(state[prefix + ".weight"])
        else:
            if prefix + ".weight_v" in state:
                v, g = np32(state[prefix + ".weight_v"]), np32(state[prefix + ".weight_g"])
            elif prefix + ".parametrizations.weight.original0" in state:
                g = np32(state[prefix + ".parametrizations.weight.original0"])
                v = np32(state[prefix + ".parametrizations.weight.original1"])
            else:
                raise KeyError(prefix)
            norm = np.linalg.norm(v.reshape(v.shape[0], -1), axis=1).reshape(-1, 1, 1)
            w = g * v / np.maximum(norm, 1e-12)
        w = np.transpose(w, (2, 0, 1) if transpose else (2, 1, 0))
        out = {"kernel": leaf(w, device, dtype)}
        if prefix + ".bias" in state:
            out["bias"] = leaf(np32(state[prefix + ".bias"]), device, dtype)
        return out

    def snake_p(prefix):
        return {k: leaf(np32(state[f"{prefix}.{k}"]).reshape(-1), device, dtype) for k in ("alpha", "beta")}

    def res_unit(prefix):
        return {
            "snake1": snake_p(prefix + ".snake1"),
            "conv1": conv(prefix + ".conv1"),
            "snake2": snake_p(prefix + ".snake2"),
            "conv2": conv(prefix + ".conv2"),
        }

    n = len(cfg.downsampling_ratios)
    units = lambda pre: {f"res_unit{k}": res_unit(f"{pre}.res_unit{k}") for k in (1, 2, 3)}
    enc_blocks = [
        {**units(f"encoder.block.{i}"), "snake1": snake_p(f"encoder.block.{i}.snake1"),
         "conv1": conv(f"encoder.block.{i}.conv1")}
        for i in range(n)
    ]
    dec_blocks = [
        {"snake1": snake_p(f"decoder.block.{i}.snake1"),
         "conv_t1": conv(f"decoder.block.{i}.conv_t1", transpose=True), **units(f"decoder.block.{i}")}
        for i in range(n)
    ]
    return {
        "encoder": {"conv1": conv("encoder.conv1"), "block": enc_blocks,
                    "snake1": snake_p("encoder.snake1"), "conv2": conv("encoder.conv2")},
        "decoder": {"conv1": conv("decoder.conv1"), "block": dec_blocks,
                    "snake1": snake_p("decoder.snake1"), "conv2": conv("decoder.conv2")},
    }
