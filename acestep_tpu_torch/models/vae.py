"""Oobleck waveform VAE decoder (Stable-Audio style).

Port of the decode half of `acestep_tpu/models/vae.py`: `snake`,
`residual_unit`, `decoder_block` (with the JAX package's dispatch and gates),
`decode` and the overlap-discard `tiled_decode`. Tensors are NLC (channels
last), kernels (K, C_in, C_out); Snake runs in fp32 with the `sin2_f32`
polynomial. The encoder half (`encode_*`, `tiled_encode`) is not ported yet.
"""

from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F

from acestep_tpu_torch.config import OobleckConfig
from acestep_tpu_torch.ops.conv import conv1d, conv_transpose1d
from acestep_tpu_torch.ops.oobleck_kernels import (
    CHAIN_CHANNELS,
    TOTAL_HALO,
    _upsample_halo,
    decoder_block_kernel,
    decoder_block_takes,
    res_units_kernel,
    snake_f32,
)

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


def _fused_block_supports(l_in: int, stride: int) -> bool:
    """The JAX package's gate for the fused decoder block (input halo fits a tile)."""
    return -(-l_in // 8) * 8 >= _upsample_halo(stride)


def _res_units_supports(l: int) -> bool:
    """The JAX package's gate for the fused residual chain (tile >= halo)."""
    return -(-l // 8) * 8 >= TOTAL_HALO


def decoder_block(p: Params, x: torch.Tensor, stride: int) -> torch.Tensor:
    """Dispatch as `acestep_tpu/models/vae.decoder_block`: c_out <= 512 takes
    the fused block kernel, else Snake and the transposed conv run here and
    c <= 1024 takes the residual-chain kernel. On the card a kernel is taken
    only at the widths it has (`decoder_block_takes`, CHAIN_CHANNELS); any
    other width runs here in torch, as short sequences run in XLA in the JAX
    package, and counts one in `decoder_block.torch_on_card` per part (block
    or chain) that the JAX package would run in a Pallas kernel."""
    c_out = p["conv_t1"]["kernel"].shape[2]
    card = x.is_cuda
    if stride % 2 == 0 and c_out <= 512 and _fused_block_supports(x.shape[1], stride):
        if not card or decoder_block_takes(x.shape[-1], c_out):
            return decoder_block_kernel(x, p, stride)
        decoder_block.torch_on_card += 1
    x = snake(p["snake1"], x)
    x = conv_transpose1d(
        x, p["conv_t1"]["kernel"], p["conv_t1"].get("bias"),
        stride=stride, padding=-(-stride // 2),
    )
    units = (p["res_unit1"], p["res_unit2"], p["res_unit3"])
    c = x.shape[-1]
    if c <= 1024 and _res_units_supports(x.shape[1]):
        if not card or c in CHAIN_CHANNELS:
            return res_units_kernel(x, units)
        decoder_block.torch_on_card += 1
    for u, d in zip(units, (1, 3, 9)):
        x = residual_unit(u, x, d)
    return x


decoder_block.torch_on_card = 0


def decode(p: Params, cfg: OobleckConfig, latents: torch.Tensor) -> torch.Tensor:
    """(B, L_latent, latent_dim) -> (B, L_audio, C_audio)."""
    d = p["decoder"]
    x = conv1d(latents, d["conv1"]["kernel"], d["conv1"].get("bias"), padding=3)
    for i, stride in enumerate(reversed(cfg.downsampling_ratios)):
        x = decoder_block(d["block"][i], x, stride)
    x = snake(d["snake1"], x)
    return conv1d(x, d["conv2"]["kernel"], d["conv2"].get("bias"), padding=3)


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
