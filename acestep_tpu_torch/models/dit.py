"""ACE-Step v1.5 DiT and condition encoders (turbo and base).

Port of `acestep_tpu/models/dit.py` as plain functions on the JAX package's
parameter tree (tensors; layers as per-layer lists, see `params.py`):

- `attention_block`, `encoder_layer`, `encoder_stack`, `lyric_encoder`,
  `timbre_encoder`, `condition_encoder`;
- the audio tokenizer chain: `attention_pooler` and `audio_tokenize` (25 Hz
  latents -> 5 Hz FSQ tokens), `detokenizer` and `decode_audio_codes` (LM
  audio codes -> FSQ -> 25 Hz hints), and `prepare_condition` with
  precomputed hints, audio codes, or the source latents through the chain;
- `timestep_embedding`, `dit_layer`, `precompute_cross_kv`, `dit_forward`;
- `dit_cross_attention_capture`: the cross-attention maps of chosen layers
  for the LRC alignment;
- `build_t_schedule`, `build_linspace_schedule`, `prepare_noise`;
- guidance: `cfg_forward`, `apg_forward` (momentum carried by the caller)
  and `adg_forward`, plain tensor functions as in the JAX package;
- `denoise` (`denoise_scan` as a Python loop: ODE or SDE steps, and with a
  null branch CFG through APG or ADG inside the CFG interval) and
  `generate_audio` with cover noise (the renoised entry partway down the
  schedule), cover strength (the non-cover segment), the null condition per
  segment, and the `noise=` and `sde_noise=` injection hooks.

Under a mesh (`parallel.tensor.Shards`, ROADMAP A.11b) the decoder runs on
this rank's tensor-parallel heads and MLP features, its rowwise products
summed over the tp ranks (`ops.basic.linear_rowwise`); heads come from a
weight's width, not from the config. With sequence parallelism each rank
denoises a contiguous slice of the latent-time axis: full-attention layers
gather K and V, sliding layers take a halo of `window` rows on each side,
APG sums its norms' squares over the sp ranks, noise is drawn for the whole
sequence and sliced, and the final latents are gathered. The condition
(`prepare_condition`) is computed whole on every rank.

The bf16 rounding points follow the JAX package: modulation in fp32 then cast
(`dit_layer`), rope in fp32, the ODE step size cast to the latent dtype; APG
and ADG compute in fp32 and cast once (APG adds its cast update to the
conditional velocity in the latent dtype); SDE noise is drawn in fp32, cast,
and mixed in the latent dtype. Decoder padding masks stay on, as in the JAX
package.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from acestep_tpu_torch.config import AceStepConfig
from acestep_tpu_torch.ops.attention import attention
from acestep_tpu_torch.ops.basic import linear, linear_rowwise, mlp_swiglu, rms_norm
from acestep_tpu_torch.ops.conv import conv1d, conv_transpose1d
from acestep_tpu_torch.ops.fsq import residual_fsq_decode_indices, residual_fsq_forward
from acestep_tpu_torch.ops.packing import pack_sequences
from acestep_tpu_torch.ops.rope import apply_rope, rope_cos_sin
from acestep_tpu_torch.parallel.tensor import Shards, halo_edges, halo_extend, halo_mask, halo_rows

Params = Dict[str, Any]

# The 8-step turbo schedules per discrete shift (ref turbo :1819-1823).
SHIFT_TIMESTEPS = {
    1.0: [1.0, 0.875, 0.75, 0.625, 0.5, 0.375, 0.25, 0.125],
    2.0: [1.0, 14 / 15, 6 / 7, 10 / 13, 2 / 3, 6 / 11, 0.4, 2 / 9],
    3.0: [1.0, 21 / 22, 0.9, 5 / 6, 0.75, 9 / 14, 0.5, 0.3],
}
VALID_TIMESTEPS = sorted({t for v in SHIFT_TIMESTEPS.values() for t in v}, reverse=True)


def _split_heads(x: torch.Tensor, head_dim: int) -> torch.Tensor:
    """(B, L, N·head_dim) -> (B, L, N, head_dim): N from the width, so a
    tensor-parallel shard gives its local heads."""
    b, l, _ = x.shape
    return x.reshape(b, l, -1, head_dim)


def _window(cfg: AceStepConfig, i: int) -> Optional[int]:
    if cfg.use_sliding_window and cfg.layer_type(i) == "sliding_attention":
        return cfg.sliding_window
    return None


# ---------------------------------------------------------------------------
# Attention block and encoder stacks
# ---------------------------------------------------------------------------


def cross_attention_kv(p: Params, cfg: AceStepConfig, enc: torch.Tensor):
    """Cross-attention K/V, computed once per trajectory."""
    k = _split_heads(linear(p["k_proj"], enc), cfg.head_dim)
    k = rms_norm(p["k_norm"]["weight"], k, cfg.rms_norm_eps)
    v = _split_heads(linear(p["v_proj"], enc), cfg.head_dim)
    return k, v


def _self_qkv(p: Params, cfg: AceStepConfig, x: torch.Tensor, cos, sin):
    """Self-attention q, k, v of x, normed, with rope when cos is given."""
    q = rms_norm(p["q_norm"]["weight"], _split_heads(linear(p["q_proj"], x), cfg.head_dim), cfg.rms_norm_eps)
    k = rms_norm(p["k_norm"]["weight"], _split_heads(linear(p["k_proj"], x), cfg.head_dim), cfg.rms_norm_eps)
    v = _split_heads(linear(p["v_proj"], x), cfg.head_dim)
    if cos is not None:
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    return q, k, v


def attention_block(
    p: Params,
    cfg: AceStepConfig,
    x: torch.Tensor,
    *,
    cos: Optional[torch.Tensor] = None,
    sin: Optional[torch.Tensor] = None,
    kv_mask: Optional[torch.Tensor] = None,
    window: Optional[int] = None,
    kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    tp_sum: Optional[Callable] = None,
) -> torch.Tensor:
    """Self-attention (kv None) or cross-attention on precomputed kv; under
    tensor parallelism on local heads, `tp_sum` summing o_proj's partials."""
    if kv is not None:
        q = _split_heads(linear(p["q_proj"], x), cfg.head_dim)
        q = rms_norm(p["q_norm"]["weight"], q, cfg.rms_norm_eps)
        k, v = kv
    else:
        q, k, v = _self_qkv(p, cfg, x, cos, sin)
    out = attention(q, k, v, kv_mask=kv_mask, window=window, scale=cfg.head_dim**-0.5)
    return linear_rowwise(p["o_proj"], out.reshape(x.shape[0], x.shape[1], -1), tp_sum)


def encoder_layer(p, cfg, x, cos, sin, kv_mask, window=None) -> torch.Tensor:
    h = rms_norm(p["input_layernorm"]["weight"], x, cfg.rms_norm_eps)
    x = x + attention_block(p["self_attn"], cfg, h, cos=cos, sin=sin, kv_mask=kv_mask, window=window)
    h = rms_norm(p["post_attention_layernorm"]["weight"], x, cfg.rms_norm_eps)
    return x + mlp_swiglu(p["mlp"], h)


def encoder_stack(layers, norm_w, cfg: AceStepConfig, x, seq_mask) -> torch.Tensor:
    """Bidirectional encoder layers, alternating sliding/full attention."""
    cos, sin = rope_cos_sin(x.shape[1], cfg.head_dim, cfg.rope_theta, device=x.device)
    for i, lp in enumerate(layers):
        x = encoder_layer(lp, cfg, x, cos, sin, seq_mask, _window(cfg, i))
    return rms_norm(norm_w, x, cfg.rms_norm_eps)


def lyric_encoder(p: Params, cfg: AceStepConfig, lyric_embeds, lyric_mask) -> torch.Tensor:
    """(B, L, text_hidden_dim) -> (B, L, hidden)."""
    x = linear(p["embed_tokens"], lyric_embeds)
    return encoder_stack(p["layers"], p["norm"]["weight"], cfg, x, lyric_mask)


def timbre_encoder(
    p: Params,
    cfg: AceStepConfig,
    packed_refs: torch.Tensor,  # (N, T_ref, 64)
    order_mask: torch.Tensor,  # (N,) batch index per packed ref
    batch_size: int,
    max_refs: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Packed reference latents -> per-ref timbre vectors, unpacked per batch item.

    The first frame's output is the timbre embedding; unpacking is the same
    one-hot product as the JAX version, and refs beyond max_refs are dropped.
    """
    x = linear(p["embed_tokens"], packed_refs)
    x = encoder_stack(p["layers"], p["norm"]["weight"], cfg, x, None)
    timbre = x[:, 0, :]
    n = timbre.shape[0]
    order = order_mask.long()
    idx = torch.arange(n, device=x.device)
    same = order[:, None] == order[None, :]
    earlier = idx[None, :] < idx[:, None]
    pos_in_batch = (same & earlier).sum(dim=1)
    flat_idx = torch.where(pos_in_batch < max_refs, order * max_refs + pos_in_batch, -1)
    slots = batch_size * max_refs
    one_hot = (flat_idx[:, None] == torch.arange(slots, device=x.device)[None, :]).to(timbre.dtype)
    unpacked = (one_hot.T @ timbre).reshape(batch_size, max_refs, -1)
    mask = (one_hot.sum(dim=0) > 0).to(torch.int32).reshape(batch_size, max_refs)
    return unpacked, mask


def condition_encoder(
    p: Params,
    cfg: AceStepConfig,
    text_hidden_states,
    text_attention_mask,
    lyric_hidden_states,
    lyric_attention_mask,
    refer_packed,
    refer_order_mask,
    max_refs: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pack lyric -> timbre -> text conditions, valid tokens first."""
    b = text_hidden_states.shape[0]
    text = linear(p["text_projector"], text_hidden_states)
    lyric = lyric_encoder(p["lyric_encoder"], cfg, lyric_hidden_states, lyric_attention_mask)
    timbre, timbre_mask = timbre_encoder(
        p["timbre_encoder"], cfg, refer_packed, refer_order_mask, b, max_refs
    )
    enc, enc_mask = pack_sequences(
        lyric, timbre.to(lyric.dtype), lyric_attention_mask.to(torch.int32), timbre_mask
    )
    return pack_sequences(enc, text, enc_mask, text_attention_mask.to(torch.int32))


def attention_pooler(p: Params, cfg: AceStepConfig, x: torch.Tensor) -> torch.Tensor:
    """(B, T, P, D) patches -> (B, T, D): the output at a prepended special token."""
    b, t, pw, _ = x.shape
    x = linear(p["embed_tokens"], x)
    cls = p["special_token"].to(x.dtype).expand(b, t, 1, x.shape[-1])
    x = torch.cat([cls, x], dim=2).reshape(b * t, pw + 1, -1)
    x = encoder_stack(p["layers"], p["norm"]["weight"], cfg, x, None)
    return x[:, 0, :].reshape(b, t, -1)


def audio_tokenize(p: Params, cfg: AceStepConfig, hidden_states: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """25 Hz acoustic latents (B, T25, 64), T25 a multiple of the pool window,
    -> (quantized 5 Hz tokens (B, T25 / P, D), integer indices (B, T25 / P))."""
    b, t25, _ = hidden_states.shape
    x = linear(p["audio_acoustic_proj"], hidden_states)
    x = x.reshape(b, t25 // cfg.pool_window_size, cfg.pool_window_size, -1)
    return residual_fsq_forward(p["quantizer"], attention_pooler(p["attention_pooler"], cfg, x), cfg.fsq_levels)


def detokenizer(p: Params, cfg: AceStepConfig, quantized: torch.Tensor) -> torch.Tensor:
    """(B, T5, D) 5 Hz tokens -> (B, T5 * P, 64) 25 Hz acoustic (ref AudioTokenDetokenizer)."""
    b, t, _ = quantized.shape
    pw = cfg.pool_window_size
    x = linear(p["embed_tokens"], quantized)
    x = x[:, :, None, :] + p["special_tokens"].to(x.dtype)[None]
    x = x.reshape(b * t, pw, -1)
    x = encoder_stack(p["layers"], p["norm"]["weight"], cfg, x, None)
    x = linear(p["proj_out"], x)
    return x.reshape(b, t * pw, -1)


def decode_audio_codes(p: Params, cfg: AceStepConfig, indices: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    """LM audio-code indices (B, T5) -> 25 Hz latent hints (B, T5 * P, 64)
    (quantizer.get_output_from_indices, then the detokenizer)."""
    quantized = residual_fsq_decode_indices(p["tokenizer"]["quantizer"], indices, cfg.fsq_levels, dtype)
    return detokenizer(p["detokenizer"], cfg, quantized)


def prepare_condition(
    params: Params,
    cfg: AceStepConfig,
    *,
    text_hidden_states,
    text_attention_mask,
    lyric_hidden_states,
    lyric_attention_mask,
    refer_packed,
    refer_order_mask,
    src_latents,  # (B, T, 64)
    chunk_masks,  # (B, T) or (B, T, 64)
    is_covers,  # (B,)
    silence_latent: Optional[torch.Tensor] = None,  # (1, >=T, 64)
    precomputed_lm_hints_25hz: Optional[torch.Tensor] = None,
    audio_codes: Optional[torch.Tensor] = None,
    max_refs: int = 1,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """-> (encoder_hidden_states, encoder_mask, context_latents).

    The LM hints come from `precomputed_lm_hints_25hz`, else from
    `audio_codes` (B, T5) through `decode_audio_codes`, else from the source
    latents themselves through the audio tokenizer and the detokenizer
    (padded with silence to a pool-window multiple); they replace the source
    latents of the cover rows.
    """
    enc, enc_mask = condition_encoder(
        params["encoder"], cfg, text_hidden_states, text_attention_mask,
        lyric_hidden_states, lyric_attention_mask, refer_packed, refer_order_mask, max_refs,
    )
    t = src_latents.shape[1]

    def fit(h: torch.Tensor) -> torch.Tensor:
        h = h[:, :t, :]
        short = t - h.shape[1]
        if short > 0:
            if silence_latent is not None:
                fill = silence_latent[:1, :short, :].expand(h.shape[0], short, h.shape[2])
            else:
                fill = torch.zeros((h.shape[0], short, h.shape[2]), dtype=h.dtype, device=h.device)
            h = torch.cat([h, fill.to(h.dtype)], dim=1)
        return h

    if precomputed_lm_hints_25hz is not None:
        h = fit(precomputed_lm_hints_25hz)
    elif audio_codes is not None:
        h = fit(decode_audio_codes(params, cfg, audio_codes, src_latents.dtype))
    else:
        hs = src_latents
        pad = (-t) % cfg.pool_window_size
        if pad:
            if silence_latent is None:
                raise ValueError("the tokenizer chain pads with the silence latent, which was not given")
            fill = silence_latent[:1, :pad, :].expand(hs.shape[0], pad, hs.shape[2])
            hs = torch.cat([hs, fill.to(hs.dtype)], dim=1)
        quantized, _ = audio_tokenize(params["tokenizer"], cfg, hs)
        h = detokenizer(params["detokenizer"], cfg, quantized)[:, :t, :]
    is_c = is_covers.to(torch.bool)[:, None, None]
    src = torch.where(is_c, h.to(src_latents.dtype), src_latents)
    cm = chunk_masks if chunk_masks.dim() == 3 else chunk_masks[..., None].expand(src.shape)
    context_latents = torch.cat([src, cm.to(src.dtype)], dim=-1)
    return enc, enc_mask, context_latents


# ---------------------------------------------------------------------------
# Timestep embedding + DiT
# ---------------------------------------------------------------------------


def timestep_embedding(p: Params, t: torch.Tensor, in_channels: int = 256, scale: float = 1000.0):
    """Returns (temb (B, D), proj (B, 6, D))."""
    half = in_channels // 2
    freqs = torch.exp(
        -np.log(10000.0) * torch.arange(half, dtype=torch.float32, device=t.device) / half
    )
    args = t.float()[:, None] * scale * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    dtype = p["linear_1"]["kernel"].dtype
    temb = linear(p["linear_1"], emb.to(dtype))
    temb = linear(p["linear_2"], F.silu(temb))
    proj = linear(p["time_proj"], F.silu(temb))
    return temb, proj.reshape(t.shape[0], 6, -1)


def dit_layer(
    p: Params,
    cfg: AceStepConfig,
    x: torch.Tensor,
    cos: torch.Tensor,
    sin: torch.Tensor,
    tproj: torch.Tensor,  # (B, 6, D)
    self_kv_mask: Optional[torch.Tensor],
    window: Optional[int],
    cross_kv_mask: Optional[torch.Tensor],
    cross_kv: Tuple[torch.Tensor, torch.Tensor],
    shards: Optional[Shards] = None,
) -> torch.Tensor:
    """AdaLN-zero DiT layer (ref AceStepDiTLayer). `cos`, `sin` and
    `self_kv_mask` are the whole sequence's; x is this rank's slice of it
    under sequence parallelism (`self_attention`)."""
    tp_sum = shards.tp_sum if shards is not None else None
    mod = p["scale_shift_table"].float() + tproj.float()
    shift_msa, scale_msa, gate_msa, c_shift, c_scale, c_gate = [
        m.to(x.dtype) for m in torch.chunk(mod, 6, dim=1)
    ]
    h = rms_norm(p["self_attn_norm"]["weight"], x, cfg.rms_norm_eps)
    h = h * (1 + scale_msa) + shift_msa
    h = self_attention(p["self_attn"], cfg, h, cos, sin, self_kv_mask, window, shards)
    x = x + h * gate_msa
    h = rms_norm(p["cross_attn_norm"]["weight"], x, cfg.rms_norm_eps)
    x = x + attention_block(p["cross_attn"], cfg, h, kv_mask=cross_kv_mask, kv=cross_kv, tp_sum=tp_sum)
    h = rms_norm(p["mlp_norm"]["weight"], x, cfg.rms_norm_eps)
    h = h * (1 + c_scale) + c_shift
    return x + mlp_swiglu(p["mlp"], h, tp_sum) * c_gate


def self_attention(
    p: Params,
    cfg: AceStepConfig,
    x: torch.Tensor,  # (B, L_local, D)
    cos: torch.Tensor,  # (L, head_dim), the whole sequence's
    sin: torch.Tensor,
    kv_mask: Optional[torch.Tensor],  # (B, L), the whole sequence's
    window: Optional[int],
    shards: Optional[Shards] = None,
) -> torch.Tensor:
    """A DiT layer's self-attention on this rank's rows. Over sp ranks a
    full layer gathers K and V of the whole sequence (after rope, at global
    positions) for its local queries; a sliding layer extends x by `window`
    rows of its neighbours on each side (zeros, masked, past the ends), runs
    the band on the extended rows and keeps the middle ones."""
    tp_sum = shards.tp_sum if shards is not None else None
    if shards is None or shards.sp == 1:
        return attention_block(p, cfg, x, cos=cos, sin=sin, kv_mask=kv_mask, window=window, tp_sum=tp_sum)
    b, l = x.shape[:2]
    start, total = shards.sp_rank * l, shards.sp * l
    if window is None:
        q, k, v = _self_qkv(p, cfg, x, cos[start:start + l], sin[start:start + l])
        kv = shards.sp_gather(torch.stack([k, v]), dim=2)  # (2, B, L, Nkv, head_dim)
        out = attention(q, kv[0], kv[1], kv_mask=kv_mask, scale=cfg.head_dim**-0.5)
    else:
        xe = halo_extend(x, shards.sp_list(halo_edges(x, window)), shards.sp_rank, window)
        rows, inside = halo_rows(start, l, window, total, device=x.device)
        q, k, v = _self_qkv(p, cfg, xe, cos[rows], sin[rows])
        out = attention(q, k, v, kv_mask=halo_mask(kv_mask, inside, start, window, b), window=window,
                        scale=cfg.head_dim**-0.5)[:, window:window + l]
    return linear_rowwise(p["o_proj"], out.reshape(b, l, -1), tp_sum)


def precompute_cross_kv(p_decoder: Params, cfg: AceStepConfig, encoder_hidden_states):
    """condition_embedder + per-layer cross K/V (a list of (k, v))."""
    enc = linear(p_decoder["condition_embedder"], encoder_hidden_states)
    return [cross_attention_kv(lp["cross_attn"], cfg, enc) for lp in p_decoder["layers"]]


def dit_forward(
    p: Params,  # decoder params
    cfg: AceStepConfig,
    xt: torch.Tensor,  # (B, T, 64)
    timestep: torch.Tensor,  # (B,)
    timestep_r: torch.Tensor,  # (B,)
    context_latents: torch.Tensor,  # (B, T, 128)
    cross_kvs: Sequence[Tuple[torch.Tensor, torch.Tensor]],
    *,
    encoder_mask: Optional[torch.Tensor] = None,  # (B, L_enc)
    latent_mask: Optional[torch.Tensor] = None,  # (B, T)
    shards: Optional[Shards] = None,
) -> torch.Tensor:
    """One denoise forward pass -> velocity (B, T, 64). Under sequence
    parallelism xt and context_latents are this rank's frames (a multiple of
    patch_size) and latent_mask is the whole sequence's; the velocity is
    this rank's frames."""
    temb_t, proj_t = timestep_embedding(p["time_embed"], timestep)
    temb_r, proj_r = timestep_embedding(p["time_embed_r"], timestep - timestep_r)
    temb = temb_t + temb_r
    tproj = proj_t + proj_r

    h = torch.cat([context_latents, xt], dim=-1)
    orig_len = h.shape[1]
    pad = (-orig_len) % cfg.patch_size
    if pad:
        h = F.pad(h, (0, 0, 0, pad))
    h = conv1d(h, p["proj_in"]["kernel"], p["proj_in"].get("bias"), stride=cfg.patch_size)
    total = h.shape[1] * (shards.sp if shards is not None else 1)
    cos, sin = rope_cos_sin(total, cfg.head_dim, cfg.rope_theta, device=h.device)

    patched_mask = None
    if latent_mask is not None:
        pm = F.pad(latent_mask, (0, (-latent_mask.shape[1]) % cfg.patch_size))
        patched_mask = pm.reshape(pm.shape[0], total, cfg.patch_size).amax(dim=-1)

    for i, lp in enumerate(p["layers"]):
        h = dit_layer(lp, cfg, h, cos, sin, tproj, patched_mask, _window(cfg, i), encoder_mask, cross_kvs[i],
                      shards)

    mod = p["scale_shift_table"].float() + temb.float()[:, None]
    shift, scale = [m.to(h.dtype) for m in torch.chunk(mod, 2, dim=1)]
    h = rms_norm(p["norm_out"]["weight"], h, cfg.rms_norm_eps) * (1 + scale) + shift
    h = conv_transpose1d(h, p["proj_out"]["kernel"], p["proj_out"].get("bias"), stride=cfg.patch_size)
    return h[:, :orig_len, :]


def _layer_params_at(layers, idx: int) -> Params:
    """One layer's parameters (the port's layers are a per-layer list)."""
    return layers[idx]


def dit_cross_attention_capture(
    p: Params,  # decoder params
    cfg: AceStepConfig,
    xt: torch.Tensor,  # (B, T, 64)
    timestep: torch.Tensor,  # (B,)
    context_latents: torch.Tensor,  # (B, T, 128)
    encoder_hidden_states: torch.Tensor,  # (B, L_enc, D), the condition encoder's output
    encoder_mask: Optional[torch.Tensor],
    capture_layers: Sequence[int],
    shards: Optional[Shards] = None,
) -> Dict[int, torch.Tensor]:
    """Run the decoder up to max(capture_layers) and return the cross-attention
    probabilities {layer: (B, heads, L_enc, L_patched)} for the LRC alignment,
    in (text, audio) orientation. Under tensor parallelism (`shards`, whose
    time axis is whole) each rank computes its local heads, gathered over
    the tp ranks into the global order.

    At a captured layer the pre-cross hidden state is recomputed: AdaLN
    modulation, the self-attention through `attention_block` (the flash
    kernel on the card at >= 256 patched frames), the gated residual and the
    cross-attention norm. The scores are an fp32 einsum of the cross q and k
    with a masked fp32 softmax, as in the JAX package; no kernel computes
    them there either. The layers then run as in `dit_forward`, without a
    latent mask.
    """
    _, proj_t = timestep_embedding(p["time_embed"], timestep)
    _, proj_r = timestep_embedding(p["time_embed_r"], timestep - timestep)
    tproj = proj_t + proj_r
    enc = linear(p["condition_embedder"], encoder_hidden_states)

    h = torch.cat([context_latents, xt], dim=-1)
    pad = (-h.shape[1]) % cfg.patch_size
    if pad:
        h = F.pad(h, (0, 0, 0, pad))
    h = conv1d(h, p["proj_in"]["kernel"], p["proj_in"].get("bias"), stride=cfg.patch_size)
    cos, sin = rope_cos_sin(h.shape[1], cfg.head_dim, cfg.rope_theta, device=h.device)

    captured: Dict[int, torch.Tensor] = {}
    for i in range(max(capture_layers) + 1):
        lp = _layer_params_at(p["layers"], i)
        if i in capture_layers:
            mod = lp["scale_shift_table"].float() + tproj.float()
            shift_msa, scale_msa, gate_msa = [m.to(h.dtype) for m in torch.chunk(mod, 6, dim=1)[:3]]
            hn = rms_norm(lp["self_attn_norm"]["weight"], h, cfg.rms_norm_eps)
            hn = hn * (1 + scale_msa) + shift_msa
            attn_out = attention_block(lp["self_attn"], cfg, hn, cos=cos, sin=sin, window=_window(cfg, i),
                                       tp_sum=shards.tp_sum if shards is not None else None)
            hq = rms_norm(lp["cross_attn_norm"]["weight"], h + attn_out * gate_msa, cfg.rms_norm_eps)
            ca = lp["cross_attn"]
            q = _split_heads(linear(ca["q_proj"], hq), cfg.head_dim)
            q = rms_norm(ca["q_norm"]["weight"], q, cfg.rms_norm_eps)
            k, _ = cross_attention_kv(ca, cfg, enc)
            kq = k.repeat_interleave(cfg.num_attention_heads // cfg.num_key_value_heads, dim=2)
            scores = torch.einsum("bqnh,bsnh->bnqs", q.float(), kq.float()) * (cfg.head_dim**-0.5)
            if encoder_mask is not None:
                keep = encoder_mask.to(torch.bool)[:, None, None, :]
                scores = scores.masked_fill(~keep, torch.finfo(torch.float32).min)
            probs = torch.softmax(scores, dim=-1).transpose(2, 3)  # (B, heads, L_enc, L_audio)
            captured[i] = probs if shards is None else shards.tp_gather(probs.contiguous(), dim=1)
        kv = cross_attention_kv(lp["cross_attn"], cfg, enc)
        h = dit_layer(lp, cfg, h, cos, sin, tproj, None, _window(cfg, i), encoder_mask, kv, shards)
    return captured


# ---------------------------------------------------------------------------
# Guidance: plain CFG, APG, ADG (plain tensor functions, as in the JAX package)
# ---------------------------------------------------------------------------


def cfg_forward(cond: torch.Tensor, uncond: torch.Tensor, scale: float) -> torch.Tensor:
    return uncond + scale * (cond - uncond)


def _norm(x: torch.Tensor, dim: int, seq_sum: Optional[Callable] = None) -> torch.Tensor:
    """The L2 norm over `dim`; with `seq_sum`, of a slice of that axis: the
    fp32 sum of squares is summed over the ranks that hold the others."""
    if seq_sum is None:
        return torch.linalg.vector_norm(x, dim=dim, keepdim=True)
    return torch.sqrt(seq_sum((x * x).sum(dim=dim, keepdim=True)))


def apg_forward(
    pred_cond: torch.Tensor,
    pred_uncond: torch.Tensor,
    guidance_scale: float,
    running_avg: torch.Tensor,
    *,
    momentum: float = -0.75,
    eta: float = 0.0,
    norm_threshold: float = 2.5,
    dim: int = 1,
    seq_sum: Optional[Callable] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """APG with the momentum buffer (fp32) carried by the caller; the norms
    run over `dim` 1, the time axis of (B, T, 64). Under sequence
    parallelism the inputs are this rank's frames and `seq_sum` sums the
    norms' squares and the dot product over the sp ranks. Returns (guided,
    new_avg)."""
    diff = (pred_cond - pred_uncond).float()
    new_avg = diff + momentum * running_avg
    diff = new_avg
    if norm_threshold > 0:
        diff = diff * torch.clamp(norm_threshold / torch.clamp(_norm(diff, dim, seq_sum), min=1e-12), max=1.0)
    v1 = pred_cond.float()
    v1n = v1 / torch.clamp(_norm(v1, dim, seq_sum), min=1e-12)
    dot = (diff * v1n).sum(dim=dim, keepdim=True)
    parallel = (dot if seq_sum is None else seq_sum(dot)) * v1n
    update = (diff - parallel) + eta * parallel
    scale = float(np.float32(guidance_scale) - np.float32(1.0))
    return pred_cond + (scale * update).to(pred_cond.dtype), new_avg


def adg_forward(
    latents: torch.Tensor,
    pred_cond: torch.Tensor,
    pred_uncond: torch.Tensor,
    sigma: float,
    guidance_scale: float,
    *,
    angle_clip: float = 3.14 / 6,
) -> torch.Tensor:
    """Angle-based dynamic guidance, in fp32 with one cast at the end. Every
    (batch, frame) row is its own 64-vector, so any batch size works (the
    original system's version takes batch 1 only)."""
    n, t, c = pred_cond.shape
    sig = float(np.float32(sigma))
    x = latents.float()
    gs1 = np.float32(guidance_scale) - np.float32(1.0)
    weight = float(gs1 * np.float32(gs1 > 0) + np.float32(1e-3))
    hat_c = x - sig * pred_cond.float()
    hat_u = x - sig * pred_uncond.float()
    diff = hat_c - hat_u

    fc = hat_c.reshape(-1, c)
    fu = hat_u.reshape(-1, c)
    cosv = (fc / torch.clamp(_norm(fc, 1), min=1e-12) * fu / torch.clamp(_norm(fu, 1), min=1e-12)).sum(
        dim=1, keepdim=True
    )
    theta = torch.arccos(torch.clamp(cosv, -1.0, 1.0))
    clip = float(np.float32(angle_clip))
    theta_new = torch.clamp(weight * theta, -clip, clip)

    fd = diff.reshape(-1, c)
    dot = (fd * fu).sum(dim=1, keepdim=True)
    nsq = (fu * fu).sum(dim=1, keepdim=True)
    perp = fd - (dot / (nsq + 1e-8)) * fu

    sin_theta = torch.sin(theta)
    big = sin_theta > 1e-3
    v_new = torch.cos(theta_new) * fc
    p_new = torch.where(
        big, perp * torch.sin(theta_new) / torch.where(big, sin_theta, torch.ones_like(sin_theta)), perp * weight
    )
    latent_new = (v_new + p_new).reshape(n, t, c)
    return ((x - latent_new) / sig).to(latents.dtype)


# ---------------------------------------------------------------------------
# Schedules, noise, denoise loop, generation
# ---------------------------------------------------------------------------


def prepare_noise(
    shape: Tuple[int, int, int], seeds: Sequence[int], dtype=torch.bfloat16, device=None
) -> torch.Tensor:
    """Per-sample seeded Gaussian noise from one CPU `torch.Generator` per seed.

    The numbers differ from `jax.random` for the same seed (a deliberate
    deviation); they are the same on the CPU and on the card.
    """
    _, t, d = shape
    rows = []
    for s in seeds:
        g = torch.Generator(device="cpu").manual_seed(int(s) & 0x7FFFFFFF)
        rows.append(torch.randn((t, d), generator=g, dtype=torch.float32))
    return torch.stack(rows).to(device=device, dtype=dtype)


def build_t_schedule(shift: float = 3.0, timesteps: Optional[Sequence[float]] = None) -> List[float]:
    """Turbo discrete schedule: snap custom timesteps to the valid set."""
    if timesteps is not None:
        ts = [float(t) for t in timesteps]
        while ts and ts[-1] == 0:
            ts.pop()
        ts = ts[:20]
        if ts:
            return [min(VALID_TIMESTEPS, key=lambda v: abs(v - t)) for t in ts]
    shift = min(SHIFT_TIMESTEPS.keys(), key=lambda v: abs(v - shift))
    return list(SHIFT_TIMESTEPS[shift])


def build_linspace_schedule(infer_steps: int, shift: float = 1.0) -> List[float]:
    """Base-model continuous schedule without the terminal 0."""
    t = np.linspace(1.0, 0.0, infer_steps + 1)
    if shift != 1.0:
        t = shift * t / (1 + (shift - 1) * t)
    return [float(v) for v in t[:-1]]


def denoise(
    decoder_params: Params,
    cfg: AceStepConfig,
    xt: torch.Tensor,  # (B, T, 64) initial state
    schedule: Sequence[float],
    context_latents: torch.Tensor,
    cross_kvs,
    encoder_mask: Optional[torch.Tensor],
    latent_mask: Optional[torch.Tensor],
    t_after: float = 0.0,
    *,
    null_cross_kvs=None,
    null_encoder_mask: Optional[torch.Tensor] = None,
    infer_method: str = "ode",
    guidance_scale: float = 1.0,
    use_adg: bool = False,
    cfg_interval_start: float = 0.0,
    cfg_interval_end: float = 1.0,
    sde_noise: Optional[Callable[[int], torch.Tensor]] = None,
    shards: Optional[Shards] = None,
) -> torch.Tensor:
    """One segment of a trajectory over `schedule` (it goes on at `t_after`);
    under sequence parallelism xt, context_latents and each step's noise
    are this rank's frames (`shards`).

    ODE: x <- x - v(x, t) * (t - t_next). SDE: x <- t_next * noise +
    (1 - t_next) * (x - v * t) while t_next > 0, the clean prediction at the
    end; `sde_noise(i)` gives step i's fp32 noise. With `null_cross_kvs` each
    step runs a second forward on the null condition (two calls, not a
    doubled batch) and, where float32 t lies in [cfg_interval_start,
    cfg_interval_end], replaces v by APG (momentum from zero in each
    segment, kept unchanged outside the interval) or ADG."""
    t_sched = np.asarray(schedule, np.float32)
    t_next = np.asarray(list(schedule[1:]) + [t_after], np.float32)
    lo, hi = np.float32(cfg_interval_start), np.float32(cfg_interval_end)
    b = xt.shape[0]
    dtype, dev = xt.dtype, xt.device

    def fwd(t_curr, kvs, mask):
        tvec = torch.full((b,), float(t_curr), dtype=torch.float32, device=dev)
        return dit_forward(
            decoder_params, cfg, xt, tvec, tvec, context_latents, kvs,
            encoder_mask=mask, latent_mask=latent_mask, shards=shards,
        )

    def scalar(v) -> float:
        """A float32 value rounded to the latent dtype, as a Python number: a
        tensor op with it computes as with the rounded 0-d tensor, and no
        host-to-device copy (a synchronisation) is made per step."""
        return float(torch.tensor(float(v), dtype=torch.float32).to(dtype))

    momentum = torch.zeros(xt.shape, dtype=torch.float32, device=dev) if null_cross_kvs is not None else None
    seq_sum = shards.sp_sum if shards is not None and shards.sp > 1 else None
    for i, (t_curr, t_nxt) in enumerate(zip(t_sched, t_next)):
        vt = fwd(t_curr, cross_kvs, encoder_mask)
        if null_cross_kvs is not None:
            vt_null = fwd(t_curr, null_cross_kvs, null_encoder_mask)
            if lo <= t_curr <= hi:
                if use_adg:
                    vt = adg_forward(xt, vt, vt_null, t_curr, guidance_scale)
                else:
                    vt, momentum = apg_forward(vt, vt_null, guidance_scale, momentum, seq_sum=seq_sum)
        if infer_method == "sde":
            pred_clean = xt - vt * scalar(t_curr)
            if t_nxt > 0:
                noise = sde_noise(i).to(device=dev, dtype=dtype)
                xt = scalar(t_nxt) * noise + scalar(np.float32(1.0) - t_nxt) * pred_clean
            else:
                xt = pred_clean
        else:
            xt = xt - vt * scalar(t_curr - t_nxt)
        xt = xt.to(dtype)
    return xt


def _sde_seed(seed: int, step: int) -> int:
    """The SDE generator's seed for a segment that starts at `step` (JAX folds
    the step into PRNGKey(seed) the same way)."""
    return ((int(seed) & 0x7FFFFFFF) << 16) + int(step)


def generate_audio(
    params: Params,
    cfg: AceStepConfig,
    *,
    text_hidden_states,
    text_attention_mask,
    lyric_hidden_states,
    lyric_attention_mask,
    refer_packed,
    refer_order_mask,
    src_latents,
    chunk_masks,
    is_covers,
    silence_latent: Optional[torch.Tensor] = None,
    attention_mask: Optional[torch.Tensor] = None,
    seeds: Optional[Sequence[int]] = None,
    shift: float = 3.0,
    timesteps: Optional[Sequence[float]] = None,
    infer_method: str = "ode",
    audio_cover_strength: float = 1.0,
    cover_noise_strength: float = 0.0,
    non_cover_text_hidden_states: Optional[torch.Tensor] = None,
    non_cover_text_attention_mask: Optional[torch.Tensor] = None,
    precomputed_lm_hints_25hz: Optional[torch.Tensor] = None,
    audio_codes: Optional[torch.Tensor] = None,
    guidance_scale: float = 1.0,
    use_adg: bool = False,
    cfg_interval_start: float = 0.0,
    cfg_interval_end: float = 1.0,
    infer_steps: Optional[int] = None,
    max_refs: int = 1,
    return_condition: bool = False,
    noise: Optional[torch.Tensor] = None,  # injection hook (tests)
    sde_noise: Optional[Sequence[torch.Tensor]] = None,  # injection hook: step i's SDE noise
    sde_rows: Optional[Tuple[int, int, int, int]] = None,
    shards: Optional[Shards] = None,
) -> Dict[str, Any]:
    """Turbo or base generation: prepare_condition, cross K/V once per
    segment, the denoise loop (ODE or SDE).

    With `cover_noise_strength` > 0 the trajectory starts at the schedule
    step nearest 1 - strength, from that mix of noise and the source
    latents. With `audio_cover_strength` < 1 the steps from
    int(steps * strength) on run a second condition: the source replaced by
    silence, no cover rows, and the `non_cover_text_*` prompt when given.
    With `guidance_scale` > 1 each segment also builds the null condition
    (`null_condition_emb` broadcast to its encoder states, its own mask) for
    CFG. SDE noise comes from a `torch.Generator` on the latents' device,
    seeded per segment from seeds[0] and the segment's first step, unless
    `sde_noise` gives each step's noise (indexed over the whole schedule).
    `sde_rows = (first, stop, batch, seed)` says that these inputs are rows
    first:stop of a request of `batch` rows whose first seed is `seed` (a
    rank's share under data parallelism): each SDE step's noise, drawn from
    that seed or injected, is the whole request's, and these rows are kept.
    Under a mesh (`shards`) the decoder runs on this rank's tp shard and,
    where the length divides by sp·patch_size, on its slice of the latent
    frames: the noise, the source mix and the context are drawn or built
    whole and sliced, and the final latents are gathered whole again."""
    if infer_method not in ("ode", "sde"):
        raise ValueError(f"infer_method must be 'ode' or 'sde', not {infer_method!r}")
    if cfg.model_version == "turbo" and infer_steps is None:
        schedule = build_t_schedule(shift, timesteps)
    elif infer_steps is not None:
        schedule = build_linspace_schedule(infer_steps, shift)
    else:
        schedule = build_t_schedule(shift, timesteps)

    cond = dict(
        lyric_hidden_states=lyric_hidden_states,
        lyric_attention_mask=lyric_attention_mask,
        refer_packed=refer_packed,
        refer_order_mask=refer_order_mask,
        chunk_masks=chunk_masks,
        silence_latent=silence_latent,
        max_refs=max_refs,
    )
    enc, enc_mask, context_latents = prepare_condition(
        params, cfg, **cond,
        text_hidden_states=text_hidden_states,
        text_attention_mask=text_attention_mask,
        src_latents=src_latents,
        is_covers=is_covers,
        precomputed_lm_hints_25hz=precomputed_lm_hints_25hz,
        audio_codes=audio_codes,
    )
    b, t, d = src_latents.shape
    seeds = list(seeds) if seeds is not None else list(range(b))
    if noise is None:
        noise = prepare_noise((b, t, d), seeds, src_latents.dtype, src_latents.device)
    noise = noise.to(device=src_latents.device, dtype=src_latents.dtype)
    if shards is not None:
        shards = shards.for_length(t, cfg.patch_size)
    split = shards is not None and shards.sp > 1
    frames = shards.frames(t) if split else slice(0, t)

    if cover_noise_strength > 0.0:
        nearest = min(schedule, key=lambda v: abs(v - (1.0 - cover_noise_strength)))
        schedule = schedule[schedule.index(nearest):]
        xt = nearest * noise[:, frames] + (1.0 - nearest) * src_latents[:, frames]
    else:
        xt = noise[:, frames]

    num_steps = len(schedule)
    segments = [(0, num_steps, enc, enc_mask, context_latents)]
    cover_steps = int(num_steps * audio_cover_strength)
    if audio_cover_strength < 1.0 and cover_steps < num_steps:
        if silence_latent is None:
            raise ValueError("audio_cover_strength < 1 needs the silence latent")
        sil = silence_latent[:, :t, :].expand(b, t, d).to(src_latents.dtype)
        # No cover rows: the hints go unused, so the silence stands in for them.
        nc = prepare_condition(
            params, cfg, **cond,
            text_hidden_states=(non_cover_text_hidden_states if non_cover_text_hidden_states is not None
                                else text_hidden_states),
            text_attention_mask=(non_cover_text_attention_mask if non_cover_text_attention_mask is not None
                                 else text_attention_mask),
            src_latents=sil,
            is_covers=torch.zeros_like(is_covers),
            precomputed_lm_hints_25hz=sil,
        )
        segments = [(0, cover_steps, enc, enc_mask, context_latents), (cover_steps, num_steps, *nc)]

    dec = params["decoder"]
    use_cfg = guidance_scale > 1.0
    for s0, s1, seg_enc, seg_mask, seg_ctx in segments:
        if s1 <= s0:
            continue
        kvs = precompute_cross_kv(dec, cfg, seg_enc)
        null_kvs = None
        if use_cfg:
            null_states = params["null_condition_emb"].to(seg_enc.dtype).expand(seg_enc.shape)
            null_kvs = precompute_cross_kv(dec, cfg, null_states)
        step_noise = None
        if infer_method == "sde":
            first, stop, batch, seed = sde_rows or (0, b, b, seeds[0])
            if sde_noise is not None:
                step_noise = lambda i, s0=s0: sde_noise[s0 + i][first:stop, frames]
            else:
                gen = torch.Generator(device=xt.device).manual_seed(_sde_seed(seed, s0))
                step_noise = lambda i, gen=gen, shape=(batch, t, d), dev=xt.device: torch.randn(
                    shape, generator=gen, dtype=torch.float32, device=dev)[first:stop, frames]
        xt = denoise(dec, cfg, xt, schedule[s0:s1], seg_ctx[:, frames], kvs, seg_mask, attention_mask,
                     t_after=schedule[s1] if s1 < num_steps else 0.0,
                     null_cross_kvs=null_kvs, null_encoder_mask=seg_mask if use_cfg else None,
                     infer_method=infer_method, guidance_scale=guidance_scale, use_adg=use_adg,
                     cfg_interval_start=cfg_interval_start, cfg_interval_end=cfg_interval_end,
                     sde_noise=step_noise, shards=shards)
    if split:
        xt = shards.sp_gather(xt)
    out = {"target_latents": xt, "num_steps": num_steps}
    if return_condition:
        out["condition"] = {
            "encoder_hidden_states": enc,
            "encoder_attention_mask": enc_mask,
            "context_latents": context_latents,
        }
    return out
