"""The yardstick: the card's peaks, the roofline bound, and the operations
and bytes of each layer, counted from the request shapes.

The peaks and `bound_ms` are frozen copies of `chip_smoke.py`'s (NVIDIA's
H100 SXM data sheet, dense). A product of two (m, k) x (k, n) operands counts
2mkn operations; attention counts 4 operations a head dimension for each
(query, key) pair its mask allows (QK^T and PV); a convolution 2 K C_in C_out
a output position; elementwise work counts none. Bytes count each input and
weight read once and each output written once.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import numpy as np

PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12
PEAK_F32_FLOPS = 67e12
PEAK_TF32_FLOPS = 495e12


def bound_ms(flops: float, nbytes: float, peak_flops: float = PEAK_BF16_FLOPS) -> tuple:
    """The least time the card could take: operations at the peak or bytes
    at the bandwidth, whichever is longer, and which one it was."""
    t_ops, t_bytes = flops / peak_flops, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def allowed_pairs(lq: int, lk: int, valid_keys: Sequence[int], *, window: Optional[int] = None,
                  causal: bool = False) -> int:
    """(query, key) pairs a mask allows over a batch: keys [0, valid) of each
    row (right padding), |i - j| <= window, and j <= i when causal."""
    i = np.arange(lq, dtype=np.int64)
    total = 0
    for valid in valid_keys:
        hi = np.full(lq, min(lk, int(valid)) - 1, np.int64)
        lo = np.zeros(lq, np.int64)
        if causal:
            hi = np.minimum(hi, i)
        if window is not None:
            hi = np.minimum(hi, i + window)
            lo = np.maximum(lo, i - window)
        total += int(np.clip(hi - lo + 1, 0, None).sum())
    return total


def attention_flops(pairs: int, heads: int, head_dim: int) -> float:
    return 4.0 * pairs * heads * head_dim


def attention_bytes(b: int, lq: int, lk: int, nq: int, nkv: int, head_dim: int, elem: int = 2,
                    masked: bool = True) -> float:
    """q, k, v read, out written, the int32 key mask read."""
    return float(elem * head_dim * (2 * b * lq * nq + 2 * b * lk * nkv) + (4 * b * lk if masked else 0))


def _layer_linear(d: int, inter: int, nq: int, nkv: int, hd: int) -> float:
    """Operations of one token through q, k, v, o and a SwiGLU MLP."""
    return 2.0 * (d * nq * hd + 2 * d * nkv * hd + nq * hd * d) + 6.0 * d * inter


def encoder_stack_flops(cfg: Dict[str, Any], n_layers: int, l: int, valid: Sequence[int]) -> float:
    """Bidirectional layers over (len(valid), l) tokens, windowed on even layers."""
    b, hd, nq = len(valid), cfg["head_dim"], cfg["num_attention_heads"]
    lin = _layer_linear(cfg["hidden_size"], cfg["intermediate_size"], nq, cfg["num_key_value_heads"], hd)
    total = 0.0
    for i in range(n_layers):
        window = cfg["sliding_window"] if cfg["use_sliding_window"] and (i + 1) % 2 else None
        total += b * l * lin + attention_flops(allowed_pairs(l, l, valid, window=window), nq, hd)
    return total


def text_encoder_flops(tcfg: Dict[str, Any], b: int, l: int) -> float:
    """Qwen3 over (b, l) tokens, causal, no key mask."""
    hd, nq = tcfg["head_dim"], tcfg["num_attention_heads"]
    lin = _layer_linear(tcfg["hidden_size"], tcfg["intermediate_size"], nq, tcfg["num_key_value_heads"], hd)
    pairs = allowed_pairs(l, l, [l] * b, causal=True)
    return tcfg["num_hidden_layers"] * (b * l * lin + attention_flops(pairs, nq, hd))


def condition_flops(cfg: Dict[str, Any], text_len: int, lyric_len: int, lyric_valid: Sequence[int]) -> float:
    """Text projector, lyric encoder, timbre encoder (one silence reference a row)."""
    b, d = len(lyric_valid), cfg["hidden_size"]
    tf = cfg["timbre_fix_frame"]
    f = 2.0 * b * text_len * cfg["text_hidden_dim"] * d
    f += 2.0 * b * lyric_len * cfg["text_hidden_dim"] * d
    f += encoder_stack_flops(cfg, cfg["num_lyric_encoder_hidden_layers"], lyric_len, lyric_valid)
    f += 2.0 * b * tf * cfg["timbre_hidden_dim"] * d
    f += encoder_stack_flops(cfg, cfg["num_timbre_encoder_hidden_layers"], tf, [tf] * b)
    return f


def cross_kv_flops(cfg: Dict[str, Any], b: int, l_enc: int) -> float:
    """The condition embedder and every layer's cross K and V, once a condition."""
    d, kv = cfg["hidden_size"], cfg["num_key_value_heads"] * cfg["head_dim"]
    return 2.0 * b * l_enc * (d * d + cfg["num_hidden_layers"] * 2 * d * kv)


def dit_forward_flops(cfg: Dict[str, Any], b: int, t: int, enc_valid: Sequence[int]) -> float:
    """One decoder forward over (b, t) latent frames: patch in, the layers
    (self-attention windowed on even layers, cross-attention onto the valid
    condition tokens), patch out; the timestep embeddings."""
    d, hd, nq, nkv = cfg["hidden_size"], cfg["head_dim"], cfg["num_attention_heads"], cfg["num_key_value_heads"]
    ps, lat = cfg["patch_size"], cfg["audio_acoustic_hidden_dim"]
    l = -(-t // ps)
    f = 2.0 * b * l * ps * cfg["in_channels"] * d + 2.0 * b * l * d * ps * lat
    f += 2 * 2.0 * b * (256 * d + d * d + d * 6 * d)
    self_lin = 2.0 * (d * nq * hd + 2 * d * nkv * hd + nq * hd * d)
    cross_lin = 2.0 * (d * nq * hd + nq * hd * d)
    mlp = 6.0 * d * cfg["intermediate_size"]
    cross_pairs = sum(l * int(v) for v in enc_valid)
    for i in range(cfg["num_hidden_layers"]):
        window = cfg["sliding_window"] if cfg["use_sliding_window"] and (i + 1) % 2 else None
        f += b * l * (self_lin + cross_lin + mlp)
        f += attention_flops(allowed_pairs(l, l, [l] * b, window=window), nq, hd)
        f += attention_flops(cross_pairs, nq, hd)
    return f


def vae_decode_flops(vcfg: Dict[str, Any], b: int, frames: int) -> float:
    """One `decode` call over (b, frames) latents: conv in, the five blocks
    (the transposed conv, 4 L_out C_in C_out; three residual units, 48 L_out
    C^2), conv out."""
    ch, cm = vcfg["decoder_channels"], (1,) + tuple(vcfg["channel_multiples"])
    ratios = tuple(reversed(vcfg["downsampling_ratios"]))
    n = len(ratios)
    l = frames
    f = 2.0 * l * 7 * vcfg["decoder_input_channels"] * ch * cm[-1]
    for i, s in enumerate(ratios):
        cin, cout = ch * cm[n - i], ch * cm[n - i - 1]
        l *= s
        f += 4.0 * l * cin * cout + 48.0 * l * cout * cout
    f += 2.0 * l * 7 * ch * vcfg["audio_channels"]
    return b * f


def vae_decoder_weight_bytes(vcfg: Dict[str, Any], elem: int = 4) -> float:
    ch, cm = vcfg["decoder_channels"], (1,) + tuple(vcfg["channel_multiples"])
    ratios = tuple(reversed(vcfg["downsampling_ratios"]))
    n = len(ratios)
    w = 7 * vcfg["decoder_input_channels"] * ch * cm[-1]
    for i, s in enumerate(ratios):
        cin, cout = ch * cm[n - i], ch * cm[n - i - 1]
        w += 2 * s * cin * cout + 3 * 8 * cout * cout
    w += 7 * ch * vcfg["audio_channels"]
    return float(elem * w)


def vae_decode_bytes(vcfg: Dict[str, Any], b: int, frames: int, elem: int = 2) -> float:
    """Latents read, weights read, the waveform written."""
    hop = int(np.prod(vcfg["downsampling_ratios"]))
    return (elem * b * frames * vcfg["decoder_input_channels"] + vae_decoder_weight_bytes(vcfg)
            + elem * b * frames * hop * vcfg["audio_channels"])


def decode_chunks(t: int, b: int) -> list:
    """The latent frames of each decode call of a (b, t) request: overlap-
    discard chunks of `core` frames plus 16 a side."""
    core = max(192, min(512, -(-t // 4), 4096 // max(b, 1)))
    core += (-core) % 8
    if t <= core:
        return [t]
    return [core + 32] * (-(-t // core))


def request_flops(config: Dict[str, Any], b: int, t: int, text_len: int, lyric_len: int,
                  lyric_valid: Sequence[int], enc_valid: Sequence[int]) -> Dict[str, float]:
    """Every layer of one text2music request, by layer."""
    cfg, sampler = config["dit"], config["sampler"]
    guided = sampler["guidance_scale"] > 1.0 and sampler["inference_steps"] > 8
    forwards = sampler["inference_steps"] * (2 if guided else 1)
    out = {
        "text_encoder": text_encoder_flops(config["text_encoder"], b, text_len),
        "condition": condition_flops(cfg, text_len, lyric_len, lyric_valid),
        "cross_kv": cross_kv_flops(cfg, 1, sum(int(v) for v in enc_valid)) * (2 if guided else 1),
        "dit": forwards * dit_forward_flops(cfg, b, t, enc_valid),
        "vae_decode": sum(vae_decode_flops(config["vae"], b, f) for f in decode_chunks(t, b)),
    }
    out["total"] = sum(out.values())
    return out
