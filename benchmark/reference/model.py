"""The plain reference of a text2music request: PyTorch in fp32, no kernels.

It follows the published model (ACE-Step v1.5: the Qwen3 text encoder, the
lyric and timbre condition encoders, the DiT with AdaLN, its turbo ODE
schedule or the base schedule with APG guidance, and the Oobleck VAE
decoder) from the weights and the request the benchmark made, and works out
again everything the program derives from them: the prompt text, its
byte-level tokens, the masks, the packed condition, the noise, the schedule,
the decode chunks and the int16 PCM. It imports nothing of the program.

Every product goes through `Precision.mm` / `Precision.conv`, which rounds
both operands: fp32 (TF32 off: set by `strict_fp32`) is the reference, fp8
(e4m3, one scale a tensor) the control that stands in for the program.
Attention runs one batch row and a block of heads at a time, the decode one
chunk and one row at a time, so that a 600 s request fits beside nothing
else on the card.
"""

from __future__ import annotations

import contextlib
import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

# Prompt formats and buckets of the text2music path (frozen copies).
SFT_GEN_PROMPT = "# Instruction\n{}\n\n# Caption\n{}\n\n# Metas\n{}<|endoftext|>\n"
TEXT2MUSIC_INSTRUCTION = "Fill the audio semantic mask based on the given conditions:"
TEXT_BUCKETS = (64, 128, 256)
LYRIC_BUCKETS = (64, 128, 256, 512, 1024, 2048)
LATENT_BUCKETS = (250, 500, 750, 1500, 2250, 3000, 4500, 6000, 7500, 15000)
TURBO_SHIFT_TIMESTEPS = {
    1.0: [1.0, 0.875, 0.75, 0.625, 0.5, 0.375, 0.25, 0.125],
    2.0: [1.0, 14 / 15, 6 / 7, 10 / 13, 2 / 3, 6 / 11, 0.4, 2 / 9],
    3.0: [1.0, 21 / 22, 0.9, 5 / 6, 0.75, 9 / 14, 0.5, 0.3],
}
LATENT_FPS = 25
DECODE_OVERLAP = 16
DILATIONS = (1, 3, 9)
FP8_MAX = 448.0


@contextlib.contextmanager
def strict_fp32():
    """fp32 products in fp32: TF32 off for matmuls and cuDNN while inside."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved[:2]
        torch.set_float32_matmul_precision(saved[2])


class Precision:
    """How the operands of every product are rounded: "fp32" (as they are),
    "bf16", or "fp8" (e4m3 with one scale a tensor, amax to 448)."""

    def __init__(self, mode: str = "fp32"):
        if mode not in ("fp32", "bf16", "fp8"):
            raise ValueError(mode)
        self.mode = mode

    def round(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        if self.mode == "fp32":
            return x
        if self.mode == "bf16":
            return x.to(torch.bfloat16).float()
        scale = x.abs().amax().clamp_min(1e-30) / FP8_MAX
        return (x / scale).to(torch.float8_e4m3fn).float() * scale

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return torch.matmul(self.round(a), self.round(b))

    def conv(self, x, w, **kw) -> torch.Tensor:
        return F.conv1d(self.round(x), self.round(w), **kw)

    def conv_t(self, x, w, **kw) -> torch.Tensor:
        return F.conv_transpose1d(self.round(x), self.round(w), **kw)


# ---------------------------------------------------------------------------
# Text: prompts and byte-level tokens
# ---------------------------------------------------------------------------


def pick_bucket(n: int, buckets) -> int:
    for b in buckets:
        if n <= b:
            return b
    return buckets[-1]


def tokenize(texts: Sequence[str], max_length: int, buckets) -> Tuple[np.ndarray, np.ndarray]:
    """Byte-level ids (byte + 3), cut to max_length, right-padded with 0 to a bucket."""
    seqs = [[b + 3 for b in t.encode("utf-8")][:max_length] for t in texts]
    l = pick_bucket(max(len(s) for s in seqs), buckets)
    ids = np.zeros((len(seqs), l), np.int64)
    mask = np.zeros((len(seqs), l), np.int64)
    for i, s in enumerate(seqs):
        n = min(len(s), l)
        ids[i, :n], mask[i, :n] = s[:n], 1
    return ids, mask


def prompt_texts(caption: str, lyrics: str, language: str, duration: float) -> Tuple[str, str]:
    metas = (f"- bpm: N/A\n- timesignature: N/A\n- keyscale: N/A\n"
             f"- duration: {int(max(10.0, min(float(duration), 600.0)))} seconds\n")
    text = SFT_GEN_PROMPT.format(TEXT2MUSIC_INSTRUCTION, caption, metas)
    lyric = f"# Languages\n{language}\n\n# Lyric\n{lyrics}<|endoftext|>"
    return text, lyric


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------


def f32(t: torch.Tensor) -> torch.Tensor:
    return t.float()


def rms_norm(w, x, eps):
    return f32(w) * (x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps))


def linear(pr: Precision, p, x):
    y = pr.mm(x, p["kernel"])
    return y + f32(p["bias"]) if "bias" in p else y


def rope(l: int, head_dim: int, theta: float, device) -> Tuple[torch.Tensor, torch.Tensor]:
    inv = 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float64, device=device) / head_dim))
    ang = torch.outer(torch.arange(l, dtype=torch.float64, device=device), inv)
    ang = torch.cat([ang, ang], dim=-1)
    return torch.cos(ang).float(), torch.sin(ang).float()


def apply_rope(x, cos, sin):  # x (B, L, N, H)
    half = x.shape[-1] // 2
    rot = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    return x * cos[:, None, :] + rot * sin[:, None, :]


def allowed(lq: int, lk: int, device, *, window=None, causal=False, kv_mask=None):
    """(B|1, Lq, Lk) bool: the keys each query may see, or None for all."""
    geom = None
    if window is not None or causal:
        d = torch.arange(lq, device=device)[:, None] - torch.arange(lk, device=device)[None, :]
        geom = torch.ones((lq, lk), dtype=torch.bool, device=device)
        if causal:
            geom &= d >= 0
        if window is not None:
            geom &= d.abs() <= window
        geom = geom[None]
    if kv_mask is not None:
        pad = kv_mask.bool()[:, None, :]
        geom = pad if geom is None else geom & pad
    return geom


def attention(pr: Precision, q, k, v, mask, heads_per_block: int = 4):
    """Softmax attention in fp32, grouped kv heads; q (B, Lq, Nq, H), k, v
    (B, Lk, Nkv, H), mask (B|1, Lq, Lk) or None. A masked-out score takes
    the least fp32 value, so a row with no key averages all keys."""
    b, lq, nq, h = q.shape
    groups = nq // k.shape[2]
    out = torch.empty((b, lq, nq, h), dtype=torch.float32, device=q.device)
    neg = torch.finfo(torch.float32).min
    for i in range(b):
        m = None if mask is None else mask[min(i, mask.shape[0] - 1)]
        for n0 in range(0, nq, heads_per_block):
            n1 = min(nq, n0 + heads_per_block)
            qi = q[i, :, n0:n1].transpose(0, 1)  # (n, Lq, H)
            kv_idx = torch.arange(n0, n1, device=q.device) // groups
            ki = k[i][:, kv_idx].transpose(0, 1)
            vi = v[i][:, kv_idx].transpose(0, 1)
            s = pr.mm(qi, ki.transpose(1, 2)) * (h ** -0.5)
            if m is not None:
                s = s.masked_fill(~m[None], neg)
            out[i, :, n0:n1] = pr.mm(torch.softmax(s, dim=-1), vi).transpose(0, 1)
    return out


def split(x, head_dim):
    return x.reshape(x.shape[0], x.shape[1], -1, head_dim)


def self_attention(pr, p, cfg, x, cos, sin, mask):
    hd, eps = cfg["head_dim"], cfg["rms_norm_eps"]
    q = rms_norm(p["q_norm"]["weight"], split(linear(pr, p["q_proj"], x), hd), eps)
    k = rms_norm(p["k_norm"]["weight"], split(linear(pr, p["k_proj"], x), hd), eps)
    v = split(linear(pr, p["v_proj"], x), hd)
    q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
    o = attention(pr, q, k, v, mask)
    return linear(pr, p["o_proj"], o.reshape(x.shape[0], x.shape[1], -1))


def mlp(pr, p, x):
    return linear(pr, p["down_proj"], F.silu(linear(pr, p["gate_proj"], x)) * linear(pr, p["up_proj"], x))


def sliding(cfg, i: int) -> Optional[int]:
    """Layer i is windowed when (i + 1) is odd, as the published config says."""
    return cfg["sliding_window"] if cfg["use_sliding_window"] and (i + 1) % 2 else None


# ---------------------------------------------------------------------------
# Text encoder and condition encoders
# ---------------------------------------------------------------------------


def text_encoder(pr, tp, tcfg, ids: torch.Tensor) -> torch.Tensor:
    """Qwen3 last hidden state, causal, no key mask (the text encoder's role)."""
    x = f32(tp["embed_tokens"]["weight"])[ids]
    cos, sin = rope(x.shape[1], tcfg["head_dim"], tcfg["rope_theta"], x.device)
    mask = allowed(x.shape[1], x.shape[1], x.device, causal=True)
    for lp in tp["layers"]:
        h = rms_norm(lp["input_layernorm"]["weight"], x, tcfg["rms_norm_eps"])
        x = x + self_attention(pr, lp["self_attn"], tcfg, h, cos, sin, mask)
        h = rms_norm(lp["post_attention_layernorm"]["weight"], x, tcfg["rms_norm_eps"])
        x = x + mlp(pr, lp["mlp"], h)
    return rms_norm(tp["norm"]["weight"], x, tcfg["rms_norm_eps"])


def encoder_stack(pr, p, cfg, x, seq_mask):
    """Bidirectional layers, windowed on alternate layers, then the norm."""
    eps, l = cfg["rms_norm_eps"], x.shape[1]
    cos, sin = rope(l, cfg["head_dim"], cfg["rope_theta"], x.device)
    for i, lp in enumerate(p["layers"]):
        mask = allowed(l, l, x.device, window=sliding(cfg, i), kv_mask=seq_mask)
        h = rms_norm(lp["input_layernorm"]["weight"], x, eps)
        x = x + self_attention(pr, lp["self_attn"], cfg, h, cos, sin, mask)
        h = rms_norm(lp["post_attention_layernorm"]["weight"], x, eps)
        x = x + mlp(pr, lp["mlp"], h)
    return rms_norm(p["norm"]["weight"], x, eps)


def pack(h1, h2, m1, m2):
    """Concatenate two masked sequences with the valid tokens first, in order."""
    h = torch.cat([h1, h2], dim=1)
    m = torch.cat([m1, m2], dim=1).long()
    l = h.shape[1]
    pos = torch.arange(l, device=h.device)[None]
    order = torch.argsort((1 - m) * l + pos, dim=1)
    packed = torch.gather(h, 1, order[..., None].expand(-1, -1, h.shape[2]))
    return packed, (pos < m.sum(dim=1, keepdim=True)).long()


def condition(pr, dp, cfg, text_hidden, text_mask, lyric_embeds, lyric_mask, refs):
    """The packed condition (B, L_enc, D) and its mask: lyric, timbre, text.
    `refs` (B, T_ref, 64) is one timbre reference a row."""
    enc = dp["encoder"]
    text = linear(pr, enc["text_projector"], text_hidden)
    le = enc["lyric_encoder"]
    lyric = encoder_stack(pr, le, cfg, linear(pr, le["embed_tokens"], lyric_embeds), lyric_mask)
    te = enc["timbre_encoder"]
    timbre = encoder_stack(pr, te, cfg, linear(pr, te["embed_tokens"], refs), None)[:, :1, :]
    ones = torch.ones((timbre.shape[0], 1), dtype=torch.long, device=timbre.device)
    h, m = pack(lyric, timbre, lyric_mask, ones)
    return pack(h, text, m, text_mask)


# ---------------------------------------------------------------------------
# DiT
# ---------------------------------------------------------------------------


def timestep_embedding(pr, p, t: torch.Tensor):
    half = 128
    freqs = torch.exp(-math.log(10000.0) * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[:, None] * 1000.0 * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    temb = linear(pr, p["linear_2"], F.silu(linear(pr, p["linear_1"], emb)))
    proj = linear(pr, p["time_proj"], F.silu(temb))
    return temb, proj.reshape(t.shape[0], 6, -1)


def cross_kv(pr, dec, cfg, enc):
    e = linear(pr, dec["condition_embedder"], enc)
    hd, eps = cfg["head_dim"], cfg["rms_norm_eps"]
    out = []
    for lp in dec["layers"]:
        ca = lp["cross_attn"]
        k = rms_norm(ca["k_norm"]["weight"], split(linear(pr, ca["k_proj"], e), hd), eps)
        out.append((k, split(linear(pr, ca["v_proj"], e), hd)))
    return out


def dit_forward(pr, dec, cfg, xt, t: float, context, kvs, enc_mask, latent_mask):
    """The velocity (B, T, 64) at time t (timestep_r = t)."""
    b, t_len, _ = xt.shape
    hd, eps, ps = cfg["head_dim"], cfg["rms_norm_eps"], cfg["patch_size"]
    tvec = torch.full((b,), float(np.float32(t)), device=xt.device)
    temb_t, proj_t = timestep_embedding(pr, dec["time_embed"], tvec)
    temb_r, proj_r = timestep_embedding(pr, dec["time_embed_r"], tvec - tvec)
    temb, tproj = temb_t + temb_r, proj_t + proj_r
    h = torch.cat([context, xt], dim=-1)
    pad = (-t_len) % ps
    if pad:
        h = F.pad(h, (0, 0, 0, pad))
    pin = dec["proj_in"]
    h = pr.conv(h.transpose(1, 2), f32(pin["kernel"]).permute(2, 1, 0), stride=ps).transpose(1, 2) + f32(pin["bias"])
    l = h.shape[1]
    cos, sin = rope(l, hd, cfg["rope_theta"], xt.device)
    pm = F.pad(latent_mask, (0, (-latent_mask.shape[1]) % ps)).reshape(b, l, ps).amax(dim=-1)
    cross_mask = enc_mask.bool()[:, None, :].expand(b, l, enc_mask.shape[1])
    for i, lp in enumerate(dec["layers"]):
        mod = f32(lp["scale_shift_table"]) + tproj
        sh, sc, g, csh, csc, cg = torch.chunk(mod, 6, dim=1)
        a = rms_norm(lp["self_attn_norm"]["weight"], h, eps) * (1 + sc) + sh
        mask = allowed(l, l, xt.device, window=sliding(cfg, i), kv_mask=pm)
        h = h + self_attention(pr, lp["self_attn"], cfg, a, cos, sin, mask) * g
        a = rms_norm(lp["cross_attn_norm"]["weight"], h, eps)
        ca = lp["cross_attn"]
        q = rms_norm(ca["q_norm"]["weight"], split(linear(pr, ca["q_proj"], a), hd), eps)
        o = attention(pr, q, kvs[i][0], kvs[i][1], cross_mask)
        h = h + linear(pr, ca["o_proj"], o.reshape(b, l, -1))
        a = rms_norm(lp["mlp_norm"]["weight"], h, eps) * (1 + csc) + csh
        h = h + mlp(pr, lp["mlp"], a) * cg
    sh, sc = torch.chunk(f32(dec["scale_shift_table"]) + temb[:, None], 2, dim=1)
    h = rms_norm(dec["norm_out"]["weight"], h, eps) * (1 + sc) + sh
    po = dec["proj_out"]
    out = pr.conv_t(h.transpose(1, 2), f32(po["kernel"]).permute(1, 2, 0), stride=ps).transpose(1, 2)
    return (out + f32(po["bias"]))[:, :t_len]


def apg(cond, uncond, scale: float, avg, momentum=-0.75, norm_threshold=2.5):
    """Adaptive projected guidance over the time axis; returns (guided, avg)."""
    diff = cond - uncond
    avg = diff + momentum * avg
    d = avg * torch.clamp(norm_threshold / torch.clamp(torch.linalg.vector_norm(avg, dim=1, keepdim=True),
                                                       min=1e-12), max=1.0)
    v1n = cond / torch.clamp(torch.linalg.vector_norm(cond, dim=1, keepdim=True), min=1e-12)
    par = (d * v1n).sum(dim=1, keepdim=True) * v1n
    return cond + (scale - 1.0) * (d - par), avg


def schedule(sampler: Dict[str, Any]) -> List[float]:
    steps, shift = sampler["inference_steps"], float(sampler["shift"])
    if sampler["model_version"] == "turbo" and steps == 8:
        return list(TURBO_SHIFT_TIMESTEPS[min(TURBO_SHIFT_TIMESTEPS, key=lambda v: abs(v - shift))])
    t = np.linspace(1.0, 0.0, steps + 1)
    if shift != 1.0:
        t = shift * t / (1 + (shift - 1) * t)
    return [float(v) for v in t[:-1]]


def noise(seeds: Sequence[int], t: int, d: int) -> torch.Tensor:
    """One CPU generator a row, seeded with the row's seed's low 31 bits."""
    rows = []
    for s in seeds:
        g = torch.Generator(device="cpu").manual_seed(int(s) & 0x7FFFFFFF)
        rows.append(torch.randn((t, d), generator=g, dtype=torch.float32))
    return torch.stack(rows)


# ---------------------------------------------------------------------------
# VAE decoder
# ---------------------------------------------------------------------------


def snake(p, x):  # x (B, C, L)
    a = torch.exp(f32(p["alpha"]))[None, :, None]
    inv_b = 1.0 / (torch.exp(f32(p["beta"])) + 1e-9)[None, :, None]
    return x + inv_b * torch.sin(a * x) ** 2


def conv(pr, p, x, **kw):  # kernel (K, Ci, Co) -> (Co, Ci, K)
    y = pr.conv(x, f32(p["kernel"]).permute(2, 1, 0), **kw)
    return y + f32(p["bias"])[None, :, None] if "bias" in p else y


def vae_decode(pr, vp, vcfg, z: torch.Tensor) -> torch.Tensor:
    """(B, T, 64) latents -> (B, 2, T * hop) waveform."""
    d = vp["decoder"]
    x = conv(pr, d["conv1"], z.transpose(1, 2), padding=3)
    for i, s in enumerate(reversed(vcfg["downsampling_ratios"])):
        bp = d["block"][i]
        x = snake(bp["snake1"], x)
        ct = bp["conv_t1"]
        x = pr.conv_t(x, f32(ct["kernel"]).permute(1, 2, 0), stride=s, padding=-(-s // 2)) \
            + f32(ct["bias"])[None, :, None]
        for name, dil in zip(("res_unit1", "res_unit2", "res_unit3"), DILATIONS):
            u = bp[name]
            y = conv(pr, u["conv1"], snake(u["snake1"], x), padding=3 * dil, dilation=dil)
            x = x + conv(pr, u["conv2"], snake(u["snake2"], y))
    return conv(pr, d["conv2"], snake(d["snake1"], x), padding=3)


def decode_core(t: int, b: int) -> int:
    core = max(192, min(512, -(-t // 4), 4096 // max(b, 1)))
    return core + (-core) % 8


def decode_to_pcm(pr, vp, vcfg, lat: torch.Tensor, normalize_db: float = -1.0) -> np.ndarray:
    """Overlap-discard chunks (16 edge-replicated frames a side), the peak
    over the whole song, then int16: scale, clip, x 32767, round half even."""
    b, t, _ = lat.shape
    hop = int(np.prod(vcfg["downsampling_ratios"]))
    core = decode_core(t, b)
    ov = DECODE_OVERLAP
    n = -(-t // core) if t > core else 1
    pieces = []
    for row in range(b):
        z = lat[row:row + 1]
        if n == 1:
            pieces.append([vae_decode(pr, vp, vcfg, z)[:, :, : t * hop]])
            continue
        padded = F.pad(z.transpose(1, 2), (ov, n * core - t + ov), mode="replicate").transpose(1, 2)
        row_pieces = []
        for ci in range(n):
            w = vae_decode(pr, vp, vcfg, padded[:, ci * core: ci * core + core + 2 * ov])
            valid = core if ci < n - 1 else t - (n - 1) * core
            row_pieces.append(w[:, :, ov * hop: (ov + valid) * hop])
        pieces.append(row_pieces)
    out = []
    for row_pieces in pieces:
        w = torch.cat(row_pieces, dim=2)[0]
        scale = (10.0 ** (normalize_db / 20.0)) / w.abs().amax().clamp_min(1e-9)
        out.append(torch.round(torch.clamp(w * scale, -1.0, 1.0) * 32767.0).to(torch.int16).cpu().numpy())
    return np.stack(out)


# ---------------------------------------------------------------------------
# A whole request
# ---------------------------------------------------------------------------


def generate(weights: Dict[str, Any], config: Dict[str, Any], request: Dict[str, Any], device,
             precision: str = "fp32", decode: bool = True) -> Dict[str, np.ndarray]:
    """The latents (B, T, 64) and the int16 PCM (B, 2, L) of one text2music
    request: {"captions", "lyrics", "language", "duration_s", "seeds"}."""
    pr = Precision(precision)
    cfg, tcfg, vcfg, sampler = config["dit"], config["text_encoder"], config["vae"], config["sampler"]
    dp = weights["dit"]
    b = len(request["seeds"])
    with torch.no_grad(), strict_fp32():
        texts = [prompt_texts(c, l, request["language"], request["duration_s"])
                 for c, l in zip(request["captions"], request["lyrics"])]
        text_ids, text_mask = tokenize([t for t, _ in texts], 256, TEXT_BUCKETS)
        lyric_ids, lyric_mask = tokenize([l for _, l in texts], 2048, LYRIC_BUCKETS)
        dev = lambda a: torch.as_tensor(a, device=device)
        text_hidden = text_encoder(pr, weights["text"], tcfg, dev(text_ids))
        lyric_embeds = f32(weights["text"]["embed_tokens"]["weight"])[dev(lyric_ids)]
        t_exact = int(float(request["duration_s"]) * LATENT_FPS)
        t_lat = pick_bucket(t_exact, LATENT_BUCKETS)
        t_exact = min(t_exact, t_lat)
        sil = f32(weights["silence"][0])
        sil_tiled = sil.repeat(-(-max(t_lat, cfg["timbre_fix_frame"]) // sil.shape[0]), 1)
        refs = sil_tiled[: cfg["timbre_fix_frame"]][None].expand(b, -1, -1)
        enc, enc_mask = condition(pr, dp, cfg, text_hidden, dev(text_mask), lyric_embeds, dev(lyric_mask), refs)
        src = sil_tiled[:t_lat][None].expand(b, -1, -1)
        context = torch.cat([src, torch.ones_like(src)], dim=-1)
        latent_mask = torch.zeros((b, t_lat), dtype=torch.long, device=device)
        latent_mask[:, :t_exact] = 1
        dec = dp["decoder"]
        kvs = cross_kv(pr, dec, cfg, enc)
        guided = sampler["guidance_scale"] > 1.0 and sampler["inference_steps"] > 8
        null_kvs = cross_kv(pr, dec, cfg, f32(dp["null_condition_emb"]).expand(enc.shape)) if guided else None
        xt = noise(request["seeds"], t_lat, cfg["audio_acoustic_hidden_dim"]).to(device)
        ts = schedule(sampler)
        lo, hi = np.float32(sampler["cfg_interval_start"]), np.float32(sampler["cfg_interval_end"])
        avg = torch.zeros_like(xt)
        for i, t in enumerate(ts):
            t_next = ts[i + 1] if i + 1 < len(ts) else 0.0
            v = dit_forward(pr, dec, cfg, xt, t, context, kvs, enc_mask, latent_mask)
            if guided:
                v_null = dit_forward(pr, dec, cfg, xt, t, context, null_kvs, enc_mask, latent_mask)
                if lo <= np.float32(t) <= hi:
                    v, avg = apg(v, v_null, float(sampler["guidance_scale"]), avg)
            xt = xt - v * (float(np.float32(t)) - float(np.float32(t_next)))
        lat = xt[:, :t_exact]
        out = {"latents": lat.cpu().numpy()}
        if decode:
            out["pcm"] = decode_to_pcm(pr, weights["vae"], vcfg, lat)
    return out
