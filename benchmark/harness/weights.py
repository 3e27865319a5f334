"""Seeded random weights, made on the device in a few large calls.

The trees have the layout the port takes (`acestep_tpu_torch/params.py`:
``kernel`` as (in, out), conv kernels as (K, C_in, C_out), layer stacks as
per-layer lists) and the distributions of its development init: normals of
std 0.02, norms ones, biases and Snake logs zeros, the AdaLN tables std
hidden**-0.5, the null condition std 1. The silence latent, which the port
reads from a checkpoint, is drawn here too (std 1).

`make_weights` lays every leaf out first, then draws all normals of one dtype
with one `torch.randn` on a `torch.Generator` of the device, scales each run
of equal std once, and hands out views: the DiT and text encoder in their
served dtype, the VAE in fp32 (the port keeps the VAE's weights in fp32).
The same seed gives the same bits on the same device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Tuple

import torch


@dataclass
class Leaf:
    shape: Tuple[int, ...]
    kind: str  # "normal", "ones" or "zeros"
    std: float
    dtype: torch.dtype
    value: Any = None


def _lin(d_in, d_out, dtype, bias=True, std=0.02):
    p = {"kernel": Leaf((d_in, d_out), "normal", std, dtype)}
    if bias:
        p["bias"] = Leaf((d_out,), "zeros", 0.0, dtype)
    return p


def _norm(d, dtype):
    return {"weight": Leaf((d,), "ones", 0.0, dtype)}


def _attn(c, dt, bias):
    d, hd = c["hidden_size"], c["head_dim"]
    return {
        "q_proj": _lin(d, c["num_attention_heads"] * hd, dt, bias),
        "k_proj": _lin(d, c["num_key_value_heads"] * hd, dt, bias),
        "v_proj": _lin(d, c["num_key_value_heads"] * hd, dt, bias),
        "o_proj": _lin(c["num_attention_heads"] * hd, d, dt, bias),
        "q_norm": _norm(hd, dt),
        "k_norm": _norm(hd, dt),
    }


def _mlp(d, i, dt):
    return {"gate_proj": _lin(d, i, dt, False), "up_proj": _lin(d, i, dt, False), "down_proj": _lin(i, d, dt, False)}


def _enc_layer(c, dt):
    d = c["hidden_size"]
    return {"self_attn": _attn(c, dt, c["attention_bias"]), "input_layernorm": _norm(d, dt),
            "post_attention_layernorm": _norm(d, dt), "mlp": _mlp(d, c["intermediate_size"], dt)}


def _enc_stack(c, n, d_in, dt):
    return {"embed_tokens": _lin(d_in, c["hidden_size"], dt), "layers": [_enc_layer(c, dt) for _ in range(n)],
            "norm": _norm(c["hidden_size"], dt)}


def dit_layout(c: Dict[str, Any], dt: torch.dtype) -> Dict[str, Any]:
    """The DiT, condition encoders and audio tokenizer chain (`init_acestep_params`)."""
    d = c["hidden_size"]

    def dit_layer():
        return {"self_attn_norm": _norm(d, dt), "self_attn": _attn(c, dt, c["attention_bias"]),
                "cross_attn_norm": _norm(d, dt), "cross_attn": _attn(c, dt, c["attention_bias"]),
                "mlp_norm": _norm(d, dt), "mlp": _mlp(d, c["intermediate_size"], dt),
                "scale_shift_table": Leaf((1, 6, d), "normal", d ** -0.5, dt)}

    def time_embed():
        return {"linear_1": _lin(256, d, dt), "linear_2": _lin(d, d, dt), "time_proj": _lin(d, d * 6, dt)}

    n_fsq = len(c["fsq_levels"])
    return {
        "decoder": {
            "layers": [dit_layer() for _ in range(c["num_hidden_layers"])],
            "proj_in": {"kernel": Leaf((c["patch_size"], c["in_channels"], d), "normal", 0.02, dt),
                        "bias": Leaf((d,), "zeros", 0.0, dt)},
            "time_embed": time_embed(),
            "time_embed_r": time_embed(),
            "condition_embedder": _lin(d, d, dt),
            "norm_out": _norm(d, dt),
            "proj_out": {"kernel": Leaf((c["patch_size"], d, c["audio_acoustic_hidden_dim"]), "normal", 0.02, dt),
                         "bias": Leaf((c["audio_acoustic_hidden_dim"],), "zeros", 0.0, dt)},
            "scale_shift_table": Leaf((1, 2, d), "normal", d ** -0.5, dt),
        },
        "encoder": {
            "text_projector": _lin(c["text_hidden_dim"], d, dt, bias=False),
            "lyric_encoder": _enc_stack(c, c["num_lyric_encoder_hidden_layers"], c["text_hidden_dim"], dt),
            "timbre_encoder": _enc_stack(c, c["num_timbre_encoder_hidden_layers"], c["timbre_hidden_dim"], dt),
        },
        "tokenizer": {
            "audio_acoustic_proj": _lin(c["audio_acoustic_hidden_dim"], d, dt),
            "attention_pooler": {
                "embed_tokens": _lin(d, d, dt),
                "special_token": Leaf((1, 1, d), "normal", 0.02, dt),
                "layers": [_enc_layer(c, dt) for _ in range(c["num_attention_pooler_hidden_layers"])],
                "norm": _norm(d, dt),
            },
            "quantizer": {"project_in": _lin(c["fsq_dim"], n_fsq, dt), "project_out": _lin(n_fsq, c["fsq_dim"], dt)},
        },
        "detokenizer": {
            "embed_tokens": _lin(d, d, dt),
            "special_tokens": Leaf((1, c["pool_window_size"], d), "normal", 0.02, dt),
            "layers": [_enc_layer(c, dt) for _ in range(c["num_attention_pooler_hidden_layers"])],
            "norm": _norm(d, dt),
            "proj_out": _lin(d, c["audio_acoustic_hidden_dim"], dt),
        },
        "null_condition_emb": Leaf((1, 1, d), "normal", 1.0, dt),
    }


def text_layout(c: Dict[str, Any], dt: torch.dtype) -> Dict[str, Any]:
    """The Qwen3 text encoder (`init_qwen3_params`, tied embeddings: no head)."""
    d = c["hidden_size"]
    layer = lambda: {"input_layernorm": _norm(d, dt), "self_attn": _attn(dict(c, attention_bias=False), dt, False),
                     "post_attention_layernorm": _norm(d, dt), "mlp": _mlp(d, c["intermediate_size"], dt)}
    return {"embed_tokens": {"weight": Leaf((c["vocab_size"], d), "normal", 0.02, dt)},
            "layers": [layer() for _ in range(c["num_hidden_layers"])], "norm": _norm(d, dt)}


def vae_layout(c: Dict[str, Any], dt: torch.dtype = torch.float32) -> Dict[str, Any]:
    """The Oobleck encoder and decoder (`init_oobleck_params`)."""
    conv = lambda k, ci, co, bias=True: ({"kernel": Leaf((k, ci, co), "normal", 0.02, dt)}
                                         | ({"bias": Leaf((co,), "zeros", 0.0, dt)} if bias else {}))
    snake = lambda ch: {"alpha": Leaf((ch,), "zeros", 0.0, dt), "beta": Leaf((ch,), "zeros", 0.0, dt)}
    unit = lambda ch: {"snake1": snake(ch), "conv1": conv(7, ch, ch), "snake2": snake(ch), "conv2": conv(1, ch, ch)}
    cm = (1,) + tuple(c["channel_multiples"])
    ehs, ch, ratios = c["encoder_hidden_size"], c["decoder_channels"], tuple(c["downsampling_ratios"])
    enc_blocks = [{"res_unit1": unit(ehs * cm[i]), "res_unit2": unit(ehs * cm[i]), "res_unit3": unit(ehs * cm[i]),
                   "snake1": snake(ehs * cm[i]), "conv1": conv(2 * s, ehs * cm[i], ehs * cm[i + 1])}
                  for i, s in enumerate(ratios)]
    n = len(ratios)
    dec_blocks = []
    for i, s in enumerate(reversed(ratios)):
        cin, cout = ch * cm[n - i], ch * cm[n - i - 1]
        dec_blocks.append({"snake1": snake(cin), "conv_t1": conv(2 * s, cin, cout), "res_unit1": unit(cout),
                           "res_unit2": unit(cout), "res_unit3": unit(cout)})
    return {
        "encoder": {"conv1": conv(7, c["audio_channels"], ehs), "block": enc_blocks,
                    "snake1": snake(ehs * cm[-1]), "conv2": conv(3, ehs * cm[-1], ehs)},
        "decoder": {"conv1": conv(7, c["decoder_input_channels"], ch * cm[-1]), "block": dec_blocks,
                    "snake1": snake(ch), "conv2": conv(7, ch, c["audio_channels"], bias=False)},
    }


def leaves(tree) -> List[Leaf]:
    if isinstance(tree, Leaf):
        return [tree]
    items = tree.values() if isinstance(tree, dict) else tree
    return [leaf for v in items for leaf in leaves(v)]


def _materialize(tree):
    if isinstance(tree, Leaf):
        return tree.value
    if isinstance(tree, dict):
        return {k: _materialize(v) for k, v in tree.items()}
    return [_materialize(v) for v in tree]


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n


def fill(trees: List[Any], seed: int, device) -> List[Any]:
    """Draw every leaf of `trees` from `seed`: per dtype one normal draw and
    one buffer each of ones and zeros, cut into views in layout order."""
    gen = torch.Generator(device=device).manual_seed(int(seed) & 0xFFFF_FFFF_FFFF)
    all_leaves = [leaf for t in trees for leaf in leaves(t)]
    for dtype in sorted({leaf.dtype for leaf in all_leaves}, key=str):
        group = [leaf for leaf in all_leaves if leaf.dtype == dtype]
        for kind in ("normal", "ones", "zeros"):
            part = [leaf for leaf in group if leaf.kind == kind]
            if kind == "normal":
                part.sort(key=lambda leaf: leaf.std)  # stable: layout order within one std
            total = sum(_numel(leaf.shape) for leaf in part)
            if not total:
                continue
            if kind == "normal":
                buf = torch.randn(total, generator=gen, device=device, dtype=dtype)
            elif kind == "ones":
                buf = torch.ones(total, device=device, dtype=dtype)
            else:
                buf = torch.zeros(total, device=device, dtype=dtype)
            at, run_start, run_std = 0, 0, None
            for leaf in part:
                n = _numel(leaf.shape)
                if kind == "normal" and leaf.std != run_std:
                    if run_std is not None and run_std != 1.0:
                        buf[run_start:at].mul_(run_std)
                    run_start, run_std = at, leaf.std
                leaf.value = buf[at:at + n].view(leaf.shape)
                at += n
            if kind == "normal" and run_std is not None and run_std != 1.0:
                buf[run_start:at].mul_(run_std)
    return [_materialize(t) for t in trees]


def make_weights(config: Dict[str, Any], seed: int, device, dtype: torch.dtype = torch.bfloat16) -> Dict[str, Any]:
    """{"dit", "text", "vae", "silence"}: the configuration's weights from `seed`.
    `dtype` is the served dtype of the DiT and the text encoder; the VAE's
    weights are fp32, the silence latent (1, 750, latent) fp32."""
    c = config
    silence = {"silence": Leaf((1, c["dit"]["timbre_fix_frame"], c["dit"]["audio_acoustic_hidden_dim"]),
                               "normal", 1.0, torch.float32)}
    dit, text, vae, sil = fill([dit_layout(c["dit"], dtype), text_layout(c["text_encoder"], dtype),
                                vae_layout(c["vae"]), silence], seed, device)
    return {"dit": dit, "text": text, "vae": vae, "silence": sil["silence"]}


def count_params(tree) -> int:
    if isinstance(tree, torch.Tensor):
        return tree.numel()
    items = tree.values() if isinstance(tree, dict) else tree
    return sum(count_params(v) for v in items)
