"""Parameter trees: random init in torch and conversion from the JAX package.

Port of `acestep_tpu/params.py` (DiT), `models/vae.py:init_oobleck_params`
and `models/qwen3.py:init_qwen3_params`. The port keeps the JAX package's
tree layout and names (``kernel`` as (in, out), conv kernels as
(K, C_in, C_out)), with tensors as leaves and layer stacks as per-layer lists.

Random init draws from the same distributions as the JAX package (normals
with std 0.02, ones for norms, zeros for biases and Snake logs) from a seeded
`torch.Generator` on the target device; the numbers differ from `jax.random`.
`from_jax_params` carries one set of JAX weights into the port, which is how
the tests hold the two packages to the same inputs.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Union

import numpy as np
import torch

from acestep_tpu_torch.config import AceStepConfig, OobleckConfig, Qwen3Config

Params = Dict[str, Any]


class _Init:
    def __init__(self, seed: int, device, dtype):
        self.device = torch.device(device)
        self.dtype = dtype
        self.gen = torch.Generator(device=self.device).manual_seed(int(seed))

    def normal(self, shape, std: float = 1.0, dtype=None) -> torch.Tensor:
        x = torch.randn(shape, generator=self.gen, device=self.device, dtype=torch.float32)
        return x.to(dtype or self.dtype) * std

    def ones(self, *shape):
        return torch.ones(shape, device=self.device, dtype=self.dtype)

    def zeros(self, *shape):
        return torch.zeros(shape, device=self.device, dtype=self.dtype)

    def linear(self, d_in, d_out, bias=True, std=0.02) -> Params:
        p = {"kernel": self.normal((d_in, d_out), std)}
        if bias:
            p["bias"] = self.zeros(d_out)
        return p

    def norm(self, d) -> Params:
        return {"weight": self.ones(d)}


def _attn(ini: _Init, cfg: AceStepConfig) -> Params:
    d, hd = cfg.hidden_size, cfg.head_dim
    return {
        "q_proj": ini.linear(d, cfg.num_attention_heads * hd, cfg.attention_bias),
        "k_proj": ini.linear(d, cfg.num_key_value_heads * hd, cfg.attention_bias),
        "v_proj": ini.linear(d, cfg.num_key_value_heads * hd, cfg.attention_bias),
        "o_proj": ini.linear(cfg.num_attention_heads * hd, d, cfg.attention_bias),
        "q_norm": ini.norm(hd),
        "k_norm": ini.norm(hd),
    }


def _mlp(ini: _Init, d: int, i: int) -> Params:
    return {
        "gate_proj": ini.linear(d, i, bias=False),
        "up_proj": ini.linear(d, i, bias=False),
        "down_proj": ini.linear(i, d, bias=False),
    }


def _encoder_layer(ini: _Init, cfg: AceStepConfig) -> Params:
    return {
        "self_attn": _attn(ini, cfg),
        "input_layernorm": ini.norm(cfg.hidden_size),
        "post_attention_layernorm": ini.norm(cfg.hidden_size),
        "mlp": _mlp(ini, cfg.hidden_size, cfg.intermediate_size),
    }


def _dit_layer(ini: _Init, cfg: AceStepConfig) -> Params:
    d = cfg.hidden_size
    return {
        "self_attn_norm": ini.norm(d),
        "self_attn": _attn(ini, cfg),
        "cross_attn_norm": ini.norm(d),
        "cross_attn": _attn(ini, cfg),
        "mlp_norm": ini.norm(d),
        "mlp": _mlp(ini, d, cfg.intermediate_size),
        "scale_shift_table": ini.normal((1, 6, d), d**-0.5),
    }


def _encoder_stack(ini: _Init, cfg: AceStepConfig, n_layers: int, d_in: int) -> Params:
    return {
        "embed_tokens": ini.linear(d_in, cfg.hidden_size),
        "layers": [_encoder_layer(ini, cfg) for _ in range(n_layers)],
        "norm": ini.norm(cfg.hidden_size),
    }


def init_acestep_params(
    cfg: AceStepConfig, *, seed: int = 0, device="cuda", dtype=torch.bfloat16
) -> Params:
    ini = _Init(seed, device, dtype)
    d = cfg.hidden_size

    def time_embed():
        return {
            "linear_1": ini.linear(256, d),
            "linear_2": ini.linear(d, d),
            "time_proj": ini.linear(d, d * 6),
        }

    decoder = {
        "layers": [_dit_layer(ini, cfg) for _ in range(cfg.num_hidden_layers)],
        "proj_in": {
            "kernel": ini.normal((cfg.patch_size, cfg.in_channels, d), 0.02),
            "bias": ini.zeros(d),
        },
        "time_embed": time_embed(),
        "time_embed_r": time_embed(),
        "condition_embedder": ini.linear(d, d),
        "norm_out": ini.norm(d),
        "proj_out": {
            "kernel": ini.normal((cfg.patch_size, d, cfg.audio_acoustic_hidden_dim), 0.02),
            "bias": ini.zeros(cfg.audio_acoustic_hidden_dim),
        },
        "scale_shift_table": ini.normal((1, 2, d), d**-0.5),
    }
    encoder = {
        "text_projector": ini.linear(cfg.text_hidden_dim, d, bias=False),
        "lyric_encoder": _encoder_stack(ini, cfg, cfg.num_lyric_encoder_hidden_layers, cfg.text_hidden_dim),
        "timbre_encoder": _encoder_stack(ini, cfg, cfg.num_timbre_encoder_hidden_layers, cfg.timbre_hidden_dim),
    }
    tokenizer = {
        "audio_acoustic_proj": ini.linear(cfg.audio_acoustic_hidden_dim, d),
        "attention_pooler": {
            "embed_tokens": ini.linear(d, d),
            "special_token": ini.normal((1, 1, d), 0.02),
            "layers": [_encoder_layer(ini, cfg) for _ in range(cfg.num_attention_pooler_hidden_layers)],
            "norm": ini.norm(d),
        },
        "quantizer": {
            "project_in": ini.linear(cfg.fsq_dim, len(cfg.fsq_levels)),
            "project_out": ini.linear(len(cfg.fsq_levels), cfg.fsq_dim),
        },
    }
    detok = {
        "embed_tokens": ini.linear(d, d),
        "special_tokens": ini.normal((1, cfg.pool_window_size, d), 0.02),
        "layers": [_encoder_layer(ini, cfg) for _ in range(cfg.num_attention_pooler_hidden_layers)],
        "norm": ini.norm(d),
        "proj_out": ini.linear(d, cfg.audio_acoustic_hidden_dim),
    }
    return {
        "decoder": decoder,
        "encoder": encoder,
        "tokenizer": tokenizer,
        "detokenizer": detok,
        "null_condition_emb": ini.normal((1, 1, d)),
    }


def _conv(ini: _Init, k, cin, cout, bias=True) -> Params:
    p = {"kernel": ini.normal((k, cin, cout), 0.02)}
    if bias:
        p["bias"] = ini.zeros(cout)
    return p


def _snake(ini: _Init, c) -> Params:
    return {"alpha": ini.zeros(c), "beta": ini.zeros(c)}


def _res_unit(ini: _Init, c) -> Params:
    return {
        "snake1": _snake(ini, c),
        "conv1": _conv(ini, 7, c, c),
        "snake2": _snake(ini, c),
        "conv2": _conv(ini, 1, c, c),
    }


def init_oobleck_params(
    cfg: OobleckConfig, *, seed: int = 0, device="cuda", dtype=torch.float32
) -> Params:
    """Encoder and decoder trees, in the JAX package's draw order."""
    ini = _Init(seed, device, dtype)
    cm = (1,) + tuple(cfg.channel_multiples)
    ehs = cfg.encoder_hidden_size
    enc_blocks = []
    for i, stride in enumerate(cfg.downsampling_ratios):
        cin, cout = ehs * cm[i], ehs * cm[i + 1]
        enc_blocks.append({
            "res_unit1": _res_unit(ini, cin),
            "res_unit2": _res_unit(ini, cin),
            "res_unit3": _res_unit(ini, cin),
            "snake1": _snake(ini, cin),
            "conv1": _conv(ini, 2 * stride, cin, cout),
        })
    encoder = {
        "conv1": _conv(ini, 7, cfg.audio_channels, ehs),
        "block": enc_blocks,
        "snake1": _snake(ini, ehs * cm[-1]),
        "conv2": _conv(ini, 3, ehs * cm[-1], ehs),
    }
    ch = cfg.decoder_channels
    ups = tuple(reversed(cfg.downsampling_ratios))
    n = len(ups)
    dec_blocks = []
    for i, stride in enumerate(ups):
        cin, cout = ch * cm[n - i], ch * cm[n - i - 1]
        dec_blocks.append({
            "snake1": _snake(ini, cin),
            "conv_t1": _conv(ini, 2 * stride, cin, cout),
            "res_unit1": _res_unit(ini, cout),
            "res_unit2": _res_unit(ini, cout),
            "res_unit3": _res_unit(ini, cout),
        })
    decoder = {
        "conv1": _conv(ini, 7, cfg.decoder_input_channels, ch * cm[-1]),
        "block": dec_blocks,
        "snake1": _snake(ini, ch),
        "conv2": _conv(ini, 7, ch, cfg.audio_channels, bias=False),
    }
    return {"encoder": encoder, "decoder": decoder}


# Planner LM sizes (the reference model zoo acestep-5Hz-lm-{0.6B,1.7B,4B});
# a copy of `acestep_tpu/lm/handler.py:LM_CONFIGS`.
LM_CONFIGS = {
    "0.6B": Qwen3Config(hidden_size=1024, intermediate_size=3072, num_hidden_layers=28,
                        num_attention_heads=16, num_key_value_heads=8),
    "1.7B": Qwen3Config(hidden_size=2048, intermediate_size=6144, num_hidden_layers=28,
                        num_attention_heads=16, num_key_value_heads=8),
    "4B": Qwen3Config(hidden_size=2560, intermediate_size=9728, num_hidden_layers=36,
                      num_attention_heads=32, num_key_value_heads=8),
}


def init_qwen3_params(
    cfg: Qwen3Config,
    *,
    seed: int = 0,
    device="cuda",
    dtype=torch.bfloat16,
    with_lm_head: Optional[bool] = None,
) -> Params:
    """Qwen3 tree for the text encoder or the planner LM. An `lm_head`
    (d, vocab) is drawn last when `with_lm_head`, which defaults to untied
    embeddings (`not cfg.tie_word_embeddings`), as in the JAX package."""
    ini = _Init(seed, device, dtype)
    d, hd = cfg.hidden_size, cfg.head_dim

    def attn():
        return {
            "q_proj": ini.linear(d, cfg.num_attention_heads * hd, bias=False),
            "k_proj": ini.linear(d, cfg.num_key_value_heads * hd, bias=False),
            "v_proj": ini.linear(d, cfg.num_key_value_heads * hd, bias=False),
            "o_proj": ini.linear(cfg.num_attention_heads * hd, d, bias=False),
            "q_norm": ini.norm(hd),
            "k_norm": ini.norm(hd),
        }

    layers = [
        {
            "input_layernorm": ini.norm(d),
            "self_attn": attn(),
            "post_attention_layernorm": ini.norm(d),
            "mlp": _mlp(ini, d, cfg.intermediate_size),
        }
        for _ in range(cfg.num_hidden_layers)
    ]
    params = {
        "embed_tokens": {"weight": ini.normal((cfg.vocab_size, d), 0.02)},
        "layers": layers,
        "norm": ini.norm(d),
    }
    if with_lm_head is None:
        with_lm_head = not cfg.tie_word_embeddings
    if with_lm_head:
        params["lm_head"] = ini.linear(d, cfg.vocab_size, bias=False)
    return params


# ---------------------------------------------------------------------------
# JAX parameter trees -> port trees
# ---------------------------------------------------------------------------


def _to_tensor(a, device, dtype) -> torch.Tensor:
    arr = np.asarray(a)
    if arr.dtype.name == "bfloat16":  # ml_dtypes array from a bf16 JAX tree
        t = torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr, copy=True))
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def _unstack(stacked: Params) -> list:
    """{"sliding": stacked, "full": stacked} -> [sliding[0], full[0], sliding[1], ...]."""

    def take(tree, i):
        if isinstance(tree, dict):
            return {k: take(v, i) for k, v in tree.items()}
        return tree[i]

    def count(tree):
        return count(next(iter(tree.values()))) if isinstance(tree, dict) else tree.shape[0]

    n = count(stacked["sliding"])
    out = []
    for i in range(n):
        out += [take(stacked["sliding"], i), take(stacked["full"], i)]
    return out


def _convert(tree, device, dtype):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            if k == "layers" and isinstance(v, dict) and set(v) == {"sliding", "full"}:
                v = _unstack(v)
            out[k] = _convert(v, device, dtype)
        return out
    if isinstance(tree, (list, tuple)):
        return [_convert(v, device, dtype) for v in tree]
    if tree is None:
        return None
    return _to_tensor(tree, device, dtype)


def from_jax_params(
    np_tree: Params,
    cfg: Union[AceStepConfig, OobleckConfig, Qwen3Config],
    *,
    device="cpu",
    dtype: Optional[torch.dtype] = None,
) -> Params:
    """Turn a JAX parameter tree (numpy leaves) of the DiT, the Oobleck VAE or
    a Qwen3 model (text encoder, or planner LM with or without `lm_head`)
    into the port's tree.

    The DiT tree may come as per-layer lists or in the stacked
    {"sliding", "full"} layout of the JAX serving handler: layer 2i is
    sliding[i], layer 2i+1 is full[i]. `dtype` casts floating leaves (None
    keeps each leaf's dtype).
    """
    out = _convert(np_tree, device, dtype)
    if isinstance(cfg, AceStepConfig):
        n, want = len(out["decoder"]["layers"]), cfg.num_hidden_layers
    elif isinstance(cfg, Qwen3Config):
        n, want = len(out["layers"]), cfg.num_hidden_layers
    elif isinstance(cfg, OobleckConfig):
        n, want = len(out["decoder"]["block"]), len(cfg.downsampling_ratios)
    else:
        raise TypeError(f"unknown config type {type(cfg).__name__}")
    if n != want:
        raise ValueError(f"parameter tree has {n} layers/blocks, config says {want}")
    return out
