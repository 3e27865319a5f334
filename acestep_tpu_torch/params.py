"""Parameter trees: random init, reference checkpoints, and the JAX package's trees.

Port of `acestep_tpu/params.py` (DiT init, `convert_torch_state_dict`,
`load_safetensors_state`), `models/vae.py:init_oobleck_params` and
`models/qwen3.py:init_qwen3_params`. The port keeps the JAX package's tree
layout and names (``kernel`` as (in, out), conv kernels as (K, C_in, C_out)),
with tensors as leaves and layer stacks as per-layer lists.

`load_safetensors_state` reads the safetensors format itself (an 8-byte
little-endian header length, a JSON header, then the raw buffers), so no
`safetensors` package is needed; the converters transpose and cast in numpy
float32 as the JAX package's do, so a converted leaf has the same bits.

Random init draws from the same distributions as the JAX package (normals
with std 0.02, ones for norms, zeros for biases and Snake logs) from a seeded
`torch.Generator` on the target device; the numbers differ from `jax.random`.
`from_jax_params` carries one set of JAX weights into the port, which is how
the tests hold the two packages to the same inputs.
"""

from __future__ import annotations

import json
import os
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


# ---------------------------------------------------------------------------
# Reference checkpoints: safetensors files -> state dicts -> port trees
# ---------------------------------------------------------------------------

# safetensors dtype -> (dtype the buffer is read as, dtype it is viewed as).
# numpy has no bf16, so BF16 is read as int16 and viewed as torch.bfloat16.
_SAFETENSORS_DTYPES = {
    "F32": (torch.float32, None),
    "F16": (torch.float16, None),
    "BF16": (torch.int16, torch.bfloat16),
    "I64": (torch.int64, None),
    "I32": (torch.int32, None),
}


def _read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    with open(path, "rb") as f:
        blob = bytearray(f.read())
    n = int.from_bytes(blob[:8], "little")
    header = json.loads(blob[8 : 8 + n].decode("utf-8"))
    base = 8 + n
    out: Dict[str, torch.Tensor] = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        if info["dtype"] not in _SAFETENSORS_DTYPES:
            raise ValueError(f"{path}: tensor {name!r} has dtype {info['dtype']}, which the reader does not take")
        raw, view = _SAFETENSORS_DTYPES[info["dtype"]]
        shape = [int(d) for d in info["shape"]]
        count = int(np.prod(shape, dtype=np.int64))
        begin, end = (int(v) for v in info["data_offsets"])
        itemsize = torch.empty((), dtype=raw).element_size()
        if end - begin != count * itemsize:
            raise ValueError(f"{path}: tensor {name!r} holds {end - begin} bytes for shape {shape}")
        if count == 0:
            t = torch.empty(shape, dtype=raw)
        elif (base + begin) % itemsize:  # unaligned: read a copy
            t = torch.frombuffer(bytearray(blob[base + begin : base + end]), dtype=raw)
        else:
            t = torch.frombuffer(blob, dtype=raw, count=count, offset=base + begin)
        out[name] = (t.view(view) if view is not None else t).reshape(shape)
    return out


def load_safetensors_state(path: str) -> Dict[str, torch.Tensor]:
    """One .safetensors file, or every one in a directory in sorted order,
    into a flat {name: CPU tensor} dict (BF16 stays torch.bfloat16)."""
    if os.path.isdir(path):
        files = [os.path.join(path, f) for f in sorted(os.listdir(path)) if f.endswith(".safetensors")]
    else:
        files = [path]
    state: Dict[str, torch.Tensor] = {}
    for f in files:
        state.update(_read_safetensors(f))
    return state


def np32(value) -> np.ndarray:
    """A state-dict entry (torch tensor of any float dtype, or array-like) as numpy float32."""
    if isinstance(value, torch.Tensor):
        return value.detach().to(device="cpu", dtype=torch.float32).numpy()
    return np.asarray(value, dtype=np.float32)


def leaf(arr: np.ndarray, device, dtype) -> torch.Tensor:
    """A numpy float32 array as a port leaf on `device` in `dtype`."""
    return torch.from_numpy(np.ascontiguousarray(arr)).to(device=device, dtype=dtype)


def convert_torch_state_dict(
    state: Dict[str, Any], cfg: AceStepConfig, dtype=torch.bfloat16, device="cpu"
) -> Params:
    """A reference AceStepConditionGenerationModel state_dict -> the port's
    DiT tree (per-layer lists). Linear weights (out, in) become (in, out)
    kernels, conv weights (out, in, K) and conv_t weights (in, out, K)
    become (K, in, out); a bias is kept wherever the state has one."""

    def t(arr):
        return leaf(arr, device, dtype)

    def lin(prefix):
        p = {"kernel": t(np32(state[prefix + ".weight"]).T)}
        if prefix + ".bias" in state:
            p["bias"] = t(np32(state[prefix + ".bias"]))
        return p

    def norm(prefix):
        return {"weight": t(np32(state[prefix + ".weight"]))}

    def attn(prefix):
        return {
            "q_proj": lin(prefix + ".q_proj"),
            "k_proj": lin(prefix + ".k_proj"),
            "v_proj": lin(prefix + ".v_proj"),
            "o_proj": lin(prefix + ".o_proj"),
            "q_norm": norm(prefix + ".q_norm"),
            "k_norm": norm(prefix + ".k_norm"),
        }

    def mlp(prefix):
        return {name: lin(f"{prefix}.{name}") for name in ("gate_proj", "up_proj", "down_proj")}

    def enc_layer(prefix):
        return {
            "self_attn": attn(prefix + ".self_attn"),
            "input_layernorm": norm(prefix + ".input_layernorm"),
            "post_attention_layernorm": norm(prefix + ".post_attention_layernorm"),
            "mlp": mlp(prefix + ".mlp"),
        }

    def conv(prefix, axes):
        p = {"kernel": t(np.transpose(np32(state[prefix + ".weight"]), axes))}
        if prefix + ".bias" in state:
            p["bias"] = t(np32(state[prefix + ".bias"]))
        return p

    def enc_stack(prefix, n):
        return {
            "embed_tokens": lin(prefix + ".embed_tokens"),
            "layers": [enc_layer(f"{prefix}.layers.{i}") for i in range(n)],
            "norm": norm(prefix + ".norm"),
        }

    def time_embed(prefix):
        return {name: lin(f"{prefix}.{name}") for name in ("linear_1", "linear_2", "time_proj")}

    decoder = {
        "layers": [
            {
                "self_attn_norm": norm(f"decoder.layers.{i}.self_attn_norm"),
                "self_attn": attn(f"decoder.layers.{i}.self_attn"),
                "cross_attn_norm": norm(f"decoder.layers.{i}.cross_attn_norm"),
                "cross_attn": attn(f"decoder.layers.{i}.cross_attn"),
                "mlp_norm": norm(f"decoder.layers.{i}.mlp_norm"),
                "mlp": mlp(f"decoder.layers.{i}.mlp"),
                "scale_shift_table": t(np32(state[f"decoder.layers.{i}.scale_shift_table"])),
            }
            for i in range(cfg.num_hidden_layers)
        ],
        # proj_in / proj_out are nn.Sequential(Lambda, Conv, Lambda): index 1.
        "proj_in": conv("decoder.proj_in.1", (2, 1, 0)),
        "time_embed": time_embed("decoder.time_embed"),
        "time_embed_r": time_embed("decoder.time_embed_r"),
        "condition_embedder": lin("decoder.condition_embedder"),
        "norm_out": norm("decoder.norm_out"),
        "proj_out": conv("decoder.proj_out.1", (2, 0, 1)),
        "scale_shift_table": t(np32(state["decoder.scale_shift_table"])),
    }
    encoder = {
        "text_projector": lin("encoder.text_projector"),
        "lyric_encoder": enc_stack("encoder.lyric_encoder", cfg.num_lyric_encoder_hidden_layers),
        "timbre_encoder": enc_stack("encoder.timbre_encoder", cfg.num_timbre_encoder_hidden_layers),
    }
    tokenizer = {
        "audio_acoustic_proj": lin("tokenizer.audio_acoustic_proj"),
        "attention_pooler": {
            "embed_tokens": lin("tokenizer.attention_pooler.embed_tokens"),
            "special_token": t(np32(state["tokenizer.attention_pooler.special_token"])),
            "layers": [
                enc_layer(f"tokenizer.attention_pooler.layers.{i}")
                for i in range(cfg.num_attention_pooler_hidden_layers)
            ],
            "norm": norm("tokenizer.attention_pooler.norm"),
        },
        "quantizer": {
            "project_in": lin("tokenizer.quantizer.project_in"),
            "project_out": lin("tokenizer.quantizer.project_out"),
        },
    }
    detok = {
        "embed_tokens": lin("detokenizer.embed_tokens"),
        "special_tokens": t(np32(state["detokenizer.special_tokens"])),
        "layers": [enc_layer(f"detokenizer.layers.{i}") for i in range(cfg.num_attention_pooler_hidden_layers)],
        "norm": norm("detokenizer.norm"),
        "proj_out": lin("detokenizer.proj_out"),
    }
    return {
        "decoder": decoder,
        "encoder": encoder,
        "tokenizer": tokenizer,
        "detokenizer": detok,
        "null_condition_emb": t(np32(state["null_condition_emb"])),
    }
