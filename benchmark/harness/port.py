"""The system under test: the port's handler with the benchmark's weights,
and the benchmark's spy on the port's layer entries.

`make_handler` builds `acestep_tpu_torch.pipeline.handler.AceStepHandler`
at the configuration's sizes and hands it the seeded weights as its random
init would (`_initialize`): parameters, the silence latent and the
byte-level tokenizer the port uses without a checkpoint.

`Spy` wraps, from outside the program, the entries the per-layer metrics
read: `pipeline.handler.AceStepHandler.generate_music` (it keeps each call's
latents for the comparison), `models.dit.dit_forward`,
`models.vae.decode` and `ops.flash_attention.flash_attention`. With tracing
each gets a span on the host clock, as do `models.qwen3.forward_hidden`,
`models.dit.prepare_condition` and the handler's `_decode_latents_finish`,
which name the idle gaps; and the operations and bytes of each attention
and decode call are counted from its shapes. `restore` puts the originals
back.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from harness import measure



def _dataclass_kwargs(cls, values: Dict[str, Any]) -> Dict[str, Any]:
    names = {f.name for f in dataclasses.fields(cls)}
    return {k: (tuple(v) if isinstance(v, list) else v) for k, v in values.items() if k in names}


def make_handler(config: Dict[str, Any], weights: Dict[str, Any], device, dtype=torch.bfloat16):
    from acestep_tpu_torch.config import AceStepConfig, OobleckConfig, Qwen3Config
    from acestep_tpu_torch.pipeline.handler import AceStepHandler
    from acestep_tpu_torch.utils.tokenizer import load_tokenizer

    h = AceStepHandler(AceStepConfig(**_dataclass_kwargs(AceStepConfig, config["dit"])),
                       OobleckConfig(**_dataclass_kwargs(OobleckConfig, config["vae"])),
                       Qwen3Config(**_dataclass_kwargs(Qwen3Config, config["text_encoder"])),
                       dtype=dtype, device=device)
    h.params, h.vae_params, h.text_params = weights["dit"], weights["vae"], weights["text"]
    h.silence_latent = weights["silence"].float().cpu().numpy()
    h.text_tokenizer = load_tokenizer(None)
    h.lora.invalidate_cache()
    h.initialized = True
    return h


class Spy:
    def __init__(self, config: Dict[str, Any], trace: bool):
        self.config = config
        self.trace = trace
        self.latents: List[np.ndarray] = []
        self.attn: List[tuple] = []  # (flops, bytes) of each flash_attention call
        self.decode: List[tuple] = []  # (flops, bytes) of each vae.decode call
        self.spans: List[tuple] = []  # (name, start ns, end ns, thread id)
        self._saved: List[tuple] = []
        self._masks: Dict[int, tuple] = {}

    def _patch(self, owner, name, make):
        orig = getattr(owner, name)
        new = make(orig)
        for attr in ("launches", "f32_launches"):
            if hasattr(orig, attr):
                setattr(new, attr, getattr(orig, attr))
        self._saved.append((owner, name, orig))
        setattr(owner, name, new)

    def install(self, keep_latents: bool = True) -> "Spy":
        from acestep_tpu_torch.models import dit, vae
        from acestep_tpu_torch.ops import flash_attention as fa
        from acestep_tpu_torch.pipeline import handler

        spy = self

        def span(name):
            return spy.span(name)

        def gen(orig):
            def generate_music(self, *a, **kw):
                with span("generate_music"):
                    out = orig(self, *a, **kw)
                if keep_latents and out is not None and "latents" in out:
                    spy.latents.append(out["latents"])
                return out
            return generate_music

        def fwd(orig):
            def dit_forward(*a, **kw):
                with span("dit_forward"):
                    return orig(*a, **kw)
            return dit_forward

        vcfg = self.config["vae"]

        def dec(orig):
            def decode(p, cfg, latents):
                if spy.trace:
                    b, f = latents.shape[0], latents.shape[1]
                    spy.decode.append((measure.vae_decode_flops(vcfg, b, f),
                                       measure.vae_decode_bytes(vcfg, b, f, latents.element_size())))
                with span("vae_decode"):
                    return orig(p, cfg, latents)
            return decode

        def attn(orig):
            def flash_attention(q, k, v, kv_mask=None, *, scale=None, window=None, causal=False):
                if spy.trace:
                    spy.attn.append((tuple(q.shape), tuple(k.shape), q.element_size(), window, causal,
                                     spy._mask_key(kv_mask)))
                with span("flash_attention"):
                    return orig(q, k, v, kv_mask, scale=scale, window=window, causal=causal)
            return flash_attention

        def labelled(name):
            def make(orig):
                def wrapper(*a, **kw):
                    with span(name):
                        return orig(*a, **kw)
                return wrapper
            return make

        from acestep_tpu_torch.models import qwen3

        self._patch(qwen3, "forward_hidden", labelled("text_encoder"))
        self._patch(dit, "prepare_condition", labelled("prepare_condition"))
        self._patch(handler.AceStepHandler, "_decode_latents_finish", labelled("decode_finish"))
        self._patch(handler.AceStepHandler, "generate_music", gen)
        self._patch(dit, "dit_forward", fwd)
        self._patch(vae, "decode", dec)
        self._patch(fa, "flash_attention", attn)
        return self

    def span(self, name: str):
        """With tracing, a span on the host clock (`time.time_ns`, the clock
        the profiler's trace is on) kept in `spans`; else nothing."""
        return _Span(self.spans, name) if self.trace else _Null()

    def _mask_key(self, kv_mask) -> Optional[int]:
        """Masks are read after the window (no sync inside it): each distinct
        mask tensor is kept, so no id is reused while it is held."""
        if kv_mask is None:
            return None
        self._masks[id(kv_mask)] = kv_mask
        return id(kv_mask)

    def attention_work(self) -> tuple:
        """(operations, bytes) of every traced flash_attention call."""
        valid = {key: [int(x) for x in (m != 0).sum(dim=1).tolist()] for key, m in self._masks.items()}
        flops = nbytes = 0.0
        cache: Dict[tuple, float] = {}
        for qs, ks, elem, window, causal, mkey in self.attn:
            b, lq, nq, hd = qs
            lk, nkv = ks[1], ks[2]
            keys = tuple(valid[mkey]) if mkey is not None else (lk,) * b
            ck = (lq, lk, keys, window, causal)
            if ck not in cache:
                cache[ck] = measure.allowed_pairs(lq, lk, keys, window=window, causal=causal)
            flops += measure.attention_flops(cache[ck], nq, hd)
            nbytes += measure.attention_bytes(b, lq, lk, nq, nkv, hd, elem, mkey is not None)
        return flops, nbytes

    def restore(self) -> None:
        for owner, name, orig in reversed(self._saved):
            setattr(owner, name, orig)
        self._saved.clear()
        self._masks.clear()


class _Span:
    def __init__(self, out: list, name: str):
        self.out, self.name = out, name

    def __enter__(self):
        self.start = time.time_ns()
        return self

    def __exit__(self, *a):
        self.out.append((self.name, self.start, time.time_ns(), threading.get_native_id()))
        return False


class _Null:
    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False
