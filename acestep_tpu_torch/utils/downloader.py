"""Local checkpoint catalog: per-component verification and the scan that
`/v1/models` reads.

The local half of `acestep_tpu/utils/downloader.py` (`verify_checkpoint`,
`list_available_models` and the component tables): the port has no download
code yet (ROADMAP A.10), so nothing here opens a network connection.
"""

from __future__ import annotations

import glob
import os
from typing import List, Optional

# Component -> required paths inside a DiT checkpoint dir (globs allowed).
DIT_CHECKPOINT_COMPONENTS = {
    "config": ["config.json"],
    "weights": ["*.safetensors"],
    "silence_latent": ["silence_latent.pt", "silence_latent.npy"],
    "vae": ["vae/config.json", "vae/*.safetensors"],
    "text_encoder": ["Qwen3-Embedding-0.6B/config.json", "Qwen3-Embedding-0.6B/*.safetensors"],
}

LM_CHECKPOINT_COMPONENTS = {
    "config": ["config.json"],
    "weights": ["*.safetensors"],
    "tokenizer": ["tokenizer.json", "tokenizer_config.json"],
}


def verify_checkpoint(path: str, components: Optional[dict] = None) -> dict:
    """Check a checkpoint dir component by component: {component: bool}.
    "vae", "text_encoder" and "tokenizer" need every pattern to match a file;
    the others need any one (alternatives such as silence_latent.pt / .npy)."""
    components = components or DIT_CHECKPOINT_COMPONENTS
    out = {}
    for comp, patterns in components.items():
        hits = [bool(glob.glob(os.path.join(path, p))) for p in patterns]
        out[comp] = all(hits) if comp in ("vae", "text_encoder", "tokenizer") else any(hits)
    return out


def list_available_models(root: Optional[str] = None) -> List[dict]:
    """The acestep-* model dirs under `root` (default ACESTEP_CHECKPOINT_ROOT
    or ./checkpoints), each with its per-component status."""
    root = root or os.environ.get("ACESTEP_CHECKPOINT_ROOT", "./checkpoints")
    out: List[dict] = []
    if not os.path.isdir(root):
        return out
    for name in sorted(os.listdir(root)):
        path = os.path.join(root, name)
        if not (os.path.isdir(path) and name.startswith("acestep-")):
            continue
        comps = LM_CHECKPOINT_COMPONENTS if "lm" in name.lower() else DIT_CHECKPOINT_COMPONENTS
        status = verify_checkpoint(path, comps)
        out.append({"name": name, "path": path, "components": status, "complete": all(status.values())})
    return out
