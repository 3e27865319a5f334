"""Checkpoints: download with source failover, per-component verification,
and the local catalog that `/v1/models` reads.

Port of `acestep_tpu/utils/downloader.py`. `ensure_model` returns a local
directory for a model name, downloading it from the Hugging Face Hub (or
ModelScope when only that answers, `pick_source`) when the cache holds none;
`ensure_components` re-downloads only when a component is missing. Without a
reachable source every download path returns None and the caller keeps to
the local directories. Only `pick_source` and the snapshot downloads open
network connections; `verify_checkpoint` and `list_available_models` read the
local disk.
"""

from __future__ import annotations

import glob
import os
import socket
from typing import List, Optional

MODEL_REPOS = {
    "acestep-v15-turbo": "ACE-Step/ACE-Step-v1.5-turbo",
    "acestep-v15-base": "ACE-Step/ACE-Step-v1.5-base",
    "acestep-v15-sft": "ACE-Step/ACE-Step-v1.5-sft",
    "acestep-5Hz-lm-0.6B": "ACE-Step/acestep-5Hz-lm-0.6B",
    "acestep-5Hz-lm-1.7B": "ACE-Step/acestep-5Hz-lm-1.7B",
    "acestep-5Hz-lm-4B": "ACE-Step/acestep-5Hz-lm-4B",
}

DEFAULT_CACHE_DIR = os.path.expanduser("~/.cache/acestep_tpu/checkpoints")


def _reachable(host: str, port: int = 443, timeout: float = 3.0) -> bool:
    try:
        with socket.create_connection((host, port), timeout=timeout):
            return True
    except OSError:
        return False


def pick_source() -> Optional[str]:
    """'hf' when huggingface.co answers, 'modelscope' as the fallback, else None."""
    if _reachable("huggingface.co"):
        return "hf"
    if _reachable("www.modelscope.cn"):
        return "modelscope"
    return None


def ensure_model(name: str, cache_dir: str = DEFAULT_CACHE_DIR, *, source: Optional[str] = None) -> Optional[str]:
    """A local directory for `name` (a key of MODEL_REPOS, or a repo id):
    the cache's when it holds files, else a download when a source answers,
    else None."""
    local = os.path.join(cache_dir, name)
    if os.path.isdir(local) and os.listdir(local):
        return local
    source = source or pick_source()
    if source is None:
        return None
    repo = MODEL_REPOS.get(name, name)
    try:
        if source == "hf":
            from huggingface_hub import snapshot_download  # type: ignore
        else:
            from modelscope import snapshot_download  # type: ignore
        return snapshot_download(repo, local_dir=local)
    except Exception:  # noqa: BLE001 — no package, no network, no repo: no directory
        return None


def ensure_all(names: List[str], cache_dir: str = DEFAULT_CACHE_DIR) -> dict:
    return {n: ensure_model(n, cache_dir) for n in names}

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


def ensure_components(name: str, cache_dir: str = DEFAULT_CACHE_DIR, *, source: Optional[str] = None) -> dict:
    """Verify the cached directory of `name` and download only when a
    component is missing: {"path", "components": {component: bool},
    "downloaded"}."""
    local = os.path.join(cache_dir, name)
    comps = LM_CHECKPOINT_COMPONENTS if "lm" in name.lower() else DIT_CHECKPOINT_COMPONENTS
    status = verify_checkpoint(local, comps) if os.path.isdir(local) else {c: False for c in comps}
    if all(status.values()):
        return {"path": local, "components": status, "downloaded": False}
    got = ensure_model(name, cache_dir, source=source)
    if got:
        status = verify_checkpoint(got, comps)
    return {"path": got, "components": status, "downloaded": got is not None}
