"""Layered configuration: .env file → environment variables → CLI args (a
copy of `acestep_tpu/utils/env.py`).

Role parity with the reference's config precedence
(`acestep_v15_pipeline.py:10-27` .env loading; precedence CLI > env > defaults,
SURVEY §5 "Config / flag system"). Stdlib-only dotenv.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

_loaded = False


def load_dotenv(path: str = ".env", *, override: bool = False) -> Dict[str, str]:
    """Load KEY=VALUE lines from .env (once); existing env vars win unless override."""
    global _loaded
    values: Dict[str, str] = {}
    candidates = [path]
    if path == ".env" and not os.path.exists(path) and os.path.exists(".env.example"):
        candidates.append(".env.example")
    for p in candidates:
        if not os.path.exists(p):
            continue
        with open(p) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#") or "=" not in line:
                    continue
                k, v = line.split("=", 1)
                k, v = k.strip(), v.strip().strip("'\"")
                values[k] = v
                if override or k not in os.environ:
                    os.environ[k] = v
        break
    _loaded = True
    return values


def env_str(key: str, default: Optional[str] = None) -> Optional[str]:
    return os.environ.get(key, default)


def env_bool(key: str, default: bool = False) -> bool:
    v = os.environ.get(key)
    if v is None:
        return default
    return v.strip().lower() in ("1", "true", "yes", "on")


def env_int(key: str, default: int) -> int:
    try:
        return int(os.environ.get(key, default))
    except ValueError:
        return default
