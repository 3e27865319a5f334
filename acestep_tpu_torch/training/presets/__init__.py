"""Training presets by card memory: a copy of `acestep_tpu/training/presets`
(the two TPU presets as they are) plus `h100_80gb.json` for the port's card,
sized from the peak memory that `chip_smoke.py`'s training phase reads."""

import json
import os
from typing import Any, Dict, List

_DIR = os.path.dirname(os.path.abspath(__file__))


def list_presets() -> List[str]:
    return sorted(f[:-5] for f in os.listdir(_DIR) if f.endswith(".json"))


def load_preset(name: str) -> Dict[str, Any]:
    with open(os.path.join(_DIR, name + ".json")) as f:
        return json.load(f)
