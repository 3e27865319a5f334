"""Time `chip_smoke.py` phase 5's text2music requests in several checkouts on
one card.

Each DIR holds `chip_smoke.py` and `acestep_tpu_torch/` (a `git archive` of a
commit unpacked into a directory that `.gitignore` lists, or the working
tree). Per checkout, as phase 5 runs them: `AceStepHandler` at full width in
bf16 with random weights (seed 0), thinking off, one untimed 1 x 30 s
warm-up, then ROUNDS rounds of 1 x 30 s, 2 x 60 s, 1 x 240 s and 1 x 600 s
through `AceStepHandler.generate_music` (int16 PCM, -1 dB). `ms` is the wall
of one request, host clock around it, each end a device synchronise. Per
shape: the first round alone (the first request at that shape, as phase 5
reads it) and the median of the others (`samples` holds them).

Usage: python -m acestep_tpu_torch.tools.compare_requests DIR [DIR ...] [--out FILE]
"""

from __future__ import annotations

import sys
from typing import Optional, Sequence

from acestep_tpu_torch.tools import compare

ROUNDS = 5

# Runs inside one checkout (argv[1]); argv[2] is "build" or "time".
_CHILD = r"""
import json, statistics, sys, time, torch
sys.path.insert(0, sys.argv[1])
from acestep_tpu_torch.ops import cuda_lib
if sys.argv[2] == "build":
    cuda_lib.build(["flash_attention", "oobleck", "oobleck_sm90"])
    sys.exit(0)
from chip_smoke import CAPTION, LYRICS
from acestep_tpu_torch.pipeline.handler import AceStepHandler

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
h = AceStepHandler(device=torch.device("cuda"))
h.initialize_service(random_init=True, seed=0)


def request(b, dur, seed):
    torch.cuda.synchronize()
    t0 = time.time()
    out = h.generate_music(CAPTION, LYRICS, batch_size=b, audio_duration=dur,
                           seeds=[seed + j for j in range(b)], use_random_seed=False,
                           normalize_db=-1.0, return_int16=True)
    torch.cuda.synchronize()
    assert out["audios"].shape == (b, 2, int(dur * 48000)), out["audios"].shape
    return (time.time() - t0) * 1e3


request(1, 30.0, 1)
walls = {}
for r in range(ROUNDS):
    for i, (b, dur) in enumerate(((1, 30.0), (2, 60.0), (1, 240.0), (1, 600.0))):
        walls.setdefault(f"b{b}x{int(dur)}s", []).append(request(b, dur, 100 + i))
out = {}
for shape, ms in walls.items():
    out[f"{shape} first"] = dict(ms=ms[0])
    out[f"{shape} median of rest"] = dict(ms=statistics.median(ms[1:]), samples=ms[1:])
print(json.dumps(out))
""".replace("ROUNDS", str(ROUNDS))


def main(argv: Optional[Sequence[str]] = None) -> int:
    return compare.main(_CHILD, "compare_requests", argv)


if __name__ == "__main__":
    sys.exit(main())
