"""Split the narrow card-vs-CPU references of `chip_smoke.py` into the decoded
audio's own error and its peak normalisation, for several checkouts on one card.

Each DIR holds `chip_smoke.py` and `acestep_tpu_torch/` (a `git archive` of a
commit unpacked into a directory that `.gitignore` lists, or the working
tree). Per checkout, its own `run_small_reference` (thinking off) and
`run_small_thinking_reference` (thinking on) run as `chip_smoke.py` runs
them, with `AceStepHandler._to_pcm` wrapped to keep the waveform it is given (its
decode chunks, joined):
the card's decode (bf16, kernels), then the CPU's (fp32, plain versions).
Reported per reference: the rel-L2 of the waveform before normalisation, the
rel-L2 after each row is scaled to its own peak (what the reference reports),
each row's peak on the card relative to the CPU's, and whether the peak is
the same sample. Times (`ms`) are the host clock of the whole reference.

Usage: python -m acestep_tpu_torch.tools.compare_references DIR [DIR ...] [--out FILE]
"""

from __future__ import annotations

import sys
from typing import Optional, Sequence

from acestep_tpu_torch.tools import compare

# Runs inside one checkout (argv[1]); argv[2] is "build" or "time".
_CHILD = r"""
import contextlib, io, json, sys, time, torch
sys.path.insert(0, sys.argv[1])
from acestep_tpu_torch.ops import cuda_lib
if sys.argv[2] == "build":
    cuda_lib.build(["flash_attention", "oobleck", "oobleck_sm90"])
    sys.exit(0)
import chip_smoke
from acestep_tpu_torch.pipeline.handler import AceStepHandler

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
seen = []
real = AceStepHandler._to_pcm


def spy(wavs, normalize_db):
    seen.append(torch.cat([w.detach().float().cpu() for w in wavs], dim=1))
    return real(wavs, normalize_db)


AceStepHandler._to_pcm = staticmethod(spy)
rel = lambda a, b: ((a - b).norm() / b.norm()).item()
out = {}
for name, run in (("thinking off", chip_smoke.run_small_reference),
                  ("thinking on", chip_smoke.run_small_thinking_reference)):
    t0 = time.time()
    with contextlib.redirect_stdout(io.StringIO()):
        run(torch.device("cuda"))
    ms = (time.time() - t0) * 1e3
    card, cpu = seen[-2], seen[-1]
    pk_card, pk_cpu = card.abs().amax(dim=(1, 2)), cpu.abs().amax(dim=(1, 2))
    at = lambda w: w.abs().flatten(1).argmax(dim=1)
    out[name] = dict(
        ms=ms, raw_rel_l2=rel(card, cpu),
        normalised_rel_l2=rel(card / pk_card[:, None, None], cpu / pk_cpu[:, None, None]),
        peak_card_over_cpu_minus_1=(pk_card / pk_cpu - 1).tolist(),
        same_peak_sample=(at(card) == at(cpu)).tolist())
print(json.dumps(out))
"""


def main(argv: Optional[Sequence[str]] = None) -> int:
    return compare.main(_CHILD, "compare_references", argv)


if __name__ == "__main__":
    sys.exit(main())
