"""The port's command line on the tiny CPU configs of the tests.

`python tests/torch_tiny_cli.py <acestep_tpu_torch.cli arguments>` runs
`acestep_tpu_torch.cli.main` with the DiT, VAE, text encoder and planner at
the tiny widths of `tests/test_torch_serve.py` (fp32) and its small buckets,
so `--random-init` builds a model a CPU runs in a second. The patches are
made when this file is imported, so the ranks that `--dp` spawns (they import
the main script again) run the same model, with one intra-op thread each;
`random` is seeded, so a request's drawn seeds are the same in every run.
"""

import os
import random
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import acestep_tpu_torch.lm.handler as TLM  # noqa: E402
import acestep_tpu_torch.pipeline.handler as TH  # noqa: E402
from acestep_tpu_torch.config import AceStepConfig, OobleckConfig, Qwen3Config  # noqa: E402
from tests.test_torch_serve import BUCKETS, TINY_DIT, TINY_TEXT, TINY_VAE  # noqa: E402

for _name, _val in BUCKETS.items():
    setattr(TH, _name, _val)
_dit_init, _lm_init = TH.AceStepHandler.__init__, TLM.LLMHandler.__init__


def _tiny_dit(self, config=None, vae_config=None, text_config=None, dtype=torch.float32, device=None):
    _dit_init(self, config or AceStepConfig(**TINY_DIT), vae_config or OobleckConfig(**TINY_VAE),
              text_config or Qwen3Config(**TINY_TEXT), dtype=dtype, device=device)


def _tiny_lm(self, config=None, dtype=torch.float32, device=None):
    _lm_init(self, config or Qwen3Config(**TINY_TEXT), dtype=dtype, device=device)


TH.AceStepHandler.__init__ = _tiny_dit
TLM.LLMHandler.__init__ = _tiny_lm
torch.set_num_threads(1)
random.seed(0)

if __name__ == "__main__":
    from acestep_tpu_torch.cli import main

    sys.exit(main())
