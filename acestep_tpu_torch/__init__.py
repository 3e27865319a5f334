"""PyTorch/CUDA port of the ACE-Step 1.5 serving path, for NVIDIA Hopper.

Mirrors the layout of `acestep_tpu/` (`ops/`, `models/`, `lm/`, `pipeline/`,
`service/`, `tools/`): each module maps to one JAX module (or tool) and names
it in its docstring. The port imports `torch` and `numpy`, never `jax` and
never `acestep_tpu`. The four Pallas kernels of the JAX package (three on the
serving path, one stage probe) are hand-written CUDA C++ for `sm_90a` under
`csrc/`, built with `nvcc` at first use into `_build/`.
"""

__version__ = "0.1.0"
