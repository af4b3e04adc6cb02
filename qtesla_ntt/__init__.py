"""qtesla_ntt — a batched polynomial-multiplication framework for qTESLA
on GPUs.

Built from scratch in JAX/XLA/Pallas with the capabilities of the CUDA
reference ``benlwk/ntt-gpu-qTESLA`` (see SURVEY.md): NTT variants with exact
precomputed twiddle tables, lane-parallel Shoup/Barrett modular reduction,
fused negacyclic weighting, a Nussbaumer cross-check path, batched polymul
pipelines with a fused Pallas kernel for the GPU, and multi-device sharding
(batch DP + Ulysses and four-step intra-transform SP).
"""

from .params import (ParamSet, available_param_sets, get_params,  # noqa: F401
                     register_param_set)

__version__ = "0.1.0"
