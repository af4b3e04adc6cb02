"""Device-mesh helpers.

The reference is single-GPU/single-process (SURVEY.md §2.4: no NCCL/MPI, no
multi-device code); this layer is the from-scratch distributed backend: a
(data, model) mesh where the batch axis is data-parallel (the reference's
blockIdx.x batching scaled out) and the model axis carries the
intra-transform sharding whose transpose is an all-to-all (SURVEY.md §5
"long-context" row).
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh

__all__ = ["make_mesh"]


def make_mesh(data: int | None = None, model: int = 1,
              devices=None) -> Mesh:
    """Build a (data, model) mesh.  data=None uses all remaining devices.

    The cards of one host are joined all to all, so device order does not
    matter for speed; the shape follows the algorithm alone (model is the
    SP group size).
    """
    devices = list(devices if devices is not None else jax.devices())
    if data is None:
        assert len(devices) % model == 0
        data = len(devices) // model
    n = data * model
    if n > len(devices):
        raise ValueError(f"mesh {data}x{model} needs {n} devices, have "
                         f"{len(devices)}")
    arr = np.asarray(devices[:n]).reshape(data, model)
    return Mesh(arr, ("data", "model"))
