"""Guard for measurement entry points: they run on a GPU or not at all."""

from __future__ import annotations

import jax

__all__ = ["require_gpu"]


def require_gpu(what: str):
    """JAX's default device if it is a GPU; otherwise exit non-zero with
    the reason, so no number is ever taken on another device."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"{what}: needs a GPU, but JAX's default device is "
                         f"{dev.platform} ({dev.device_kind}); not running")
    return dev
