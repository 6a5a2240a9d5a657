"""Device and constant-tensor helpers shared by the port's modules.

Static problem structure lives in NumPy (float64 tables, int index maps).
``const`` turns one such array into a tensor once per (key, dtype, device)
and caches it, so the batched solvers never rebuild or re-upload a table.
"""

from __future__ import annotations

from typing import Callable, Dict, Hashable, Optional, Tuple, Union

import numpy as np
import torch

DeviceLike = Optional[Union[str, torch.device]]

_CONST_CACHE: Dict[Tuple[Hashable, torch.dtype, torch.device], torch.Tensor] = {}


def resolve_device(device: DeviceLike) -> torch.device:
    """``None`` means the CUDA card; there is no silent CPU fallback.

    Raises RuntimeError when the card is asked for (explicitly or by default)
    and none is present.  Pass ``device="cpu"`` to run on the host.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' explicitly "
                "to run on the host")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def const(key: Hashable, build: Callable[[], np.ndarray], dtype: torch.dtype,
          device: torch.device) -> torch.Tensor:
    """Cached tensor of the NumPy constant ``build()`` for this dtype/device.

    Integer index maps pass ``dtype=torch.long``.  float64 tables are rounded
    once to the working dtype here -- the single place where f64 constants
    enter f32 arithmetic.
    """
    device = torch.device(device)
    full_key = (key, dtype, device)
    out = _CONST_CACHE.get(full_key)
    if out is None:
        out = torch.as_tensor(np.array(build()), dtype=dtype,
                              device=device)
        _CONST_CACHE[full_key] = out
    return out


def as_tensor(a, dtype: Optional[torch.dtype], device: torch.device
              ) -> torch.Tensor:
    """Array-like or tensor -> tensor on ``device`` (dtype kept if None)."""
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=dtype if dtype is not None
                    else a.dtype)
    return torch.as_tensor(np.array(a), dtype=dtype, device=device)


def tensor_dtype(a) -> torch.dtype:
    """Torch dtype of a tensor or array-like (NumPy rules for the latter)."""
    if isinstance(a, torch.Tensor):
        return a.dtype
    return torch.from_numpy(np.zeros((), np.asarray(a).dtype)).dtype
