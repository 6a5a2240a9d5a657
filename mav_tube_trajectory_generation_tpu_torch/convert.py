"""Carries problem state between the JAX package and this one, as NumPy.

The system has no weights; what crosses over is problem state.  Nothing here
imports the JAX package: its objects are read by attribute or as dicts of
NumPy arrays, so the host-only tests can feed one package's intermediate
tensors to the other and compare a single stage apart from the assembly.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from ._tensors import DeviceLike, as_tensor, resolve_device
from .solver.qcqp import _Pre
from .solver.structure import ProblemStructure, make_structure

_STRUCTURE_ARRAYS = ("fixed_mask", "gather_idx", "fixed_cols", "free_cols")


def structure_from_fields(other: Any) -> ProblemStructure:
    """This package's ``ProblemStructure`` from any object with the same
    attributes (``n_coefficients``, ``dimension``, ``derivative_to_optimize``,
    ``fixed_mask``).  The index maps are rebuilt from the mask and checked
    against the source's, where it has them."""
    structure = make_structure(
        np.asarray(other.fixed_mask, dtype=bool), int(other.dimension),
        int(other.n_coefficients), int(other.derivative_to_optimize))
    for name in _STRUCTURE_ARRAYS:
        theirs = getattr(other, name, None)
        if theirs is not None and not np.array_equal(
                np.asarray(theirs), getattr(structure, name)):
            raise ValueError(f"structure field {name!r} differs from the "
                             f"source object's")
    return structure


def pre_from_numpy(pre: Mapping[str, Any], device: DeviceLike = None,
                   dtype: torch.dtype = torch.float32) -> _Pre:
    """The pre-stage bundle of a batch (``gt, b_pad, rb, sb, sh, p_eq,
    q_flat, x_flat0, d_scale``, each with a leading batch axis) from a
    mapping of NumPy arrays, e.g. the fields of the JAX package's
    ``_PallasPre`` as ``solve_qcqp_batch(..., _return_pre=True)`` returns
    them with the scenario blocking flattened."""
    dev = resolve_device(device)
    return _Pre(**{name: as_tensor(np.asarray(pre[name]), dtype, dev)
                   for name in _Pre._fields})


def solution_to_numpy(sol: Any) -> Dict[str, np.ndarray]:
    """A solution NamedTuple (``LinearSolution``, ``QCQPSolution``) as a dict
    of NumPy arrays; fields that are None are left out."""
    out = {}
    for name, value in sol._asdict().items():
        if value is None:
            continue
        if isinstance(value, torch.Tensor):
            value = value.detach().cpu().numpy()
        out[name] = np.asarray(value)
    return out
