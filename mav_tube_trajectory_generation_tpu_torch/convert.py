"""Carries problem state between the JAX package and this one, as NumPy.

The system has no weights; what crosses over is problem state.  Nothing here
imports the JAX package: its objects are read by attribute or as dicts of
NumPy arrays, so the host-only tests can feed one package's intermediate
tensors to the other and compare a single stage apart from the assembly.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

from ._tensors import DeviceLike, as_tensor, resolve_device
from .models.esdf import Esdf
from .models.trajectory import Trajectory
from .solver.ipm import IPMConfig
from .solver.nonlinear import (CostWeights, MagnitudeConstraint,
                               NonlinearParameters, NonlinearResult,
                               Objective)
from .solver.qcqp import ADMMConfig, QCQPSolution, _Pre
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


def ipm_config_from_fields(other: Any) -> IPMConfig:
    """This package's ``IPMConfig`` from any object with its fields (e.g.
    the JAX package's; fields of ``other`` that this package has no use
    for, such as that package's choice of accelerator back end, are
    ignored)."""
    return IPMConfig(**{f.name: getattr(other, f.name)
                        for f in dataclasses.fields(IPMConfig)})


def admm_config_from_fields(other: Any) -> ADMMConfig:
    """This package's ``ADMMConfig`` from any object with its fields (e.g.
    the JAX package's, with its KKT route selectors ``kkt_inverse``,
    ``kkt_apply``, ``band_gram`` and ``gt_assembly``).  That package's
    ``use_pallas`` is ignored (here the device of the tensors picks kernel or
    plain version)."""
    return ADMMConfig(**{f.name: getattr(other, f.name)
                         for f in dataclasses.fields(ADMMConfig)})


def pre_from_numpy(pre: Any, device: DeviceLike = None,
                   dtype: torch.dtype = torch.float32) -> _Pre:
    """The pre-stage bundle of a batch (``gt, b_pad, rb, sb, sh, p_eq,
    q_flat, x_flat0, d_scale``, each with a leading batch axis) from a
    mapping of NumPy arrays or from an object with those attributes, e.g.
    the JAX package's ``_PallasPre`` as ``solve_qcqp_batch(...,
    _return_pre=True)`` returns it (flat batch axis; its other fields are
    ignored), so that ``solve_qcqp_ipm_lanes(pre=...)`` starts from the same
    assembled system in both packages.  G^T's row factors, which only the
    ``gt_assembly="kernel"`` route has, are left None."""
    dev = resolve_device(device)
    get = pre.__getitem__ if isinstance(pre, Mapping) else \
        (lambda name: getattr(pre, name))
    return _Pre(**{name: as_tensor(np.asarray(get(name)), dtype, dev)
                   for name in _Pre._fields
                   if name not in _Pre._field_defaults})


#: The 20 inputs of one ``ops.ipm_kernel.ipm_pipe_step`` call, in order.
PIPE_STEP_INPUTS = ("gt", "b", "rb", "pe_d", "pe_u", "q", "x", "s", "lam",
                    "y", "bx", "by", "bm", "sinv", "t", "tt", "dsc", "rhs",
                    "act", "cw")


#: The 12 inputs of one ``ops.ipm_kernel.ipm_solve_fused`` call, in order.
FUSED_SOLVE_INPUTS = ("gt", "b", "rb", "pe_d", "pe_u", "q", "x0", "s0",
                      "lam0", "y0", "act", "cw")


def _kernel_inputs(names, state, device, dtype) -> Tuple[torch.Tensor, ...]:
    dev = resolve_device(device)
    out = []
    for name in names:
        a = np.asarray(state[name])
        want = 3 if name not in ("pe_d", "pe_u", "sinv", "t", "tt") else 4
        if a.ndim == want + 1 and name not in ("act", "cw"):
            a = a.reshape((-1,) + a.shape[2:])
        out.append(as_tensor(a, dtype, dev).contiguous())
    return tuple(out)


def lanes_state_from_numpy(state: Mapping[str, Any],
                           device: DeviceLike = None,
                           dtype: torch.dtype = torch.float32
                           ) -> Tuple[torch.Tensor, ...]:
    """The 20 input tensors of one pipelined IPM step (``PIPE_STEP_INPUTS``)
    from a mapping of NumPy arrays.  Arrays grouped as (B / S, S, ...) by the
    JAX package's scenario blocking are flattened to the port's flat batch;
    ``act`` and ``cw`` stay (1, 1, m_p)."""
    return _kernel_inputs(PIPE_STEP_INPUTS, state, device, dtype)


def fused_state_from_numpy(state: Mapping[str, Any],
                           device: DeviceLike = None,
                           dtype: torch.dtype = torch.float32
                           ) -> Tuple[torch.Tensor, ...]:
    """The 12 input tensors of one whole-polish call
    (``FUSED_SOLVE_INPUTS``) from a mapping of NumPy arrays, blocked arrays
    flattened as in ``lanes_state_from_numpy``."""
    return _kernel_inputs(FUSED_SOLVE_INPUTS, state, device, dtype)


def solution_from_numpy(fields: Any, device: DeviceLike = None,
                        dtype: torch.dtype = None) -> QCQPSolution:
    """This package's ``QCQPSolution`` from a mapping of NumPy arrays or
    from an object with those attributes (e.g. the JAX package's solution, or
    what ``solution_to_numpy`` gave): float fields in ``dtype`` (kept if
    None), ``converged`` and ``infeasible`` as bool, missing or None fields
    None.  For handing one package's tier result to the other's router."""
    dev = resolve_device(device)
    get = fields.get if isinstance(fields, Mapping) else \
        (lambda name: getattr(fields, name, None))
    out = {}
    for name in QCQPSolution._fields:
        value = get(name)
        if value is None:
            out[name] = None
            continue
        a = np.asarray(value)
        out[name] = as_tensor(a, torch.bool if a.dtype == bool else (
            dtype if a.dtype.kind == "f" else None), dev)
    return QCQPSolution(**out)


def auto_result_to_numpy(res: Any) -> Dict[str, Any]:
    """An ``AutoResult`` as plain NumPy: ``solution`` as
    ``solution_to_numpy`` gives it, plus ``verdict``, ``escalated``,
    ``n_escalated`` and ``tier``."""
    return dict(solution=solution_to_numpy(res.solution),
                verdict=np.asarray(res.verdict),
                escalated=np.asarray(res.escalated),
                n_escalated=int(res.n_escalated),
                tier=None if res.tier is None else np.asarray(res.tier))


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


def trajectory_from_numpy(other: Any, device: DeviceLike = None,
                          dtype: torch.dtype = None) -> Trajectory:
    """This package's ``Trajectory`` from any object with ``coefficients``
    (..., K, N, D) and ``times`` (..., K) arrays (e.g. the JAX package's),
    on ``device`` (None: the CUDA card), in ``dtype`` (None: kept)."""
    dev = resolve_device(device)
    return Trajectory(as_tensor(np.asarray(other.coefficients), dtype, dev),
                      as_tensor(np.asarray(other.times), dtype, dev))


def trajectory_to_numpy(traj: Trajectory) -> Tuple[np.ndarray, np.ndarray]:
    """(coefficients, times) as NumPy arrays: ``Trajectory(*result)`` in
    either package."""
    return (traj.coefficients.detach().cpu().numpy(),
            traj.times.detach().cpu().numpy())


def esdf_from_numpy(other: Any, device: DeviceLike = None,
                    dtype: torch.dtype = None) -> Esdf:
    """This package's ``Esdf`` from any object with ``distance``,
    ``origin`` and ``resolution`` arrays (e.g. the JAX package's), on
    ``device`` (None: the CUDA card), in ``dtype`` (None: kept)."""
    dev = resolve_device(device)
    return Esdf(as_tensor(np.asarray(other.distance), dtype, dev),
                as_tensor(np.asarray(other.origin), dtype, dev),
                as_tensor(np.asarray(other.resolution), dtype, dev),
                getattr(other, "method", None))


def nonlinear_parameters_from_fields(other: Any) -> NonlinearParameters:
    """This package's ``NonlinearParameters`` from any object with its
    fields (e.g. the JAX package's): the objective by its value, the
    weights as ``CostWeights``."""
    kw = {f.name: getattr(other, f.name)
          for f in dataclasses.fields(NonlinearParameters)}
    kw["objective"] = Objective(getattr(kw["objective"], "value",
                                        kw["objective"]))
    kw["weights"] = CostWeights(**{f.name: getattr(kw["weights"], f.name)
                                   for f in dataclasses.fields(CostWeights)})
    return NonlinearParameters(**kw)


def magnitude_constraint_from_fields(other: Any) -> MagnitudeConstraint:
    """This package's ``MagnitudeConstraint`` from any object with
    ``derivative`` and ``value``."""
    return MagnitudeConstraint(int(other.derivative), float(other.value))


def nonlinear_result_to_numpy(res: NonlinearResult) -> Dict[str, Any]:
    """A ``NonlinearResult`` as NumPy: its array fields as arrays, ``cost``
    and ``initial_cost`` as dicts of arrays, ``maxima`` keyed by
    derivative order; fields that are None are left out."""
    def np_of(a):
        return a.detach().cpu().numpy()
    out: Dict[str, Any] = {}
    for name, value in res._asdict().items():
        if value is None:
            continue
        if name in ("cost", "initial_cost"):
            out[name] = {k: np_of(v) for k, v in value._asdict().items()}
        elif name == "maxima":
            out[name] = {k: np_of(v) for k, v in value.items()}
        else:
            out[name] = np_of(value)
    return out
