"""Scenario-parallel execution over ``torch.distributed``: one process per
card.

Counterpart of the JAX package's ``parallel/mesh.py``.  There a global batch
is sharded over a 1-D ("data") device mesh with ``shard_map``; PyTorch's
idiom is one process per card (``torchrun --nproc-per-node=N``), so here
each rank holds its own contiguous block of the batch (``local_rows``: the
layout ``P("data")`` gives), solves it on its own card, and communicates
only the metric reductions and, in ``shard_scenarios``, the outputs.
Scenarios are independent, so no row ever needs another rank's data.

Every sharded entry takes this rank's rows and returns this rank's rows (the
counterpart of ``jax.make_array_from_process_local_data``, which is what
several hosts feed); its reductions come back the same on every rank.

Collectives run on the mesh's device under NCCL and on the host under gloo,
chosen by the group's backend.  NCCL refuses two ranks on one device, so a
world of 2 on a single card is a gloo group with both ranks on that card: a
correctness run, not a measure of scaling.

Multi-card usage::

    # torchrun --nproc-per-node=N script.py
    torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
    initialize_distributed(backend="nccl")
    mesh = make_mesh()
    sol, metrics = solve_linear_sharded(structure, mesh,
                                        local_rows(d_fixed, mesh),
                                        local_rows(times, mesh))
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import torch
import torch.distributed as dist

from .._tensors import DeviceLike, as_tensor, resolve_device
from ..solver import linear
from ..solver.qcqp import ADMMConfig, solve_qcqp_batch
from ..solver.structure import ProblemStructure

#: The mesh axis's name in the JAX package; kept for the name.
DATA_AXIS = "data"


class Mesh(NamedTuple):
    """This rank's view of a 1-D scenario mesh."""
    group: Any                  # torch.distributed ProcessGroup
    rank: int                   # this rank within ``group``
    size: int                   # ranks in ``group``
    device: torch.device        # where this rank solves its rows


def initialize_distributed(**kwargs) -> None:
    """``torch.distributed.init_process_group`` passthrough (under torchrun
    call it with no arguments, or just ``backend=``).

    Does nothing when a group already exists; any real bring-up error (bad
    rendezvous, unreachable peers, ...) propagates: a misconfigured job that
    quietly ran as one process would corrupt every reduced metric.
    """
    if dist.is_initialized():
        return
    dist.init_process_group(**kwargs)


def make_mesh(device: DeviceLike = None, group=None) -> Mesh:
    """The 1-D scenario mesh over ``group`` (the world group by default),
    solving on ``device``: ``None`` means the current CUDA card (set it with
    ``torch.cuda.set_device`` first) and raises when there is none.

    Raises RuntimeError when no process group is initialised.
    """
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "no torch.distributed process group is initialised: call "
            "initialize_distributed(...) first (under torchrun with no "
            "arguments)")
    group = dist.group.WORLD if group is None else group
    return Mesh(group, dist.get_rank(group), dist.get_world_size(group),
                resolve_device(device))


def pad_batch(n: int, n_shards: int) -> int:
    """Smallest multiple of n_shards >= n (ragged-batch padding)."""
    return ((n + n_shards - 1) // n_shards) * n_shards


def local_rows(x, mesh: Mesh):
    """This rank's contiguous block of a global batch ``x`` (leading axis
    divisible by the mesh size: use ``pad_batch``), as ``P("data")`` lays
    the batch out.  A slice of ``x`` (tensor or NumPy array), not a copy."""
    n = x.shape[0]
    if n % mesh.size:
        raise ValueError(f"a batch of {n} rows does not divide over "
                         f"{mesh.size} ranks; pad it (pad_batch)")
    per = n // mesh.size
    return x[mesh.rank * per:(mesh.rank + 1) * per]


def _comm_device(mesh: Mesh) -> torch.device:
    if dist.get_backend(mesh.group) == dist.Backend.NCCL:
        return mesh.device
    return torch.device("cpu")


def _all_reduce(mesh: Mesh, t: torch.Tensor,
                op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``t`` reduced over the mesh, as a new tensor on ``t``'s device."""
    c = t.to(_comm_device(mesh), copy=True)
    dist.all_reduce(c, op=op, group=mesh.group)
    return c.to(t.device)


def _all_gather(mesh: Mesh, t: torch.Tensor) -> torch.Tensor:
    """Every rank's ``t`` (same shape on each) concatenated along the
    leading axis in rank order, on ``t``'s device."""
    c = t.to(_comm_device(mesh)).contiguous()
    if c.dtype == torch.bool:           # gathered as bytes
        c = c.to(torch.uint8)
    parts = [torch.empty_like(c) for _ in range(mesh.size)]
    dist.all_gather(parts, c, group=mesh.group)
    return torch.cat(parts).to(device=t.device, dtype=t.dtype)


class BatchMetrics(NamedTuple):
    """Metric reductions over the mesh (0-d tensors on the mesh's device,
    the same on every rank)."""
    n_scenarios: torch.Tensor     # float32
    n_finite: torch.Tensor        # float32
    total_cost: torch.Tensor      # sum of the finite costs
    max_cost: torch.Tensor        # max of the finite costs; -inf if none


def _batch_metrics(mesh: Mesh, cost: torch.Tensor) -> BatchMetrics:
    finite = torch.isfinite(cost)
    c64 = cost.to(torch.float64)
    sums = torch.stack([
        torch.tensor(float(cost.shape[0]), dtype=torch.float64,
                     device=cost.device),
        finite.sum().to(torch.float64),
        torch.where(finite, c64, 0.0).sum()])
    # -inf joins the finite costs, so that an empty shard gives -inf
    top = torch.cat([torch.where(finite, c64, -torch.inf),
                     c64.new_full((1,), -torch.inf)]).max()
    sums = _all_reduce(mesh, sums).to(mesh.device)
    top = _all_reduce(mesh, top, dist.ReduceOp.MAX).to(mesh.device)
    return BatchMetrics(n_scenarios=sums[0].to(torch.float32),
                        n_finite=sums[1].to(torch.float32),
                        total_cost=sums[2].to(cost.dtype),
                        max_cost=top.to(cost.dtype))


def solve_linear_sharded(structure: ProblemStructure, mesh: Mesh, d_fixed,
                         times):
    """This rank's rows of a batched linear solve, with metrics over the
    whole mesh.

    Args:
      structure: static problem family.
      mesh: from ``make_mesh``.
      d_fixed: (b, n_fixed, D), this rank's rows (``local_rows``).
      times: (b, K).

    Returns (LinearSolution of this rank's rows on ``mesh.device``,
    BatchMetrics reduced over every rank: counts and cost sum by
    ``all_reduce`` SUM, the largest finite cost by MAX).
    """
    d_fixed = as_tensor(d_fixed, None, mesh.device)
    times = as_tensor(times, None, mesh.device)
    sol = linear.solve_linear(structure, d_fixed, times)
    return sol, _batch_metrics(mesh, sol.cost)


def solve_qcqp_sharded(structure: ProblemStructure, mesh: Mesh, d_fixed,
                       times, waypoints, radii,
                       config: Optional[ADMMConfig] = None, x0=None):
    """This rank's rows of the tube-QCQP batch (``solve_qcqp_batch`` on
    ``mesh.device``; no cross-scenario communication), and the count of rows
    under the 1e-2 gate over the whole mesh.

    With ``x0=None`` each rank runs ``solve_qcqp_batch``'s own cold start
    (the unconstrained minimum), as the unsharded call does.

    Returns (QCQPSolution of this rank's rows, n_ok: float32 0-d tensor on
    ``mesh.device``, the same on every rank).
    """
    if config is None:
        config = ADMMConfig()
    sol = solve_qcqp_batch(structure, d_fixed, times, waypoints, radii,
                           config=config, x0=x0, device=mesh.device)
    n_ok = (sol.max_violation < 1e-2).sum(dtype=torch.float32)
    return sol, _all_reduce(mesh, n_ok)


def _gather_tree(mesh: Mesh, out):
    if out is None:
        return None
    if isinstance(out, torch.Tensor):
        return _all_gather(mesh, out)
    if isinstance(out, tuple) and hasattr(out, "_fields"):     # NamedTuple
        return type(out)(*(_gather_tree(mesh, o) for o in out))
    if isinstance(out, (tuple, list)):
        return type(out)(_gather_tree(mesh, o) for o in out)
    raise TypeError(f"shard_scenarios: cannot gather a {type(out).__name__}")


def shard_scenarios(fn: Callable[..., Any], mesh: Mesh,
                    n_args: int) -> Callable[..., Any]:
    """Wrap a per-scenario-batch function for scenario-parallel execution.

    The wrapper takes ``n_args`` arrays of this rank's rows (leading batch
    axis), runs ``fn`` on them and returns its outputs (a tensor, or tuples,
    lists and NamedTuples of them, each with a leading batch axis)
    gathered over the mesh into the whole batch in rank order, which is what
    ``out_specs=P("data")`` gives.  Every rank must hold the same number of
    rows: otherwise every rank raises ValueError before ``fn`` runs.
    """
    def sharded(*args):
        if len(args) != n_args:
            raise TypeError(f"expected {n_args} arrays, got {len(args)}")
        rows = torch.tensor([a.shape[0] for a in args], dtype=torch.long)
        table = _all_gather(mesh, rows[None]).tolist()
        if any(r != table[0][0] for ranks in table for r in ranks):
            raise ValueError(
                "shard_scenarios: the ranks hold different row counts "
                f"(rank by argument: {table}); pad the batch (pad_batch)")
        return _gather_tree(mesh, fn(*args))
    return sharded
