"""A forward step on the flagship configuration, for a first check that the
package runs on a device, and a dry run of the whole compute path over a
scenario mesh: the counterparts of the JAX package's
``__graft_entry__.entry()`` and ``dryrun_multichip``.

``entry()`` returns ``(fn, example_args)``: ``fn(d_fixed, times)`` solves a
batch of 10-segment, 3-D, N=10 min-snap problems (``solve_linear``) and
rolls each trajectory out at 32 points of its duration (positions and
velocities); ``example_args`` is a batch of 16 such problems on ``device``.

``dryrun_multichip(mesh)`` runs, inside an initialised process group, one
sharded pipeline step on tiny shapes (two scenarios a rank).
"""

from __future__ import annotations

import numpy as np
import torch

from ._tensors import DeviceLike, resolve_device
from .models import trajectory as tj
from .models.vertex import segment_times_nfabian
from .parallel import mesh as pmesh
from .solver import auto, ipm_lanes, linear, nonlinear, qcqp
from .solver import structure as sm
from .solver.ipm import IPMConfig


def _flagship_structure():
    return sm.make_structure(sm.standard_mask(11, 10), dimension=3,
                             n_coefficients=10)


def _example_inputs(structure, batch: int, dtype: torch.dtype,
                    device: torch.device):
    rng = np.random.RandomState(0)
    waypoints = np.cumsum(rng.uniform(0.5, 2.0, size=(batch, 11, 3)), axis=1)
    values = np.zeros((batch, 11, 5, 3))
    values[:, :, 0, :] = waypoints
    times = np.asarray(segment_times_nfabian(waypoints, 3.0, 5.0))
    d_fixed = linear.extract_fixed_values(structure,
                                          torch.as_tensor(values))
    return (d_fixed.to(device=device, dtype=dtype),
            torch.as_tensor(times, dtype=dtype, device=device))


def entry(device: DeviceLike = None, dtype: torch.dtype = torch.float32):
    """(fn, example_args): the batched solve and rollout, and a batch of 16
    problems in ``dtype`` on ``device`` (None means the CUDA card)."""
    dev = resolve_device(device)
    structure = _flagship_structure()

    def forward(d_fixed, times):
        sol = linear.solve_linear(structure, d_fixed, times)
        traj = tj.Trajectory(sol.coefficients, sol.times)
        total = torch.sum(times, dim=-1, keepdim=True)
        ts = total * torch.linspace(0.0, 0.999, 32, dtype=times.dtype,
                                    device=times.device)
        return sol.cost, tj.evaluate(traj, ts, 0), tj.evaluate(traj, ts, 1)

    return forward, _example_inputs(structure, 16, dtype, dev)


def dryrun_multichip(mesh=None, device: DeviceLike = None) -> dict:
    """One whole sharded pipeline step over a scenario mesh, on tiny shapes
    (K=4, two scenarios a rank; the dry run checks the sharding, not the
    throughput): the linear warm start, the tube QCQP from it, one autograd
    step through the nonlinear objective, the polished strict path, and
    the sharded strict router on corridors of which every fourth is tight.

    ``mesh``: a ``parallel.mesh.Mesh``; ``None`` builds one with
    ``make_mesh(device)`` over the initialised process group.  Every rank
    must call this.  Counts and the mean cost are reduced over the mesh;
    rank 0 prints one line.  Raises RuntimeError unless every cost is
    finite and every verdict of the router is determinate.  Returns the
    reduced numbers (the same on every rank).
    """
    mesh = pmesh.make_mesh(device) if mesh is None else mesh
    dev, f32 = mesh.device, torch.float32
    k = 4
    free = sm.make_structure(sm.free_interior_mask(k + 1, 10), 3, 10)
    batch = pmesh.pad_batch(2 * mesh.size, mesh.size)

    # The global batch, made the same on every rank; each keeps its rows.
    rng = np.random.RandomState(0)
    waypoints = np.cumsum(rng.uniform(0.5, 1.5, size=(batch, k + 1, 3)),
                          axis=1)
    values = np.zeros((batch, k + 1, 5, 3))
    values[:, :, 0, :] = waypoints
    times = segment_times_nfabian(waypoints, 2.0, 2.0)
    tight = np.arange(batch)[:, None, None] % 4 == 3
    r_radii = np.broadcast_to(np.where(tight, 0.12, 0.6), (batch, k, 2))

    def local(a):
        return torch.as_tensor(np.array(pmesh.local_rows(np.asarray(a), mesh)),
                               dtype=f32, device=dev)

    wpts, vals, t = local(waypoints), local(values), local(times)
    df_free = linear.extract_fixed_values(free, vals)
    radii = torch.full((wpts.shape[0], k, 2), 0.6, dtype=f32, device=dev)

    # The linear warm start (the position-constrained min-snap solve, read
    # at the free structure's columns) -> tube QCQP on the reference-layout
    # system.
    con = qcqp._solve_qcqp_rows(
        free, df_free, t, wpts, radii,
        config=qcqp.ADMMConfig(rho=0.003, n_stages=2, n_iters=15),
        x0=qcqp.position_constrained_warmstart(free, vals, t))

    # One gradient step through the nonlinear objective's graph.
    params = nonlinear.NonlinearParameters(
        objective=nonlinear.Objective.FREE_CONSTRAINTS, max_iterations=3,
        use_soft_constraints=False)
    d_free = con.d_free.detach().requires_grad_(True)
    (grad,) = torch.autograd.grad(
        nonlinear.total_cost(free, df_free, d_free, t, params).total.sum(),
        d_free)
    refined = nonlinear.total_cost(free, df_free, con.d_free - 1e-6 * grad,
                                   t, params).total
    cost = con.cost + 0.0 * refined

    # The strict path: ADMM + plane-layout polish, then the sharded router.
    pol = ipm_lanes.solve_qcqp_polished_batch(
        free, df_free, t, wpts, radii,
        ipm_config=IPMConfig(n_iters=4, sigma_min=0.3, corrector=False),
        device=dev)
    res, n_strict_router = auto.solve_qcqp_strict_sharded(
        free, df_free, t, wpts, local(r_radii), mesh=mesh,
        warmstart_values=vals,
        admm_config=qcqp.ADMMConfig(rho=0.005, n_stages=1, n_iters=24,
                                    rho_tube_factor=0.125,
                                    rho_half_factor=0.125),
        ipm_config=IPMConfig(n_iters=6, sigma_min=0.3, corrector=False))

    counts = torch.stack([
        (con.max_violation < 1e-2).sum(),
        (pol.max_violation < 1e-4).sum(),
        torch.isfinite(cost).sum(),
        torch.as_tensor(int((res.verdict != auto.UNDETERMINED).sum()),
                        device=dev),
        torch.as_tensor(res.n_escalated, device=dev)]).to(torch.float64)
    totals = pmesh._all_reduce(mesh, torch.cat([
        counts, cost.detach().to(torch.float64).sum()[None]])).tolist()
    n_ok, n_strict, n_finite, n_det, n_esc, cost_sum = totals
    out = dict(batch=batch, n_ok=int(n_ok), n_strict=int(n_strict),
               n_strict_router=int(n_strict_router), n_escalated=int(n_esc),
               n_determinate=int(n_det), mean_cost=cost_sum / batch)
    if n_finite != batch:
        raise RuntimeError(f"dryrun_multichip: {batch - int(n_finite)} "
                           f"non-finite QCQP costs")
    if n_det != batch:
        raise RuntimeError(f"dryrun_multichip: the sharded router left "
                           f"{batch - int(n_det)} rows UNDETERMINED")
    if mesh.rank == 0:
        print(f"dryrun_multichip({mesh.size}): OK -- {batch} scenarios, "
              f"{out['n_ok']} feasible, mean QCQP cost "
              f"{out['mean_cost']:.4f}, polished strict-feasible "
              f"{out['n_strict']}/{batch}; sharded router: "
              f"{out['n_strict_router']}/{batch} strict (all_reduce), "
              f"{out['n_escalated']} escalated, {out['n_determinate']} "
              f"determinate verdicts", flush=True)
    return out
