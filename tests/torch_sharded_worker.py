"""One gloo rank of the port's scenario-parallel tests
(``tests/test_torch_parallel.py``), in a process that cannot import JAX or
the JAX package:

    python tests/torch_sharded_worker.py RANK WORLD STORE INPUTS OUT CASE...

It joins a gloo group of WORLD ranks through the file store STORE, builds a
CPU mesh, runs each CASE (a function of this module) on this rank's rows of
the NumPy arrays in INPUTS (an ``.npz``; keys ``<case>_<name>``), and saves
what the cases return to OUT (an ``.npz``; keys ``<case>_<name>``).
"""

import os
import sys

sys.modules["jax"] = None
sys.modules["mav_tube_trajectory_generation_tpu"] = None
sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

import mav_tube_trajectory_generation_tpu_torch as mtt  # noqa: E402
from mav_tube_trajectory_generation_tpu_torch.parallel import (  # noqa: E402
    mesh as pmesh)

N = 10
STRICT_ADMM = dict(rho=0.005, n_stages=1, n_iters=24, rho_tube_factor=0.125,
                   rho_half_factor=0.125)


def _free(k):
    return mtt.make_structure(mtt.free_interior_mask(k + 1, N), 3, N)


def _np(a):
    return a.detach().cpu().numpy()


def linear(mesh, x):
    """solve_linear_sharded on this rank's rows; the default device."""
    k = x["times"].shape[1]
    std = mtt.make_structure(mtt.standard_mask(k + 1, N), 3, N)
    sol, m = pmesh.solve_linear_sharded(
        std, mesh, pmesh.local_rows(x["d_fixed"], mesh),
        pmesh.local_rows(x["times"], mesh))
    try:
        pmesh.make_mesh()
        default_device_raised = False
    except RuntimeError:
        default_device_raised = True
    return dict(coefficients=_np(sol.coefficients), cost=_np(sol.cost),
                metrics=np.array([float(v) for v in m]),
                default_device_raised=np.array(default_device_raised))


def shard(mesh, x):
    """shard_scenarios over the linear costs, then with unequal rows."""
    k = x["times"].shape[1]
    std = mtt.make_structure(mtt.standard_mask(k + 1, N), 3, N)
    calls = []

    def costs(df, t):
        calls.append(len(t))
        return mtt.solve_linear(std, df, t).cost

    fn = pmesh.shard_scenarios(costs, mesh, 2)
    d_fixed = torch.as_tensor(pmesh.local_rows(x["d_fixed"], mesh))
    times = torch.as_tensor(pmesh.local_rows(x["times"], mesh))
    gathered = fn(d_fixed, times)
    n_calls = len(calls)
    cut = 1 if mesh.rank == 0 else 0            # rank 0 one row short
    try:
        fn(d_fixed[cut:], times[cut:])
        unequal_raised = False
    except ValueError:
        unequal_raised = True
    return dict(costs=_np(gathered), unequal_raised=np.array(unequal_raised),
                calls_after_unequal=np.array(len(calls) - n_calls))


def qcqp(mesh, x):
    """solve_qcqp_sharded, cold start (x0=None)."""
    local = {n: pmesh.local_rows(a, mesh) for n, a in x.items()}
    sol, n_ok = pmesh.solve_qcqp_sharded(
        _free(x["times"].shape[1]), mesh, local["d_fixed"], local["times"],
        local["waypoints"], local["radii"],
        config=mtt.ADMMConfig(rho=0.01, n_stages=2, n_iters=25))
    out = {n: _np(getattr(sol, n)) for n in sol._fields
           if getattr(sol, n) is not None}
    return dict(out, n_ok=np.array(float(n_ok)))


def _router(mesh, x, ipm_kw, tier2_f64):
    local = {n: pmesh.local_rows(a, mesh) for n, a in x.items()}
    res, n_strict = mtt.solve_qcqp_strict_sharded(
        _free(x["times"].shape[1]), local["d_fixed"], local["times"],
        local["waypoints"], local["radii"], mesh=mesh,
        warmstart_values=local["values"],
        admm_config=mtt.ADMMConfig(**STRICT_ADMM),
        ipm_config=mtt.IPMConfig(**ipm_kw), tier2_f64=tier2_f64)
    return dict(verdict=res.verdict, escalated=res.escalated, tier=res.tier,
                max_violation=_np(res.solution.max_violation),
                cost=_np(res.solution.cost),
                n_strict=np.array(float(n_strict)))


def strict(mesh, x):
    """The router with tier 2 on, tier 1 at 6 Newton steps."""
    return _router(mesh, x, dict(n_iters=6, sigma_min=0.3, corrector=False),
                   True)


def router(mesh, x):
    """The router with tier 2 off, tier 1 at 8 Newton steps + 2 snaps."""
    return _router(mesh, x, dict(n_iters=8, snap_iters=2, sigma_min=0.3,
                                 corrector=False), False)


def dryrun(mesh, x):
    """dryrun_multichip's reduced numbers, and the JAX modules loaded."""
    out = {n: np.array(v) for n, v in mtt.dryrun_multichip(mesh).items()}
    jax_modules = [n for n in sys.modules
                   if n.split(".")[0] in ("jax", "jaxlib",
                                          "mav_tube_trajectory_generation_tpu")
                   and sys.modules[n] is not None]
    return dict(out, jax_modules=np.array(jax_modules, dtype=str))


def main():
    rank, world, store, inputs, out = sys.argv[1:6]
    torch.set_num_threads(1)
    pmesh.initialize_distributed(backend="gloo",
                                 init_method=f"file://{store}",
                                 rank=int(rank), world_size=int(world))
    try:
        mesh = pmesh.make_mesh("cpu")
        with np.load(inputs) as f:
            arrays = dict(f)
        results = {}
        for case in sys.argv[6:]:
            x = {n[len(case) + 1:]: a for n, a in arrays.items()
                 if n.startswith(case + "_")}
            for name, a in globals()[case](mesh, x).items():
                results[f"{case}_{name}"] = a
        np.savez(out, **results)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
