"""Shared helpers of the test_torch_*.py files: seeded small problems as
NumPy arrays, handed to both the JAX package and the PyTorch port."""

import numpy as np
import torch

# Six xdist workers share the host: one thread each is enough at these sizes.
torch.set_num_threads(1)

N = 10
# An H100's shared memory as its CUDA runtime reports it: what a block may
# take (cudaDevAttrMaxSharedMemoryPerBlockOptin), what an SM holds
# (cudaDevAttrMaxSharedMemoryPerMultiprocessor) and what the card keeps for
# each block (cudaDevAttrReservedSharedMemoryPerBlock).  The kernels read
# these from the device; the tests hold the layouts' bytes against them.
H100_SMEM_OPTIN = 232448
H100_SMEM_PER_SM = 233472
H100_SMEM_RESERVED = 1024
BENCH_KW = dict(rho=0.005, n_iters=48, rho_tube_factor=0.125,
                rho_half_factor=0.125)


def blocks_an_sm(smem_bytes):
    """Blocks of ``smem_bytes`` of dynamic shared memory an H100 SM holds at
    once."""
    return H100_SMEM_PER_SM // (smem_bytes + H100_SMEM_RESERVED)


def to_np(a):
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)      # NumPy and JAX arrays alike


def tt(a, dtype=None):
    """NumPy -> CPU tensor (dtype kept unless given)."""
    return torch.as_tensor(np.array(a), dtype=dtype)


def problem(k=4, batch=8, seed=0, dtype=np.float32, radius=0.8):
    """A batch of K-segment scenarios in the benchmark's distribution, as
    NumPy arrays of ``dtype``: dict with waypoints (B, K+1, 3), values
    (B, K+1, 5, 3), times (B, K), radii (B, K, 2)."""
    rng = np.random.RandomState(seed)
    waypoints = np.cumsum(rng.uniform(0.5, 2.0, size=(batch, k + 1, 3)),
                          axis=1)
    d = np.linalg.norm(np.diff(waypoints, axis=1), axis=-1)
    times = d / 3.0 * 2.0 * (1.0 + 6.5 * 3.0 / 5.0 * np.exp(-d / 3.0 * 2.0))
    values = np.zeros((batch, k + 1, 5, 3))
    values[:, :, 0, :] = waypoints
    radii = np.full((batch, k, 2), radius)
    return {name: a.astype(dtype) for name, a in dict(
        waypoints=waypoints, values=values, times=times, radii=radii).items()}


def jax_pre(k=4, batch=8, seed=0, n_iters=2, **config_kw):
    """(jax free structure, JAX-assembled pre-stage bundle as a dict of NumPy
    arrays with a flat batch axis, the problem dict) for float32 scenarios,
    through the JAX package's own ``solve_qcqp_batch(_return_pre=True)``
    (Pallas kernel in interpret mode on the CPU)."""
    import jax.numpy as jnp
    from mav_tube_trajectory_generation_tpu.solver import linear as jlinear
    from mav_tube_trajectory_generation_tpu.solver import qcqp as jqcqp
    from mav_tube_trajectory_generation_tpu.solver import structure as jsm

    p = problem(k=k, batch=batch, seed=seed)
    free = jsm.make_structure(jsm.free_interior_mask(k + 1, N), 3, N)
    d_fixed = jlinear.extract_fixed_values(free, jnp.asarray(p["values"]))
    cfg = jqcqp.ADMMConfig(use_pallas=True, n_stages=1, n_iters=n_iters,
                           **config_kw)
    _, pre = jqcqp.solve_qcqp_batch(
        free, d_fixed, jnp.asarray(p["times"]), jnp.asarray(p["waypoints"]),
        jnp.asarray(p["radii"]), config=cfg,
        warmstart_values=jnp.asarray(p["values"]), scenario_block=4,
        _return_pre=True)
    fields = ("gt", "b_pad", "rb", "sb", "sh", "p_eq", "q_flat", "x_flat0",
              "d_scale")
    p["d_fixed"] = np.asarray(d_fixed)
    return free, {f: np.asarray(getattr(pre, f)) for f in fields}, p
