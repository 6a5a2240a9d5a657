"""Shared helpers of the test_torch_*.py files: seeded small problems as
NumPy arrays, handed to both the JAX package and the PyTorch port."""

import ctypes
import os
import subprocess

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


def router_batch():
    """The verdict router's fixture (K=4, batch 8, float32 NumPy arrays and
    the port's free structure): generous corridors (rows 0, 1, 4-6 pass the
    gate), tight ones (rows 2, 3 escalate), and row 7, whose start lies 5
    units off its corridor (escalates and is certified infeasible).
    Returns (structure, d_fixed, times, waypoints, radii, values)."""
    import mav_tube_trajectory_generation_tpu_torch as mtt
    k = 4
    rng = np.random.RandomState(11)
    b = 8
    waypoints = np.cumsum(rng.uniform(0.5, 2.0, size=(b, k + 1, 3)),
                          axis=1).astype(np.float32)
    ts = mtt.make_structure(mtt.free_interior_mask(k + 1, N), 3, N)
    values = np.zeros((b, k + 1, 5, 3), dtype=np.float32)
    values[:, :, 0, :] = waypoints
    times = to_np(mtt.segment_times_nfabian(tt(waypoints), 3.0, 5.0))
    radii = np.full((b, k, 2), 0.8, dtype=np.float32)
    radii[2:4] = 0.1                       # tight: the 24-iter gate misses
    df = to_np(mtt.extract_fixed_values(ts, tt(values))).copy()
    df[7, 0, :] += 5.0                     # start 5 units off the corridor
    radii[7] = 0.05
    return ts, df, times, waypoints, radii, values


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


_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ORACLE_SRC = os.path.join(_REPO, "mav_tube_trajectory_generation_tpu",
                          "native", "parity_oracle.cpp")
# git-ignored; the port's kernels are built beside it on the card
ORACLE_DIR = os.path.join(_REPO, "mav_tube_trajectory_generation_tpu_torch",
                          "build")
ORACLE_LIB = os.path.join(ORACLE_DIR, "libparity_oracle_tests.so")
_oracle = []


def parity_oracle():
    """The C++ closed-form linear solve (``parity_oracle.cpp`` of the JAX
    package's ``native/``, read as a source file only), built with g++ into
    the git-ignored build directory and loaded with its own ctypes
    signature.  Each process compiles to a name of its own and renames the
    result into place (atomic), so parallel test workers never load a
    half-written library.  Returns ``solve(fixed_mask, values, times,
    derivative, n) -> (K, N, D) coefficients``."""
    if not _oracle:
        if (not os.path.exists(ORACLE_LIB) or os.path.getmtime(ORACLE_LIB)
                < os.path.getmtime(ORACLE_SRC)):
            os.makedirs(ORACLE_DIR, exist_ok=True)
            tmp = f"{ORACLE_LIB}.{os.getpid()}.tmp"
            subprocess.run(["g++", "-O2", "-shared", "-fPIC", "-o", tmp,
                            ORACLE_SRC], check=True, capture_output=True,
                           timeout=120)
            os.replace(tmp, ORACLE_LIB)
        lib = ctypes.CDLL(ORACLE_LIB)
        lib.mtg_solve_linear.restype = ctypes.c_int
        lib.mtg_solve_linear.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS"),
            np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")]
        _oracle.append(lib)
    lib = _oracle[0]

    def solve(fixed_mask, values, times, derivative, n):
        mask = np.ascontiguousarray(fixed_mask, dtype=np.uint8)
        values = np.ascontiguousarray(values, dtype=np.float64)
        times = np.ascontiguousarray(times, dtype=np.float64)
        v = mask.shape[0]
        dim = values.shape[-1]
        if mask.shape != (v, n // 2) or values.shape != (v, n // 2, dim) \
                or times.shape != (v - 1,):
            raise ValueError("oracle inputs of the wrong shape")
        out = np.zeros(((v - 1) * n * dim,), dtype=np.float64)
        status = lib.mtg_solve_linear(n, dim, v, derivative, mask.ravel(),
                                      values.ravel(), times, out)
        if status != 0:
            raise RuntimeError(f"mtg_solve_linear failed: status {status}")
        return out.reshape(v - 1, n, dim)
    return solve
