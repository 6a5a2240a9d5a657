"""The port's utilities (``utils.timing``, ``utils.export``,
``utils.checkpointing``) and its ``entry()`` held against the JAX package's:
the same text and npz files from the same trajectory, checkpoints that
round-trip, the timer registry's arithmetic, and the flagship forward step
to rtol 1e-9 in float64.
"""

import time

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import mav_tube_trajectory_generation_tpu as jmtg
import mav_tube_trajectory_generation_tpu_torch as mtt
from mav_tube_trajectory_generation_tpu.utils import export as jexport
from mav_tube_trajectory_generation_tpu.utils import timing as jtiming
from mav_tube_trajectory_generation_tpu_torch.solver import nonlinear as tnl
from mav_tube_trajectory_generation_tpu_torch.utils import checkpointing
from mav_tube_trajectory_generation_tpu_torch.utils import export
from mav_tube_trajectory_generation_tpu_torch.utils import timing

from torch_port_util import to_np, tt


@pytest.fixture(scope="module")
def trajectories():
    verts = jmtg.create_random_vertices(4, 3, np.zeros(3), 5 * np.ones(3), 2)
    structure, values = jmtg.structure_from_vertices(verts)
    times = np.asarray(jmtg.estimate_segment_times(verts, 2.0, 2.0))
    d_fixed = jmtg.extract_fixed_values(structure, jnp.asarray(values))
    sol = jmtg.solve_linear(structure, d_fixed, jnp.asarray(times))
    jtraj = jmtg.Trajectory(sol.coefficients, sol.times)
    ttraj = mtt.trajectory_from_numpy(jtraj, device="cpu")
    return jtraj, ttraj


def test_sampled_text_equals_jax(trajectories, tmp_path):
    jtraj, ttraj = trajectories
    ours = export.sample_trajectory(ttraj, 0.05)
    ref = jexport.sample_trajectory(jtraj, 0.05)
    assert ours.shape == ref.shape == (ref.shape[0], 16)
    np.testing.assert_allclose(ours, ref, rtol=1e-12, atol=1e-12)
    a, b = tmp_path / "ours.txt", tmp_path / "ref.txt"
    export.write_matlab_sampled_trajectory(ttraj, str(a), dt=0.1)
    jexport.write_matlab_sampled_trajectory(jtraj, str(b), dt=0.1)
    la, lb = a.read_text().splitlines(), b.read_text().splitlines()
    assert len(la) == len(lb) > 10
    np.testing.assert_allclose(np.loadtxt(str(a)), np.loadtxt(str(b)),
                               rtol=1e-11, atol=1e-12)
    assert all(len(x.split()) == 16 for x in la)


def test_npz_archive_equals_jax(trajectories, tmp_path):
    jtraj, ttraj = trajectories
    a, b = tmp_path / "ours.npz", tmp_path / "ref.npz"
    extra = np.arange(4.0)
    export.save_trajectories(str(a), ttraj, cost=tt(extra))
    jexport.save_trajectories(str(b), jtraj, cost=extra)
    with np.load(str(a)) as da, np.load(str(b)) as db:
        assert sorted(da.files) == sorted(db.files)
        for k in db.files:
            np.testing.assert_array_equal(da[k], db[k])
    back = export.load_trajectories(str(b), device="cpu")
    np.testing.assert_array_equal(to_np(back.coefficients),
                                  np.asarray(jtraj.coefficients))
    jback = jexport.load_trajectories(str(a))
    np.testing.assert_array_equal(np.asarray(jback.times), to_np(ttraj.times))


def test_checkpoint_round_trip(tmp_path):
    state = {"d_free": torch.randn(3, 4, 3, dtype=torch.float64),
             "history": [torch.arange(5.0), (torch.ones(2, dtype=torch.int32),
                                             None)],
             "breakdown": tnl.CostBreakdown(*(torch.full((3,), float(i))
                                              for i in range(5))),
             "step": 7}
    path = str(tmp_path / "ckpt.npz")
    checkpointing.save_pytree(path, state)
    back = checkpointing.load_pytree(path, state, device="cpu")
    assert isinstance(back["breakdown"], tnl.CostBreakdown)
    assert back["history"][1][1] is None
    leaves, _ = checkpointing.tree_flatten(state)
    got, _ = checkpointing.tree_flatten(back)
    assert len(leaves) == len(got) == 9
    for a, b in zip(leaves, got):
        np.testing.assert_array_equal(to_np(b), np.asarray(to_np(a)))
        if isinstance(a, torch.Tensor):
            assert b.dtype == a.dtype
    with pytest.raises(ValueError, match="leaves"):
        checkpointing.load_pytree(path, {"d_free": state["d_free"]},
                                  device="cpu")
    other = dict(state, breakdown=list(state["breakdown"]))
    with pytest.raises(ValueError, match="treedef"):
        checkpointing.load_pytree(path, other, device="cpu")


def test_timing_registry_matches_jax():
    """The same samples give the same statistics and report lines."""
    timing.Timing.reset()
    jtiming.Timing.reset()
    samples = [0.5, 0.25, 1.0, 0.125] + [0.01 * i for i in range(60)]
    for s in samples:
        timing.Timing.add("solve", s)
        jtiming.Timing.add("solve", s)
    a, b = timing.Timing.get("solve"), jtiming.Timing.get("solve")
    for name in ("total", "count", "min", "max", "mean", "rolling_mean",
                 "std"):
        assert getattr(a, name) == getattr(b, name), name
    assert timing.Timing.print() == jtiming.Timing.print()
    with timing.Timer("block") as t:
        time.sleep(0.01)
    assert not t.is_timing() and timing.Timing.get_num_samples("block") == 1
    assert timing.Timing.get_total("block") >= 0.01
    out = timing.time_torch("call", lambda x: x * 2, torch.ones(3))
    assert float(out.sum()) == 6.0 and timing.Timing.get_num_samples("call")
    with timing.trace("traced"):
        pass
    assert timing.Timing.get_mean("traced") >= 0.0
    d = timing.DummyTimer("x")
    with d:
        pass
    assert d.stop() == 0.0 and not d.is_timing()
    timing.Timing.reset()
    jtiming.Timing.reset()


def test_entry_matches_graft_entry():
    import __graft_entry__ as graft
    jfn, jargs = graft.entry()
    fn, args = mtt.entry(device="cpu", dtype=torch.float64)
    for a, b in zip(args, jargs):
        np.testing.assert_allclose(to_np(a), np.asarray(b), rtol=1e-12)
    ours = fn(*args)
    ref = jax.jit(jfn)(*jargs)
    assert [tuple(o.shape) for o in ours] == [(16,), (16, 32, 3),
                                               (16, 32, 3)]
    for a, b in zip(ours, ref):
        np.testing.assert_allclose(to_np(a), np.asarray(b), rtol=1e-9,
                                   atol=1e-9)
    fn32, args32 = mtt.entry(device="cpu")
    assert args32[0].dtype == torch.float32
    assert all(bool(torch.isfinite(o).all()) for o in fn32(*args32))
