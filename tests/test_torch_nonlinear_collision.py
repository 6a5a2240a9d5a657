"""The collision case of test_nonlinear.py from the port's own start, and the
knife edge it sits on, float64, both packages on the same inputs.

The case's straight path lies on voxel planes (y = z = 1.0 m, voxel index
10), where the trilinear field has kinks: just above the planes the
field is flat in y and z, just below it falls towards the box's lower faces.
A start above the planes by 1e-13 in the free derivatives' y and z leaves
the run on the flat side, where no gradient points out, and the JAX package
as the port ends at 0.97 of the initial J_c, above the test's bar of 0.5;
from 1e-13 below, both end at 0.32.  From the port's own linear solve,
which puts y and z on the planes to ~1e-28, the two packages agree through
the first two line searches and part at the third, on the sign of a 1e-16
y offset that each one's rounding sets: at every point the port probes,
the two packages' values and gradients agree to 3e-11.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import mav_tube_trajectory_generation_tpu as jmtg
import mav_tube_trajectory_generation_tpu_torch as mtt
from mav_tube_trajectory_generation_tpu.solver import nonlinear as jnl
from mav_tube_trajectory_generation_tpu.solver import structure as jsm
from mav_tube_trajectory_generation_tpu_torch import convert
from mav_tube_trajectory_generation_tpu_torch.solver import nonlinear as tnl

from test_torch_nonlinear import params_pair
from test_torch_nonlinear_objectives import (_clearance, _close_or_lower,
                                             _fields)
from torch_port_util import N, to_np, tt

H = N // 2
OFFSET = 1e-13       # the start's offset of the y and z free derivatives
BAR = 0.5            # test_nonlinear.py: final J_c < 0.5 of the initial


@pytest.fixture(scope="module")
def case():
    dim, k = 3, 2
    js = jsm.make_structure(jsm.standard_mask(k + 1, N), dim, N)
    ts = convert.structure_from_fields(js)
    values = np.zeros((k + 1, H, dim))
    values[0, 0] = [0.2, 1.0, 1.0]
    values[1, 0] = [1.0, 1.0, 1.0]
    values[2, 0] = [1.8, 1.0, 1.0]
    d_fixed = np.asarray(jmtg.extract_fixed_values(js, jnp.asarray(values)))
    times = np.array([3.0, 3.0])
    occ = jmtg.make_obstacle_grid((20, 20, 20), (0, 0, 0), 0.1,
                                  boxes=[((1.15, 0.9, 0.85),
                                          (1.45, 1.35, 1.3))])
    jfield, tfield = _fields(occ, (0, 0, 0), 0.1)
    jp, tp = params_pair(
        objective=jnl.Objective.FREE_CONSTRAINTS_AND_COLLISION,
        max_iterations=100, use_soft_constraints=False, robot_radius=0.1,
        epsilon=0.3, collision_samples_per_segment=64,
        weights=jnl.CostWeights(w_d=0.1, w_c=1000.0))
    jopt = jax.jit(lambda d0: jnl.optimize(
        js, jnp.asarray(d_fixed), jnp.asarray(times), jp, field=jfield,
        d_free_init=d0))

    def ours(d0):
        return tnl.optimize(ts, tt(d_fixed), tt(times), tp, field=tfield,
                            d_free_init=None if d0 is None else tt(d0),
                            device="cpu")
    own = to_np(mtt.solve_linear(ts, tt(d_fixed), tt(times)).d_free)
    return dict(jopt=jopt, ours=ours, own=own, tfield=tfield, tp=tp, runs={})


def _ratio(res):
    return float(res.cost.collision) / float(res.initial_cost.collision)


def _side(case, sign):
    """Both packages from the port's own start moved by sign * OFFSET in the
    y and z free derivatives."""
    key = ("side", sign)
    if key not in case["runs"]:
        d0 = case["own"].copy()
        d0[:, 1:] += sign * OFFSET
        case["runs"][key] = (case["jopt"](jnp.asarray(d0)), case["ours"](d0))
    return case["runs"][key]


@pytest.mark.parametrize("sign", [1.0, -1.0], ids=["above", "below"])
def test_collision_knife_edge_both_packages_alike(case, sign):
    """From either side of the planes the port ends where the JAX package
    ends: the same share of J_c to 0.01 and the final total within 2 %.
    Below, both pass test_nonlinear.py's bars; above, both miss the J_c bar
    (the JAX package too, from 1e-13 off its own start)."""
    ref, ours = _side(case, sign)
    assert float(ours.initial_cost.total) == pytest.approx(
        float(ref.initial_cost.total), rel=1e-12)
    _close_or_lower(ours, ref)
    assert abs(_ratio(ours) - _ratio(ref)) <= 0.01, (_ratio(ours),
                                                     _ratio(ref))
    if sign < 0:
        assert _ratio(ours) < BAR and _ratio(ref) < BAR
        assert _clearance(case["tfield"], ours) > case["tp"].robot_radius
    else:
        assert _ratio(ours) > BAR and _ratio(ref) > BAR


def test_collision_from_the_ports_own_start(case):
    """d_free_init=None: the port starts from its own linear solve; the JAX
    package is given that same start.  They agree to rtol 1e-9 through the
    first three history entries (two line searches); the port then stays
    on the flat side of the planes and ends where both packages end from
    1e-13 above them, the JAX package's rounding takes it below."""
    ours = case["ours"](None)
    ref = case["jopt"](jnp.asarray(case["own"]))
    np.testing.assert_allclose(to_np(ours.cost_history)[:3],
                               np.asarray(ref.cost_history)[:3], rtol=1e-9)
    above_ref, above_ours = _side(case, 1.0)
    assert abs(_ratio(ours) - _ratio(above_ref)) <= 0.01, (
        _ratio(ours), _ratio(above_ref))
    assert abs(_ratio(ours) - _ratio(above_ours)) <= 0.01
    assert float(ours.cost.total) <= float(ours.initial_cost.total)
