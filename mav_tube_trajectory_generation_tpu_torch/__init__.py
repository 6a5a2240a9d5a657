"""mav_tube_trajectory_generation_tpu_torch: the PyTorch/CUDA port of
``mav_tube_trajectory_generation_tpu`` for an NVIDIA H100.

The JAX package stays in the repository as the reference; this package sits
beside it, imports ``torch`` and ``numpy`` only, and shares no module with
it.  Sub-packages carry the same names (``ops``, ``solver``, ``models``) so
each counterpart is easy to find.  Ported so far: the headline QP+QCQP path
(``solve_qcqp_batch`` on every KKT route of ``ADMMConfig``: the banded
factored stage, the dense-inverse stage, the Gram-band kernels, and the
``gt_assembly="kernel"`` ("ew") route, whose stage and band kernels read
G^T as its rank-1 row factors and never form it), the
closed-form linear solve beneath it, the strict verdict router
(``solve_qcqp_strict`` /
``solve_qcqp_auto``: ADMM plus snap sweeps, the plane-layout interior-point
polish with its CUDA step kernels or as one whole-polish launch
(``IPMConfig(fused=True)``), the float32 restart chain, and the float64 last
tier), the reference-layout solvers that tier runs (``solve_qcqp``,
``solve_qcqp_ipm``, ``solve_qcqp_polished``; any float dtype), and the
linear planner path: the closed-form solve at any K (``solve_linear`` dense,
``solve_linear_banded`` by block cyclic reduction), ``solve_from_positions``,
``position_constrained_warmstart``, and the ``Trajectory`` model with its
analytic extrema (``min_max_magnitude``, ``max_magnitude``: a grid bracket
and a fixed count of bisections on the magnitude's derivative), and the
nonlinear optimizer (``optimize`` on all five objectives, with the
Nelder-Mead simplex and the batched L-BFGS of ``solver.lbfgs``;
``optimize_time_gradient``) over the signed distance field of
``models.esdf`` (``esdf_from_occupancy``: the min-plus transform on the
card or the host C++ one of ``csrc/edt.cpp``), with the timers, export and
checkpointing of ``utils`` and ``entry()``, and scenario-parallel
execution over ``torch.distributed`` (``parallel.mesh``: one process per
card, each rank solving its own rows; ``solve_qcqp_strict_sharded``, the
strict router over such a mesh; ``entry.dryrun_multichip``).  It exports
every public name of the JAX package.

Entry points take ``device=None``, which means the CUDA card and raises when
there is none; pass ``device="cpu"`` to run on the host, where each kernel's
plain PyTorch version stands in for it.

Quick start::

    import mav_tube_trajectory_generation_tpu_torch as mtg

    sc = mtg.make_inputs(10, 1024, seed=0)
    cfg = mtg.ADMMConfig(rho=0.005, n_stages=1, n_iters=48,
                         rho_tube_factor=0.125, rho_half_factor=0.125)
    sol = mtg.solve_qcqp_batch(sc.free, sc.d_fixed_free, sc.times,
                               sc.waypoints, sc.radii, config=cfg,
                               warmstart_values=sc.values)
    res = mtg.solve_qcqp_strict(sc.free, sc.d_fixed_free, sc.times,
                                sc.waypoints, sc.radii,
                                warmstart_values=sc.values)
    # res.verdict: +1 feasible (violation < 1e-4), -1 infeasible, 0 open
"""

import torch

# Full-precision float32 matrix products everywhere.  The solvers' assembly
# spans ~17 decades of T-power dynamic range and the reference found that
# lower matmul precision broke feasibility, so TF32 is switched off for the
# whole process (it is PyTorch's default for matmul; stated here so that the
# package does not depend on a default).
torch.backends.cuda.matmul.allow_tf32 = False

from . import motion_defines                                    # noqa: E402
from .motion_defines import (POSITION, VELOCITY, ACCELERATION,  # noqa: E402
                             JERK, SNAP)
from .solver.structure import (ProblemStructure, make_structure,  # noqa: E402
                               standard_mask, free_interior_mask)
from .solver.linear import (LinearSolution, solve_linear,       # noqa: E402
                            solve_linear_with_free, extract_fixed_values,
                            assemble_r, derivative_cost_and_grad,
                            compact_from_segment_derivatives,
                            solve_from_positions)
from .solver.qcqp import (ADMMConfig, QCQPSolution,             # noqa: E402
                          solve_qcqp, solve_qcqp_batch, build_constraints,
                          position_constrained_warmstart)
from .solver.banded import (solve_linear_banded,                # noqa: E402
                            block_tridiag_solve)
from .solver.ipm import (IPMConfig, solve_qcqp_ipm,             # noqa: E402
                         solve_qcqp_polished)
from .ops.ipm_kernel import (gt_matvec, ipm_eval_step,          # noqa: E402
                             ipm_pipe_step, ipm_solve_fused)
from .ops.admm_kernel import (admm_stage_fused_factored,        # noqa: E402
                              admm_stage_fused_factored_ew,
                              admm_stage_fused, admm_stage, gram_band,
                              gram_band_factors, gram_band_factors_ew)
from .solver.ipm_lanes import (solve_qcqp_ipm_lanes,            # noqa: E402
                               solve_qcqp_polished_batch)
from .solver.auto import (AutoResult, solve_qcqp_auto,          # noqa: E402
                          solve_qcqp_strict, solve_qcqp_strict_sharded,
                          FEASIBLE, INFEASIBLE, UNDETERMINED)
from .models.vertex import (Vertex, vertices_to_arrays,         # noqa: E402
                            structure_from_vertices,
                            create_random_vertices,
                            create_random_vertices_1d,
                            create_square_vertices,
                            estimate_segment_times,
                            estimate_segment_times_nfabian,
                            estimate_segment_times_velocity_ramp,
                            segment_times_nfabian,
                            segment_times_velocity_ramp)
from .models.trajectory import (Trajectory, Extremum,            # noqa: E402
                                evaluate, evaluate_range, sample_times,
                                min_max_magnitude, max_magnitude,
                                append_dimension, get_vertex_at_time,
                                scale_trajectory_time,
                                scale_times_to_limits)
from .solver.nonlinear import (Objective, CostWeights,          # noqa: E402
                               MagnitudeConstraint, NonlinearParameters,
                               NonlinearResult, optimize,
                               optimize_time_gradient)
from .models.esdf import (Esdf, esdf_from_occupancy, distance_at,  # noqa: E402
                          collision_potential, make_obstacle_grid)
from .scenarios import (ScenarioBatch, make_inputs,             # noqa: E402
                        tight_radii)
from .convert import (structure_from_fields, pre_from_numpy,    # noqa: E402
                      solution_to_numpy, solution_from_numpy,
                      ipm_config_from_fields, admm_config_from_fields,
                      lanes_state_from_numpy,
                      fused_state_from_numpy, auto_result_to_numpy,
                      trajectory_from_numpy, trajectory_to_numpy,
                      esdf_from_numpy, nonlinear_parameters_from_fields,
                      magnitude_constraint_from_fields,
                      nonlinear_result_to_numpy)
from .entry import entry, dryrun_multichip                      # noqa: E402

__version__ = "0.6.0"
