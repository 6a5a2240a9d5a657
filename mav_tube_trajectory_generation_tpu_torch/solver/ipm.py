"""Interior-point configuration.

Counterpart of ``IPMConfig`` of the JAX package's ``solver/ipm.py``: every
field, the same defaults, so that a configuration converts one to one
(``convert.ipm_config_from_fields``).  The row-layout solvers of that module
(``solve_qcqp_ipm``, ``solve_qcqp_polished``, float64-capable) are not ported
yet; the plane-layout solver that reads this configuration is
``solver.ipm_lanes``.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class IPMConfig:
    """Static IPM knobs."""
    n_iters: int = 25           # Newton iterations
    sigma: float = 0.1          # centering parameter
    tau: float = 0.995          # fraction-to-boundary
    reg: float = 1e-9           # Hessian regularization
    s_init: float = 1.0         # initial slack floor
    lam_init: float = 1.0       # initial multiplier
    eps_feas: float = 1e-6      # convergence thresholds for status output
    eps_mu: float = 1e-8
    # Relative merit threshold for `converged`: best_merit is compared
    # against eps_merit * (1 + ||q_eq||_inf) -- the merit's complementarity
    # term scales linearly with the (equilibrated) objective's gradient
    # scale, so an absolute threshold would mislabel large-cost problems.
    eps_merit: float = 1e-4
    # Primal-infeasibility certificate (QCQPSolution.infeasible): the max
    # multiplier growing by more than this factor over the second half of
    # the iterations while the lam-weighted average violation stays
    # positive.  On a feasible problem the multipliers converge (growth ->
    # 1); on an infeasible one they diverge along a Farkas direction.
    infeas_growth: float = 10.0
    # Dual warm start (lam0_ball/lam0_half given).  warm_s_min inflates the
    # start into the interior: hugging the boundary stalls the
    # fraction-to-boundary steps, while an interior start that keeps only the
    # duals' scale converges.
    warm_s_min: float = 1.0
    warm_lam_min: float = 1e-5
    # Central-path re-centering of the warm duals: products s_i lam_i are
    # clipped into [mu0/beta, beta*mu0] with mu0 = warm_mu_boost * mean(s lam).
    warm_beta: float = 10.0
    warm_mu_boost: float = 1.0
    # float32-endgame safeguards (plane-layout path): centering floor,
    # fraction-to-boundary step cap, and complementarity-weight cap.
    # Unrestricted Mehrotra steps drive mu below what float32 can resolve and
    # the Newton directions blow up; these bound the per-step mu decrease and
    # the Newton system's condition number.
    sigma_min: float = 0.1
    alpha_max: float = 1.0
    w_cap: float = 1e6
    # Post-IPM feasibility snap (lanes path): Gauss-Newton sweeps on the
    # violated rows only, repairing the float32 endgame's violation tail.
    snap_iters: int = 2
    snap_rho: float = 1e4
    # Mehrotra predictor-corrector toggle (lanes path).  False = single
    # direction per step with fixed centering sigma = sigma_min: drops one
    # factored solve and one G dx matvec per step.
    corrector: bool = True
    # Weighted-Gram product precision.  The kernels of this package compute
    # in full float32; anything but "highest" is refused.
    gram_precision: str = "highest"
    # Lanes path: the whole polish as one fused kernel (the JAX package's
    # ipm_solve_fused).  Not ported yet: True raises NotImplementedError.
    fused: bool = False
    # Lanes path: pipelined kernel schedule (ops.ipm_kernel.ipm_pipe_step) --
    # one kernel launch per Newton/snap step that finishes the previous step
    # and evaluates the next point, with only the batched band factor left
    # outside.  Requires corrector=False.  Mutually exclusive with `fused`.
    pipelined: bool = False
    # Pipelined path: re-factorize the Newton Hessian only every k-th step
    # (modified Newton).  1 = factor every step.  Snap sweeps always get a
    # fresh factor.
    refactor_every: int = 1
    # Scenario block of the fused kernel in the JAX package; kept so that
    # configurations convert one to one, read by nothing here.
    fused_block: int = 2
    # Hessian inverse back end of the JAX package's row-layout solver; kept
    # so that configurations convert one to one, read by nothing here.
    hess_inverse: str = "schur"

    def __post_init__(self):
        if self.gram_precision != "highest":
            raise ValueError(
                f"gram_precision must be 'highest' (full float32), got "
                f"{self.gram_precision!r}")
