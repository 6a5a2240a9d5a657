"""Verdict router: ADMM gate plus selective interior-point escalation.

Counterpart of the JAX package's ``solver/auto.py``: the single-process
router (tiers 0, 1, 1.5 and 2) and the same router over a scenario mesh
(``solve_qcqp_strict_sharded``, one process per card).  The reference
returns an interior-point verdict at every corridor width
(qcqp_impl.h:709-788).  The headline path (48-iteration warm-started ADMM,
``solver.qcqp.solve_qcqp_batch``) matches that verdict on generous corridors
but is conservative on tight ones: the fixed first-order iteration budget
stops short of the feasibility gate on scenarios an interior-point method
solves fine.

``solve_qcqp_auto`` closes that gap: every scenario gets the throughput ADMM
solve (tier 0, optionally followed by snap-only Gauss-Newton sweeps), and only
the scenarios failing the gate are re-solved by the plane-layout IPM polish
(``solver.ipm_lanes``, tier 1), warm-started from their tier-0 iterate; what
that leaves above the strict gate goes through a chain of restarted float32
endgames (tier 1.5), and what float32 cannot settle is solved in float64 by
the row-layout interior-point method (``solver.ipm``, tier 2), so that every
row ends with a determinate verdict wherever float64 can give one.

Escalation is host control flow by nature -- the verdict decides a different
program per scenario (the reference's analogue: the Mosek status switch,
qcqp_impl.h:715-770).  The gate mask is read on the host once per tier; the
failing rows are gathered exactly (scenarios are independent and nothing is
compiled per shape, so there is no padding to a bucket of sizes), solved, and
scattered back on the device.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional

import numpy as np
import torch

from .._tensors import DeviceLike, as_tensor, resolve_device
from ..parallel.mesh import Mesh, _all_reduce
from . import ipm, ipm_lanes
from ..utils import timing
from .ipm import IPMConfig
from .qcqp import ADMMConfig, QCQPSolution, solve_qcqp_batch
from .structure import ProblemStructure

#: Verdict codes (int8): +1 feasible, -1 infeasible (certificate), 0
#: undetermined (neither a feasible point to tolerance nor a certificate --
#: near-degenerate corridors; the reference would surface Mosek's
#: MSK_SOL_STA_UNKNOWN here).
FEASIBLE = np.int8(1)
INFEASIBLE = np.int8(-1)
UNDETERMINED = np.int8(0)

#: The two restarted endgames of tier 1.5, in order: Mehrotra corrector
#: first, then single-direction steps with extra snap sweeps.
RESTART_CONFIGS = (
    IPMConfig(n_iters=10, snap_iters=4, sigma_min=0.3, corrector=True),
    IPMConfig(n_iters=10, snap_iters=6, sigma_min=0.3, corrector=False),
)

#: Newton iterations of tier 2's four stages: two interior-point polishes
#: from a cold ADMM warm start, then two restarts from the best float64
#: iterate.
TIER2_STAGE_ITERS = (30, 120, 60, 60)

#: Rows tier 2 solves at a time.  A row's dense float64 working set (the
#: reference-layout Jacobians, W^-1 G^T, the weighted Gram) is about 3 MB at
#: ten segments, so a batch in which everything escalates still fits the
#: card.
TIER2_CHUNK_ROWS = 512


class AutoResult(NamedTuple):
    solution: QCQPSolution        # merged batch (ADMM or escalated-IPM rows)
    verdict: np.ndarray           # (B,) int8: +1 / -1 / 0 (see module codes)
    escalated: np.ndarray         # (B,) bool: row was re-solved by the IPM
    n_escalated: int
    # (B,) int8 diagnostic: the last tier that re-ran each row (0 = tier-0
    # gate pass, 1 = tier-1 IPM -- including its speculative restart, 2/3 =
    # tier-1.5 restart #1/#2, 4 = tier-2 f64).  For FEASIBLE escalated rows
    # this is the tier that landed them (restarts only fire on still-failing
    # rows).
    tier: Optional[np.ndarray] = None


def _bucket(n: int, block: int) -> int:
    """Escalation-batch bucket size >= n of the reference router:
    power-of-two multiples of ``block`` up to 256, then multiples of 256.
    The reference pads its escalated set to such a size to bound its count
    of compiled shapes; this router gathers exactly the failing rows and
    does not call it.  Kept so that a reference bucket can be reproduced
    when the two routers are compared."""
    b = block
    while b < min(n, 256):
        b *= 2
    if n <= b:
        return b
    return ((n + 255) // 256) * 256


def _sel_positions(a_mask):
    """Positions of the named QCQPSolution fields inside the mask-filtered
    merged-field list the tiers carry."""
    fields_idx = QCQPSolution._fields
    sel = [i for i, m in enumerate(a_mask) if m]
    return {name: sel.index(fields_idx.index(name))
            for name in ("d_free", "dual_ball", "dual_half",
                         "max_violation")}


def _take(keep: torch.Tensor, new: torch.Tensor, old: torch.Tensor):
    """Row-wise select: ``new`` where keep, else ``old``."""
    k = keep.reshape(keep.shape + (1,) * (new.dim() - 1))
    return torch.where(k, new.to(old.dtype), old)


def _run_tier15_chain(structure, d32, t32, w32, r32, idx, t1_viol, t1_inf,
                      merged_fields: List[torch.Tensor], a_mask,
                      strict_gate, tier_mark=None):
    """Tier 1.5: float32 restart chain on the residue.

    The rows tier 1 leaves above the strict gate are not unresolvable in
    float32: a restarted endgame -- fresh factors, re-centered warm duals, a
    different iteration path -- lands them.  Two restarts with different
    rounding paths, each warm-started from the current best iterate and
    firing only on what remains.

    idx: (n_esc,) int64 NumPy, batch rows of the escalated set.  Mutates
    ``t1_viol`` / ``t1_inf`` (NumPy, per escalated row) and ``tier_mark`` in
    place; returns the updated merged fields.  Certificates are replaced,
    not OR-ed: each restart re-examined the row with fresh factors, so its
    certificate supersedes an earlier (possibly false-fired) one.
    ``t1_viol`` is merged by minimum, and a solution row is replaced only by
    a restart that improved its violation (best-by-violation), so solution
    and verdict stay consistent and the next restart warm-starts from the
    best point seen.
    """
    pos = _sel_positions(a_mask)
    dev = d32.device
    for restart_no, ipm15 in enumerate(RESTART_CONFIGS):
        need15 = (t1_viol >= strict_gate) & ~t1_inf
        if not need15.any():
            break
        sub15 = np.nonzero(need15)[0]
        gi = torch.as_tensor(idx[sub15], dtype=torch.long, device=dev)
        pol15 = ipm_lanes.solve_qcqp_ipm_lanes(
            structure, d32[gi], t32[gi], w32[gi], r32[gi], config=ipm15,
            x0=merged_fields[pos["d_free"]][gi],
            lam0_ball=merged_fields[pos["dual_ball"]][gi],
            lam0_half=merged_fields[pos["dual_half"]][gi], device=dev)
        p_sel = [pf for m, pf in zip(a_mask, pol15) if m]
        keep = pol15.max_violation < merged_fields[pos["max_violation"]][gi]
        merged_fields = [mf.index_copy(0, gi, _take(keep, pf, mf[gi]))
                         for mf, pf in zip(merged_fields, p_sel)]
        # one read of this tier's gate data
        v15, i15 = (a.cpu().numpy() for a in (pol15.max_violation,
                                              pol15.infeasible))
        t1_viol[sub15] = np.minimum(t1_viol[sub15], v15)
        t1_inf[sub15] = i15
        if tier_mark is not None:
            tier_mark[sub15] = 2 + restart_no
    return merged_fields


def _run_tier2_f64(structure, d_fixed, times, waypoints, radii, idx,
                   t1_viol, t1_inf, merged_fields: List[torch.Tensor], a_mask,
                   strict_gate, tier_mark=None, device: DeviceLike = None):
    """Tier 2: the float64 row-layout interior-point method for anything the
    float32 tiers cannot settle.  It runs on ``device`` like the other tiers
    (float64 is native there), on exactly the rows that need it, in chunks
    of ``TIER2_CHUNK_ROWS``.

    Staged: 30 float64 iterations resolve the bulk; rows still at or above
    the strict gate after that get four times the budget -- including rows
    the first pass certified infeasible: a warm float64 certificate can
    false-fire exactly where a longer run exhibits a feasible point, and
    feasibility by exhibition always outranks a certificate.  It solves the
    caller's original problem data (``d_fixed`` ... ``radii`` as given, cast
    to float64), not the float32 copies of the other tiers: on
    near-degenerate corridors the float32 rounding of the problem itself
    perturbs strict 1e-4 margins.

    After the two stages that start from a cold ADMM solve, rows still
    undetermined get two restarted float64 endgames (60 iterations each,
    warm-started from the best float64 iterate, fresh factors).

    Rows the tier-1.5 chain landed (``tier_mark`` 2 or 3) carry snap-repaired
    points: feasible, but possibly far above the interior-point optimum at
    very tight radii.  They join the first stage even though they are
    feasible and ride along (``pending``) through every stage until a float64
    point under the gate replaces the repaired one; if none does, the float32
    exhibition stands and the verdict is unchanged.

    idx: (n_esc,) int64 NumPy, batch rows of the escalated set.  Mutates
    ``t1_viol`` / ``t1_inf`` (NumPy, per escalated row) and ``tier_mark`` in
    place; returns the updated merged fields and the number of rows that
    entered each stage that ran.  One host read per stage (the gate data);
    the best float64 iterate per row stays on the device.
    """
    pos = _sel_positions(a_mask)
    pos_mv = pos["max_violation"]
    dev = resolve_device(device)
    f64 = torch.float64
    d64, t64, w64, r64 = (as_tensor(a, f64, dev)
                          for a in (d_fixed, times, waypoints, radii))
    n_esc = int(idx.size)
    # Best float64 iterate per escalated row, for the restart stages' warm
    # starts: best by float64 violation, not the merged minimum, which
    # includes the float32 exhibition and would pin pending rows to their
    # first-stage iterate for ever.
    warm_v = torch.full((n_esc,), float("inf"), dtype=f64, device=dev)
    warm_seen = torch.zeros((n_esc,), dtype=torch.bool, device=dev)
    warm = None                     # [d_free, dual_ball, dual_half]
    pending = (np.isin(tier_mark, (2, 3)) if tier_mark is not None
               else np.zeros_like(t1_inf, dtype=bool))
    stage_rows: List[int] = []

    for stage, t2_iters in enumerate(TIER2_STAGE_ITERS):
        restart = stage >= 2
        if restart:
            # Restart stages fire on undetermined rows only (exhibition
            # outranks certificates, so certified rows rest), plus the
            # still-pending optimality-repair rows.
            need2 = ((t1_viol >= strict_gate) & ~t1_inf) | pending
        else:
            need2 = (t1_viol >= strict_gate) | pending
        if not need2.any():
            break
        sub = np.nonzero(need2)[0]
        stage_rows.append(int(sub.size))
        cfg = IPMConfig(n_iters=t2_iters)
        v_parts, i_parts = [], []
        for c0 in range(0, sub.size, TIER2_CHUNK_ROWS):
            chunk = sub[c0:c0 + TIER2_CHUNK_ROWS]
            li = torch.as_tensor(chunk, dtype=torch.long, device=dev)
            gi = torch.as_tensor(idx[chunk], dtype=torch.long, device=dev)
            rows = (d64[gi], t64[gi], w64[gi], r64[gi])
            if restart:
                pol64 = ipm._solve_qcqp_ipm_rows(
                    structure, *rows, config=cfg, x0=warm[0][li],
                    lam0_ball=warm[1][li], lam0_half=warm[2][li])
            else:
                pol64 = ipm._solve_qcqp_polished_rows(structure, *rows,
                                                      ipm_config=cfg)
            # Prefer the float64 interior-point iterate whenever it is
            # strictly feasible (it is the near-optimal point); otherwise
            # best by violation, so that solution rows stay consistent with
            # the running-minimum verdict bookkeeping below.
            v64 = pol64.max_violation
            keep = (v64 < strict_gate) | (v64 < merged_fields[pos_mv][gi])
            p_sel = [pf for m, pf in zip(a_mask, pol64) if m]
            merged_fields = [mf.index_copy(0, gi, _take(keep, pf, mf[gi]))
                             for mf, pf in zip(merged_fields, p_sel)]
            new = (pol64.d_free, pol64.dual_ball, pol64.dual_half)
            if warm is None:
                warm = [torch.zeros((n_esc,) + a.shape[1:], dtype=f64,
                                    device=dev) for a in new]
            better = ~warm_seen[li] | (v64 <= warm_v[li])
            for buf, a in zip(warm, new):
                buf.index_copy_(0, li, _take(better, a, buf[li]))
            warm_v.index_copy_(0, li, torch.where(better, v64, warm_v[li]))
            warm_seen[li] = True
            v_parts.append(v64)
            i_parts.append(pol64.infeasible)
        # this stage's one read of the gate data
        v_np = torch.cat(v_parts).cpu().numpy()
        i_np = torch.cat(i_parts).cpu().numpy()
        t1_viol[sub] = np.minimum(t1_viol[sub], v_np)
        pending[sub] &= ~(v_np < strict_gate)
        if tier_mark is not None:
            tier_mark[sub] = 4
        # The float64 certificate replaces the accumulated float32 one for
        # every row this stage re-examined: only the float64 solve may assert
        # INFEASIBLE on these rows -- an OR would let a float32 Farkas
        # false-fire survive into a determinate false-INFEASIBLE verdict.
        t1_inf[sub] = i_np
    return merged_fields, stage_rows


def solve_qcqp_auto(structure: ProblemStructure, d_fixed, times, waypoints,
                    radii,
                    admm_config: Optional[ADMMConfig] = None,
                    ipm_config: Optional[IPMConfig] = None,
                    warmstart_values=None,
                    gate: float = 1e-2,
                    strict_gate: float = 1e-4,
                    tier0_snap: int = 0,
                    tier2_f64: bool = True,
                    tier0_config: Optional[IPMConfig] = None,
                    tier1_spec: int = 0,
                    device: DeviceLike = None) -> AutoResult:
    """Batched tube-QCQP solve with interior-point-grade verdicts at every
    corridor width (all array args carry a leading batch axis).

    Pipeline: throughput ADMM on the full batch (plus ``tier0_snap``
    snap-only Gauss-Newton sweeps when set); scenarios with
    ``max_violation >= gate`` are gathered and re-solved by the warm-started
    plane-layout IPM; rows still at or above ``strict_gate`` without a
    certificate go through the restart chain.  Verdicts: feasible by
    exhibition (violation < ``strict_gate`` after escalation, < ``gate``
    from tier 0), infeasible by the IPM's static / Farkas certificate, else
    undetermined.

    ``tier1_spec``: right after tier 1, run the first restart of the chain
    on the worst ``min(tier1_spec, n_escalated)`` rows by violation, before
    the gate data is read: the residue the chain would re-solve is almost
    surely inside that slice, and landing it here saves the chain's host
    round trips.  0 disables.

    ``tier2_f64``: the last tier, the float64 row-layout interior-point
    method on every row the float32 tiers leave at or above ``strict_gate``
    (certified rows included) and on the rows the restart chain landed; it
    gives the final verdict for them (``_run_tier2_f64``).  With ``False``
    the tier-1.5 verdict stands (conservative: never falsely feasible).

    ``device``: ``None`` means the CUDA card (RuntimeError without one);
    ``"cpu"`` runs the kernels' plain versions on the host.

    While a profiler session is active the call is the span ``strict``
    (``utils.timing``), with ``tier0`` (its host read included),
    ``tier1``, ``tier1_restart``, ``tier15`` and ``tier2`` inside.

    Returns an AutoResult; ``solution`` rows of escalated scenarios are the
    IPM's, everything else tier 0's.
    """
    dev = resolve_device(device)
    with timing.span("strict", dev):
        if admm_config is None:
            admm_config = ADMMConfig(rho=0.005, n_stages=1, n_iters=48,
                                     rho_tube_factor=0.125,
                                     rho_half_factor=0.125)
        if ipm_config is None:
            ipm_config = IPMConfig(n_iters=10, sigma_min=0.3, corrector=False)

        # Tiers 0 to 1.5 run in float32 regardless of the caller's
        # precision; tier 2 solves the caller's original data in float64, so
        # a float64 caller gets everything-in-doubles semantics on the rows
        # that need it and a float32 caller sees the same problem in every
        # tier.
        f32 = torch.float32
        d32, t32, w32, r32 = (as_tensor(a, f32, dev)
                              for a in (d_fixed, times, waypoints, radii))
        ws32 = (None if warmstart_values is None
                else as_tensor(warmstart_values, f32, dev))

        with timing.span("tier0"):
            if tier0_snap:
                # Strict tier 0: ADMM + snap-only Gauss-Newton sweeps
                # (pipelined, one band factor per sweep) -- pulls the ADMM's
                # 1e-4-class violations under the strict gate for the bulk of
                # the batch at a fraction of the full polish's cost.
                ipm0 = tier0_config if tier0_config is not None else \
                    IPMConfig(n_iters=0, snap_iters=tier0_snap, sigma_min=0.3,
                              corrector=False, pipelined=True)
                a = ipm_lanes.solve_qcqp_polished_batch(
                    structure, d32, t32, w32, r32, admm_config=admm_config,
                    ipm_config=ipm0, warmstart_values=ws32, device=dev)
            else:
                a = solve_qcqp_batch(structure, d32, t32, w32, r32,
                                     config=admm_config,
                                     warmstart_values=ws32, device=dev)
            a_viol = a.max_violation.cpu().numpy()         # tier 0's one read
        bsz = int(a.cost.shape[0])
        gate_ok = a_viol < gate

        verdict = np.where(gate_ok, FEASIBLE, UNDETERMINED).astype(np.int8)
        escalated = ~gate_ok
        idx = np.nonzero(escalated)[0]
        n_esc = int(idx.size)
        if n_esc == 0:
            return AutoResult(solution=a, verdict=verdict,
                              escalated=escalated, n_escalated=0,
                              tier=np.zeros(bsz, np.int8))

        a_mask = tuple(af is not None for af in a)
        a_fields = [af for m, af in zip(a_mask, a) if m]
        ip = torch.as_tensor(idx, dtype=torch.long, device=dev)

        # Tier 1 on exactly the failing rows, warm-started from tier 0.
        with timing.span("tier1"):
            pol = ipm_lanes.solve_qcqp_ipm_lanes(
                structure, d32[ip], t32[ip], w32[ip], r32[ip],
                config=ipm_config, x0=a.d_free[ip], lam0_ball=a.dual_ball[ip],
                lam0_half=a.dual_half[ip], device=dev)
        spec_rows = min(int(tier1_spec), n_esc)
        if spec_rows:
            # Speculative first restart on the worst slice: best-by-violation
            # iterate merge, the restart's certificate replaces the row's
            # (chain semantics).  topk indices are unique, so the scatters
            # cannot collide.
            with timing.span("tier1_restart"):
                viol1 = pol.max_violation
                wi = torch.topk(viol1, spec_rows).indices
                ip_w = ip[wi]
                rs = ipm_lanes.solve_qcqp_ipm_lanes(
                    structure, d32[ip_w], t32[ip_w], w32[ip_w], r32[ip_w],
                    config=RESTART_CONFIGS[0], x0=pol.d_free[wi],
                    lam0_ball=pol.dual_ball[wi], lam0_half=pol.dual_half[wi],
                    device=dev)
                keep = rs.max_violation < viol1[wi]
                fields = []
                for name, pf, nf in zip(QCQPSolution._fields, pol, rs):
                    if pf is None:
                        fields.append(None)
                    elif name == "infeasible":
                        fields.append(pf.index_copy(0, wi, nf))
                    else:
                        fields.append(pf.index_copy(
                            0, wi, _take(keep, nf, pf[wi])))
                pol = QCQPSolution(*fields)
        pol_sel = [pf for m, pf in zip(a_mask, pol) if m]
        merged_fields = [af.index_copy(0, ip, pf.to(af.dtype))
                         for af, pf in zip(a_fields, pol_sel)]

        # Tier 1's one read.  The restart chain takes the rows still at or
        # above the strict gate that carry no certificate.
        t1_viol = pol.max_violation.cpu().numpy().copy()
        t1_inf = pol.infeasible.cpu().numpy().copy()
        tier_esc = np.ones(n_esc, np.int8)
        with timing.span("tier15"):
            merged_fields = _run_tier15_chain(
                structure, d32, t32, w32, r32, idx, t1_viol, t1_inf,
                merged_fields, a_mask, strict_gate, tier_mark=tier_esc)
        if tier2_f64:
            with timing.span("tier2"):
                merged_fields, _ = _run_tier2_f64(
                    structure, d_fixed, times, waypoints, radii, idx, t1_viol,
                    t1_inf, merged_fields, a_mask, strict_gate,
                    tier_mark=tier_esc, device=dev)

        it = iter(merged_fields)
        merged = QCQPSolution(*(next(it) if m else af
                                for m, af in zip(a_mask, a)))

        v_esc = np.where(t1_viol < strict_gate, FEASIBLE,
                         np.where(t1_inf, INFEASIBLE, UNDETERMINED)).astype(
            np.int8)
        verdict[idx] = v_esc
        tier = np.zeros(bsz, np.int8)
        tier[idx] = tier_esc
        return AutoResult(solution=merged, verdict=verdict,
                          escalated=escalated, n_escalated=n_esc, tier=tier)


def solve_qcqp_strict(structure: ProblemStructure, d_fixed, times, waypoints,
                      radii, warmstart_values=None,
                      tier2_f64: bool = True,
                      ipm_config: Optional[IPMConfig] = None,
                      tier1_spec: int = 128,
                      device: DeviceLike = None) -> AutoResult:
    """Strict-feasibility solve at router throughput.

    Tier 0: ADMM + 2 snap-only Gauss-Newton sweeps (one band factor each);
    tier 1: rows still >= 1e-4 escalate to the warm-started plane-layout IPM
    polish (6 single-direction Newton steps at centering 0.3 + 2 snap
    sweeps) with a 128-row speculative restart; tier 1.5: float32 restart
    chain on the residue; tier 2 (the float64 row-layout IPM) for anything
    left, so that every row ends determinate.  Verdicts are
    feasibility-by-exhibition at the 1e-4 strict gate -- the per-solve
    semantics of the reference's Mosek back end (qcqp_impl.h:709-788) with
    the polish cost paid only by the scenarios that need it.
    """
    if ipm_config is None:
        ipm_config = IPMConfig(n_iters=6, sigma_min=0.3, corrector=False)
    return solve_qcqp_auto(structure, d_fixed, times, waypoints, radii,
                           warmstart_values=warmstart_values, gate=1e-4,
                           strict_gate=1e-4, tier0_snap=2,
                           tier2_f64=tier2_f64, ipm_config=ipm_config,
                           tier1_spec=tier1_spec, device=device)


def solve_qcqp_strict_sharded(structure: ProblemStructure, d_fixed, times,
                              waypoints, radii, *, mesh: Mesh,
                              warmstart_values=None,
                              admm_config: Optional[ADMMConfig] = None,
                              ipm_config: Optional[IPMConfig] = None,
                              gate: float = 1e-4,
                              strict_gate: float = 1e-4,
                              tier0_snap: int = 2,
                              tier2_f64: bool = True):
    """The strict verdict router over a scenario mesh
    (``parallel.mesh.make_mesh``).

    The caller passes this rank's rows (``parallel.mesh.local_rows`` of the
    global batch) and gets back this rank's rows.  Routing is per rank:
    tiers 0, 1, 1.5 and 2 run through ``solve_qcqp_auto`` on the rank's own
    rows on ``mesh.device``; escalated rows never leave their rank, and the
    float64 tier 2 runs on the rank's device on its own residue.  Scenarios
    are independent, so a row's verdict does not depend on which rank
    solves it.  This is the per-host routing the JAX package recommends for
    several processes.

    Defaults are the JAX package's mesh router's: the headline ADMM, tier
    0's two snap sweeps, and tier 1 at ten single-direction Newton steps
    (it10) with no speculative restart (``tier1_spec=0``), where the
    single-process ``solve_qcqp_strict`` runs it6 with a 128-row
    speculation.

    There is no bucket quantum: the JAX router pads its escalated set to a
    multiple of ``tier1_block`` x the device count because XLA needs static
    shapes; that is a TPU workaround, and each rank here gathers exactly its
    failing rows.

    Returns (AutoResult of this rank's rows, n_strict): n_strict counts
    ``max_violation < strict_gate`` over every rank's final merged rows, by
    one ``all_reduce``, as a float32 0-d tensor on ``mesh.device``, the same
    on every rank.  Every rank joins that reduction, also a rank none of
    whose rows escalated.
    """
    if ipm_config is None:
        ipm_config = IPMConfig(n_iters=10, sigma_min=0.3, corrector=False)
    res = solve_qcqp_auto(structure, d_fixed, times, waypoints, radii,
                          admm_config=admm_config, ipm_config=ipm_config,
                          warmstart_values=warmstart_values, gate=gate,
                          strict_gate=strict_gate, tier0_snap=tier0_snap,
                          tier2_f64=tier2_f64, tier1_spec=0,
                          device=mesh.device)
    n_strict = (res.solution.max_violation < strict_gate).sum(
        dtype=torch.float32)
    return res, _all_reduce(mesh, n_strict)
