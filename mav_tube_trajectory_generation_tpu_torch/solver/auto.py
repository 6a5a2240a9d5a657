"""Verdict router: ADMM gate plus selective interior-point escalation.

Counterpart of the JAX package's ``solver/auto.py`` (single-process router,
tiers 0, 1 and 1.5; the float64 tier 2 is not ported yet).  The reference
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
endgames (tier 1.5).

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
from . import ipm_lanes
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

_TIER2_MESSAGE = (
    "tier 2 (the float64 rows IPM: solve_qcqp_ipm / solve_qcqp_polished on "
    "the generic solve_qcqp path) is not ported yet -- ROADMAP.md queue 1 "
    "item 4; pass tier2_f64=False to keep the tier-1.5 verdict "
    "(conservative: never false-feasible)")


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

    ``tier2_f64``: the reference's last tier, a float64 rows IPM for what
    the float32 tiers cannot settle.  It is not ported yet, and its default
    is kept: a call with ``True`` raises NotImplementedError before any
    work.  With ``False`` the tier-1.5 verdict stands.

    ``device``: ``None`` means the CUDA card (RuntimeError without one);
    ``"cpu"`` runs the kernels' plain versions on the host.

    Returns an AutoResult; ``solution`` rows of escalated scenarios are the
    IPM's, everything else tier 0's.
    """
    if tier2_f64:
        raise NotImplementedError(_TIER2_MESSAGE)
    dev = resolve_device(device)
    if admm_config is None:
        admm_config = ADMMConfig(rho=0.005, n_stages=1, n_iters=48,
                                 rho_tube_factor=0.125,
                                 rho_half_factor=0.125)
    if ipm_config is None:
        ipm_config = IPMConfig(n_iters=10, sigma_min=0.3, corrector=False)

    # The tiers run in float32 regardless of the caller's precision.
    f32 = torch.float32
    d32, t32, w32, r32 = (as_tensor(a, f32, dev)
                          for a in (d_fixed, times, waypoints, radii))
    ws32 = (None if warmstart_values is None
            else as_tensor(warmstart_values, f32, dev))

    if tier0_snap:
        # Strict tier 0: ADMM + snap-only Gauss-Newton sweeps (pipelined,
        # one band factor per sweep) -- pulls the ADMM's 1e-4-class
        # violations under the strict gate for the bulk of the batch at a
        # fraction of the full polish's cost.
        ipm0 = tier0_config if tier0_config is not None else IPMConfig(
            n_iters=0, snap_iters=tier0_snap, sigma_min=0.3,
            corrector=False, pipelined=True)
        a = ipm_lanes.solve_qcqp_polished_batch(
            structure, d32, t32, w32, r32, admm_config=admm_config,
            ipm_config=ipm0, warmstart_values=ws32, device=dev)
    else:
        a = solve_qcqp_batch(structure, d32, t32, w32, r32,
                             config=admm_config, warmstart_values=ws32,
                             device=dev)
    bsz = int(a.cost.shape[0])
    a_viol = a.max_violation.cpu().numpy()                 # tier 0's one read
    gate_ok = a_viol < gate

    verdict = np.where(gate_ok, FEASIBLE, UNDETERMINED).astype(np.int8)
    escalated = ~gate_ok
    idx = np.nonzero(escalated)[0]
    n_esc = int(idx.size)
    if n_esc == 0:
        return AutoResult(solution=a, verdict=verdict, escalated=escalated,
                          n_escalated=0, tier=np.zeros(bsz, np.int8))

    a_mask = tuple(af is not None for af in a)
    a_fields = [af for m, af in zip(a_mask, a) if m]
    ip = torch.as_tensor(idx, dtype=torch.long, device=dev)

    # Tier 1 on exactly the failing rows, warm-started from tier 0.
    pol = ipm_lanes.solve_qcqp_ipm_lanes(
        structure, d32[ip], t32[ip], w32[ip], r32[ip], config=ipm_config,
        x0=a.d_free[ip], lam0_ball=a.dual_ball[ip],
        lam0_half=a.dual_half[ip], device=dev)
    spec_rows = min(int(tier1_spec), n_esc)
    if spec_rows:
        # Speculative first restart on the worst slice: best-by-violation
        # iterate merge, the restart's certificate replaces the row's (chain
        # semantics).  topk indices are unique, so the scatters cannot
        # collide.
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
                fields.append(pf.index_copy(0, wi, _take(keep, nf, pf[wi])))
        pol = QCQPSolution(*fields)
    pol_sel = [pf for m, pf in zip(a_mask, pol) if m]
    merged_fields = [af.index_copy(0, ip, pf.to(af.dtype))
                     for af, pf in zip(a_fields, pol_sel)]

    # Tier 1's one read.  The restart chain takes the rows still at or above
    # the strict gate that carry no certificate.
    t1_viol = pol.max_violation.cpu().numpy().copy()
    t1_inf = pol.infeasible.cpu().numpy().copy()
    tier_esc = np.ones(n_esc, np.int8)
    merged_fields = _run_tier15_chain(
        structure, d32, t32, w32, r32, idx, t1_viol, t1_inf, merged_fields,
        a_mask, strict_gate, tier_mark=tier_esc)

    it = iter(merged_fields)
    merged = QCQPSolution(*(next(it) if m else af
                            for m, af in zip(a_mask, a)))

    v_esc = np.where(t1_viol < strict_gate, FEASIBLE,
                     np.where(t1_inf, INFEASIBLE, UNDETERMINED)).astype(
        np.int8)
    verdict[idx] = v_esc
    tier = np.zeros(bsz, np.int8)
    tier[idx] = tier_esc
    return AutoResult(solution=merged, verdict=verdict, escalated=escalated,
                      n_escalated=n_esc, tier=tier)


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
    chain on the residue; tier 2 (float64 rows IPM) for anything left -- not
    ported yet, see ``solve_qcqp_auto``.  Verdicts are
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
