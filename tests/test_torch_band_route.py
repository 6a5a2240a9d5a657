"""The Gram band's default route, ``band_gram="auto"``, on the card: float32
G^T takes the hand-written kernel ``gram_band`` (#6) once a solve in place
of the dense batched Gram, agrees with the dense route within the KKT
routes' limits of ``chip_smoke.py``, and is counted by ``qcqp.band_kernel``;
float64 keeps the dense route; float32 G^T the kernel does not take
raises, as on "pallas".

The host side (the default is the dense route bit for bit there, the
explicit routes, the values the config takes) is in
``test_torch_admm_routes.py``.  These tests need an NVIDIA card and nvcc,
and skip without them (the kernel has no host mode).  This file imports no
JAX: the card runs it as it is.
"""

import os
import sys

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import mav_tube_trajectory_generation_tpu_torch as mtt
from mav_tube_trajectory_generation_tpu_torch.ops import admm_kernel
from mav_tube_trajectory_generation_tpu_torch.solver import qcqp
from mav_tube_trajectory_generation_tpu_torch.utils import timing

from torch_port_util import BENCH_KW

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

K, BLK, NFD, M_P = 10, 15, 135, 512


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no host mode")


def _solver(batch, seed=0, n_stages=1, **over):
    sc = mtt.make_inputs(K, batch, seed=seed, device="cuda")
    cfg = mtt.ADMMConfig(n_stages=n_stages, **BENCH_KW, **over)
    return lambda: mtt.solve_qcqp_batch(
        sc.free, sc.d_fixed_free, sc.times, sc.waypoints, sc.radii,
        config=cfg, warmstart_values=sc.values)


def _dense_gram_products(prof, rows):
    """The profiled matmuls of ``rows`` scenarios' (nfd, m_p) G^T by its
    transpose: the dense Gram of the "xla" route."""
    want = [[rows, NFD, M_P], [rows, M_P, NFD]]
    return [e.name for e in prof.events()
            if e.name in ("aten::matmul", "aten::bmm")
            and [list(s) for s in e.input_shapes[:2]] == want]


@pytest.mark.gpu
@pytest.mark.parametrize("n_stages", [1, 2])
def test_default_takes_the_band_kernel_once_a_solve(n_stages):
    """At K=10 in float32 the default launches ``gram_band`` once a solve,
    whatever the stages, and forms no dense Gram; "xla" forms it (the
    control of the profile's reading) and launches no band kernel."""
    _need_card()
    batch = 512
    for over, kernel in (({}, 1), (dict(band_gram="xla"), 0)):
        call = _solver(batch, n_stages=n_stages, **over)
        call()
        torch.cuda.synchronize()
        before = dict(admm_kernel.launches)
        with profile(activities=[ProfilerActivity.CPU],
                     record_shapes=True) as prof:
            sol = call()
            torch.cuda.synchronize()
        launched = {n: admm_kernel.launches[n] - before.get(n, 0)
                    for n in admm_kernel.launches}
        assert launched["gram_band"] == kernel, over
        assert launched["gram_band_factors"] == 0
        assert launched["admm_stage_fused_factored"] == n_stages
        assert bool(_dense_gram_products(prof, batch)) == (not kernel), over
        assert bool(torch.isfinite(sol.coefficients).all())
    timing.clear_span_log()


@pytest.mark.gpu
def test_default_agrees_with_xla_within_the_route_limits():
    """The headline (K=10, batch 6144, seed 0) on the default route against
    "xla" on the same inputs, at ``chip_smoke.py``'s limits for the KKT
    routes: relative cost gap median and 99th percentile, rows beyond it,
    and the feasible count at 1e-2."""
    _need_card()
    import chip_smoke
    batch = chip_smoke.MAIN_BATCH
    auto = _solver(batch)()
    xla = _solver(batch, band_gram="xla")()
    gap = chip_smoke.cost_gap_summary(auto, xla)
    assert chip_smoke.gap_ok(gap, batch), gap
    qa = chip_smoke.solution_quality(auto)
    qx = chip_smoke.solution_quality(xla)
    assert qa["all_finite"] and qx["all_finite"]
    assert (abs(qa["feasible_at_1e_2"] - qx["feasible_at_1e_2"])
            <= chip_smoke.ROUTE_FEASIBLE_SHARE * batch), (qa, qx)


@pytest.mark.gpu
@pytest.mark.parametrize("mode,kernel", [("auto", True), ("pallas", True),
                                         ("xla", False)])
def test_band_kernel_counter_reads_the_batch(mode, kernel):
    _need_card()
    batch = 512
    call = _solver(batch, band_gram=mode)
    call()
    torch.cuda.synchronize()
    timing.clear_span_log()
    with profile(activities=[ProfilerActivity.CUDA]):
        call()
        torch.cuda.synchronize()
    (log,) = timing.span_log()
    timing.clear_span_log()
    assert log["counters"]["qcqp.band_kernel"] == (batch if kernel else 0)


@pytest.mark.gpu
def test_default_keeps_the_dense_route_in_float64():
    """G^T in float64 (the kernel takes float32 only): the default takes
    the dense route, bit for bit "xla"'s, launches nothing and does not
    raise."""
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(5)
    f64 = torch.float64
    gt = torch.randn((8, NFD, M_P), generator=gen, device="cuda", dtype=f64)
    p_eq = torch.randn((8, NFD // 3, NFD // 3), generator=gen, device="cuda",
                       dtype=f64)
    assert qcqp._band_route(gt, "auto") == "xla"
    before = dict(admm_kernel.launches)
    timing.clear_span_log()
    with profile(activities=[ProfilerActivity.CUDA]):
        with timing.span("qcqp", gt.device):
            band = qcqp._kkt_band(gt, p_eq, BLK)
        torch.cuda.synchronize()
    (log,) = timing.span_log()
    timing.clear_span_log()
    assert admm_kernel.launches == before
    assert log["counters"]["qcqp.band_kernel"] == 0
    for a, b in zip(band, qcqp._kkt_band(gt, p_eq, BLK, "xla")):
        assert a.dtype == f64 and torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["strided", "m_p_510"])
def test_default_raises_where_the_kernel_refuses(case):
    """float32 G^T on the card that the kernel does not take (a strided
    view, lanes not a multiple of 4; no solve builds either) raises on the
    default route, as on "pallas", and does not fall back."""
    _need_card()
    gen = torch.Generator(device="cuda").manual_seed(6)
    m_p = 510 if case == "m_p_510" else M_P
    if case == "strided":
        gt = torch.randn((8, m_p, NFD), generator=gen,
                         device="cuda").transpose(1, 2)
    else:
        gt = torch.randn((8, NFD, m_p), generator=gen, device="cuda")
    p_eq = torch.randn((8, NFD // 3, NFD // 3), generator=gen, device="cuda")
    assert qcqp._band_route(gt, "auto") == "pallas"
    for mode in ("auto", "pallas"):
        with pytest.raises(ValueError):
            qcqp._kkt_band(gt, p_eq, BLK, mode)
