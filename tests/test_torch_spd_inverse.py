"""``ops.linalg.spd_inverse``: the contract its CUDA kernel copies, pinned on
the host's library route, and on the card the kernel (``csrc/spd_inverse.cu``)
against that route, the route by shape, and a headline call with no host
synchronisation.

The card tests need an NVIDIA card and nvcc, and skip without them (the
kernel has no host mode).  This file imports no JAX: the card runs it as it
is.

Tolerances of the kernel against the library route on the host: both factor
and solve against the identity, in other orders of their sums (the kernel
in LAPACK's dpotf2 and dtrsm order and in float64 for either type, rounded
once; the host library blocked, in the call's type).  On blocks
equilibrated to condition ~3, as in
``test_torch_foundations.test_spd_inverse``, that leaves a few units of the
last place of the equilibrated inverse, whose entries are O(1): the gap is
taken there, 2e-4 of its largest entry in float32, 1e-10 in float64.
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import mav_tube_trajectory_generation_tpu_torch as mtt
from mav_tube_trajectory_generation_tpu_torch.ops import linalg
from mav_tube_trajectory_generation_tpu_torch.utils import timing

from torch_port_util import BENCH_KW

RTOL = {torch.float32: 2e-4, torch.float64: 1e-10}
INDEFINITE, NON_FINITE = 5, 11


def _batch(n, dtype, batch=24, seed=0, indefinite=True, non_finite=True):
    """Blocks as in ``test_spd_inverse`` (SPD, scaled over six decades,
    equilibrated condition ~3), one indefinite with a positive diagonal
    ([[1, 2], [2, 1]] in the identity) and one with a NaN on its diagonal."""
    rng = np.random.RandomState(seed + n)
    a = rng.randn(batch, n, n)
    a = a @ a.transpose(0, 2, 1) + n * np.eye(n)
    a *= np.logspace(-3, 3, n)[:, None] * np.logspace(-3, 3, n)[None, :]
    if indefinite:
        a[INDEFINITE] = np.eye(n)
        a[INDEFINITE, 0, 1] = a[INDEFINITE, 1, 0] = 2.0
    if non_finite:
        a[NON_FINITE, n // 2, n // 2] = np.nan
    return torch.tensor(a, dtype=dtype)


def _profiled_counters(fn):
    timing.clear_span_log()
    with profile(activities=[ProfilerActivity.CPU]):
        out = fn()
    (call,) = timing.span_log()
    timing.clear_span_log()
    return out, call["counters"]


# ---- the contract, on the host's library route ---------------------------

@pytest.mark.parametrize("n", [9, 15, 36])
def test_contract_on_the_library_route(n):
    a = _batch(n, torch.float64)
    clean = _batch(n, torch.float64, non_finite=False)
    launches = linalg.launches
    inv, counters = _profiled_counters(lambda: linalg.spd_inverse(a))
    assert linalg.launches == launches                 # no kernel on the host
    eye = torch.eye(n, dtype=a.dtype)
    a_eq = a / torch.sqrt(torch.diagonal(a, dim1=-2, dim2=-1)[..., :, None]
                          * torch.diagonal(a, dim1=-2, dim2=-1)[..., None, :])
    refused = torch.linalg.cholesky_ex(a_eq)[1] != 0
    assert refused.nonzero().flatten().tolist() == [INDEFINITE, NON_FINITE]
    # the refused block gets the pivoted inverse
    assert torch.allclose(inv[INDEFINITE] @ a[INDEFINITE], eye, atol=1e-12)
    assert torch.allclose(inv[INDEFINITE], torch.linalg.inv(a[INDEFINITE]),
                          rtol=1e-12, atol=1e-14)
    # a non-finite block: non-finite there, every other block bit for bit
    # what it is in a batch without it
    assert not torch.isfinite(inv[NON_FINITE]).all()
    others = [i for i in range(a.shape[0]) if i != NON_FINITE]
    assert torch.isfinite(inv[others]).all()
    assert torch.equal(inv[others], linalg.spd_inverse(clean)[others])
    # exactly symmetric
    assert torch.equal(inv[others], inv[others].transpose(-1, -2))
    for i in others:
        assert torch.allclose(inv[i] @ a[i], eye, atol=1e-8), i
    # the counters: refused blocks, and no kernel block on the host
    assert counters == {"spd_inverse.lu_blocks": 2.0,
                        "spd_inverse.kernel_blocks": 0.0}


# ---- the kernel, on the card --------------------------------------------

def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no host mode")


def _rel_gap(x, y, a):
    """Largest |x - y| of each block over the block's largest |y|, both
    taken in the equilibrated frame (times d_i d_j, d = diag(a)^1/2), where
    the inverse's entries are O(1): a gap in its smallest entries shows."""
    d = torch.sqrt(torch.diagonal(a, dim1=-2, dim2=-1))
    dd = d[..., :, None] * d[..., None, :]
    return (((x - y) * dd).abs().amax(dim=(-2, -1))
            / (y * dd).abs().amax(dim=(-2, -1)))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64],
                         ids=["f32", "f64"])
@pytest.mark.parametrize("n", [6, 9, 15, 36, 64])
def test_kernel_matches_the_library_route(n, dtype):
    _need_card()
    a = _batch(n, dtype)
    plain, plain_refused = linalg._spd_inverse_library(a)
    launches = linalg.launches
    inv_d, refused_d = linalg.spd_inverse_cuda(a.cuda())
    torch.cuda.synchronize()
    assert linalg.launches == launches + 1
    inv, refused = inv_d.cpu(), refused_d.cpu()
    assert refused.dtype == torch.int32
    # the refusal flags are the Cholesky factor's
    assert torch.equal(refused != 0, plain_refused)
    assert (refused != 0).nonzero().flatten().tolist() == [INDEFINITE,
                                                          NON_FINITE]
    # the NaN stays in its block
    assert not torch.isfinite(inv[NON_FINITE]).all()
    others = [i for i in range(a.shape[0]) if i != NON_FINITE]
    assert torch.isfinite(inv[others]).all()
    # exactly symmetric
    assert torch.equal(inv[others], inv[others].transpose(-1, -2))
    # the refused block's pivoted inverse
    eye = torch.eye(n, dtype=dtype)
    atol = 1e-5 if dtype == torch.float32 else 1e-12
    assert torch.allclose(inv[INDEFINITE] @ a[INDEFINITE], eye, atol=atol)
    gap = _rel_gap(inv[others], plain[others], a[others])
    assert float(gap.max()) < RTOL[dtype], gap


@pytest.mark.gpu
def test_route_by_shape_on_the_card():
    """n <= 64 takes the kernel (through a copy where the blocks are a
    strided view), n > 64 the library route as before; a type the kernel
    does not take raises."""
    _need_card()
    stacked = _batch(15, torch.float32, batch=8 * 3).reshape(8, 3, 15, 15)
    view = stacked.cuda()[:, 1]                        # not contiguous
    launches = linalg.launches
    got = linalg.spd_inverse(view)
    assert linalg.launches == launches + 1
    assert torch.equal(got, linalg.spd_inverse_cuda(view.contiguous())[0])
    big = _batch(65, torch.float32, batch=4, indefinite=False,
                 non_finite=False).cuda()
    launches = linalg.launches
    got = linalg.spd_inverse(big)
    assert linalg.launches == launches
    assert torch.equal(got, linalg._spd_inverse_library(big)[0])
    with pytest.raises(TypeError):
        linalg.spd_inverse(_batch(15, torch.float16, batch=2,
                                  indefinite=False, non_finite=False).cuda())


@pytest.mark.gpu
def test_headline_call_does_not_synchronise():
    """A warm ``solve_qcqp_batch`` at the benchmark's settings (batch 256,
    one stage, warm-started from the vertex values) completes with the CUDA
    sync debug mode raising on any host synchronisation, and takes the
    kernel ten times: the warm start's block and the nine pivot blocks."""
    _need_card()
    sc = mtt.make_inputs(10, 256, seed=0, device="cuda")
    cfg = mtt.ADMMConfig(n_stages=1, **BENCH_KW)

    def call():
        return mtt.solve_qcqp_batch(sc.free, sc.d_fixed_free, sc.times,
                                    sc.waypoints, sc.radii, config=cfg,
                                    warmstart_values=sc.values)

    call()
    torch.cuda.synchronize()
    launches = linalg.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        sol = call()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert linalg.launches == launches + 10
    torch.cuda.synchronize()
    assert bool(torch.isfinite(sol.coefficients).all())
