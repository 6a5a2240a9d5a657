"""The cluster design of the interior-point kernels ``ipm_eval_step`` (band
output and the whole Gram), ``ipm_pipe_step`` and ``ipm_solve_fused``: what
of it the host can compute.

* The lane split: the two blocks of a scenario's cluster split the lanes by
  ball index; every lane lies in exactly one block, a ball's three planes
  and its Jacobian row in one block, and each block sums its lanes in its
  local order.
* The shared-memory budget (``cluster_layout``, the same function as
  ``make_cluster_layout`` in ``csrc/ipm_cluster.cuh``): the flagship shape
  and K=4 fit an H100 block, K=12 does not and keeps the one-block body.
* The plain versions that sum the band in the design's order
  (``ipm_eval_step_cluster_plain``, ``ipm_pipe_step_cluster_plain``,
  ``ipm_solve_fused_cluster_plain``) and the whole Gram in its order (rank
  0's sum + rank 1's, the blocks under the diagonal mirrored from those
  above) against the JAX package's Pallas kernels in interpret mode, at the
  tolerance of ``tests/test_torch_ipm_kernel.py`` (``TOL`` = 2e-5 of each
  output's scale: the same float32 formulas summed in another order; the
  whole polish, a chain of steps on a well-conditioned random system, ten
  times that), and against the reference order in float64, where the two
  orders agree to rounding (1e-12 of scale): a lane summed twice or left
  out, or a block mirrored from the wrong one, would not.

The kernels themselves run only on the card: the ``gpu`` tests.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from mav_tube_trajectory_generation_tpu.ops import ipm_kernel as jk
import mav_tube_trajectory_generation_tpu_torch as mtt
from mav_tube_trajectory_generation_tpu_torch.ops import ipm_kernel as tk

from test_torch_ipm_kernel import (EVAL_OUT, FUSED_OUT, GRAM_OUT, MODE_PAIRS,
                                   PIPE_OUT, TOL, _close, _fused_random_case,
                                   _random_inputs)
from torch_port_util import to_np, tt

# (nfd, m_p, blk, nb_p, n_ball): the flagship K=10, K=4 and K=12 layouts of
# the 10-coefficient problem, and the random test shape of
# tests/test_torch_ipm_kernel.py (final half-space plane present).
SHAPES = {"flagship K=10": (135, 512, 15, 128, 89),
          "K=4": (45, 384, 15, 128, 35),
          "K=12": (165, 640, 15, 128, 107),
          "random": (24, 512, 6, 128, 17)}
FITS = {"flagship K=10": True, "K=4": True, "K=12": False, "random": True}
# A block's shared memory on an H100 (the opt-in limit, 227 KB); on the card
# the library reads it from the device.
H100_SMEM = 232448
KERNELS = ("ipm_eval_step", "ipm_pipe_step")
# The whole-Gram evaluation (#10) and the whole polish (#11), in the cluster
# design too.
NEW_KERNELS = ("ipm_eval_step_gram", "ipm_solve_fused")


@pytest.mark.parametrize("shape", list(SHAPES))
def test_lane_split_and_band_order(shape):
    nfd, m_p, blk, nb_p, n_ball = SHAPES[shape]
    parts = tk.cluster_band_parts(m_p, nb_p, n_ball)
    assert [r for r, _, _ in parts] == [0, 1]
    lanes = [l for _, ls, _ in parts for l in ls]
    assert sorted(lanes) == list(range(m_p))           # each lane once
    balls = [j for _, _, bs in parts for j in bs]
    assert sorted(balls) == list(range(n_ball))        # each row once
    rank_of = {l: r for r, ls, _ in parts for l in ls}
    for r, _, bs in parts:
        for j in bs:                     # a ball's planes and row together
            assert rank_of[j] == rank_of[nb_p + j] == rank_of[2 * nb_p + j] \
                == r
    # each block sums its lanes in its local order
    for rank, (block, _) in enumerate(tk.cluster_lane_split(m_p, nb_p)):
        assert parts[rank][1] == block
    # rank 0 takes the first ceil(nb_p / 2) balls of each plane
    assert all(rank_of[j] == (0 if j < (nb_p + 1) // 2 else 1)
               for j in range(nb_p))
    # a warp a row block, a thread a tile of its two band blocks
    lay = tk.cluster_layout("ipm_eval_step", nfd, m_p, blk, nb_p)
    assert 2 * lay["per"] <= 32 and nfd // blk <= tk.THREADS // 32


@pytest.mark.parametrize("shape", list(SHAPES))
def test_shared_memory_budget(shape):
    nfd, m_p, blk, nb_p, _ = SHAPES[shape]
    nl0 = len(tk.cluster_lane_split(m_p, nb_p)[0][0])
    for kernel in KERNELS:
        lay = tk.cluster_layout(kernel, nfd, m_p, blk, nb_p)
        total = 4 * lay["total"]
        assert total == tk.cluster_smem_bytes(kernel, nfd, m_p, blk, nb_p)
        # G^T's share alone (a tile a plane segment), then the rest
        assert nfd * nl0 <= lay["nseg"] * nfd * lay["lds"] < lay["total"]
        assert lay["tile"] % 32 == 0                  # 128-byte TMA boxes
        assert lay["lds"] % 8 == 4 and lay["ldj"] % 8 == 4   # odd float4
        assert (total <= H100_SMEM) == FITS[shape]
    eval_b = tk.cluster_smem_bytes("ipm_eval_step", nfd, m_p, blk, nb_p)
    pipe_b = tk.cluster_smem_bytes("ipm_pipe_step", nfd, m_p, blk, nb_p)
    assert eval_b < pipe_b
    if shape == "flagship K=10":
        # 146,944 B of G^T (four tiles of 135 rows of 68 floats), 36,720
        # of Jacobian rows, the rest vectors, the band's halves, the lane
        # lists and the reductions
        assert (eval_b, pipe_b) == (211184, 227808)
    if shape == "K=12":
        # half of G^T and the Jacobian rows alone exceed the limit
        lay = tk.cluster_layout("ipm_eval_step", nfd, m_p, blk, nb_p)
        assert 4 * (lay["nseg"] * lay["tile"] + nfd * lay["ldj"]) > \
            H100_SMEM


@pytest.mark.parametrize("upd,ev", MODE_PAIRS)
def test_pipe_cluster_order_against_pallas_interpret(upd, ev):
    d, kw = _random_inputs(seed=3)
    names = mtt.convert.PIPE_STEP_INPUTS
    ref = jk.ipm_pipe_step(*(jnp.asarray(d[n]) for n in names),
                           upd_mode=upd, eval_mode=ev, interpret=True, **kw)
    ours = tk.ipm_pipe_step_cluster_plain(
        *mtt.lanes_state_from_numpy(d, device="cpu"), upd_mode=upd,
        eval_mode=ev, **kw)
    _close(ours, ref, PIPE_OUT)


@pytest.mark.parametrize("phr", [False, True])
def test_eval_cluster_order_against_pallas_interpret(phr):
    d, kw = _random_inputs(seed=4)
    if phr:      # as the snap feeds it: lam on some lanes, s = lam / rho
        rng = np.random.RandomState(5)
        d["lam"] = np.where(rng.rand(*d["lam"].shape) < 0.3, 1e-6,
                            0.0).astype(np.float32)
        d["s"] = (d["lam"] / 1e4).astype(np.float32)
    args = [d[n] for n in ("gt", "b", "rb", "x", "s", "lam")]
    ekw = dict(nb_p=kw["nb_p"], n_ball=kw["n_ball"],
               w_cap=1e4 if phr else 1e6, phr=phr, band_block=kw["blk"])
    ref = jk.ipm_eval_step(*(jnp.asarray(a) for a in args), interpret=True,
                           **ekw)
    ours = tk.ipm_eval_step_cluster_plain(*(tt(a) for a in args), **ekw)
    _close(ours, ref, EVAL_OUT)


@pytest.mark.parametrize("shape", ["flagship K=10", "K=4", "random"])
def test_cluster_order_is_the_same_band_in_float64(shape):
    nfd, m_p, blk, nb_p, n_ball = SHAPES[shape]
    d, _ = _random_inputs(seed=11, s_blk=2, nfd=nfd, nb_p=nb_p,
                          nh_p=m_p - 3 * nb_p, n_ball=n_ball, blk=blk)
    args = [tt(d[n], torch.float64)
            for n in ("gt", "b", "rb", "x", "s", "lam")]
    ekw = dict(nb_p=nb_p, n_ball=n_ball, w_cap=1e6, band_block=blk)
    ref = tk.ipm_eval_step_plain(*args, **ekw)
    ours = tk.ipm_eval_step_cluster_plain(*args, **ekw)
    for name, a, b in zip(EVAL_OUT, ours, ref):
        assert a.dtype == torch.float64
        scale = float(b.abs().max())
        assert float((a - b).abs().max()) <= 1e-12 * scale, name


@pytest.mark.gpu
def test_cluster_design_on_the_card():
    """At the random shape both kernels take the cluster design, agree with
    their plain versions in both orders, and give the same bits run to run.
    Needs an NVIDIA card and nvcc."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no host mode")
    d, kw = _random_inputs(seed=3)
    dev = mtt.lanes_state_from_numpy(d)
    nfd, m_p = d["gt"].shape[1:]
    for kernel in KERNELS:
        assert tk.ipm_design(kernel, nfd, m_p, kw["blk"],
                             kw["nb_p"]) == "cluster"
        assert tk.smem_bytes(tk.CLUSTER_KERNELS[kernel], nfd, m_p, kw["blk"],
                             kw["nb_p"], design="cluster") == \
            tk.cluster_smem_bytes(kernel, nfd, m_p, kw["blk"], kw["nb_p"])
    for upd, ev in MODE_PAIRS:
        ours = tk.ipm_pipe_step(*dev, upd_mode=upd, eval_mode=ev, **kw)
        again = tk.ipm_pipe_step(*dev, upd_mode=upd, eval_mode=ev, **kw)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(ours, again))
        for plain in (tk.ipm_pipe_step_plain, tk.ipm_pipe_step_cluster_plain):
            ref = plain(*dev, upd_mode=upd, eval_mode=ev, **kw)
            _close(ours, [to_np(o) for o in ref], PIPE_OUT)
    ev_args = [dev[i] for i in (0, 1, 2, 6, 7, 8)]
    for phr in (False, True):
        ekw = dict(nb_p=128, n_ball=17, phr=phr, w_cap=1e6, band_block=6)
        ours = tk.ipm_eval_step(*ev_args, **ekw)
        for plain in (tk.ipm_eval_step_plain, tk.ipm_eval_step_cluster_plain):
            _close(ours, [to_np(o) for o in plain(*ev_args, **ekw)],
                   EVAL_OUT)


@pytest.mark.gpu
def test_stream_design_on_the_card():
    """At K=12's layout (half of G^T alone is 211 KB) both kernels keep
    their one-block body and agree with their plain versions.  Needs an
    NVIDIA card and nvcc."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no host mode")
    nfd, m_p, blk, nb_p, n_ball = SHAPES["K=12"]
    d, kw = _random_inputs(seed=13, nfd=nfd, nb_p=nb_p, nh_p=m_p - 3 * nb_p,
                           n_ball=n_ball, blk=blk)
    dev = mtt.lanes_state_from_numpy(d)
    for kernel in KERNELS:
        assert tk.ipm_design(kernel, nfd, m_p, blk, nb_p) == "stream"
    for upd, ev in (("newton", "newton"), ("snap", "snap")):
        ours = tk.ipm_pipe_step(*dev, upd_mode=upd, eval_mode=ev, **kw)
        ref = tk.ipm_pipe_step_plain(*dev, upd_mode=upd, eval_mode=ev, **kw)
        _close(ours, [to_np(o) for o in ref], PIPE_OUT)
    ev_args = [dev[i] for i in (0, 1, 2, 6, 7, 8)]
    ekw = dict(nb_p=nb_p, n_ball=n_ball, w_cap=1e6, band_block=blk)
    _close(tk.ipm_eval_step(*ev_args, **ekw),
           [to_np(o) for o in tk.ipm_eval_step_plain(*ev_args, **ekw)],
           EVAL_OUT)


@pytest.mark.parametrize("kernel", NEW_KERNELS)
@pytest.mark.parametrize("shape", list(SHAPES))
def test_gram_and_solve_layouts_fit_where_the_band_fits(shape, kernel):
    """#10's layout (the band's receive buffer replaced by a row block's
    partial and two receive buffers of its half) and #11's (#8's less the
    snap's two lane vectors, with the band and its factors in the Jacobian
    rows' room, the equilibration scale in place of #8's u and the share's
    row-block masks besides) against the H100's 232,448 B: the flagship
    shape and K=4 fit, K=12 does not."""
    nfd, m_p, blk, nb_p, _ = SHAPES[shape]
    if kernel == "ipm_eval_step_gram":
        blk = tk.gram_row_block(nfd)
    lay = tk.cluster_layout(kernel, nfd, m_p, blk, nb_p)
    total = 4 * lay["total"]
    assert total == tk.cluster_smem_bytes(kernel, nfd, m_p, blk, nb_p)
    assert (total <= H100_SMEM) == FITS[shape]
    band = tk.cluster_layout("ipm_eval_step", nfd, m_p, blk, nb_p)
    bb, m_blk = blk * blk, nfd // blk
    if kernel == "ipm_solve_fused":
        # the band, then the L_i and the C_i of its factor, in jr
        assert lay["lf"] >= lay["nband"] and lay["lf"] % 4 == 0
        assert lay["cf"] == lay["lf"] + m_blk * bb
        assert lay["cf"] + (m_blk - 1) * bb <= lay["jr"]
        assert lay["jr"] >= band["jr"]
        assert total <= tk.cluster_smem_bytes("ipm_pipe_step", nfd, m_p,
                                              blk, nb_p)
    else:
        # a row block's partial is blk x nfd, each half at most gh
        assert 2 * lay["gh"] >= bb * m_blk and lay["gh"] % 4 == 0
    if shape == "flagship K=10":
        assert total == {"ipm_eval_step_gram": 219760,
                         "ipm_solve_fused": 226768}[kernel]


@pytest.mark.parametrize("nfd,want", [(135, 15), (45, 15), (165, 15),
                                      (24, 12), (16, 16), (17, 1), (64, 16)])
def test_gram_row_block(nfd, want):
    """The whole Gram's row blocks: the largest divisor of nfd a band block
    may be, so the vertex block at every flagship-family shape."""
    assert tk.gram_row_block(nfd) == want
    assert nfd % want == 0 and want <= tk.CLUSTER_BMAX


@pytest.mark.parametrize("phr", [False, True])
def test_gram_cluster_order_against_pallas_interpret(phr):
    d, kw = _random_inputs(seed=4)
    if phr:      # as the snap feeds it: lam on some lanes, s = lam / rho
        rng = np.random.RandomState(5)
        d["lam"] = np.where(rng.rand(*d["lam"].shape) < 0.3, 1e-6,
                            0.0).astype(np.float32)
        d["s"] = (d["lam"] / 1e4).astype(np.float32)
    args = [d[n] for n in ("gt", "b", "rb", "x", "s", "lam")]
    ekw = dict(nb_p=kw["nb_p"], n_ball=kw["n_ball"],
               w_cap=1e4 if phr else 1e6, phr=phr, band_block=0)
    ref = jk.ipm_eval_step(*(jnp.asarray(a) for a in args), interpret=True,
                           **ekw)
    ours = tk.ipm_eval_step_cluster_plain(*(tt(a) for a in args), **ekw)
    assert ours[4].shape == (2, 24, 24)
    _close(ours, ref, GRAM_OUT)
    # the blocks under the diagonal are those above, transposed, bit for bit
    g, blk = to_np(ours[4]), tk.gram_row_block(24)
    np.testing.assert_array_equal(g[:, blk:, :blk],
                                  g[:, :blk, blk:].transpose(0, 2, 1))


@pytest.mark.parametrize("shape", ["flagship K=10", "K=4", "random"])
def test_pair_list_gram_is_the_dense_gram_in_float64(shape):
    """On a random G^T every lane reaches every row block, so every block
    pair is summed over every lane: the cluster order's whole Gram is the
    dense one to rounding."""
    nfd, m_p, blk, nb_p, n_ball = SHAPES[shape]
    d, _ = _random_inputs(seed=12, s_blk=2, nfd=nfd, nb_p=nb_p,
                          nh_p=m_p - 3 * nb_p, n_ball=n_ball, blk=blk)
    args = [tt(d[n], torch.float64)
            for n in ("gt", "b", "rb", "x", "s", "lam")]
    ekw = dict(nb_p=nb_p, n_ball=n_ball, w_cap=1e6, band_block=0)
    ref = tk.ipm_eval_step_plain(*args, **ekw)
    ours = tk.ipm_eval_step_cluster_plain(*args, **ekw)
    for name, a, b in zip(GRAM_OUT, ours, ref):
        assert a.dtype == torch.float64
        assert float((a - b).abs().max()) <= 1e-12 * float(b.abs().max()), \
            name


@pytest.mark.parametrize("n_iters,snap_iters", [(2, 0), (0, 1), (2, 1)])
def test_solve_cluster_order_against_pallas_interpret(n_iters, snap_iters):
    """The whole polish with each band summed in the cluster order, against
    the Pallas kernel (random arrays, four scenarios, handed to the Pallas
    kernel as two blocks of two; a positive semidefinite objective band, as
    in test_torch_ipm_kernel.py, so every scenario is held to it)."""
    kw, ref, args = _fused_random_case(n_iters, snap_iters)
    ours = tk.ipm_solve_fused_cluster_plain(*args, **kw)
    _close(ours, ref, FUSED_OUT, tol=10 * TOL)


@pytest.mark.gpu
def test_gram_and_solve_cluster_design_on_the_card():
    """At the random shape #10 and #11 take the cluster design, agree with
    their plain versions in both orders and give the same bits run to run.
    Needs an NVIDIA card and nvcc."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no host mode")
    d, kw = _random_inputs(seed=3, s_blk=4)
    dev = mtt.lanes_state_from_numpy(d)
    nfd, m_p = d["gt"].shape[1:]
    assert tk.ipm_design("ipm_eval_step_gram", nfd, m_p,
                         tk.gram_row_block(nfd), kw["nb_p"]) == "cluster"
    assert tk.ipm_design("ipm_solve_fused", nfd, m_p, kw["blk"],
                         kw["nb_p"]) == "cluster"
    for kernel in NEW_KERNELS:
        blk = (tk.gram_row_block(nfd) if kernel == "ipm_eval_step_gram"
               else kw["blk"])
        assert tk.smem_bytes(tk.CLUSTER_KERNELS[kernel], nfd, m_p, blk,
                             kw["nb_p"], design="cluster") == \
            tk.cluster_smem_bytes(kernel, nfd, m_p, blk, kw["nb_p"])
    ev_args = [dev[i] for i in (0, 1, 2, 6, 7, 8)]
    for phr in (False, True):
        ekw = dict(nb_p=128, n_ball=17, phr=phr, w_cap=1e6, band_block=0)
        ours = tk.ipm_eval_step(*ev_args, **ekw)
        again = tk.ipm_eval_step(*ev_args, **ekw)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(ours, again))
        for plain in (tk.ipm_eval_step_plain, tk.ipm_eval_step_cluster_plain):
            _close(ours, [to_np(o) for o in plain(*ev_args, **ekw)],
                   GRAM_OUT)
    skw = dict(kw, n_iters=2, snap_iters=1)
    sargs = [dev[i] for i in (0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 18, 19)]
    sargs[9] = tk.gt_matvec_plain(dev[0], dev[6]) + dev[1]     # y0 = G x0 + b
    ours = tk.ipm_solve_fused(*sargs, **skw)
    again = tk.ipm_solve_fused(*sargs, **skw)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(ours, again))
    for plain in (tk.ipm_solve_fused_plain, tk.ipm_solve_fused_cluster_plain):
        _close(ours, [to_np(o) for o in plain(*sargs, **skw)], FUSED_OUT,
               tol=10 * TOL)


@pytest.mark.gpu
def test_gram_and_solve_stream_design_on_the_card():
    """At K=12's layout #10 and #11 keep their one-block bodies and agree
    with their plain versions.  Needs an NVIDIA card and nvcc."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no host mode")
    nfd, m_p, blk, nb_p, n_ball = SHAPES["K=12"]
    d, kw = _random_inputs(seed=13, nfd=nfd, nb_p=nb_p, nh_p=m_p - 3 * nb_p,
                           n_ball=n_ball, blk=blk)
    dev = mtt.lanes_state_from_numpy(d)
    assert tk.ipm_design("ipm_eval_step_gram", nfd, m_p,
                         tk.gram_row_block(nfd), nb_p) == "stream"
    assert tk.ipm_design("ipm_solve_fused", nfd, m_p, blk, nb_p) == "stream"
    ev_args = [dev[i] for i in (0, 1, 2, 6, 7, 8)]
    ekw = dict(nb_p=nb_p, n_ball=n_ball, w_cap=1e6, band_block=0)
    _close(tk.ipm_eval_step(*ev_args, **ekw),
           [to_np(o) for o in tk.ipm_eval_step_plain(*ev_args, **ekw)],
           GRAM_OUT)
    skw = dict(kw, n_iters=2, snap_iters=1)
    sargs = [dev[i] for i in (0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 18, 19)]
    sargs[9] = tk.gt_matvec_plain(dev[0], dev[6]) + dev[1]     # y0 = G x0 + b
    _close(tk.ipm_solve_fused(*sargs, **skw),
           [to_np(o) for o in tk.ipm_solve_fused_plain(*sargs, **skw)],
           FUSED_OUT, tol=10 * TOL)
