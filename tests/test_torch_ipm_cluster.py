"""The cluster design of the interior-point kernels ``ipm_eval_step`` (band
output) and ``ipm_pipe_step``: what of it the host can compute.

* The lane split: the two blocks of a scenario's cluster split the lanes by
  ball index; every lane lies in exactly one block, a ball's three planes
  and its Jacobian row in one block, and each block sums its lanes in its
  local order.
* The shared-memory budget (``cluster_layout``, the same function as
  ``make_cluster_layout`` in ``csrc/ipm_cluster.cuh``): the flagship shape
  and K=4 fit an H100 block, K=12 does not and keeps the one-block body.
* The plain versions that sum the band in the design's order
  (``ipm_eval_step_cluster_plain``, ``ipm_pipe_step_cluster_plain``) against
  the JAX package's Pallas kernels in interpret mode, at the tolerance of
  ``tests/test_torch_ipm_kernel.py`` (``TOL`` = 2e-5 of each output's scale:
  the same float32 formulas summed in another order), and against the
  reference order in float64, where the two orders agree to rounding
  (1e-12 of scale): a lane summed twice or left out would not.

The kernels themselves run only on the card: the ``gpu`` tests.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from mav_tube_trajectory_generation_tpu.ops import ipm_kernel as jk
import mav_tube_trajectory_generation_tpu_torch as mtt
from mav_tube_trajectory_generation_tpu_torch.ops import ipm_kernel as tk

from test_torch_ipm_kernel import (EVAL_OUT, MODE_PAIRS, PIPE_OUT, _close,
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
