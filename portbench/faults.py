"""Controls and planted faults of the correctness check.

Each is a context manager that puts something in the timed path's place
for as long as it is open, so that a run through ``core.run_cell`` shows
whether the check catches it.  ``calibrate.py`` reads them on the card at
the cells' own sizes; ``tests/test_portbench_faults.py`` drives them on the
host.

Controls (a lower precision than the configuration states):
  * ``reference_tf32`` (ADMM): the plain reference in float32 with TF32
    matrix products, in the program's place;
  * ``reference_f32`` (ADMM, a witness, not a control): the plain reference
    in float32 with TF32 off -- float32's own distance from float64;
  * ``program_tf32`` (either): the program with TF32 matrix products on;
  * ``no_f64_tier`` (strict): the router with its float64 tier switched off.

Faults (planted in the program):
  * ``stage_unchanged``: kernel #1 hands back the iterate it was given;
  * ``slice_radii_halved``: kernel #1 is given the ball radii halved for
    every sixteenth row (a wrong assembly block for a slice of the
    scenarios, whose answers stay consistent with themselves);
  * ``half_batch``: only the first half of a batch is solved, and its
    answers stand in for the second half's;
  * ``answer_altered``: the first row's answer is the second row's.
"""

from __future__ import annotations

import contextlib
import functools
import importlib
from types import SimpleNamespace

import numpy as np
import torch

from portbench.reference import tube_qcqp as ref

PACKAGE = "mav_tube_trajectory_generation_tpu_torch"


@contextlib.contextmanager
def _patched(mod_name: str, attr: str, make):
    mod = importlib.import_module(f"{PACKAGE}.{mod_name}")
    orig = getattr(mod, attr)
    setattr(mod, attr, make(orig))
    try:
        yield
    finally:
        setattr(mod, attr, orig)


@contextlib.contextmanager
def _tf32(on: bool):
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def _reference_in_place(rcfg, block: int):
    """A stand-in for ``solve_qcqp_batch``: the plain reference in the
    inputs' dtype (float32)."""
    def solve(structure, d_fixed, times, waypoints, radii, config=None,
              warmstart_values=None, device=None, **kw):
        outs = [ref.admm(waypoints[i:i + block], times[i:i + block],
                         radii[i:i + block], d_fixed[i:i + block], rcfg)
                for i in range(0, times.shape[0], block)]
        cat = {k: torch.cat([o[k] for o in outs]) for k in outs[0]}
        return SimpleNamespace(coefficients=cat["coefficients"],
                               d_free=cat["d_free"], cost=cat["cost"],
                               max_violation=cat["violation"])
    return solve


def _rows(a, idx):
    if a is None:
        return None
    if isinstance(a, np.ndarray):
        return a[idx.cpu().numpy()]
    if isinstance(a, torch.Tensor):
        return a[idx.to(a.device)]
    if hasattr(a, "_fields"):
        return type(a)(*(_rows(f, idx) for f in a))
    return a


def _half(orig):
    """Solve the first half of the batch; its answers stand for the rest."""
    def solve(structure, d_fixed, times, waypoints, radii, **kw):
        bsz = times.shape[0]
        h = (bsz + 1) // 2
        kw = dict(kw)
        if kw.get("warmstart_values") is not None:
            kw["warmstart_values"] = kw["warmstart_values"][:h]
        out = orig(structure, d_fixed[:h], times[:h], waypoints[:h],
                   radii[:h], **kw)
        idx = torch.arange(bsz) % h
        return _rows(out, idx)
    return solve


def _altered(orig):
    """The first row's answer is the second row's."""
    def solve(*args, **kw):
        out = orig(*args, **kw)
        sol = getattr(out, "solution", out)
        for name in ("coefficients", "d_free"):
            t = getattr(sol, name)
            t[0] = t[1]
        return out
    return solve


def _unchanged(orig):
    def stage(*args, **kw):
        out = orig(*args, **kw)
        x0 = args[8] if len(args) > 8 else kw["x0"]
        return (x0.clone(),) + tuple(out[1:])
    return stage


def _slice_radii_halved(orig):
    def stage(*args, **kw):
        args = list(args)
        rb = args[6].clone()                               # (B, ..) ball radii
        rb[::16] *= 0.5
        args[6] = rb
        return orig(*args, **kw)
    return stage


@contextlib.contextmanager
def planted(name: str, cell):
    """Open the control or fault ``name`` for ``cell`` (driven by
    "solve_qcqp_batch" or "solve_qcqp_strict")."""
    entry = ("solver.qcqp", "solve_qcqp_batch") \
        if cell.config["driver"] == "solve_qcqp_batch" else \
        ("solver.auto", "solve_qcqp_strict")
    if name == "none":
        yield
    elif name in ("reference_tf32", "reference_f32"):
        from portbench.drivers.solve_qcqp_batch import (REFERENCE_BLOCK,
                                                        reference_config)
        with _tf32(name == "reference_tf32"), \
                _patched(*entry, lambda orig: _reference_in_place(
                    reference_config(cell.config), REFERENCE_BLOCK)):
            yield
    elif name == "program_tf32":
        with _tf32(True):
            yield
    elif name == "no_f64_tier":
        with _patched(*entry, lambda orig: functools.partial(
                orig, tier2_f64=False)):
            yield
    elif name in ("stage_unchanged", "slice_radii_halved"):
        with _patched("ops.admm_kernel", "admm_stage_fused_factored",
                      _unchanged if name == "stage_unchanged"
                      else _slice_radii_halved):
            yield
    elif name == "half_batch":
        with _patched(*entry, _half):
            yield
    elif name == "answer_altered":
        with _patched(*entry, _altered):
            yield
    else:
        raise ValueError(f"unknown control or fault {name!r}")
