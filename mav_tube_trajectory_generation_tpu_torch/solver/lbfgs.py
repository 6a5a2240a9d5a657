"""Batched L-BFGS with a strong-Wolfe zoom or an Armijo backtracking line
search, for the nonlinear optimizer (``solver.nonlinear``).

The JAX package runs optax 0.2.6 per scenario under ``vmap``:
``optax.lbfgs()`` (``scale_by_lbfgs(memory_size=10,
scale_init_precond=True)``, ``scale(-1)``, ``scale_by_zoom_linesearch(
max_linesearch_steps=20, initial_guess_strategy='one')``), or
``scale_by_lbfgs``, ``scale(-1)``, ``scale_by_backtracking_linesearch(
max_backtracking_steps=12, store_grad=True)``, each stepped with
``value_and_grad_from_state`` and ``apply_updates`` in a fixed-length scan.
This module carries that arithmetic over to a batch of scenarios, each a row
of a (B, n) tensor: every row keeps its own memory, step sizes and line
search state, and a row whose line search has ended keeps its state while
the others probe (each probe evaluates the whole batch once and the rows
that are still searching take the result).  A row's iterates are the ones
optax computes for that scenario alone.

``fn`` maps x (B, n) to values (B,), each row depending on its own row of
x only; gradients come from ``torch.autograd.grad``.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import torch

Fn = Callable[[torch.Tensor], torch.Tensor]

MEMORY = 10
# scale_by_zoom_linesearch (optax defaults but the step count)
ZOOM_STEPS = 20
SLOPE_RTOL = 1e-4
CURV_RTOL = 0.9
APPROX_DEC_RTOL = 1e-6
INTERVAL_THRESHOLD = 1e-5
ZOOM_INCREASE = 2.0
# scale_by_backtracking_linesearch
BACKTRACKING_STEPS = 12
DECREASE_FACTOR = 0.8
BACKTRACKING_INCREASE = 1.5
MAX_LEARNING_RATE = 1.0

LINESEARCHES = ("zoom", "backtracking", "hybrid")


def value_and_grad(fn: Fn, x: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(fn(x), d fn / d x) row by row."""
    with torch.enable_grad():
        xg = x.detach().requires_grad_(True)
        v = fn(xg)
        g, = torch.autograd.grad(v.sum(), xg)
    return v.detach(), g


def _value(fn: Fn, x: torch.Tensor) -> torch.Tensor:
    with torch.no_grad():
        return fn(x)


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a * b).sum(dim=-1)


class _Memory:
    """scale_by_lbfgs's state and its update: the last MEMORY differences of
    iterates and gradients, their weights, and the two-loop product."""

    def __init__(self, x: torch.Tensor):
        self.count = 0
        self.s = torch.zeros((MEMORY,) + x.shape, dtype=x.dtype,
                             device=x.device)
        self.y = torch.zeros_like(self.s)
        self.rho = torch.zeros((MEMORY,) + x.shape[:1], dtype=x.dtype,
                               device=x.device)
        self.x_prev = torch.zeros_like(x)
        self.g_prev = torch.zeros_like(x)

    def direction(self, x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
        """The descent direction -P_k g at iterate x with gradient g; the
        memory takes (x - x_prev, g - g_prev) first."""
        m = MEMORY
        idx = self.count % m
        prev = (self.count - 1) % m
        zero = torch.zeros((), dtype=x.dtype, device=x.device)
        if self.count > 0:
            ds = x - self.x_prev
            dy = g - self.g_prev
            vd = _dot(dy, ds)
            w = torch.where(vd == 0.0, zero, 1.0 / vd)
        else:
            ds = torch.zeros_like(x)
            dy = torch.zeros_like(x)
            w = torch.zeros_like(x[:, 0])
        self.s[prev] = ds
        self.y[prev] = dy
        self.rho[prev] = w
        if self.count > 0:
            den = _dot(dy, dy)
            gamma = torch.where(den > 0.0, _dot(dy, ds) / den,
                                torch.ones_like(den))
        else:
            # a capped reciprocal of the gradient norm for the first step
            gamma = torch.clamp(1.0 / torch.linalg.vector_norm(g, dim=-1),
                                max=1.0)
        order = [(idx + i) % m for i in range(m)]
        q = g
        alphas = {}
        for i in reversed(order):
            a = self.rho[i] * _dot(self.s[i], q)
            q = q + (-a)[:, None] * self.y[i]
            alphas[i] = a
        r = gamma[:, None] * q
        for i in order:
            b = self.rho[i] * _dot(self.y[i], r)
            r = r + (alphas[i] - b)[:, None] * self.s[i]
        self.count += 1
        self.x_prev = x
        self.g_prev = g
        return -r


class _Step(NamedTuple):
    """A line search's result per row: the step size taken and the value
    and gradient it leaves for the next iteration."""
    stepsize: torch.Tensor
    value: torch.Tensor
    grad: torch.Tensor


def _where(mask: torch.Tensor, a: torch.Tensor, b: torch.Tensor
           ) -> torch.Tensor:
    """Row-wise select: mask (B,) against (B,) or (B, n) tensors."""
    if a.dim() > mask.dim():
        mask = mask[:, None]
    return torch.where(mask, a, b)


def _nan_to_inf(e: torch.Tensor) -> torch.Tensor:
    return torch.where(torch.isnan(e), torch.full_like(e, float("inf")), e)


def _cubicmin(a, fa, fpa, b, fb, c, fc):
    """Critical point of the cubic through (a, fa), (b, fb), (c, fc) with
    slope fpa at a (NaN when there is none)."""
    cc = fpa
    db = b - a
    dc = c - a
    denom = (db * dc) ** 2 * (db - dc)
    r0 = fb - fa - cc * db
    r1 = fc - fa - cc * dc
    aa = (dc ** 2 * r0 + (-(db ** 2)) * r1) / denom
    bb = ((-(dc ** 3)) * r0 + db ** 3 * r1) / denom
    radical = bb * bb - 3.0 * aa * cc
    return a + (-bb + torch.sqrt(radical)) / (3.0 * aa)


def _quadmin(a, fa, fpa, b, fb):
    """Critical point of the quadratic through (a, fa), (b, fb) with slope
    fpa at a."""
    db = b - a
    bb = (fb - fa - fpa * db) / (db ** 2)
    return a - fpa / (2.0 * bb)


def _zoom(fn: Fn, x: torch.Tensor, u: torch.Tensor, value: torch.Tensor,
          grad: torch.Tensor) -> _Step:
    """zoom_linesearch (Nocedal and Wright, algorithms 3.5 and 3.6, with
    Hager and Zhang's approximate decrease) along u from x, row by row."""
    inf = torch.full_like(value, float("inf"))
    zero = torch.zeros_like(value)
    false = torch.zeros_like(value, dtype=torch.bool)
    slope0 = _dot(u, grad)
    v_init, s_init = value, slope0
    step, val, g, slope = zero, value, grad, slope0
    dec_err, curv_err = inf, inf
    interval_found, done, failed = false, false, false
    low, v_low, s_low = zero, value, slope0
    high, v_high, s_high = zero, value, slope0
    cref, v_cref = zero, value
    safe_step, safe_val, safe_g = zero, value, grad

    def decrease_error(t, v_t, s_t):
        e = v_t - v_init - SLOPE_RTOL * t * s_init
        approx = s_t - (2 * SLOPE_RTOL - 1.0) * s_init
        delta = v_t - v_init - APPROX_DEC_RTOL * torch.abs(v_init)
        e = torch.minimum(torch.maximum(approx, delta), e)
        return _nan_to_inf(torch.clamp(e, min=0.0))

    def curvature_error(s_t):
        e = torch.abs(s_t) - CURV_RTOL * torch.abs(s_init)
        return _nan_to_inf(torch.clamp(e, min=0.0))

    for k in range(ZOOM_STEPS):
        active = ~(done | failed)
        if not bool(active.any()):
            break
        # the zoom's trial point (rows whose interval is found)
        delta = torch.abs(high - low)
        left = torch.minimum(high, low)
        right = torch.maximum(high, low)
        mid_c = _cubicmin(low, v_low, s_low, high, v_high, cref, v_cref)
        use_c = (mid_c > left + 0.2 * delta) & (mid_c < right - 0.2 * delta)
        mid_q = _quadmin(low, v_low, s_low, high, v_high)
        use_q = ~use_c & ((mid_q > left + 0.1 * delta)
                          & (mid_q < right - 0.1 * delta))
        use_b = ~use_c & ~use_q
        middle = torch.where(use_c, mid_c, cref)
        middle = torch.where(use_q, mid_q, middle)
        middle = torch.where(use_b, (low + high) / 2.0, middle)
        # the interval search's trial point (the others)
        grow = torch.ones_like(step) if k == 0 else ZOOM_INCREASE * step
        t_new = torch.where(interval_found, middle, grow)

        v_t, g_t = value_and_grad(fn, x + t_new[:, None] * u)
        s_t = _dot(g_t, u)
        d_e = decrease_error(t_new, v_t, s_t)
        c_e = curvature_error(s_t)
        err = torch.maximum(d_e, c_e)
        ok_dec = d_e <= 0.0
        last = k + 1 >= ZOOM_STEPS

        # interval search (algorithm 3.5)
        up_a = ok_dec
        hi_new = (d_e > 0.0) | ((v_t >= val) & (k > 0))
        lo_new = (s_t >= 0.0) & ~hi_new
        low_a = torch.where(lo_new, t_new, step)
        vlow_a = torch.where(lo_new, v_t, val)
        slow_a = torch.where(lo_new, s_t, slope)
        high_a = torch.where(lo_new, step, t_new)
        vhigh_a = torch.where(lo_new, val, v_t)
        shigh_a = torch.where(lo_new, slope, s_t)
        found_a = hi_new | lo_new | (err <= 0.0)
        done_a = err <= 0.0

        # zoom (algorithm 3.6)
        up_b = ok_dec & (v_t < safe_val)
        done_b = err <= 0.0
        hi_mid = (d_e > 0.0) | (v_t >= v_low)
        hi_low = (s_t * (high - low) >= 0.0) & ~hi_mid
        lo_mid = ~hi_mid
        high_b = torch.where(hi_low, low, torch.where(hi_mid, t_new, high))
        vhigh_b = torch.where(hi_low, v_low,
                              torch.where(hi_mid, v_t, v_high))
        shigh_b = torch.where(hi_low, s_low,
                              torch.where(hi_mid, s_t, s_high))
        low_b = torch.where(lo_mid, t_new, low)
        vlow_b = torch.where(lo_mid, v_t, v_low)
        slow_b = torch.where(lo_mid, s_t, s_low)
        moved = hi_mid | hi_low
        cref_b = torch.where(moved, high, low)
        vcref_b = torch.where(moved, v_high, v_low)

        zm = interval_found
        up = torch.where(zm, up_b, up_a)
        n_safe_step = torch.where(up, t_new, safe_step)
        n_safe_val = torch.where(up, v_t, safe_val)
        n_safe_g = _where(up, g_t, safe_g)
        n_done = torch.where(zm, done_b, done_a)
        small = delta <= INTERVAL_THRESHOLD
        n_failed = torch.where(
            zm, last | (small & (n_safe_step > 0.0)),
            torch.full_like(zm, last)) & ~n_done
        n_low = torch.where(zm, low_b, low_a)
        n_vlow = torch.where(zm, vlow_b, vlow_a)
        n_slow = torch.where(zm, slow_b, slow_a)
        n_high = torch.where(zm, high_b, high_a)
        n_vhigh = torch.where(zm, vhigh_b, vhigh_a)
        n_shigh = torch.where(zm, shigh_b, shigh_a)
        n_cref = torch.where(zm, cref_b, low_a)
        n_vcref = torch.where(zm, vcref_b, vlow_a)
        n_found = torch.where(zm, interval_found, found_a)
        n_step, n_val, n_g = t_new, v_t, g_t
        # a failed search takes the safe step (one with sufficient
        # decrease), or none when even the trial left the domain
        take_safe = n_failed & ((n_safe_step > 0.0) | torch.isinf(d_e))
        n_step = torch.where(take_safe, n_safe_step, n_step)
        n_val = torch.where(take_safe, n_safe_val, n_val)
        n_g = _where(take_safe, n_safe_g, n_g)

        a = active
        step = torch.where(a, n_step, step)
        val = torch.where(a, n_val, val)
        g = _where(a, n_g, g)
        slope = torch.where(a, s_t, slope)
        dec_err = torch.where(a, d_e, dec_err)
        curv_err = torch.where(a, c_e, curv_err)
        interval_found = torch.where(a, n_found, interval_found)
        done = torch.where(a, n_done, done)
        failed = torch.where(a, n_failed, failed)
        low = torch.where(a, n_low, low)
        v_low = torch.where(a, n_vlow, v_low)
        s_low = torch.where(a, n_slow, s_low)
        high = torch.where(a, n_high, high)
        v_high = torch.where(a, n_vhigh, v_high)
        s_high = torch.where(a, n_shigh, s_high)
        cref = torch.where(a, n_cref, cref)
        v_cref = torch.where(a, n_vcref, v_cref)
        safe_step = torch.where(a, n_safe_step, safe_step)
        safe_val = torch.where(a, n_safe_val, safe_val)
        safe_g = _where(a, n_safe_g, safe_g)
    return _Step(step, val, g)


def _backtracking(fn: Fn, x: torch.Tensor, u: torch.Tensor,
                  value: torch.Tensor, grad: torch.Tensor,
                  lr_prev: torch.Tensor) -> _Step:
    """scale_by_backtracking_linesearch with store_grad: value-only probes
    from min(1.5 lr_prev, 1) down by 0.8 until the Armijo condition holds
    (at most 13 probes), then one gradient at the point taken.  A row whose
    last probe left the domain (an infinite decrease error) takes step 0."""
    slope = _dot(u, grad)
    lr = torch.clamp(BACKTRACKING_INCREASE * lr_prev, max=MAX_LEARNING_RATE)
    new_value = value
    dec_err = torch.full_like(value, float("inf"))
    for k in range(BACKTRACKING_STEPS + 1):
        active = dec_err > 0.0
        if not bool(active.any()):
            break
        lr_t = DECREASE_FACTOR * lr if k > 0 else lr
        v_t = _value(fn, x + lr_t[:, None] * u)
        e = _nan_to_inf(v_t - value - lr_t * SLOPE_RTOL * slope)
        e = torch.clamp(e, min=0.0)
        lr = torch.where(active, lr_t, lr)
        new_value = torch.where(active, v_t, new_value)
        dec_err = torch.where(active, e, dec_err)
    _, new_grad = value_and_grad(fn, x + lr[:, None] * u)
    lr = torch.where(torch.isinf(dec_err), torch.zeros_like(lr), lr)
    return _Step(lr, new_value, new_grad)


def _run(fn: Fn, x: torch.Tensor, n_iters: int,
         project: Optional[Callable[[torch.Tensor], torch.Tensor]],
         linesearch: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """One optimizer's fixed-length run from x; the value at the start of
    each iteration, (B, n_iters)."""
    memory = _Memory(x)
    # the line search's stored value (inf: evaluate afresh) and gradient
    value = torch.full(x.shape[:1], float("inf"), dtype=x.dtype,
                       device=x.device)
    grad = torch.zeros_like(x)
    lr = torch.ones_like(value)
    history = []
    for _ in range(n_iters):
        fresh = torch.isinf(value) | torch.isnan(value)
        if bool(fresh.any()):
            v, g = value_and_grad(fn, x)
            value = torch.where(fresh, v, value)
            grad = _where(fresh, g, grad)
        history.append(value)
        u = memory.direction(x, grad)
        if linesearch == "zoom":
            res = _zoom(fn, x, u, value, grad)
        else:
            res = _backtracking(fn, x, u, value, grad, lr)
        lr = res.stepsize
        x = x + res.stepsize[:, None] * u
        if project is not None:
            x = project(x)
        value, grad = res.value, res.grad
    if not history:
        return x, torch.zeros(x.shape[:1] + (0,), dtype=x.dtype,
                              device=x.device)
    return x, torch.stack(history, dim=-1)


def lbfgs_minimize(fn: Fn, x0: torch.Tensor, n_iters: int,
                   project: Optional[Callable[[torch.Tensor],
                                              torch.Tensor]] = None,
                   linesearch: str = "zoom", hybrid_zoom_iters: int = 4
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fixed-iteration L-BFGS over the rows of x0 (B, n).

    ``project`` maps an iterate back onto a feasible box after every update
    (projected L-BFGS: x0 is projected first, and the value and gradient
    the line search leaves are those of the point before projection, as in
    the JAX package).  ``linesearch``: "zoom", "backtracking", or "hybrid"
    (backtracking for all but ``hybrid_zoom_iters`` iterations, then zoom
    with fresh memory).  Returns (x (B, n), values (B, n_iters)): the value
    at the start of each iteration.
    """
    if linesearch not in LINESEARCHES:
        raise ValueError(f"linesearch must be one of {LINESEARCHES}, got "
                         f"{linesearch!r}")
    x0 = x0 if project is None else project(x0)
    if linesearch == "hybrid":
        n_zoom = min(hybrid_zoom_iters, n_iters)
        n_bt = n_iters - n_zoom
        if n_bt == 0:
            return _run(fn, x0, n_iters, project, "zoom")
        x_mid, v_bt = _run(fn, x0, n_bt, project, "backtracking")
        x_fin, v_zoom = _run(fn, x_mid, n_zoom, project, "zoom")
        return x_fin, torch.cat([v_bt, v_zoom], dim=-1)
    return _run(fn, x0, n_iters, project, linesearch)
