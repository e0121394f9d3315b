"""Optimizers: on-chip Adam schedule automaton + pure-XLA L-BFGS.

Adam
----
The reference drives Adam from a Python loop that re-enters the device every
step and hops to the host for resampling (pyDOE) and density smoothing
(scipy) (software.py:396-460).  Here the *entire* Adam phase — step,
periodic resampling, adaptive-density refresh, plateau-detect LR halving and
the "tail" loop that forces the final loss below the recent minimum — is a
single jit-compiled ``lax.scan`` + ``lax.while_loop`` state machine.  The
schedule semantics match the reference:

- resample all points every ``resample_every`` (100) steps (software.py:416-422),
- refresh the adaptive density every ``density_every`` (2000) steps (:427-428),
- every ``plateau_every`` (4000) steps compare the mean of the last-2000
  window against the prior-2000 window and halve the LR when
  ``|Δmean|/std < 0.4`` (:430-441) — the LR lives inside the optimizer state
  via ``optax.inject_hyperparams``, and (matching a reference quirk, SURVEY
  §2b.7) the moment estimates are *not* reset on LR changes,
- after the main loop keep stepping (≤ ``tail_max`` = 4000) until the last
  loss beats the minimum of the final ``epochs/5`` window (:443-456).

L-BFGS
------
The reference calls tensorflow-probability's ``lbfgs_minimize``
(software.py:499-514).  Here L-BFGS is implemented natively in XLA: fixed
``memory``-slot two-loop recursion with circular history buffers and a
strong-Wolfe line search (bracket + zoom, Nocedal & Wright alg. 3.5/3.6)
inside ``lax.while_loop`` — no host round-trips, runs under jit on any
backend, and is differentiable-shape-free (all buffers static).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Callable, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import optax
import jax.flatten_util

Array = jax.Array


# ===========================================================================
# Adam phase
# ===========================================================================


@dataclass(frozen=True)
class AdamConfig:
    epochs: int
    lr: float = 1e-3
    resample_every: int = 100
    density_every: int = 2000
    plateau_every: int = 4000
    plateau_ratio: float = 0.4
    # Floor for the plateau-halving schedule (0.0 = reference behavior,
    # software.py:430-441, which halves without bound).  Long budgets
    # otherwise decay lr into oblivion: a 204k-step helmholtz run reached
    # lr 1.9e-9 — frozen for its last ~100k steps (runs hP/hR).
    lr_min: float = 0.0
    tail_max: int = 4000
    log_every: int = 100
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    # Upper bound on scan steps per device dispatch.  The phase CALIBRATES
    # the actual per-step cost on its first two (short) dispatches and
    # sizes the rest to a ~25s target; max_chunk stays the hard cap.
    # Bounded dispatches keep the host responsive between chunks (log
    # lines, mid-stage checkpoints).  Whether the sizing earns its
    # recompiles on the H100 is not yet measured.
    max_chunk: int = 2000
    # Parameter layout inside the scanned automaton.  "flat" runs the
    # whole phase on ONE raveled vector (loss unravels it on entry):
    # Adam is elementwise, so the math is identical to the per-leaf
    # layout — trajectories agree to float32 ulps (asserted in
    # tests/test_optim.py; the residual ~1 ulp/step is XLA fusing the
    # unravel-reshaped graph with different reduction rounding), but the
    # ~14-leaf pytree's per-step update chain (m/v/update/apply per leaf)
    # collapses into a handful of full-vector ops — at small-net shapes
    # the scanned step is op-count-bound, not FLOP-bound, so this trims
    # real step time.  "tree" is the pre-round-4 layout (kept for A/B
    # timing and for resuming mid-Adam checkpoints saved before the flip).
    layout: str = "flat"

    def __post_init__(self):
        if self.layout not in ("flat", "tree"):
            raise ValueError(f"layout must be 'flat'|'tree', "
                             f"got {self.layout!r}")


class AdamPhaseResult(NamedTuple):
    params: dict
    history: Array          # [epochs + tail_max, k] loss_info rows
    n_valid: Array          # scalar int: epochs + tail steps actually taken
    density: Array          # final adaptive density F
    data: dict              # final point set
    key: Array              # advanced RNG key
    lr: Array               # final learning rate


def make_adam_phase(
    loss_fn: Callable,
    sample_fn: Callable,
    density_fn: Optional[Callable],
    config: AdamConfig,
    info_width: int,
    log_fn: Optional[Callable] = None,
):
    """Build the Adam phase: jitted scan chunks + jitted tail while_loop.

    :param loss_fn: ``(params, data, lw, ref) -> (loss_n, loss_info)``.
    :param sample_fn: ``(key, F) -> data`` (jittable, static shapes).
    :param density_fn: ``params -> F`` adaptive-density refresh (predictF
        equivalent), or None to keep the density fixed.
    :param log_fn: optional host logger ``(step, loss_info_row)``.  Without
        it the whole epoch loop is ONE device computation; with it the loop
        runs in chunks of ``10*log_every`` steps and the per-100-step lines
        (the reference's stderr format, software.py:416-419) are replayed
        from each chunk's history on the host — no in-graph callbacks.
    :returns: ``phase(key, params, data, F, lw, ref)`` -> AdamPhaseResult.

    With ``config.layout == "flat"`` the scan carries the params as one
    raveled vector (see AdamConfig.layout); callers still pass and receive
    pytrees — the conversion happens in ``make_state0`` / on return, so
    mid-stage checkpoints written by either layout only load back under
    the same layout (a mismatch raises in ``load_phase_state`` and the
    caller's existing except-path restarts the phase).
    """

    opt = optax.inject_hyperparams(optax.adam)(
        learning_rate=config.lr, b1=config.b1, b2=config.b2, eps=config.eps
    )
    use_flat = config.layout == "flat"
    if use_flat:
        # the unravel closure is bound at make_state0 time (the factory
        # never sees a params template); one factory serves one stage, but
        # guard against structure swaps between calls anyway
        _flat = {"unravel": None, "treedef": None}
        raw_loss, raw_density = loss_fn, density_fn

        def loss_fn(vec, data, lw, ref):  # noqa: F811
            return raw_loss(_flat["unravel"](vec), data, lw, ref)

        if density_fn is not None:
            def density_fn(vec):  # noqa: F811
                return raw_density(_flat["unravel"](vec))

        def _bind_flat(params):
            td = jax.tree_util.tree_structure(params)
            if _flat["treedef"] is not None and td != _flat["treedef"]:
                raise ValueError(
                    "make_adam_phase(layout='flat'): one phase factory "
                    "serves one params structure; build a new factory for "
                    f"{td} (bound: {_flat['treedef']})"
                )
            flat, unravel = jax.flatten_util.ravel_pytree(params)
            _flat["unravel"], _flat["treedef"] = unravel, td
            return flat

    grad_fn = jax.grad(loss_fn, has_aux=True)
    ring_n = max(1, config.plateau_every)
    half = config.plateau_every // 2  # reference: nc0-sized windows (:431-433)
    tail_window = max(1, int(round(config.epochs / 5)))

    def step_update(params, opt_state, data, lw, ref):
        grads, loss_info = grad_fn(params, data, lw, ref)
        updates, opt_state = opt.update(grads, opt_state)
        params = optax.apply_updates(params, updates)
        return params, opt_state, loss_info

    def body_for(lw, ref):
        def body(carry, step):
            params, opt_state, data, F, key, ring = carry
            params, opt_state, loss_info = step_update(
                params, opt_state, data, lw, ref
            )
            ring = ring.at[step % ring_n].set(loss_info[0])

            # resample every `resample_every` steps (after the update, as in
            # the reference loop ordering); sample_fn=None drops the whole
            # block from the graph (fixed point set / compile bisection)
            if sample_fn is not None:
                def do_resample(op):
                    key, data = op
                    key, sub = jax.random.split(key)
                    return key, sample_fn(sub, F)

                key, data = jax.lax.cond(
                    (step % config.resample_every == 0) & (step > 0),
                    do_resample,
                    lambda op: op,
                    (key, data),
                )

            # adaptive-density refresh every `density_every` steps
            if density_fn is not None:
                F = jax.lax.cond(
                    (step + 1) % config.density_every == 0,
                    lambda p: density_fn(p),
                    lambda p: F,
                    params,
                )

            # plateau-detect LR halving every `plateau_every` steps
            # (plateau_every=0 drops the block from the graph)
            def maybe_halve(opt_state):
                lc1 = jax.lax.dynamic_slice(ring, (0,), (half,))
                lc2 = jax.lax.dynamic_slice(ring, (half,), (ring_n - half,))
                mm12 = jnp.abs(jnp.mean(lc1) - jnp.mean(lc2))
                stdl2 = jnp.std(lc2)
                lr = opt_state.hyperparams["learning_rate"]
                new_lr = jnp.where(
                    mm12 / stdl2 < config.plateau_ratio, lr * 0.5, lr
                )
                new_lr = jnp.maximum(new_lr, config.lr_min)
                hp = dict(opt_state.hyperparams)
                hp["learning_rate"] = new_lr
                return opt_state._replace(hyperparams=hp)

            if config.plateau_every > 0:
                opt_state = jax.lax.cond(
                    (step + 1) % config.plateau_every == 0,
                    maybe_halve,
                    lambda s: s,
                    opt_state,
                )

            return (params, opt_state, data, F, key, ring), loss_info

        return body

    # the carry is donated across chunk dispatches: params/opt_state/data/F
    # alias in-place between chunks (lower peak device memory, no boundary
    # copies); phase() hands the first dispatch a private copy so callers
    # keep their buffers
    @partial(jax.jit, static_argnames=("n_steps",), donate_argnums=(0,))
    def run_chunk(state, lw, ref, start, n_steps: int):
        steps = start + jnp.arange(n_steps)
        return jax.lax.scan(body_for(lw, ref), state, steps)

    @partial(jax.jit, donate_argnums=(0, 6))
    def run_tail(state, lw, ref, lmin, llast, n_tail0, tail_buf, i_end):
        """One bounded dispatch of the tail loop (resumable: carries the
        tail buffer and step count so the host can chunk it under the
        runtime's dispatch deadline)."""
        params, opt_state, data, F, key, ring = state

        def tail_cond(s):
            params, opt_state, llast, i, tail_buf = s
            return (llast >= lmin) & (i < i_end)

        def tail_body(s):
            params, opt_state, llast, i, tail_buf = s
            params, opt_state, loss_info = step_update(
                params, opt_state, data, lw, ref
            )
            tail_buf = jax.lax.dynamic_update_slice(
                tail_buf, loss_info[None, :], (i, jnp.int32(0))
            )
            return params, opt_state, loss_info[0], i + 1, tail_buf

        params, opt_state, llast, n_tail, tail_buf = jax.lax.while_loop(
            tail_cond, tail_body,
            (params, opt_state, llast, n_tail0, tail_buf),
        )
        return ((params, opt_state, data, F, key, ring), tail_buf, n_tail,
                llast)

    def make_state0(key, params, data, F, ref):
        """The step-0 scan carry — also the template pytree for loading a
        mid-stage checkpoint (tpinn.utils.checkpoint.load_phase_state)."""
        f_dtype = jnp.asarray(0.0, dtype=jnp.result_type(ref)).dtype
        if use_flat:
            params = _bind_flat(params)
        return (params, opt.init(params), data, F, key,
                jnp.zeros((ring_n,), f_dtype))

    def phase(key, params, data, F, lw, ref,
              ckpt_cb=None, init=None) -> AdamPhaseResult:
        """Run the Adam phase.

        :param ckpt_cb: optional ``cb(done, state, hist_so_far)`` called
            after every dispatched chunk — the mid-stage checkpoint hook
            (state is the full scan carry incl. opt_state/data/F/key/ring).
        :param init: optional ``(done, state, hist)`` from a previous
            ``ckpt_cb`` to resume from; the scan continues at step ``done``
            with identical numerics (same carry, same chunk grid).
        """
        import numpy as _np

        state = jax.tree_util.tree_map(
            jnp.copy, make_state0(key, params, data, F, ref)
        )

        # chunked dispatches: bounded by max_chunk (see
        # AdamConfig.max_chunk) and by the log cadence
        base = config.epochs if log_fn is None else max(
            config.log_every * 10, 1
        )
        chunk = max(1, min(base, config.max_chunk))
        chunks = []
        done = 0
        if init is not None:
            done, state, hist0 = init
            state = jax.tree_util.tree_map(jnp.copy, state)
            done = int(done)
            # `done` need not sit on this run's chunk grid (the saver may
            # have used a different log cadence): the loop below simply
            # issues one catch-up dispatch of min(chunk, epochs-done)
            # steps, at worst one extra compile shape
            if done:
                chunks.append(jnp.asarray(hist0)[:done])
        # --- adaptive dispatch sizing.  max_chunk was tuned on the
        # flagship shape; a wide/Fourier net runs far longer per step.
        # Calibrate on two short dispatches (the second is compile-cached,
        # so its wall is pure run time) and size the remainder to a ~25s
        # target; sizes stay multiples of the calibration length to bound
        # recompiles.
        import time as _time

        target_s = 25.0
        cal = max(1, min(2 * config.log_every, chunk))
        n_disp = 0
        while done < config.epochs:
            calibrating = n_disp < 2 and chunk > cal
            n = min(cal if calibrating else chunk, config.epochs - done)
            t0 = _time.perf_counter()
            state, hist = run_chunk(state, lw, ref, jnp.int32(done), n)
            if calibrating:
                _np.asarray(hist[-1:])  # host fetch = sync
                dt = _time.perf_counter() - t0
                if n_disp == 1 and n == cal:
                    per_step = max(dt / n, 1e-7)
                    chunk = int(max(cal, min(
                        config.max_chunk,
                        target_s / per_step // cal * cal)))
            n_disp += 1
            if log_fn is not None:
                rows = _np.asarray(hist)
                for k in range(n):
                    step = done + k
                    if step > 0 and step % config.log_every == 0:
                        log_fn(step, rows[k])
            chunks.append(hist)
            done += n
            if ckpt_cb is not None:
                ckpt_cb(done, state, jnp.concatenate(chunks, axis=0))
        if not chunks:  # epochs == 0 (L-BFGS-only stage)
            chunks = [jnp.zeros((0, info_width), jnp.result_type(ref))]
        hist_scan = jnp.concatenate(chunks, axis=0) if len(chunks) > 1 \
            else chunks[0]

        params, opt_state, data, F, key, ring = state
        lr = opt_state.hyperparams["learning_rate"]

        if config.tail_max == 0 or hist_scan.shape[0] == 0:
            if use_flat:
                params = _flat["unravel"](params)
            return AdamPhaseResult(params, hist_scan, jnp.int32(config.epochs),
                                   F, data, key, lr)

        lmin = jnp.min(hist_scan[-tail_window:, 0])
        llast = hist_scan[-1, 0]
        tail_buf = jnp.zeros((config.tail_max, info_width),
                             jnp.result_type(lmin))
        n_tail = jnp.int32(0)
        tail_done = 0
        while tail_done < config.tail_max:
            i_end = jnp.int32(min(tail_done + chunk, config.tail_max))
            state, tail_buf, n_tail, llast = run_tail(
                state, lw, ref, lmin, llast, n_tail, tail_buf, i_end
            )
            tail_done = int(n_tail)
            if float(llast) < float(lmin) or tail_done < int(i_end):
                break  # tail condition met inside this chunk
        params, opt_state, data, F, key, ring = state
        lr = opt_state.hyperparams["learning_rate"]
        history = jnp.concatenate([hist_scan, tail_buf], axis=0)
        n_valid = jnp.int32(config.epochs) + n_tail
        if use_flat:
            params = _flat["unravel"](params)
        return AdamPhaseResult(params, history, n_valid, F, data, key, lr)

    phase.make_state0 = make_state0
    phase.run_chunk = run_chunk  # exposed for AOT compile probes/diagnostics
    return phase


# ===========================================================================
# Pure-XLA L-BFGS with strong-Wolfe line search
# ===========================================================================


@dataclass(frozen=True)
class LBFGSConfig:
    max_iters: int
    memory: int = 10
    tolerance: float = 1e-10       # sup-norm gradient tolerance (TFP default gate)
    c1: float = 1e-4               # Armijo (sufficient decrease)
    c2: float = 0.9                # curvature (strong Wolfe)
    max_linesearch: int = 20
    max_bracket: int = 10
    # Iterations per device dispatch (bounded dispatches, as
    # AdamConfig.max_chunk).  0 = unchunked.
    chunk_iters: int = 100
    # History cadence: "iters" records one loss_info row per ACCEPTED
    # iterate (compact; round-1/2 behavior).  "evals" records one row per
    # FUNCTION EVALUATION — line-search probes included — which is the
    # reference's cadence (it harvests rows via jax.debug.callback inside
    # the jitted value-and-grad, software.py:485-488), so UI loss curves
    # show the same number of points per L-BFGS phase.
    history: str = "iters"

    def __post_init__(self):
        if self.history not in ("iters", "evals"):
            raise ValueError(f"history must be 'iters'|'evals', got "
                             f"{self.history!r}")

    @property
    def history_rows(self) -> int:
        """Preallocated history buffer length (excludes nothing; row 0 is
        the initial loss)."""
        if self.history == "evals":
            return 1 + self.max_iters * (self.max_bracket
                                         + self.max_linesearch)
        return 1 + self.max_iters


class LBFGSResult(NamedTuple):
    x: Array
    f: Array
    g: Array
    history: Array      # [max_iters + 1, k] loss_info per accepted iterate
    n_iters: Array
    n_rows: Array       # accepted-iterate rows written to history (incl. row 0)
    converged: Array
    failed: Array


def _two_loop(g, S, Y, rho, count, head, gamma, memory):
    """Two-loop recursion with circular buffers (Nocedal & Wright alg 7.4)."""
    q = g
    alpha = jnp.zeros((memory,), g.dtype)

    def bwd(j, carry):
        q, alpha = carry
        pos = (head - 1 - j) % memory
        valid = j < count
        a = rho[pos] * jnp.dot(S[pos], q)
        a = jnp.where(valid, a, 0.0)
        q = q - a * Y[pos]
        alpha = alpha.at[pos].set(a)
        return q, alpha

    q, alpha = jax.lax.fori_loop(0, memory, bwd, (q, alpha))
    r = gamma * q

    def fwd(j, r):
        pos = (head - count + j) % memory
        valid = j < count
        b = rho[pos] * jnp.dot(Y[pos], r)
        corr = jnp.where(valid, alpha[pos] - b, 0.0)
        return r + corr * S[pos]

    r = jax.lax.fori_loop(0, memory, fwd, r)
    return -r


def wolfe_linesearch(vg, x, f0, g0, info0, d, alpha0, cfg: LBFGSConfig,
                     hist=None, rows=None):
    """Strong-Wolfe line search as a SINGLE state machine while_loop.

    Bracketing and zoom (Nocedal & Wright alg. 3.5/3.6, with safeguarded
    quadratic interpolation in the zoom stage) share one function-eval site
    per iteration — the loss/grad graph is instantiated once, keeping the
    compiled artifact small.  Returns (alpha, f_new, g_new, info_new, ok)
    — plus (hist, rows) when per-evaluation history is threaded in
    (LBFGSConfig.history == "evals"): every function evaluation appends its
    loss_info row, matching the reference's debug-callback cadence
    (software.py:485-488).

    mode: 0 = bracketing, 1 = zooming, 2 = accepted, 3 = failed.
    """
    dphi0 = jnp.dot(g0, d)
    c1, c2 = cfg.c1, cfg.c2
    zero = jnp.zeros((), f0.dtype)
    i0, i1, i2, i3 = (jnp.int32(k) for k in range(4))
    max_evals = cfg.max_bracket + cfg.max_linesearch

    def interp(a_lo, a_hi, phi_lo, dphi_lo, phi_hi):
        """Safeguarded quadratic trial inside (a_lo, a_hi); bisect fallback."""
        span = a_hi - a_lo
        denom = phi_hi - phi_lo - dphi_lo * span
        a_q = a_lo - 0.5 * dphi_lo * span * span / denom
        t = (a_q - a_lo) / jnp.where(span == 0.0, 1.0, span)
        good = jnp.isfinite(a_q) & (t > 0.1) & (t < 0.9) & (denom != 0.0)
        return jnp.where(good, a_q, 0.5 * (a_lo + a_hi))

    def cond(s):
        return (s["mode"] < 2) & (s["evals"] < max_evals)

    def body(s):
        a = s["a_cur"]
        f, g, info = vg(x + a * d)
        extra = {}
        if hist is not None:
            extra["hist"] = jax.lax.dynamic_update_slice(
                s["hist"], info[None, :], (s["rows"], jnp.int32(0))
            )
            extra["rows"] = s["rows"] + 1
        df = jnp.dot(g, d)
        armijo = f <= f0 + c1 * a * dphi0
        curv = jnp.abs(df) <= -c2 * dphi0
        bracketing = s["mode"] == 0

        # --- bracketing-stage classification (only meaningful if mode==0)
        b_hi = (~armijo) | ((f >= s["phi_prev"]) & (s["evals"] > 0))
        b_accept = armijo & curv & ~b_hi
        b_flip = ~b_hi & ~b_accept & (df >= 0.0)
        # --- zoom-stage classification (only meaningful if mode==1)
        z_hi = (~armijo) | (f >= s["phi_lo"])
        z_accept = ~z_hi & curv
        z_flip = ~z_hi & ~curv & (df * (s["a_hi"] - s["a_lo"]) >= 0.0)

        accept = jnp.where(bracketing, b_accept, z_accept)
        to_zoom = bracketing & (b_hi | b_flip)

        # interval updates
        a_lo = jnp.where(
            bracketing,
            jnp.where(b_hi, s["a_prev"], a),
            jnp.where(z_hi, s["a_lo"], a),
        )
        phi_lo = jnp.where(
            bracketing,
            jnp.where(b_hi, s["phi_prev"], f),
            jnp.where(z_hi, s["phi_lo"], f),
        )
        dphi_lo = jnp.where(
            bracketing,
            jnp.where(b_hi, s["dphi_prev"], df),
            jnp.where(z_hi, s["dphi_lo"], df),
        )
        a_hi = jnp.where(
            bracketing,
            jnp.where(b_hi, a, s["a_prev"]),
            jnp.where(z_hi, a, jnp.where(z_flip, s["a_lo"], s["a_hi"])),
        )
        phi_hi = jnp.where(
            bracketing,
            jnp.where(b_hi, f, s["phi_prev"]),
            jnp.where(z_hi, f, jnp.where(z_flip, s["phi_lo"], s["phi_hi"])),
        )

        zooming_next = to_zoom | ((s["mode"] == 1) & ~accept)
        a_next = jnp.where(
            zooming_next,
            interp(a_lo, a_hi, phi_lo, dphi_lo, phi_hi),
            2.0 * a,  # keep expanding the bracket
        )
        mode = jnp.where(accept, i2, jnp.where(zooming_next, i1, i0))
        # budget exhaustion -> failed
        mode = jnp.where((mode < 2) & (s["evals"] + 1 >= max_evals), i3, mode)

        return {
            "mode": mode,
            "evals": s["evals"] + 1,
            "a_prev": a,
            "phi_prev": f,
            "dphi_prev": df,
            "a_cur": a_next,
            "a_lo": a_lo,
            "a_hi": a_hi,
            "phi_lo": phi_lo,
            "dphi_lo": dphi_lo,
            "phi_hi": phi_hi,
            "a_acc": jnp.where(accept, a, s["a_acc"]),
            "f_acc": jnp.where(accept, f, s["f_acc"]),
            "g_acc": jnp.where(accept, g, s["g_acc"]),
            "info_acc": jnp.where(accept, info, s["info_acc"]),
            **extra,
        }

    s0 = {
        "mode": i0,
        "evals": jnp.int32(0),
        "a_prev": zero,
        "phi_prev": f0,
        "dphi_prev": dphi0,
        "a_cur": jnp.asarray(alpha0, f0.dtype),
        "a_lo": zero,
        "a_hi": jnp.asarray(alpha0, f0.dtype),
        "phi_lo": f0,
        "dphi_lo": dphi0,
        "phi_hi": f0,
        "a_acc": zero,
        "f_acc": f0,
        "g_acc": g0,
        "info_acc": info0,
    }
    if hist is not None:
        s0["hist"] = hist
        s0["rows"] = rows
    s = jax.lax.while_loop(cond, body, s0)
    ok = s["mode"] == 2
    if hist is not None:
        return (s["a_acc"], s["f_acc"], s["g_acc"], s["info_acc"], ok,
                s["hist"], s["rows"])
    return s["a_acc"], s["f_acc"], s["g_acc"], s["info_acc"], ok


def _lbfgs_init_state(value_and_grad_fn, x0, config: LBFGSConfig):
    m = config.memory
    n = x0.shape[0]
    f0, g0, info0 = jax.jit(value_and_grad_fn)(x0)
    dtype = f0.dtype
    hist = jnp.zeros((config.history_rows, info0.shape[0]), info0.dtype)
    hist = hist.at[0].set(info0)
    return {
        "x": x0,
        "f": f0,
        "g": g0,
        "info": info0,
        "S": jnp.zeros((m, n), dtype),
        "Y": jnp.zeros((m, n), dtype),
        "rho": jnp.zeros((m,), dtype),
        "count": jnp.int32(0),
        "head": jnp.int32(0),
        "gamma": jnp.ones((), dtype),
        "it": jnp.int32(0),
        "rows": jnp.int32(1),
        "done": jnp.zeros((), jnp.bool_),
        "failed": jnp.zeros((), jnp.bool_),
        "hist": hist,
    }


def _lbfgs_advance(value_and_grad_fn, state, it_end, config: LBFGSConfig):
    """Run L-BFGS iterations until ``done`` or ``it == it_end`` — ONE
    bounded device dispatch of the resumable state machine."""
    m = config.memory
    dtype = state["f"].dtype

    def cond(s):
        return (~s["done"]) & (s["it"] < it_end)

    def body(s):
        d = _two_loop(
            s["g"], s["S"], s["Y"], s["rho"], s["count"], s["head"], s["gamma"], m
        )
        # safeguard: if d is not a descent direction, fall back to -g
        descent = jnp.dot(d, s["g"]) < 0.0
        d = jnp.where(descent, d, -s["g"])
        # first-iteration step length heuristic
        g_norm1 = jnp.sum(jnp.abs(s["g"]))
        alpha0 = jnp.where(
            s["count"] == 0, jnp.minimum(1.0, 1.0 / jnp.maximum(g_norm1, 1e-12)), 1.0
        ).astype(dtype)
        if config.history == "evals":
            (alpha, f_new, g_new, info_new, ok, hist_ls,
             rows_ls) = wolfe_linesearch(
                value_and_grad_fn, s["x"], s["f"], s["g"], s["info"], d,
                alpha0, config, hist=s["hist"], rows=s["rows"],
            )
        else:
            alpha, f_new, g_new, info_new, ok = wolfe_linesearch(
                value_and_grad_fn, s["x"], s["f"], s["g"], s["info"], d,
                alpha0, config,
            )

        x_new = s["x"] + alpha * d
        sk = x_new - s["x"]
        yk = g_new - s["g"]
        sy = jnp.dot(sk, yk)
        curv_ok = sy > 1e-12 * jnp.linalg.norm(sk) * jnp.linalg.norm(yk)
        store = ok & curv_ok

        head = s["head"]
        S = jnp.where(store, s["S"].at[head % m].set(sk), s["S"])
        Y = jnp.where(store, s["Y"].at[head % m].set(yk), s["Y"])
        rho = jnp.where(store, s["rho"].at[head % m].set(1.0 / sy), s["rho"])
        count = jnp.where(store, jnp.minimum(s["count"] + 1, m), s["count"])
        head_new = jnp.where(store, (head + 1) % m, head)
        gamma = jnp.where(store, sy / jnp.maximum(jnp.dot(yk, yk), 1e-30), s["gamma"])

        it = s["it"] + 1
        if config.history == "evals":
            # per-evaluation rows were already written inside the line
            # search (including rejected probes — the reference's cadence)
            hist, rows = hist_ls, rows_ls
        else:
            # history rows are indexed by ACCEPTED iterates so a failing
            # final line search never leaves a zero row at the end
            hist = jnp.where(
                ok,
                jax.lax.dynamic_update_slice(
                    s["hist"], info_new[None, :], (s["rows"], jnp.int32(0))
                ),
                s["hist"],
            )
            rows = jnp.where(ok, s["rows"] + 1, s["rows"])
        converged = jnp.max(jnp.abs(g_new)) <= config.tolerance
        return {
            "x": jnp.where(ok, x_new, s["x"]),
            "f": jnp.where(ok, f_new, s["f"]),
            "g": jnp.where(ok, g_new, s["g"]),
            "info": jnp.where(ok, info_new, s["info"]),
            "S": S,
            "Y": Y,
            "rho": rho,
            "count": count,
            "head": head_new,
            "gamma": gamma,
            "it": it,
            "rows": rows,
            "done": (~ok) | converged,
            "failed": ~ok,
            "hist": hist,
        }

    return jax.lax.while_loop(cond, body, state)


def lbfgs_minimize(
    value_and_grad_fn: Callable,
    x0: Array,
    config: LBFGSConfig,
) -> LBFGSResult:
    """Minimize ``f(x)`` over a flat parameter vector, purely in XLA.

    :param value_and_grad_fn: ``x -> (f, g, loss_info)`` — the aux
        ``loss_info`` row of each accepted iterate is recorded in
        ``history`` (the reference harvests these via jax.debug.callback
        side effects, software.py:485-488; here they are a first-class
        output).

    Execution is CHUNKED: at most ``config.chunk_iters`` iterations run per
    device dispatch (jitted resumable state machine), with a scalar sync
    between chunks.  ``chunk_iters=0`` runs everything in one dispatch
    (fine inside an outer jit).
    """
    state = _lbfgs_init_state(value_and_grad_fn, x0, config)

    if config.chunk_iters <= 0:
        s = _lbfgs_advance(
            value_and_grad_fn, state, jnp.int32(config.max_iters), config
        )
    else:
        advance = jax.jit(
            lambda s, it_end: _lbfgs_advance(
                value_and_grad_fn, s, it_end, config
            )
        )
        s = state
        # adaptive dispatch sizing, as in the Adam phase: per-iteration
        # cost scales with net width × line-search evals.  Probe short,
        # measure the second (compile-cached) dispatch, size the rest to
        # ~25s.
        # chunk_iters stays the hard cap; it_target is a dynamic arg, so
        # resizing costs no recompile.
        import time as _time

        target_s = 25.0
        probe = max(1, min(20, config.chunk_iters))
        inc = probe
        prev_it, n_disp = 0, 0
        it_target = min(inc, config.max_iters)
        while True:
            t0 = _time.perf_counter()
            s = advance(s, jnp.int32(it_target))
            # host sync on two scalars: the chunk boundary
            done_now, it_now = bool(s["done"]), int(s["it"])
            dt = _time.perf_counter() - t0
            if done_now or it_now >= config.max_iters:
                break
            if n_disp == 1 and it_now > prev_it:
                per_it = max(dt / (it_now - prev_it), 1e-7)
                inc = int(max(probe, min(config.chunk_iters,
                                         target_s / per_it)))
            prev_it = it_now
            n_disp += 1
            it_target = min(it_now + inc, config.max_iters)

    converged = jnp.max(jnp.abs(s["g"])) <= config.tolerance
    return LBFGSResult(
        x=s["x"], f=s["f"], g=s["g"], history=s["hist"],
        n_iters=s["it"], n_rows=s["rows"], converged=converged,
        failed=s["failed"],
    )


def lbfgs_over_pytree(
    loss_fn: Callable,
    params,
    data,
    lw,
    ref,
    config: LBFGSConfig,
):
    """Run pure-XLA L-BFGS on a parameter pytree (ravel/unravel wrapper).

    Mirrors the reference's flatten→optimize→unflatten flow
    (software.py:463-514) without TFP.  Returns
    (params, history, n_rows) with history[:n_rows] the valid loss rows.
    """
    flat0, unravel = jax.flatten_util.ravel_pytree(params)

    def vg(x):
        p = unravel(x)
        (loss_n, info), grads = jax.value_and_grad(loss_fn, has_aux=True)(
            p, data, lw, ref
        )
        gflat = jax.flatten_util.ravel_pytree(grads)[0]
        return loss_n, gflat, info

    # lbfgs_minimize manages its own (chunked) jit dispatches
    result = lbfgs_minimize(vg, flat0, config)
    return unravel(result.x), result.history, result.n_rows
