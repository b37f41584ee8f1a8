"""Meanfield ADVI (automatic differentiation variational inference).

The accelerator replacement for the reference's `rstan::vb` path
(R/utilities.R:246-278, 1482-1494): a meanfield Gaussian q(theta) =
N(m, diag(s^2)) in unconstrained space, optimized by stochastic gradient
ascent on the reparametrized ELBO, with the reference's convergence rule
(relative ELBO change vs tol_rel_obj, assessed every `eval_every` iterations
over a rolling window, as Stan's ADVI does) and the reference's
retry-until-success wrapper (`vb_iterative`, R/utilities.R:246-278).

Generic over pytree states (a bare [D] vector is the trivial pytree), so the
same code runs single-chip or gene-sharded over a mesh: the variational
parameters inherit the model state's shardings and XLA GSPMD keeps the
elementwise reparametrization local per shard.

Everything inside one optimization chunk is a single jitted lax.scan, so the
whole fit is a handful of XLA executions regardless of iteration count.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np
import optax

from ppcseq.model.params import tree_normal_like, tree_size

_FNS_CACHE: dict = {}


@dataclass
class ADVIResult:
    mean: Any  # pytree (or ndarray) variational mean
    log_sd: Any  # pytree (or ndarray) variational log-stddev
    elbo: float
    elbo_trace: np.ndarray
    converged: bool
    iterations: int


def _sample_q(key, m, log_s):
    eps = tree_normal_like(key, m)
    return jax.tree.map(lambda mi, lsi, ei: mi + jnp.exp(lsi) * ei, m, log_s, eps)


def _elbo_estimate(log_density, m, log_s, key, n_samples):
    """Reparametrized ELBO: E_q[logp(theta)] + entropy(q)."""
    D = tree_size(m)
    keys = jax.random.split(key, n_samples)
    logps = jax.vmap(lambda k: log_density(_sample_q(k, m, log_s)))(keys)
    entropy = sum(jnp.sum(ls) for ls in jax.tree.leaves(log_s))
    entropy = entropy + 0.5 * D * (1.0 + jnp.log(2.0 * jnp.pi))
    return jnp.mean(logps) + entropy


def _get_advi_fns(log_density, has_data, eval_every, grad_samples, elbo_samples, learning_rate):
    """Jitted chunk/eval functions cached per (log-density fn, static config).

    Model data rides as an operand, so repeated fits with same-shaped data
    (the pipeline's two passes; retry attempts) reuse one compile.
    """
    cache_key = (log_density, has_data, eval_every, grad_samples, elbo_samples, float(learning_rate))
    hit = _FNS_CACHE.get(cache_key)
    if hit is not None:
        return hit

    # inverse-sqrt step-size decay, like Stan ADVI's rho_k ~ eta / sqrt(k)
    schedule = lambda step: learning_rate / jnp.sqrt(1.0 + step / 100.0)  # noqa: E731
    optimizer = optax.adam(schedule)

    def bind(data):
        if has_data:
            return lambda th: log_density(th, data)
        return log_density

    @jax.jit
    def chunk(params, opt_state, key, data):
        ld = bind(data)

        def loss_fn(p, k):
            return -_elbo_estimate(ld, p["m"], p["log_s"], k, grad_samples)

        def step(carry, k):
            p, s = carry
            loss, grads = jax.value_and_grad(loss_fn)(p, k)
            updates, s = optimizer.update(grads, s, p)
            p = optax.apply_updates(p, updates)
            return (p, s), loss

        keys = jax.random.split(key, eval_every)
        (params, opt_state), losses = jax.lax.scan(step, (params, opt_state), keys)
        return params, opt_state, losses

    elbo_eval = jax.jit(
        lambda p, k, data: _elbo_estimate(bind(data), p["m"], p["log_s"], k, elbo_samples)
    )

    fns = (optimizer, chunk, elbo_eval)
    _FNS_CACHE[cache_key] = fns
    return fns


def fit_advi(
    log_density,
    prototype,
    key,
    *,
    data=None,
    max_iter: int = 50000,
    tol_rel_obj: float = 0.005,
    eval_every: int = 100,
    elbo_samples: int = 100,
    grad_samples: int = 1,
    learning_rate: float = 0.1,
    window: int = 8,
    init_mean=None,
    init_log_sd: float | None = None,
    dtype=jnp.float32,
) -> ADVIResult:
    """Fit meanfield ADVI; returns the variational parameters.

    `prototype` defines the state structure: an int D (flat vector), an
    example array, or a pytree. With `data` given, `log_density(theta,
    data)` is used and the compiled optimizer is reused across fits (see
    _get_advi_fns). Convergence: ELBO estimated with `elbo_samples` draws
    every `eval_every` steps; stop when the mean or the median of the last
    `window` relative changes drops below tol_rel_obj (Stan ADVI's rule).
    `init_mean` seeds the variational location (e.g. nb_model.smart_init); a
    data-informed start makes the relative-ELBO rule meaningful from the
    first window.
    """
    if isinstance(prototype, int):
        prototype = jnp.zeros(prototype, dtype)
    proto = jax.tree.map(lambda x: jnp.asarray(x, dtype), prototype)

    if init_log_sd is None:
        init_log_sd = -1.0 if init_mean is not None else 0.0
    m0 = (
        jax.tree.map(lambda x: jnp.asarray(x, dtype), init_mean)
        if init_mean is not None
        else jax.tree.map(jnp.zeros_like, proto)
    )
    params = {
        "m": m0,
        "log_s": jax.tree.map(lambda x: jnp.full_like(x, init_log_sd), proto),
    }
    optimizer, chunk, elbo_eval = _get_advi_fns(
        log_density, data is not None, eval_every, grad_samples, elbo_samples, learning_rate
    )
    opt_state = optimizer.init(params)

    elbos = []
    deltas = []
    converged = False
    it = 0
    while it < max_iter:
        key, k_chunk, k_eval = jax.random.split(key, 3)
        params, opt_state, _ = chunk(params, opt_state, k_chunk, data)
        it += eval_every
        elbo = float(elbo_eval(params, k_eval, data))
        if not np.isfinite(elbo):
            break
        if elbos:
            prev = elbos[-1]
            deltas.append(abs((elbo - prev) / prev) if prev != 0 else np.inf)
            recent = deltas[-window:]
            if len(recent) >= 2 and (
                np.mean(recent) < tol_rel_obj or np.median(recent) < tol_rel_obj
            ):
                elbos.append(elbo)
                converged = True
                break
        elbos.append(elbo)

    final_elbo = elbos[-1] if elbos else float("nan")
    is_vector = isinstance(params["m"], jnp.ndarray)
    return ADVIResult(
        mean=np.asarray(params["m"]) if is_vector else params["m"],
        log_sd=np.asarray(params["log_s"]) if is_vector else params["log_s"],
        elbo=final_elbo,
        elbo_trace=np.asarray(elbos),
        converged=converged,
        iterations=it,
    )


def advi_sample(result: ADVIResult, key, n_draws: int, dtype=jnp.float32):
    """Draw n_draws samples from the fitted meanfield posterior.

    Returns [n, D] for vector states, or a stacked pytree (leading draw axis)
    for pytree states.
    """
    m = jax.tree.map(lambda x: jnp.asarray(x, dtype), result.mean)
    log_s = jax.tree.map(lambda x: jnp.asarray(x, dtype), result.log_sd)
    keys = jax.random.split(key, n_draws)
    return jax.vmap(lambda k: _sample_q(k, m, log_s))(keys)


@jax.jit
def _all_finite(tree):
    """Device-side all-finite reduction: leaves may be sharded across
    processes (multi-host gene sharding), where a host fetch of the full
    array is impossible — the reduced scalar is fully addressable."""
    return jax.tree.reduce(
        jnp.logical_and, jax.tree.map(lambda l: jnp.all(jnp.isfinite(l)), tree)
    )


def vb_iterative(
    log_density,
    prototype,
    key,
    *,
    max_attempts: int = 5,
    min_elbo: float = -1e15,
    init_mean=None,
    **advi_kwargs,
) -> ADVIResult:
    """Retry ADVI until it succeeds (reference `vb_iterative`, R/utilities.R:246-278).

    After the first failure the data-driven init is dropped in favor of the
    zero init, mirroring the reference's retry-from-scratch behavior.
    """
    last = None
    for attempt in range(max_attempts):
        key, sub = jax.random.split(key)
        res = fit_advi(
            log_density, prototype, sub,
            init_mean=init_mean if attempt == 0 else None,
            **advi_kwargs,
        )
        finite_mean = bool(_all_finite(res.mean))
        ok = np.isfinite(res.elbo) and res.elbo > min_elbo and finite_mean
        if ok:
            return res
        last = res
        print(f"Further attempt with Variational Bayes: attempt {attempt + 1} failed")
    if last is None:
        raise RuntimeError("ADVI failed to produce any result")
    raise RuntimeError(f"ADVI failed after {max_attempts} attempts (elbo={last.elbo})")
