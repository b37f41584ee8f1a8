"""Vectorized fixed-trajectory jittered HMC — the accelerator-native sampler.

NUTS's dynamic tree building is control-flow heavy: nested while_loops,
U-turn checkpoint scans, and per-leaf select/merge machinery cost many raw
leapfrogs per tree step (its cost on the GPU is not measured yet). This
module is the batched alternative: plain Hamiltonian Monte Carlo with

- a jittered trajectory length L_t ~ Uniform{ceil(0.4 L), ..., L} shared by
  all chains in a draw. The integrator runs a STATIC-length lax.scan of L
  iterations whose body is cond-gated on the scalar `i < L_t` (the untaken
  leapfrog branch never executes), so a draw costs exactly L_t
  gradient evaluations — jitter breaks the periodicity pathologies of
  fixed-L HMC (Neal 2011 §5.4.3.3) at zero wasted compute, with none of the
  per-iteration overhead a traced-bound while_loop would add.
- a Metropolis accept per chain (exact MCMC),
- dual-averaged shared step size (target accept 0.8, warmup draws only),
- a fixed diagonal mass matrix, normally the ADVI warm start's variational
  scales (infer.advi) — the same warm start the NUTS path uses.

The state is a flat [chains, D] float32 matrix: every integrator op is ONE
fused XLA op over the whole chain batch, which is what makes the sampler run
at raw-leapfrog speed. This replaces the reference's forked-process rstan
NUTS chains (R/utilities.R:1497-1512) as the fast path; infer.nuts remains
for robustness checks and gene-sharded multi-chip states.

Compiled-runner caching: the jitted program is cached per (log-density
function, static config), with the model data, init point, mass matrix and
seed as operands — repeated fits (the pipeline's two passes, warm/timed
bench runs) reuse one compile. Pass `data=` and a stable function (e.g.
nb_model.flat_logp(dims)) to benefit across different datasets of one shape.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np

MAX_DELTA_ENERGY = 1000.0

_RUNNER_CACHE: dict = {}

# static sampling-scan lengths the trajectory adaptation can select
_L_BUCKETS = (4, 6, 8, 12, 16, 24, 32, 48, 64)


def _halton_seq(n, base=2):
    """Halton low-discrepancy sequence, host-side, values in (0, 1)."""
    out = np.empty(n)
    for k in range(n):
        f, r, i = 1.0, 0.0, k + 1
        while i > 0:
            f /= base
            r += f * (i % base)
            i //= base
        out[k] = r
    return out


@dataclass
class HMCResult:
    draws: Any  # [chains, num_draws, D] jax.Array, left on device (np.asarray to copy)
    accept_prob: np.ndarray  # [chains, num_draws]
    divergences: np.ndarray  # [chains] count in sampling phase
    step_size: float
    num_leapfrog: int  # EXECUTED leapfrog steps (all chains, warmup + sampling)
    trajectory_length: float | None = None  # adapted T (adapt_trajectory=True)


def _build_runner(
    log_density, has_data, D, num_chains, num_warmup, num_draws,
    num_leapfrog, L_min, target_accept, dtype,
):
    gamma, t0_da, kappa = 0.05, 10.0, 0.75

    def logp_grad_batch(z, data):
        if has_data:
            lp, g = jax.vmap(jax.value_and_grad(log_density), in_axes=(0, None))(z, data)
        else:
            lp, g = jax.vmap(jax.value_and_grad(log_density))(z)
        bad = ~jnp.isfinite(lp)
        lp = jnp.where(bad, -jnp.inf, lp).astype(dtype)
        g = jnp.where(jnp.isfinite(g), g, 0.0).astype(dtype)
        return lp, g

    def runner(data, z0, inv_mass, mu, key):
        sqrt_inv_mass = jnp.sqrt(inv_mass)

        def kinetic(r):
            return 0.5 * jnp.sum(r * r * inv_mass[None, :], axis=1)

        def transition(z, lp, g, eps, key):
            k_mom, k_len, k_acc = jax.random.split(key, 3)
            L_t = jax.random.randint(k_len, (), L_min, num_leapfrog + 1)
            r0 = jax.random.normal(k_mom, z.shape, dtype) / sqrt_inv_mass[None, :]
            energy0 = -lp + kinetic(r0)

            # cond-gated static scan: iterations past the jittered length L_t
            # are identity (the scalar predicate is shared by all chains, so
            # the untaken leapfrog branch never executes) — recovers the
            # ~E[L - L_t]/L ~ 30% of gradient evaluations the snapshot
            # formulation wasted, and drops its 4-tensor per-step `where`
            # traffic (measured 16.0 -> 11.1 ms/draw on the bench model).
            def leapfrog(carry):
                z, r, g, lp = carry
                r_half = r + 0.5 * eps * g
                z1 = z + eps * (r_half * inv_mass[None, :])
                lp1, g1 = logp_grad_batch(z1, data)
                r1 = r_half + 0.5 * eps * g1
                return (z1, r1, g1, lp1)

            def step(carry, i):
                return jax.lax.cond(i < L_t, leapfrog, lambda c: c, carry), None

            (zp, rp, gp, lpp), _ = jax.lax.scan(
                step, (z, r0, g, lp), jnp.arange(num_leapfrog)
            )
            energy1 = -lpp + kinetic(rp)
            delta = energy1 - energy0
            delta = jnp.where(jnp.isnan(delta), jnp.inf, delta)
            diverging = delta > MAX_DELTA_ENERGY
            accept_prob = jnp.minimum(1.0, jnp.exp(-delta))
            u = jax.random.uniform(k_acc, (num_chains,), dtype)
            take = (u < accept_prob) & ~diverging
            z_new = jnp.where(take[:, None], zp, z)
            lp_new = jnp.where(take, lpp, lp)
            g_new = jnp.where(take[:, None], gp, g)
            return z_new, lp_new, g_new, accept_prob, diverging, L_t

        def warmup_step(carry, args):
            z, lp, g, log_eps, log_eps_avg, h_sum = carry
            i, k = args
            eps = jnp.exp(log_eps).astype(dtype)
            z, lp, g, accept, _, L_t = transition(z, lp, g, eps, k)
            a_mean = jnp.mean(accept)
            count = i + 1.0
            w = 1.0 / (count + t0_da)
            h_sum = (1 - w) * h_sum + w * (target_accept - a_mean)
            log_eps = mu - jnp.sqrt(count) / gamma * h_sum
            eta = count ** (-kappa)
            log_eps_avg = eta * log_eps + (1 - eta) * log_eps_avg
            return (z, lp, g, log_eps, log_eps_avg, h_sum), L_t

        def sample_step(carry, k):
            z, lp, g, eps = carry
            z, lp, g, accept, div, L_t = transition(z, lp, g, eps, k)
            return (z, lp, g, eps), (z, accept, div, L_t)

        lp, g = logp_grad_batch(z0, data)
        k_warm, k_samp = jax.random.split(key)
        wkeys = jax.random.split(k_warm, num_warmup)
        idx = jnp.arange(num_warmup, dtype=dtype)
        le0 = mu - jnp.log(10.0).astype(dtype)  # mu = log(10*eps0)
        (z, lp, g, _, log_eps_avg, _), warm_Ls = jax.lax.scan(
            warmup_step, (z0, lp, g, le0, le0, jnp.asarray(0.0, dtype)), (idx, wkeys)
        )
        eps = jnp.exp(log_eps_avg).astype(dtype)
        skeys = jax.random.split(k_samp, num_draws)
        (_, _, _, _), (draws, accept, div, samp_Ls) = jax.lax.scan(
            sample_step, (z, lp, g, eps), skeys
        )
        # [num_draws, chains, D] -> [chains, num_draws, D]
        return (
            jnp.swapaxes(draws, 0, 1),
            jnp.swapaxes(accept, 0, 1),
            jnp.swapaxes(div, 0, 1),
            eps,
            jnp.sum(warm_Ls) + jnp.sum(samp_Ls),
        )

    return jax.jit(runner)


def _make_parts(log_density, has_data, num_chains, L_static, dtype):
    """Shared pieces: batched logp+grad and a snapshot-jittered transition
    of static scan length L_static with traced snapshot step L_t."""

    def logp_grad_batch(z, data):
        if has_data:
            lp, g = jax.vmap(jax.value_and_grad(log_density), in_axes=(0, None))(z, data)
        else:
            lp, g = jax.vmap(jax.value_and_grad(log_density))(z)
        bad = ~jnp.isfinite(lp)
        lp = jnp.where(bad, -jnp.inf, lp).astype(dtype)
        g = jnp.where(jnp.isfinite(g), g, 0.0).astype(dtype)
        return lp, g

    def transition(z, lp, g, eps, L_t, key, data, inv_mass):
        sqrt_inv_mass = jnp.sqrt(inv_mass)

        def kinetic(r):
            return 0.5 * jnp.sum(r * r * inv_mass[None, :], axis=1)

        k_mom, k_acc = jax.random.split(key)
        r0 = jax.random.normal(k_mom, z.shape, dtype) / sqrt_inv_mass[None, :]
        energy0 = -lp + kinetic(r0)

        # cond-gated static scan (see _build_runner.transition): iterations
        # past the traced L_t are identity, so jittered trajectories cost
        # only the leapfrogs they actually take.
        def leapfrog(carry):
            z, r, g, lp = carry
            r_half = r + 0.5 * eps * g
            z1 = z + eps * (r_half * inv_mass[None, :])
            lp1, g1 = logp_grad_batch(z1, data)
            r1 = r_half + 0.5 * eps * g1
            return (z1, r1, g1, lp1)

        def step(carry, i):
            return jax.lax.cond(i < L_t, leapfrog, lambda c: c, carry), None

        (zp, rp, gp, lpp), _ = jax.lax.scan(
            step, (z, r0, g, lp), jnp.arange(L_static)
        )
        energy1 = -lpp + kinetic(rp)
        delta = energy1 - energy0
        delta = jnp.where(jnp.isnan(delta), jnp.inf, delta)
        diverging = delta > MAX_DELTA_ENERGY
        accept_prob = jnp.where(diverging, 0.0, jnp.minimum(1.0, jnp.exp(-delta)))
        u = jax.random.uniform(k_acc, (num_chains,), dtype)
        take = (u < accept_prob) & ~diverging
        z_new = jnp.where(take[:, None], zp, z)
        lp_new = jnp.where(take, lpp, lp)
        g_new = jnp.where(take[:, None], gp, g)
        return z_new, lp_new, g_new, accept_prob, diverging, (zp, rp)

    return logp_grad_batch, transition


def _build_chees_warmup(log_density, has_data, D, num_chains, num_warmup,
                        L_cap, target_accept, dtype):
    """Warmup that jointly adapts step size (dual averaging) and trajectory
    length T by ascending a ChEES-family criterion with Adam, with
    Halton-jittered T per draw.

    The criterion is SNAPER (Sountsov & Hoffman 2022): the squared change of
    the SQUARED PRINCIPAL-COMPONENT PROJECTION, E[(p(x')^2 - p(x)^2)^2]
    with p(x) = <x - mean, u> in mass-matrix-whitened coordinates, where u
    is the leading eigenvector of the whitened posterior covariance,
    estimated online across chains by Oja's rule. Projecting makes the
    criterion track the SLOWEST direction; the original full-norm ChEES
    criterion is a sum over all D coordinates, which on the hierarchical NB
    posterior is dominated by the ~2G fast gene coordinates and settles at
    T ~3x too short for the global hyperparameters (split-Rhat 1.9; the
    round-1 known-wrong behavior this replaces)."""
    gamma, t0_da, kappa = 0.05, 10.0, 0.75
    adam_lr, b1, b2, adam_eps = 0.05, 0.9, 0.999, 1e-8

    logp_grad_batch, transition = _make_parts(
        log_density, has_data, num_chains, L_cap, dtype
    )

    def warmup(data, z0, inv_mass, mu, key, u_seq):
        sqrt_inv_mass = jnp.sqrt(inv_mass)

        def step(carry, args):
            (z, lp, g, log_eps, log_eps_avg, h_sum,
             log_T, log_T_avg, m_adam, v_adam, pc) = carry
            i, k, u = args
            eps = jnp.exp(log_eps).astype(dtype)
            T_jit = u * jnp.exp(log_T).astype(dtype)
            L_t = jnp.clip(
                jnp.ceil(T_jit / eps).astype(jnp.int32), 1, L_cap
            )
            z1, lp1, g1, accept, div, (zp, rp) = transition(
                z, lp, g, eps, L_t, k, data, inv_mass
            )

            # whitened coordinates
            w = 1.0 / sqrt_inv_mass[None, :]
            xw = z * w
            xw_p = zp * w
            vw_p = (rp * inv_mass[None, :]) * w  # whitened end velocity
            xw_c = xw - xw.mean(axis=0, keepdims=True)
            xwp_c = xw_p - xw_p.mean(axis=0, keepdims=True)

            # Oja's rule on the post-accept chain batch: pc tracks the
            # leading eigenvector of the whitened posterior covariance
            x1w = z1 * w
            x1w_c = x1w - x1w.mean(axis=0, keepdims=True)  # [chains, D]
            # f32 products run at full precision (a GPU may otherwise use
            # TF32, ~3 decimal digits), like the likelihood's own dots
            hi = jax.lax.Precision.HIGHEST
            cov_pc = jnp.matmul(
                x1w_c.T, jnp.matmul(x1w_c, pc, precision=hi), precision=hi
            ) / num_chains
            lr_oja = 3.0 / (i + 10.0)
            pc_new = pc + lr_oja.astype(dtype) * cov_pc
            pc = pc_new / jnp.maximum(jnp.linalg.norm(pc_new), 1e-20)

            # SNAPER criterion on the principal projection
            proj0 = jnp.matmul(xw_c, pc, precision=hi)  # [chains]
            proj1 = jnp.matmul(xwp_c, pc, precision=hi)
            projv = jnp.matmul(vw_p, pc, precision=hi)
            h = proj1 * proj1 - proj0 * proj0
            dh = 2.0 * proj1 * projv
            wsum = jnp.maximum(jnp.sum(accept), 1e-6)
            # d/dlogT with the jitter chain rule (T_t = u * T)
            grad = jnp.sum(accept * h * dh, axis=0) / wsum * u * jnp.exp(log_T)
            grad = jnp.where(jnp.isfinite(grad), grad, 0.0)
            # Adam ASCENT on log T
            count = i + 1.0
            m_adam = b1 * m_adam + (1 - b1) * grad
            v_adam = b2 * v_adam + (1 - b2) * grad * grad
            m_hat = m_adam / (1 - b1**count)
            v_hat = v_adam / (1 - b2**count)
            log_T = log_T + adam_lr * m_hat / (jnp.sqrt(v_hat) + adam_eps)
            log_T = jnp.clip(log_T, jnp.log(eps), jnp.log(eps * L_cap))
            eta = count ** (-kappa)
            log_T_avg = eta * log_T + (1 - eta) * log_T_avg

            # dual averaging on eps
            a_mean = jnp.mean(accept)
            w_da = 1.0 / (count + t0_da)
            h_sum = (1 - w_da) * h_sum + w_da * (target_accept - a_mean)
            log_eps = mu - jnp.sqrt(count) / gamma * h_sum
            log_eps_avg = eta * log_eps + (1 - eta) * log_eps_avg

            return (z1, lp1, g1, log_eps, log_eps_avg, h_sum,
                    log_T, log_T_avg, m_adam, v_adam, pc), (a_mean, L_t)

        lp, g = logp_grad_batch(z0, data)
        le0 = mu - jnp.log(10.0).astype(dtype)
        lT0 = le0 + jnp.log(0.5 * L_cap).astype(dtype)  # start at half the cap
        zero = jnp.asarray(0.0, dtype)
        # init principal direction from the chain spread (deterministic)
        pc0 = z0[0] - z0[-1]
        pc0 = (pc0 / jnp.maximum(jnp.linalg.norm(pc0), 1e-20)).astype(dtype)
        idx = jnp.arange(num_warmup, dtype=dtype)
        keys = jax.random.split(key, num_warmup)
        carry0 = (z0, lp, g, le0, le0, zero, lT0, lT0, zero, zero, pc0)
        (z, lp, g, _, log_eps_avg, _, _, log_T_avg, _, _, _), (acc, Ls) = jax.lax.scan(
            step, carry0, (idx, keys, u_seq)
        )
        return z, lp, g, jnp.exp(log_eps_avg).astype(dtype), jnp.exp(log_T_avg).astype(dtype), jnp.sum(Ls)

    return jax.jit(warmup)


def _build_sampler(log_density, has_data, num_chains, num_draws, L_static, dtype):
    """Sampling scan of static length L_static; per-draw snapshot L_t comes
    from the Halton sequence x adapted trajectory length (operands)."""
    logp_grad_batch, transition = _make_parts(
        log_density, has_data, num_chains, L_static, dtype
    )

    def sampler(data, z, lp, g, eps, T, inv_mass, key, u_seq):
        def step(carry, args):
            z, lp, g = carry
            k, u = args
            L_t = jnp.clip(jnp.ceil(u * T / eps).astype(jnp.int32), 1, L_static)
            z, lp, g, accept, div, _ = transition(z, lp, g, eps, L_t, k, data, inv_mass)
            return (z, lp, g), (z, accept, div, L_t)

        keys = jax.random.split(key, num_draws)
        (_, _, _), (draws, accept, div, Ls) = jax.lax.scan(step, (z, lp, g), (keys, u_seq))
        return (
            jnp.swapaxes(draws, 0, 1),
            jnp.swapaxes(accept, 0, 1),
            jnp.swapaxes(div, 0, 1),
            jnp.sum(Ls),
        )

    return jax.jit(sampler)


def run_hmc(
    log_density,
    dim: int,
    key,
    *,
    data=None,
    num_chains: int = 128,
    num_warmup: int = 100,
    num_draws: int = 100,
    num_leapfrog: int = 32,
    jitter_low: float = 0.4,
    target_accept: float = 0.8,
    init_theta=None,
    init_jitter: float = 0.1,
    inv_mass=None,
    step_size0: float = 0.05,
    mesh=None,
    adapt_trajectory: bool = False,
    dtype=jnp.float32,
) -> HMCResult:
    """Run jittered-trajectory HMC on a flat [D] unconstrained state.

    `log_density` maps a [D] vector (plus `data`, when given) to a scalar.
    `inv_mass` is the diagonal inverse mass (posterior variance estimate,
    e.g. exp(2*log_sd) from ADVI). Returns post-warmup draws stacked
    [chains, num_draws, D].

    With `mesh` (a jax.sharding.Mesh with a "chains" axis), the chain batch
    is sharded across devices: pure data-parallel scaling of the flagship
    sampler — every integrator op stays local per device, the only
    cross-device collective is the scalar mean-accept psum in warmup (the
    analog of the reference's chain-per-process parallelism,
    R/utilities.R:1497-1502). `data` and the mass matrix are replicated.
    """
    D = int(dim)
    L_min = max(1, int(np.ceil(jitter_low * num_leapfrog)))
    if not adapt_trajectory:
        cache_key = (
            log_density, data is not None, D, num_chains, num_warmup, num_draws,
            int(num_leapfrog), L_min, float(target_accept), jnp.dtype(dtype).name,
            mesh,
        )
        runner = _RUNNER_CACHE.get(cache_key)
        if runner is None:
            runner = _build_runner(
                log_density, data is not None, D, num_chains, num_warmup,
                num_draws, int(num_leapfrog), L_min, float(target_accept), dtype,
            )
            _RUNNER_CACHE[cache_key] = runner

    if inv_mass is None:
        inv_mass = jnp.ones(D, dtype)
    inv_mass = jnp.asarray(inv_mass, dtype)

    key, k_init = jax.random.split(key)
    if init_theta is None:
        z0 = jax.random.uniform(k_init, (num_chains, D), dtype, -2.0, 2.0)
    else:
        base = jnp.asarray(init_theta, dtype)
        z0 = base[None, :] + init_jitter * jax.random.normal(k_init, (num_chains, D), dtype)

    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec as P

        chain_sh = NamedSharding(mesh, P("chains", None))
        rep = NamedSharding(mesh, P())
        z0 = jax.device_put(z0, chain_sh)
        inv_mass = jax.device_put(inv_mass, rep)
        if data is not None:
            data = jax.tree.map(
                lambda x: jax.device_put(x, rep) if x is not None else None, data
            )

    mu = jnp.asarray(np.log(10.0 * step_size0), dtype)

    if not adapt_trajectory:
        draws, accept, div, eps, exec_lf = runner(data, z0, inv_mass, mu, key)
        # draws stay ON DEVICE: the pipeline's PPC simulation and draw
        # extraction consume them there, so no fit pays a host copy of the
        # full [chains, draws, D] stack. np.asarray() at any consumer still
        # works (triggers the transfer).
        return HMCResult(
            draws=draws,
            accept_prob=np.asarray(accept),
            divergences=np.asarray(np.asarray(div).sum(axis=1)),
            step_size=float(eps),
            num_leapfrog=int(exec_lf) * num_chains,
        )

    # --- ChEES path: adapt trajectory length in warmup, then sample with a
    # bucketed static scan length ------------------------------------------
    L_cap = int(num_leapfrog)
    wkey = ("chees_warm", log_density, data is not None, D, num_chains,
            num_warmup, L_cap, float(target_accept), jnp.dtype(dtype).name, mesh)
    warmup = _RUNNER_CACHE.get(wkey)
    if warmup is None:
        warmup = _build_chees_warmup(
            log_density, data is not None, D, num_chains, num_warmup,
            L_cap, float(target_accept), dtype,
        )
        _RUNNER_CACHE[wkey] = warmup

    k_warm, k_samp = jax.random.split(key)
    u_warm = jnp.asarray(_halton_seq(num_warmup), dtype)
    z, lp, g, eps, T_hat, warm_lf = warmup(data, z0, inv_mass, mu, k_warm, u_warm)
    eps_f, T_f = float(eps), float(T_hat)
    L_star = max(1, int(np.ceil(T_f / max(eps_f, 1e-12))))
    bucket = next((b for b in _L_BUCKETS if b >= min(L_star, L_cap)), L_cap)

    skey = ("chees_samp", log_density, data is not None, D, num_chains,
            num_draws, bucket, jnp.dtype(dtype).name, mesh)
    sampler = _RUNNER_CACHE.get(skey)
    if sampler is None:
        sampler = _build_sampler(
            log_density, data is not None, num_chains, num_draws, bucket, dtype
        )
        _RUNNER_CACHE[skey] = sampler

    u_draws = jnp.asarray(_halton_seq(num_draws, base=3), dtype)
    draws, accept, div, samp_lf = sampler(
        data, z, lp, g, eps, T_hat, inv_mass, k_samp, u_draws
    )
    total_lf = (int(warm_lf) + int(samp_lf)) * num_chains
    return HMCResult(
        draws=draws,
        accept_prob=np.asarray(accept),
        divergences=np.asarray(np.asarray(div).sum(axis=1)),
        step_size=eps_f,
        num_leapfrog=total_lf,
        trajectory_length=T_f,
    )


# ----------------------------------------------------------------------------
# Tree-state (gene-shardable) jittered HMC
# ----------------------------------------------------------------------------
#
# The flat runner above keeps the state as one [chains, D] matrix — fastest
# single-device layout, and chain-shardable. For GENE-axis scaling (the
# map_rect/MPI analog, stan:226-240) the state must instead be the parameter
# pytree so per-gene leaves ([chains, G]) can carry a `genes` NamedSharding
# while scalars replicate. This runner is the same algorithm over pytrees:
# static-length lax.scan integrator (no while_loops), so — unlike the
# gene-sharded NUTS tree-build — GSPMD partitions it in seconds, making the
# gene axis measurable at scale on a virtual CPU mesh and on real pods.


def _bsum(x):
    """Per-chain reduction: sum over all non-leading axes."""
    return jnp.sum(x, axis=tuple(range(1, x.ndim)))


def _bwhere(pred, a, b):
    """tree_where with a per-chain [chains] predicate."""
    return jax.tree.map(
        lambda x, y: jnp.where(pred.reshape((-1,) + (1,) * (x.ndim - 1)), x, y), a, b
    )


def _build_tree_runner(
    log_density, has_data, num_chains, num_warmup, num_draws,
    num_leapfrog, L_min, target_accept, dtype,
):
    gamma, t0_da, kappa = 0.05, 10.0, 0.75

    def logp_grad_batch(z, data):
        if has_data:
            lp, g = jax.vmap(jax.value_and_grad(log_density), in_axes=(0, None))(z, data)
        else:
            lp, g = jax.vmap(jax.value_and_grad(log_density))(z)
        bad = ~jnp.isfinite(lp)
        lp = jnp.where(bad, -jnp.inf, lp).astype(dtype)
        g = jax.tree.map(lambda gi: jnp.where(jnp.isfinite(gi), gi, 0.0).astype(dtype), g)
        return lp, g

    def runner(data, z0, inv_mass, mu, key):
        # inv_mass leaves have the UNstacked shape; broadcast over chains
        im_b = jax.tree.map(lambda im: im[None], inv_mass)
        sd_b = jax.tree.map(lambda im: jnp.sqrt(im)[None], inv_mass)

        def kinetic(r):
            parts = jax.tree.leaves(
                jax.tree.map(lambda ri, im: _bsum(ri * ri * im), r, im_b)
            )
            return 0.5 * sum(parts)

        def transition(z, lp, g, eps, key):
            from ppcseq.model.params import tree_normal_like

            k_mom, k_len, k_acc = jax.random.split(key, 3)
            L_t = jax.random.randint(k_len, (), L_min, num_leapfrog + 1)
            r0 = jax.tree.map(
                lambda n, sd: n / sd, tree_normal_like(k_mom, z), sd_b
            )
            energy0 = -lp + kinetic(r0)

            # cond-gated static scan (see _build_runner.transition); the
            # scalar predicate replicates under GSPMD, so gene-sharded
            # leaves branch uniformly across devices.
            def leapfrog(carry):
                z, r, g, lp = carry
                r_half = jax.tree.map(lambda ri, gi: ri + 0.5 * eps * gi, r, g)
                z1 = jax.tree.map(lambda zi, ri, im: zi + eps * ri * im, z, r_half, im_b)
                lp1, g1 = logp_grad_batch(z1, data)
                r1 = jax.tree.map(lambda ri, gi: ri + 0.5 * eps * gi, r_half, g1)
                return (z1, r1, g1, lp1)

            def step(carry, i):
                return jax.lax.cond(i < L_t, leapfrog, lambda c: c, carry), None

            (zp, rp, gp, lpp), _ = jax.lax.scan(
                step, (z, r0, g, lp), jnp.arange(num_leapfrog)
            )
            energy1 = -lpp + kinetic(rp)
            delta = energy1 - energy0
            delta = jnp.where(jnp.isnan(delta), jnp.inf, delta)
            diverging = delta > MAX_DELTA_ENERGY
            accept_prob = jnp.where(diverging, 0.0, jnp.minimum(1.0, jnp.exp(-delta)))
            u = jax.random.uniform(k_acc, (num_chains,), dtype)
            take = (u < accept_prob) & ~diverging
            z_new = _bwhere(take, zp, z)
            lp_new = jnp.where(take, lpp, lp)
            g_new = _bwhere(take, gp, g)
            return z_new, lp_new, g_new, accept_prob, diverging, L_t

        def warmup_step(carry, args):
            z, lp, g, log_eps, log_eps_avg, h_sum = carry
            i, k = args
            eps = jnp.exp(log_eps).astype(dtype)
            z, lp, g, accept, _, L_t = transition(z, lp, g, eps, k)
            a_mean = jnp.mean(accept)
            count = i + 1.0
            w = 1.0 / (count + t0_da)
            h_sum = (1 - w) * h_sum + w * (target_accept - a_mean)
            log_eps = mu - jnp.sqrt(count) / gamma * h_sum
            eta = count ** (-kappa)
            log_eps_avg = eta * log_eps + (1 - eta) * log_eps_avg
            return (z, lp, g, log_eps, log_eps_avg, h_sum), L_t

        def sample_step(carry, k):
            z, lp, g, eps = carry
            z, lp, g, accept, div, L_t = transition(z, lp, g, eps, k)
            return (z, lp, g, eps), (z, accept, div, L_t)

        lp, g = logp_grad_batch(z0, data)
        k_warm, k_samp = jax.random.split(key)
        wkeys = jax.random.split(k_warm, num_warmup)
        idx = jnp.arange(num_warmup, dtype=dtype)
        le0 = mu - jnp.log(10.0).astype(dtype)
        (z, lp, g, _, log_eps_avg, _), warm_Ls = jax.lax.scan(
            warmup_step, (z0, lp, g, le0, le0, jnp.asarray(0.0, dtype)), (idx, wkeys)
        )
        eps = jnp.exp(log_eps_avg).astype(dtype)
        skeys = jax.random.split(k_samp, num_draws)
        (_, _, _, _), (draws, accept, div, samp_Ls) = jax.lax.scan(
            sample_step, (z, lp, g, eps), skeys
        )
        # leaves [num_draws, chains, ...] -> [chains, num_draws, ...]
        draws = jax.tree.map(lambda x: jnp.swapaxes(x, 0, 1), draws)
        return (
            draws,
            jnp.swapaxes(accept, 0, 1),
            jnp.swapaxes(div, 0, 1),
            eps,
            jnp.sum(warm_Ls) + jnp.sum(samp_Ls),
        )

    return jax.jit(runner)


def run_hmc_tree(
    log_density,
    prototype,
    key,
    *,
    data=None,
    num_chains: int = 8,
    num_warmup: int = 100,
    num_draws: int = 100,
    num_leapfrog: int = 32,
    jitter_low: float = 0.4,
    target_accept: float = 0.8,
    init_theta=None,
    init_jitter: float = 0.1,
    inv_mass=None,
    step_size0: float = 0.05,
    mesh=None,
    dims=None,
    dtype=jnp.float32,
) -> HMCResult:
    """Jittered-trajectory HMC over a pytree state, gene-shardable.

    Same algorithm as `run_hmc`, but the state is the unconstrained
    parameter pytree stacked over a leading chain axis, so per-gene leaves
    can be sharded over a `genes` mesh axis — the equivalent of
    the reference's map_rect gene fan-out (stan:226-240): elementwise
    leapfrog math stays local to each gene shard and the only collectives
    are the psums GSPMD inserts for the scalar energy/log-density
    reductions. Chains ride a vmap axis and shard too when the mesh has a
    `chains` axis.

    With `mesh` and `dims` given, the initial state / mass matrix / model
    data are device_put with the parallel.sharding specs (gene leaves
    sharded, scalars replicated; chain axis sharded iff the mesh names one).
    Compiled runners are cached per (log-density fn, static config) exactly
    like the flat runner.

    Returns an HMCResult whose `draws` is a stacked pytree with
    [chains, num_draws, ...] leaves.
    """
    from ppcseq.model.params import tree_axpy, tree_normal_like, tree_ones_like

    proto = jax.tree.map(lambda x: jnp.asarray(x, dtype), prototype)
    L_min = max(1, int(np.ceil(jitter_low * num_leapfrog)))

    cache_key = (
        "tree", log_density, data is not None, num_chains, num_warmup,
        num_draws, int(num_leapfrog), L_min, float(target_accept),
        jnp.dtype(dtype).name, mesh,
    )
    runner = _RUNNER_CACHE.get(cache_key)
    if runner is None:
        runner = _build_tree_runner(
            log_density, data is not None, num_chains, num_warmup,
            num_draws, int(num_leapfrog), L_min, float(target_accept), dtype,
        )
        _RUNNER_CACHE[cache_key] = runner

    if inv_mass is None:
        inv_mass = tree_ones_like(proto)
    inv_mass = jax.tree.map(lambda x: jnp.asarray(x, dtype), inv_mass)

    key, k_init = jax.random.split(key)
    init_keys = jax.random.split(k_init, num_chains)
    if init_theta is None:
        base = proto
    else:
        base = jax.tree.map(lambda x: jnp.asarray(x, dtype), init_theta)
    z0 = jax.vmap(lambda k: tree_axpy(init_jitter, tree_normal_like(k, base), base))(
        init_keys
    )

    if mesh is not None:
        if dims is None:
            raise ValueError("run_hmc_tree(mesh=...) requires dims=")
        from ppcseq.parallel.sharding import (
            param_shardings,
            shard_data,
            shard_params,
        )

        chain_ax = "chains" if "chains" in mesh.axis_names else True
        state_sh = param_shardings(mesh, dims, chain_axis=chain_ax)
        z0 = {k: jax.device_put(v, state_sh[k]) for k, v in z0.items()}
        inv_mass = shard_params(inv_mass, mesh, dims)
        if data is not None:
            data = shard_data(data, mesh)

    mu = jnp.asarray(np.log(10.0 * step_size0), dtype)
    draws, accept, div, eps, exec_lf = runner(data, z0, inv_mass, mu, key)
    return HMCResult(
        draws=draws,
        accept_prob=np.asarray(accept),
        divergences=np.asarray(np.asarray(div).sum(axis=1)),
        step_size=float(eps),
        num_leapfrog=int(exec_lf) * num_chains,
    )
