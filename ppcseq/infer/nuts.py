"""Vectorized multi-chain NUTS, generic over pytree states.

The accelerator replacement for the reference's `rstan::sampling` NUTS path
(R/utilities.R:1497-1512). Instead of forked CPU processes per chain, chains
are vmapped into one XLA program; the tree build is the iterative
(non-recursive) formulation of multinomial NUTS with the generalized U-turn
criterion and O(max_depth) momentum checkpoints, so it is a fixed-shape
lax.while_loop the compiler can schedule.

The sampler state is an arbitrary pytree (a bare [D] vector is the trivial
case). With per-gene leaves annotated with a `genes`-axis sharding, XLA GSPMD
keeps every leapfrog elementwise op local to its shard and turns the
tree_dot reductions (energy, U-turn tests) into all-reduces — this is how
the gene axis scales across devices without any explicit communication code
(the map_rect/MPI analog in the reference, stan:226-240).

Warmup follows Stan's windowed adaptation: dual-averaged step size
(target accept 0.8) plus a diagonal (Welford) mass matrix adapted over
expanding windows (init=75, term=50, base window=25).

References: Hoffman & Gelman (2014); Betancourt (2017) for multinomial
sampling and the generalized U-turn criterion; the iterative checkpointing
scheme follows Phan et al. (arXiv:1912.11554).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ppcseq.model.params import (
    tree_axpy,
    tree_dot,
    tree_mul,
    tree_normal_like,
    tree_uniform_like,
    tree_where,
)

MAX_DELTA_ENERGY = 1000.0  # Stan's divergence threshold


def _leapfrog(logp_grad, z, r, grad, eps, inv_mass):
    r_half = tree_axpy(0.5 * eps, grad, r)
    z_new = tree_axpy(eps, tree_mul(inv_mass, r_half), z)
    logp_new, grad_new = logp_grad(z_new)
    r_new = tree_axpy(0.5 * eps, grad_new, r_half)
    return z_new, r_new, logp_new, grad_new


def _energy(logp, r, inv_mass):
    return -logp + 0.5 * tree_dot(r, tree_mul(inv_mass, r))


def _is_turning(r_sum, r_first, r_last, inv_mass):
    """Generalized U-turn: rho against velocities at both subtree ends."""
    v_first = tree_mul(inv_mass, r_first)
    v_last = tree_mul(inv_mass, r_last)
    return (tree_dot(r_sum, v_first) <= 0) | (tree_dot(r_sum, v_last) <= 0)


def _leaf_to_ckpt(leaf_idx):
    """Checkpoint slot range for leaf `leaf_idx` (0-based, iterative NUTS)."""
    n = leaf_idx.astype(jnp.uint32)
    idx_max = jax.lax.population_count(n >> 1).astype(jnp.int32)

    def body(c):
        n, t = c
        return n >> 1, t + 1

    _, t = jax.lax.while_loop(lambda c: (c[0] & 1) == 1, body, (n, jnp.int32(0)))
    return idx_max - t + 1, idx_max


def _stack_slots(tree, n):
    """Allocate [n, ...leaf] checkpoint storage for a pytree."""
    return jax.tree.map(lambda x: jnp.zeros((n,) + jnp.shape(x), jnp.asarray(x).dtype), tree)


def _slot_set(slots, idx, tree):
    return jax.tree.map(lambda s, x: s.at[idx].set(x), slots, tree)


def _slot_get(slots, idx):
    return jax.tree.map(lambda s: s[idx], slots)


class _SubtreeCarry(NamedTuple):
    i: jnp.ndarray
    z: Any
    r: Any
    grad: Any
    z_prop: Any
    logp_prop: jnp.ndarray
    grad_prop: Any
    log_weight: jnp.ndarray
    r_sum: Any
    turning: jnp.ndarray
    diverging: jnp.ndarray
    sum_accept: jnp.ndarray
    r_ckpts: Any
    r_sum_ckpts: Any
    key: jnp.ndarray


def _build_subtree(logp_grad, z0, r0, grad0, eps_signed, inv_mass, depth, energy0, key, max_depth):
    """Build a subtree of 2^depth leapfrog steps from (z0, r0) in one direction."""
    n_leaves = jnp.int32(1) << depth
    fdtype = energy0.dtype

    def cond(c: _SubtreeCarry):
        return (c.i < n_leaves) & ~c.turning & ~c.diverging

    def body(c: _SubtreeCarry):
        z, r, logp, grad = _leapfrog(logp_grad, c.z, c.r, c.grad, eps_signed, inv_mass)
        energy = _energy(logp, r, inv_mass)
        delta = energy - energy0
        delta = jnp.where(jnp.isnan(delta), jnp.inf, delta)
        diverging = delta > MAX_DELTA_ENERGY
        log_w = -delta
        accept = jnp.minimum(1.0, jnp.exp(-delta))

        key, k_accept = jax.random.split(c.key)
        new_total = jnp.logaddexp(c.log_weight, log_w)
        p_take = jnp.exp(log_w - new_total)
        take = jax.random.uniform(k_accept) < p_take
        z_prop = tree_where(take, z, c.z_prop)
        logp_prop = jnp.where(take, logp, c.logp_prop)
        grad_prop = tree_where(take, grad, c.grad_prop)

        r_sum = jax.tree.map(jnp.add, c.r_sum, r)

        ckpt_min, ckpt_max = _leaf_to_ckpt(c.i)
        is_even = (c.i % 2) == 0
        r_ckpts = tree_where(is_even, _slot_set(c.r_ckpts, ckpt_max, r), c.r_ckpts)
        r_sum_ckpts = tree_where(
            is_even, _slot_set(c.r_sum_ckpts, ckpt_max, r_sum), c.r_sum_ckpts
        )

        def check_turning(_):
            def scan_body(turning, j):
                rj = _slot_get(r_ckpts, j)
                rsj = _slot_get(r_sum_ckpts, j)
                block_sum = jax.tree.map(lambda a, b, cc: a - b + cc, r_sum, rsj, rj)
                t = _is_turning(block_sum, rj, r, inv_mass)
                in_range = (j >= ckpt_min) & (j <= ckpt_max)
                return turning | (t & in_range), None

            turning, _ = jax.lax.scan(scan_body, jnp.bool_(False), jnp.arange(max_depth + 1))
            return turning

        turning = jax.lax.cond((c.i % 2) == 1, check_turning, lambda _: jnp.bool_(False), None)

        return _SubtreeCarry(
            i=c.i + 1, z=z, r=r, grad=grad,
            z_prop=z_prop, logp_prop=logp_prop, grad_prop=grad_prop,
            log_weight=new_total, r_sum=r_sum,
            turning=turning, diverging=diverging,
            sum_accept=c.sum_accept + accept,
            r_ckpts=r_ckpts, r_sum_ckpts=r_sum_ckpts, key=key,
        )

    init = _SubtreeCarry(
        i=jnp.int32(0), z=z0, r=r0, grad=grad0,
        z_prop=z0, logp_prop=jnp.array(-jnp.inf, fdtype), grad_prop=grad0,
        log_weight=jnp.array(-jnp.inf, fdtype),
        r_sum=jax.tree.map(jnp.zeros_like, r0),
        turning=jnp.bool_(False), diverging=jnp.bool_(False),
        sum_accept=jnp.array(0.0, fdtype),
        r_ckpts=_stack_slots(r0, max_depth + 1),
        r_sum_ckpts=_stack_slots(r0, max_depth + 1),
        key=key,
    )
    return jax.lax.while_loop(cond, body, init)


class _TrajCarry(NamedTuple):
    z_left: Any
    r_left: Any
    grad_left: Any
    z_right: Any
    r_right: Any
    grad_right: Any
    z_prop: Any
    logp_prop: jnp.ndarray
    grad_prop: Any
    depth: jnp.ndarray
    log_weight: jnp.ndarray
    r_sum: Any
    turning: jnp.ndarray
    diverging: jnp.ndarray
    sum_accept: jnp.ndarray
    num_steps: jnp.ndarray
    key: jnp.ndarray


def _nuts_transition(logp_grad, z, logp, grad, eps, inv_mass, key, max_depth):
    """One NUTS draw for one chain. Returns new (z, logp, grad, stats)."""
    key, k_mom, k_build = jax.random.split(key, 3)
    r0 = jax.tree.map(
        lambda n, im: n / jnp.sqrt(im), tree_normal_like(k_mom, z), inv_mass
    )
    energy0 = _energy(logp, r0, inv_mass)

    init = _TrajCarry(
        z_left=z, r_left=r0, grad_left=grad,
        z_right=z, r_right=r0, grad_right=grad,
        z_prop=z, logp_prop=logp, grad_prop=grad,
        depth=jnp.int32(0),
        log_weight=jnp.array(0.0, energy0.dtype),  # initial point: exp(-(H0-H0)) = 1
        r_sum=r0,
        turning=jnp.bool_(False), diverging=jnp.bool_(False),
        sum_accept=jnp.array(0.0, energy0.dtype),
        num_steps=jnp.int32(0), key=k_build,
    )

    def cond(t: _TrajCarry):
        return (t.depth < max_depth) & ~t.turning & ~t.diverging

    def body(t: _TrajCarry):
        key, k_dir, k_sub, k_merge = jax.random.split(t.key, 4)
        go_right = jax.random.uniform(k_dir) < 0.5
        eps_signed = jnp.where(go_right, eps, -eps)
        z0 = tree_where(go_right, t.z_right, t.z_left)
        r0_ = tree_where(go_right, t.r_right, t.r_left)
        g0 = tree_where(go_right, t.grad_right, t.grad_left)

        sub = _build_subtree(
            logp_grad, z0, r0_, g0, eps_signed, inv_mass, t.depth, energy0, k_sub, max_depth
        )

        z_left = tree_where(go_right, t.z_left, sub.z)
        r_left = tree_where(go_right, t.r_left, sub.r)
        grad_left = tree_where(go_right, t.grad_left, sub.grad)
        z_right = tree_where(go_right, sub.z, t.z_right)
        r_right = tree_where(go_right, sub.r, t.r_right)
        grad_right = tree_where(go_right, sub.grad, t.grad_right)

        # biased progressive sampling across the doubling (Stan/Betancourt)
        log_ratio = sub.log_weight - t.log_weight
        p_new = jnp.minimum(1.0, jnp.exp(log_ratio))
        take = (jax.random.uniform(k_merge) < p_new) & ~sub.turning & ~sub.diverging
        z_prop = tree_where(take, sub.z_prop, t.z_prop)
        logp_prop = jnp.where(take, sub.logp_prop, t.logp_prop)
        grad_prop = tree_where(take, sub.grad_prop, t.grad_prop)

        r_sum = jax.tree.map(jnp.add, t.r_sum, sub.r_sum)
        turning = sub.turning | _is_turning(r_sum, r_left, r_right, inv_mass)

        return _TrajCarry(
            z_left=z_left, r_left=r_left, grad_left=grad_left,
            z_right=z_right, r_right=r_right, grad_right=grad_right,
            z_prop=z_prop, logp_prop=logp_prop, grad_prop=grad_prop,
            depth=t.depth + 1,
            log_weight=jnp.logaddexp(t.log_weight, sub.log_weight),
            r_sum=r_sum, turning=turning, diverging=sub.diverging,
            sum_accept=t.sum_accept + sub.sum_accept,
            num_steps=t.num_steps + sub.i, key=key,
        )

    t = jax.lax.while_loop(cond, body, init)

    accept_prob = t.sum_accept / jnp.maximum(1, t.num_steps)
    stats = {
        "accept_prob": accept_prob,
        "diverging": t.diverging,
        "num_steps": t.num_steps,
        "depth": t.depth,
        "energy": energy0,
    }
    return t.z_prop, t.logp_prop, t.grad_prop, stats


# ----------------------------------------------------------------------------
# Warmup adaptation (Stan-style)
# ----------------------------------------------------------------------------


class DualAveragingState(NamedTuple):
    log_eps: jnp.ndarray
    log_eps_avg: jnp.ndarray
    h_sum: jnp.ndarray
    mu: jnp.ndarray
    count: jnp.ndarray


def _da_init(eps0):
    return DualAveragingState(
        log_eps=jnp.log(eps0),
        log_eps_avg=jnp.log(eps0),
        h_sum=jnp.zeros_like(eps0),
        mu=jnp.log(10.0 * eps0),
        count=jnp.zeros((), jnp.int32),
    )


def _da_update(state: DualAveragingState, accept_prob, target=0.8):
    gamma, t0, kappa = 0.05, 10.0, 0.75
    count = state.count + 1
    w = 1.0 / (count + t0)
    h_sum = (1 - w) * state.h_sum + w * (target - accept_prob)
    log_eps = state.mu - jnp.sqrt(count.astype(h_sum.dtype)) / gamma * h_sum
    eta = count.astype(h_sum.dtype) ** (-kappa)
    log_eps_avg = eta * log_eps + (1 - eta) * state.log_eps_avg
    return DualAveragingState(log_eps, log_eps_avg, h_sum, state.mu, count)


class WelfordState(NamedTuple):
    count: jnp.ndarray
    mean: Any
    m2: Any


def _welford_init(proto):
    z = jax.tree.map(jnp.zeros_like, proto)
    return WelfordState(jnp.zeros((), jnp.int32), z, jax.tree.map(jnp.zeros_like, proto))


def _welford_update(state: WelfordState, x):
    count = state.count + 1
    delta = jax.tree.map(jnp.subtract, x, state.mean)
    mean = jax.tree.map(lambda m, d: m + d / count, state.mean, delta)
    m2 = jax.tree.map(
        lambda m2_, d, xi, mi: m2_ + d * (xi - mi), state.m2, delta, x, mean
    )
    return WelfordState(count, mean, m2)


def _welford_variance(state: WelfordState):
    # Stan regularizes the estimate toward unity
    n = state.count.astype(jnp.float32)
    return jax.tree.map(
        lambda m2: ((n / (n + 5.0)) * (m2 / jnp.maximum(n - 1, 1)) + 1e-3 * (5.0 / (n + 5.0))).astype(m2.dtype),
        state.m2,
    )


def build_warmup_schedule(num_warmup, init_buffer=75, term_buffer=50, base_window=25):
    """Stan's windowed schedule: iteration indices where a metric window closes."""
    if num_warmup < 20:
        return [], 0, 0
    if init_buffer + term_buffer + base_window > num_warmup:
        init_buffer = int(0.15 * num_warmup)
        term_buffer = int(0.10 * num_warmup)
        base_window = num_warmup - init_buffer - term_buffer
    ends = []
    pos = init_buffer
    w = base_window
    while pos + w <= num_warmup - term_buffer:
        if pos + 2 * w > num_warmup - term_buffer:
            w = num_warmup - term_buffer - pos
        ends.append(pos + w)
        pos += w
        w *= 2
    return ends, init_buffer, term_buffer


@dataclass
class NUTSResult:
    draws: Any  # stacked pytree [chains, num_draws, ...] (or ndarray for vector states)
    accept_prob: np.ndarray
    divergences: np.ndarray  # [chains] count in sampling phase
    step_size: np.ndarray  # [chains]
    inv_mass: Any  # pytree with [chains, ...] leaves
    num_leapfrog: int  # total leapfrog steps, warmup + sampling


_NUTS_RUNNER_CACHE: dict = {}


def _build_nuts_runners(
    log_density, has_data, num_warmup, num_draws, max_depth, target_accept
):
    """Jitted (warmup, sample) programs with the model data, initial states
    and mass matrix as operands. Cached per (log-density fn, static config)
    by run_nuts, so repeated fits of one model family (the pipeline's two
    passes; retry attempts) reuse one compile — the same contract as
    infer.hmc's _RUNNER_CACHE and infer.advi's _FNS_CACHE."""
    schedule, metric_start, term_buffer = build_warmup_schedule(num_warmup)
    schedule = tuple(schedule)

    def make_logp_grad(data):
        if has_data:
            raw = jax.value_and_grad(lambda z: log_density(z, data))
        else:
            raw = jax.value_and_grad(log_density)

        def logp_grad(z):
            lp, g = raw(z)
            bad = ~jnp.isfinite(lp)
            lp = jnp.where(bad, -jnp.inf, lp)
            g = jax.tree.map(lambda gi: jnp.where(jnp.isfinite(gi), gi, 0.0), g)
            return lp, g

        return logp_grad

    def chain_warmup(data, z, mass0, key):
        logp_grad = make_logp_grad(data)
        proto = z  # per-chain state defines the structure
        dtype = jnp.result_type(*[x.dtype for x in jax.tree.leaves(z)])
        lp, g = logp_grad(z)

        # crude reasonable-epsilon search: first-step accept prob ~ 0.8
        def find_eps(eps, _):
            r = jax.tree.map(
                lambda n, im: n / jnp.sqrt(im), tree_normal_like(jax.random.fold_in(key, 7), proto), mass0
            )
            e0 = _energy(lp, r, mass0)
            _, r1, lp1, _ = _leapfrog(logp_grad, z, r, g, eps, mass0)
            e1 = _energy(lp1, r1, mass0)
            delta = e0 - e1
            delta = jnp.where(jnp.isnan(delta), -jnp.inf, delta)
            return jnp.where(delta > jnp.log(0.8), eps * 2.0, eps * 0.5), None

        eps0, _ = jax.lax.scan(find_eps, jnp.asarray(0.1, dtype), None, length=8)
        eps0 = jnp.clip(eps0, 1e-6, 10.0)

        da = _da_init(eps0)
        wf = _welford_init(proto)
        inv_mass = mass0

        def warmup_step(carry, args):
            z, lp, g, da, wf, inv_mass, key = carry
            i, is_window_end = args
            key, k = jax.random.split(key)
            eps = jnp.exp(da.log_eps)
            z, lp, g, stats = _nuts_transition(logp_grad, z, lp, g, eps, inv_mass, k, max_depth)
            da = _da_update(da, stats["accept_prob"], target_accept)
            in_metric_phase = (i >= metric_start) & (i < num_warmup - term_buffer)
            wf = jax.lax.cond(in_metric_phase, lambda w: _welford_update(w, z), lambda w: w, wf)

            def close_window(args):
                da, wf, inv_mass = args
                new_inv_mass = _welford_variance(wf)
                new_da = _da_init(jnp.exp(da.log_eps))
                return new_da, _welford_init(proto), new_inv_mass

            da, wf, inv_mass = jax.lax.cond(
                is_window_end, close_window, lambda a: a, (da, wf, inv_mass)
            )
            return (z, lp, g, da, wf, inv_mass, key), stats["num_steps"]

        idx = jnp.arange(num_warmup)
        window_end = np.zeros(num_warmup, bool)
        for e in schedule:
            window_end[e - 1] = True
        window_end = jnp.asarray(window_end)
        (z, lp, g, da, wf, inv_mass, key), steps = jax.lax.scan(
            warmup_step, (z, lp, g, da, wf, inv_mass, key), (idx, window_end)
        )
        eps_final = jnp.exp(da.log_eps_avg)
        return z, lp, g, eps_final, inv_mass, jnp.sum(steps)

    def chain_sample(data, z, lp, g, eps, inv_mass, key):
        logp_grad = make_logp_grad(data)

        def step(carry, k):
            z, lp, g = carry
            z, lp, g, stats = _nuts_transition(logp_grad, z, lp, g, eps, inv_mass, k, max_depth)
            return (z, lp, g), (z, stats["accept_prob"], stats["diverging"], stats["num_steps"])

        keys = jax.random.split(key, num_draws)
        (_, _, _), (draws, accept, div, steps) = jax.lax.scan(step, (z, lp, g), keys)
        return draws, accept, div, jnp.sum(steps)

    warm = jax.jit(jax.vmap(chain_warmup, in_axes=(None, 0, None, 0)))
    samp = jax.jit(jax.vmap(chain_sample, in_axes=(None, 0, 0, 0, 0, 0, 0)))
    return warm, samp


def run_nuts(
    log_density,
    prototype,
    key,
    *,
    data=None,
    num_chains: int = 4,
    num_warmup: int = 150,
    num_draws: int = 250,
    max_depth: int = 10,
    target_accept: float = 0.8,
    init_theta=None,
    init_scale: float = 2.0,
    init_jitter: float = 0.1,
    inv_mass_init=None,
    mesh=None,
    dims=None,
    dtype=jnp.float32,
) -> NUTSResult:
    """Run vectorized multi-chain NUTS; returns post-warmup draws.

    `prototype` defines the state structure: an int D (flat vector state), an
    example array, or an example pytree. Chains are vmapped: one compiled
    program advances all chains in lockstep (the reference forks one OS
    process per chain, R/utilities.R:1497-1502).

    With `data` given, `log_density(theta, data)` is used and the compiled
    warmup/sampling programs are cached per (log-density fn, static config)
    with the data as a jit operand — pass a stable fn (e.g.
    nb_model.flat_logp(dims)) so repeated fits share one compile.
    """
    if isinstance(prototype, int):
        prototype = jnp.zeros(prototype, dtype)
    proto = jax.tree.map(lambda x: jnp.asarray(x, dtype), prototype)

    key, k_init = jax.random.split(key)
    chain_keys = jax.random.split(key, num_chains)
    init_keys = jax.random.split(k_init, num_chains)

    if init_theta is None:
        z0 = jax.vmap(lambda k: tree_uniform_like(k, proto, -init_scale, init_scale))(init_keys)
    else:
        base = jax.tree.map(lambda x: jnp.asarray(x, dtype), init_theta)
        z0 = jax.vmap(
            lambda k: tree_axpy(init_jitter, tree_normal_like(k, base), base)
        )(init_keys)

    mass0 = (
        jax.tree.map(lambda x: jnp.asarray(x, dtype), inv_mass_init)
        if inv_mass_init is not None
        else jax.tree.map(jnp.ones_like, proto)
    )

    if mesh is not None and dims is not None and isinstance(proto, dict):
        # gene-sharded (optionally 2-D chain x gene) NUTS over a pytree
        # state — the map_rect analog (stan:226-240) at sampler granularity:
        # per-gene leaves/data shard over the `genes` axis and the chain
        # batch shards over a `chains` axis when the mesh names one (same
        # layout contract as run_hmc_tree, parallel/sharding.py).
        from jax.sharding import NamedSharding, PartitionSpec as P

        from ppcseq.parallel.sharding import (
            param_shardings,
            shard_data,
            shard_params,
        )

        chain_ax = "chains" if "chains" in mesh.axis_names else True
        state_sh = param_shardings(mesh, dims, chain_axis=chain_ax)
        z0 = {k: jax.device_put(v, state_sh[k]) for k, v in z0.items()}
        mass0 = shard_params(mass0, mesh, dims)
        key_sh = NamedSharding(mesh, P("chains") if chain_ax == "chains" else P())
        chain_keys = jax.device_put(chain_keys, key_sh)
        if data is not None:
            data = shard_data(data, mesh)
    elif mesh is not None:
        # chain-sharded NUTS (mesh must name a "chains" axis): the vmapped
        # chain batch is split across devices, data/mass replicated — the
        # analog of the reference's chain-per-process parallelism
        # (R/utilities.R:1497-1502); no cross-device collective is needed
        # because chains are independent.
        from jax.sharding import NamedSharding, PartitionSpec as P

        chain_sh = NamedSharding(mesh, P("chains"))
        rep = NamedSharding(mesh, P())
        z0 = jax.tree.map(lambda x: jax.device_put(x, chain_sh), z0)
        chain_keys = jax.device_put(chain_keys, chain_sh)
        mass0 = jax.tree.map(lambda x: jax.device_put(x, rep), mass0)
        if data is not None:
            data = jax.tree.map(lambda x: jax.device_put(x, rep), data)

    cache_key = (
        log_density, data is not None, num_warmup, num_draws,
        int(max_depth), float(target_accept),
    )
    runners = _NUTS_RUNNER_CACHE.get(cache_key)
    if runners is None:
        runners = _build_nuts_runners(
            log_density, data is not None, num_warmup, num_draws,
            int(max_depth), float(target_accept),
        )
        _NUTS_RUNNER_CACHE[cache_key] = runners
    warm, samp = runners

    z, lp, g, eps, inv_mass, warm_steps = warm(data, z0, mass0, chain_keys)
    keys2 = jax.vmap(lambda k: jax.random.fold_in(k, 1))(chain_keys)
    draws, accept, div, samp_steps = samp(data, z, lp, g, eps, inv_mass, keys2)

    # draws stay on device (see infer/hmc.py): PPC consumes them there.
    is_tree = not isinstance(draws, jnp.ndarray)
    return NUTSResult(
        draws=draws,
        accept_prob=np.asarray(accept),
        divergences=np.asarray(div.sum(axis=1)),
        step_size=np.asarray(eps),
        inv_mass=inv_mass if is_tree else np.asarray(inv_mass),
        num_leapfrog=int(np.asarray(warm_steps).sum() + np.asarray(samp_steps).sum()),
    )
