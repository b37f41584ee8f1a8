"""Leapfrog cost of autodiff vs analytic-VJP likelihood gradients.

Times N sequential leapfrogs (the serial core of HMC/NUTS) on the bench
model (counts 15-gene + 500 controls) for each likelihood implementation:
- plain:     stable-lpmf forward, autodiff backward
- delta:     delta-form forward, autodiff backward       (round-2 default)
- analytic:  same forwards, closed-form custom-VJP backward (ops/nb_grad)
- fast:      hoisted one-pass value+gradient (ops/nb_fast)

`python chip_smoke.py` times the same variants at both real widths in one
process; its table decides nb_model._resolve_auto.
"""

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, os.path.dirname(__file__))

import jax
import jax.numpy as jnp

from ppcseq.model import nb_model
from profile_bench import setup

N_STEPS = 512


def time_scan(logp, data, theta0, num_chains):
    z = jnp.tile(theta0[None, :], (num_chains, 1))
    eps = jnp.asarray(1e-3, jnp.float32)

    @jax.jit
    def run(z, data):
        def vg(zz):
            return jax.vmap(jax.value_and_grad(logp), in_axes=(0, None))(zz, data)

        def step(carry, _):
            z, g = carry
            z1 = z + eps * g
            lp, g1 = vg(z1)
            return (z1, g1), lp

        _, g0 = vg(z)
        (zf, _), lps = jax.lax.scan(step, (z, g0), None, length=N_STEPS)
        return zf, lps

    zf, _ = run(z, data)
    jax.block_until_ready(zf)
    t0 = time.time()
    zf, _ = run(z, data)
    jax.block_until_ready(zf)
    return (time.time() - t0) / N_STEPS


def main():
    data, dims = setup()
    data_base = nb_model.with_baseline(data, dims)
    theta0 = jnp.asarray(nb_model.smart_init(data, dims), jnp.float32)

    variants = [
        ("plain-autodiff ", nb_model.flat_logp(dims, "plain"), data),
        ("delta-autodiff ", nb_model.flat_logp(dims, "plain"), data_base),
        ("plain-analytic ", nb_model.flat_logp(dims, "analytic"), data),
        ("delta-analytic ", nb_model.flat_logp(dims, "analytic"), data_base),
        ("delta-fusedXLA ", nb_model.flat_logp(dims, "fused"), data_base),
        ("plain-fast     ", nb_model.flat_logp(dims, "fast"), data),
        ("delta-fast     ", nb_model.flat_logp(dims, "fast"), data_base),
    ]

    for chains in (128, 512):
        print(f"--- chains={chains} ---")
        for name, logp, d in variants:
            dt = time_scan(logp, d, theta0, chains)
            print(f"{name}: {dt*1e6:8.1f} us/leapfrog ({chains/dt:12.0f} chain-lf/s)")


if __name__ == "__main__":
    main()
