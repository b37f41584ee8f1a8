"""Tune the ADVI warm start's wall time (it gates end-to-end bench)."""

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, os.path.dirname(__file__))

import jax
import jax.numpy as jnp
import numpy as np

from ppcseq.infer.advi import fit_advi
from ppcseq.infer.hmc import run_hmc
from ppcseq.model import nb_model
from profile_bench import setup


def main():
    data, dims = setup()
    logp = nb_model.flat_logp(dims)
    init = jnp.asarray(nb_model.smart_init(data, dims), jnp.float32)

    configs = [
        dict(eval_every=100, learning_rate=0.2, grad_samples=1, tol_rel_obj=0.01),
        dict(eval_every=50, learning_rate=0.2, grad_samples=1, tol_rel_obj=0.01),
        dict(eval_every=50, learning_rate=0.3, grad_samples=4, tol_rel_obj=0.01),
        dict(eval_every=25, learning_rate=0.4, grad_samples=8, tol_rel_obj=0.02),
    ]
    for cfg in configs:
        # compile pass
        r = fit_advi(logp, dims.dim, jax.random.PRNGKey(5), data=data, init_mean=init, **cfg)
        t0 = time.time()
        r = fit_advi(logp, dims.dim, jax.random.PRNGKey(6), data=data, init_mean=init, **cfg)
        t_advi = time.time() - t0
        # quality probe: run a short HMC with the resulting mass matrix
        inv_mass = np.exp(2.0 * np.asarray(r.log_sd))
        h = run_hmc(
            logp, dims.dim, jax.random.PRNGKey(7), data=data,
            num_chains=128, num_warmup=50, num_draws=20, num_leapfrog=32,
            init_theta=r.mean, inv_mass=inv_mass,
        )
        t0 = time.time()
        h = run_hmc(
            logp, dims.dim, jax.random.PRNGKey(8), data=data,
            num_chains=128, num_warmup=50, num_draws=20, num_leapfrog=32,
            init_theta=r.mean, inv_mass=inv_mass,
        )
        t_hmc = time.time() - t0
        print(
            f"{cfg}: advi {t_advi:5.2f}s iters={r.iterations:4d} elbo={r.elbo:12.1f} | "
            f"hmc50+20 {t_hmc:.2f}s eps={h.step_size:.3f} acc={h.accept_prob.mean():.3f} "
            f"div={h.divergences.sum()}",
            flush=True,
        )


if __name__ == "__main__":
    main()
