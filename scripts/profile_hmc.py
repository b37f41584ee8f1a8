"""Time jittered HMC on the bench model (counts, G=515) on the accelerator."""

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
    log_density = nb_model.make_log_density(data, dims)  # flat state
    init = nb_model.smart_init(data, dims)
    D = dims.dim

    t0 = time.time()
    warm = fit_advi(
        log_density, D, jax.random.PRNGKey(8),
        init_mean=jnp.asarray(init, jnp.float32), tol_rel_obj=0.01, learning_rate=0.2,
    )
    t_advi = time.time() - t0
    inv_mass = np.exp(2.0 * warm.log_sd)
    print(f"ADVI {t_advi:.1f}s iters={warm.iterations}", flush=True)

    total_target = 10500
    for num_chains, num_warmup, L in [
        (128, 100, 32),
        (128, 100, 64),
        (256, 100, 32),
        (512, 75, 32),
        (1024, 75, 16),
    ]:
        per_chain = -(-total_target // num_chains)
        kw = dict(
            num_chains=num_chains, num_warmup=num_warmup, num_draws=per_chain,
            num_leapfrog=L, init_theta=warm.mean, inv_mass=inv_mass,
        )
        r = run_hmc(log_density, D, jax.random.PRNGKey(1), **kw)
        t0 = time.time()
        r = run_hmc(log_density, D, jax.random.PRNGKey(2), **kw)
        elapsed = time.time() - t0
        total = num_chains * per_chain
        # crude ESS proxy: lag-1 autocorr of logp-ish first coordinate
        x = r.draws[:, :, 6]  # first intercept coordinate
        xc = x - x.mean(axis=1, keepdims=True)
        ac1 = (xc[:, 1:] * xc[:, :-1]).sum() / np.maximum((xc * xc).sum(), 1e-9)
        print(
            f"chains={num_chains:4d} warmup={num_warmup:3d} L={L:3d}: "
            f"{elapsed:6.2f}s {total/elapsed:8.1f} draws/s "
            f"lf={r.num_leapfrog} ({r.num_leapfrog/elapsed:9.0f}/s) "
            f"eps={r.step_size:.3f} div={r.divergences.sum()} "
            f"acc={r.accept_prob.mean():.3f} lag1={ac1:.3f}",
            flush=True,
        )


if __name__ == "__main__":
    main()
