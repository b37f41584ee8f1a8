"""Compare per-leapfrog latency: pytree state vs flat [D] vector state.

The NUTS inner loop does ~10 pytree-leaf ops per leapfrog; with a flat
vector each becomes ONE vector op. This measures the end-to-end NUTS
draws/sec difference on the bench configuration.
"""

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, os.path.dirname(__file__))

import jax
import jax.numpy as jnp
import numpy as np

from ppcseq.infer.advi import fit_advi
from ppcseq.infer.nuts import run_nuts
from ppcseq.model import nb_model
from ppcseq.model.params import zeros_tree
from profile_bench import setup


def main():
    data, dims = setup()
    total_target = 10500

    for mode in ["flat", "tree"]:
        tree = mode == "tree"
        log_density = nb_model.make_log_density(data, dims, tree=tree)
        init = nb_model.smart_init(data, dims, as_tree=tree)
        proto = zeros_tree(dims) if tree else dims.dim

        t0 = time.time()
        warm = fit_advi(
            log_density, proto, jax.random.PRNGKey(8),
            init_mean=init, tol_rel_obj=0.01, learning_rate=0.2,
        )
        jax.block_until_ready(jax.tree.leaves(warm.mean)[0])
        t_advi = time.time() - t0
        inv_mass = jax.tree.map(lambda ls: jnp.exp(2.0 * ls), warm.log_sd)

        for num_chains, num_warmup, max_depth in [(32, 150, 10), (64, 75, 9)]:
            per_chain = -(-total_target // num_chains)
            r = run_nuts(
                log_density, proto, jax.random.PRNGKey(1),
                num_chains=num_chains, num_warmup=num_warmup, num_draws=per_chain,
                max_depth=max_depth, init_theta=warm.mean, inv_mass_init=inv_mass,
            )
            t0 = time.time()
            r = run_nuts(
                log_density, proto, jax.random.PRNGKey(2),
                num_chains=num_chains, num_warmup=num_warmup, num_draws=per_chain,
                max_depth=max_depth, init_theta=warm.mean, inv_mass_init=inv_mass,
            )
            elapsed = time.time() - t0
            total = num_chains * per_chain
            print(
                f"{mode:4s} chains={num_chains:3d} warmup={num_warmup:3d} depth={max_depth}: "
                f"{elapsed:6.2f}s {total/elapsed:8.1f} draws/s "
                f"lf={r.num_leapfrog} ({r.num_leapfrog/elapsed:8.0f}/s) "
                f"div={r.divergences.sum()} acc={r.accept_prob.mean():.3f} "
                f"(advi {t_advi:.1f}s)",
                flush=True,
            )


if __name__ == "__main__":
    main()
