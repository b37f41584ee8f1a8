"""Phase-level profiling of the bench configuration on the accelerator.

Times ADVI warm start, NUTS warmup, and NUTS sampling separately, at several
chain counts / warmup lengths, to locate the draws/sec ceiling.
"""

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import jax.numpy as jnp
import numpy as np

from ppcseq import load_counts
from ppcseq.data import ingest
from ppcseq.formula.design import create_design_matrix
from ppcseq.infer.advi import fit_advi
from ppcseq.infer.nuts import run_nuts
from ppcseq.model import nb_model
from ppcseq.model.params import zeros_tree
from ppcseq.norm.tmm import sample_scaling


def setup():
    counts = load_counts()
    counts["is_significant"] = counts.FDR < 0.01
    work = counts.assign(do_check___=counts.is_significant)
    my_df = ingest.format_input(
        work, "~ Label", "sample", "symbol", "value", "do_check___", "PValue", 500
    )
    X, _, xr = create_design_matrix(my_df, "~ Label", "sample")
    scal = sample_scaling(my_df, "sample", "symbol", "value")
    md = ingest.build_model_data(
        my_df, "sample", "symbol", "value", "do_check___",
        X, list(xr["sample"]), dict(zip(scal["sample"], scal.exposure_rate)),
    )
    data, dims = nb_model.prepare_data(
        md.counts, md.X, md.exposure_rate, md.n_check, dtype=jnp.float32
    )
    return data, dims


def main():
    data, dims = setup()
    log_density = nb_model.make_log_density(data, dims, tree=True)
    init = nb_model.smart_init(data, dims, as_tree=True)
    proto = zeros_tree(dims)

    t0 = time.time()
    warm = fit_advi(
        log_density, proto, jax.random.PRNGKey(8),
        init_mean=init, tol_rel_obj=0.01, learning_rate=0.2,
    )
    jax.block_until_ready(warm.mean)
    t_advi_compile = time.time() - t0

    t0 = time.time()
    warm = fit_advi(
        log_density, proto, jax.random.PRNGKey(9),
        init_mean=init, tol_rel_obj=0.01, learning_rate=0.2,
    )
    jax.block_until_ready(warm.mean)
    t_advi = time.time() - t0
    inv_mass = jax.tree.map(lambda ls: jnp.exp(2.0 * ls), warm.log_sd)
    print(
        f"ADVI: compile+run {t_advi_compile:.1f}s, run {t_advi:.1f}s, iters={warm.iterations}",
        flush=True,
    )

    total_target = 10500
    import sys as _sys

    configs = [
        (128, 75, 10),
        (256, 75, 8),
        (512, 50, 8),
    ]
    if len(_sys.argv) > 1:
        configs = [tuple(int(x) for x in a.split(",")) for a in _sys.argv[1:]]
    for num_chains, num_warmup, max_depth in configs:
        per_chain = -(-total_target // num_chains)
        # compile warm-up run
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
            f"chains={num_chains:4d} warmup={num_warmup:3d} depth={max_depth:2d}: "
            f"{elapsed:6.2f}s {total/elapsed:8.1f} draws/s "
            f"leapfrog={r.num_leapfrog} ({r.num_leapfrog/elapsed:9.0f}/s) "
            f"div={r.divergences.sum()} acc={r.accept_prob.mean():.3f}",
            flush=True,
        )


if __name__ == "__main__":
    main()
