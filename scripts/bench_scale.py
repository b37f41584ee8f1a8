"""Production-scale single-chip benchmark: 50k genes x 100 samples.

The reference's map_rect sharding exists to scale the gene axis across CPU
threads/MPI ranks; this measures the one-card equivalent at the BASELINE.json
synthetic-cohort scale (5M data points, ~100k unconstrained dims) with the
flagship jittered-HMC path on ONE chip. Draw budget = the approximated-CI
analysis path's 1000 practical draws (R/utilities.R:1372).

Reports the roofline utilization (utils/roofline: XLA-counted flops/bytes of
the batched logp+gradient x executed leapfrogs) alongside raw throughput,
so "fast" has an absolute meaning against the card's f32/HBM ceilings.

Usage:
  python scripts/bench_scale.py [--genes 50000] [--samples 100] [--chains 8]
      [--likelihood auto|plain|analytic|fused|fast]
      [--no-baseline]   # skip delta-form baseline constants
      [--cpu]           # without it, the script fails when no GPU is present
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np


def main(n_genes=50000, n_samples=100, chains=8, likelihood="auto", baseline=True, cpu=False):
    from ppcseq.utils import device

    if cpu:
        device.force_cpu()
    import jax
    import jax.numpy as jnp

    dev_info = device.describe(cpu=cpu)
    from ppcseq.infer.advi import fit_advi
    from ppcseq.infer.hmc import run_hmc
    from ppcseq.model import nb_model
    from ppcseq.utils.roofline import cost_of, utilization
    from ppcseq.utils.synthetic import synthetic_cohort

    counts, X, exposure, _ = synthetic_cohort(n_genes, n_samples, n_check=100, seed=0)
    data, dims = nb_model.prepare_data(counts, X, exposure, 100, dtype=jnp.float32)
    if baseline:
        data = nb_model.with_baseline(data, dims)
    logp = nb_model.flat_logp(dims, likelihood)
    init = jnp.asarray(nb_model.smart_init(data, dims), jnp.float32)
    print(f"dims: S={dims.S} G={dims.G} D={dims.dim} likelihood={likelihood} "
          f"baseline={baseline}", flush=True)

    t0 = time.time()
    warm = fit_advi(
        logp, dims.dim, jax.random.PRNGKey(7), data=data,
        init_mean=init, tol_rel_obj=0.01, learning_rate=0.3,
        eval_every=50, grad_samples=4,
    )
    t_advi_cold = time.time() - t0
    inv_mass = np.exp(2.0 * np.asarray(warm.log_sd))
    print(f"ADVI cold {t_advi_cold:.1f}s iters={warm.iterations}", flush=True)

    per_chain = -(-1000 // chains)
    kw = dict(
        num_chains=chains, num_warmup=100, num_draws=per_chain, num_leapfrog=32,
        init_theta=warm.mean, inv_mass=inv_mass,
    )
    r = run_hmc(logp, dims.dim, jax.random.PRNGKey(1), data=data, **kw)
    t0 = time.time()
    r = run_hmc(logp, dims.dim, jax.random.PRNGKey(2), data=data, **kw)
    elapsed = time.time() - t0
    total = chains * per_chain

    z_batch = jnp.tile(jnp.asarray(warm.mean, jnp.float32)[None, :], (chains, 1))
    hot = cost_of(
        lambda z, d: jax.vmap(jax.value_and_grad(logp), in_axes=(0, None))(z, d),
        z_batch, data,
    )
    batched_lf = r.num_leapfrog / chains
    util = {} if cpu else utilization(
        None if hot["flops"] is None else hot["flops"] * batched_lf / elapsed,
        None if hot["bytes"] is None else hot["bytes"] * batched_lf / elapsed,
        jax.devices()[0],
    )

    print(json.dumps({
        "metric": f"draws_per_sec_1chip_synthetic_{n_genes}x{n_samples}",
        "value": round(total / elapsed, 1),
        "unit": "draws/s",
        "detail": {
            "elapsed_s": round(elapsed, 2),
            "chains": chains,
            "likelihood": likelihood,
            "delta_baseline": baseline,
            "total_draws": total,
            "nb_point_grads_per_sec": round(
                r.num_leapfrog / elapsed * n_genes * n_samples, 0
            ),
            "leapfrogs_per_sec": round(r.num_leapfrog / elapsed, 1),
            "divergences": int(r.divergences.sum()),
            "mean_accept": round(float(r.accept_prob.mean()), 3),
            **dev_info,
            **util,
        },
    }), flush=True)


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--genes", type=int, default=50000)
    ap.add_argument("--samples", type=int, default=100)
    ap.add_argument("--chains", type=int, default=8)
    ap.add_argument("--likelihood", default="auto")
    ap.add_argument("--no-baseline", action="store_true")
    ap.add_argument("--cpu", action="store_true", help="measure the CPU backend")
    a = ap.parse_args()
    main(a.genes, a.samples, a.chains, a.likelihood, not a.no_baseline, a.cpu)
