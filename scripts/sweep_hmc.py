"""Config sweep for the flagship bench workload on the accelerator.

Sweeps (chains, warmup, leapfrog) for the jittered-HMC bench configuration
and reports draws/s, leapfrogs/s, min-ESS/s and rhat for each point — the
evidence base for picking bench.py's configuration. One compile run and
one timed run per config.

    python scripts/sweep_hmc.py [--configs "128,60,32 256,60,32 ..."]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument(
        "--configs",
        default="128,60,32 256,60,32 256,48,32 256,60,24 512,60,32 512,48,24",
        help="space-separated chains,warmup,leapfrog triples",
    )
    ap.add_argument("--draws", type=int, default=10500, help="total draw budget")
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()

    if args.cpu:
        os.environ["JAX_PLATFORMS"] = "cpu"
        import jax

        jax.config.update("jax_platforms", "cpu")

    import jax
    import jax.numpy as jnp

    from ppcseq import load_counts
    from ppcseq.data import ingest
    from ppcseq.formula.design import create_design_matrix
    from ppcseq.infer.advi import fit_advi
    from ppcseq.infer.diagnostics import summarize as diag_summarize
    from ppcseq.infer.hmc import run_hmc
    from ppcseq.model import nb_model
    from ppcseq.norm.tmm import sample_scaling

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
    logp = nb_model.flat_logp(dims)
    init = jnp.asarray(nb_model.smart_init(data, dims), jnp.float32)

    warm = fit_advi(
        logp, dims.dim, jax.random.PRNGKey(7), data=data,
        init_mean=init, tol_rel_obj=0.01, learning_rate=0.3,
        eval_every=50, grad_samples=4,
    )
    inv_mass = np.exp(2.0 * np.asarray(warm.log_sd))
    sel = np.r_[0:6, 6 + 2 * dims.G : 6 + 2 * dims.G + dims.n_check]

    results = []
    for spec in args.configs.split():
        chains, warmup, leapfrog = (int(x) for x in spec.split(","))
        per_chain = int(np.ceil(args.draws / chains))
        total = chains * per_chain

        def go(seed):
            return run_hmc(
                logp, dims.dim, jax.random.PRNGKey(seed), data=data,
                num_chains=chains, num_warmup=warmup, num_draws=per_chain,
                num_leapfrog=leapfrog, init_theta=warm.mean, inv_mass=inv_mass,
            )

        _ = go(1)  # compile
        t0 = time.time()
        r = go(0)
        dt = time.time() - t0
        diag = diag_summarize(r.draws[:, :, sel])
        rec = {
            "chains": chains, "warmup": warmup, "leapfrog": leapfrog,
            "per_chain": per_chain, "total_draws": total,
            "elapsed_s": round(dt, 2),
            "draws_per_sec": round(total / dt, 1),
            "leapfrogs_per_sec": round(r.num_leapfrog / dt, 1),
            "ess_min": round(diag["ess_min"], 0),
            "ess_per_sec": round(diag["ess_min"] / dt, 1),
            "rhat_max": round(diag["rhat_max"], 3),
            "div_frac": round(float(r.divergences.sum()) / total, 5),
            "accept": round(float(r.accept_prob.mean()), 3),
        }
        results.append(rec)
        print(json.dumps(rec), flush=True)

    results.sort(key=lambda r: -r["ess_per_sec"])
    print("\nranked by ess/s:")
    for r in results:
        print(f"  {r['chains']:4d}ch x{r['per_chain']:3d} w{r['warmup']} L{r['leapfrog']}: "
              f"{r['draws_per_sec']:8.1f} draws/s  {r['ess_per_sec']:7.1f} ess/s  "
              f"rhat {r['rhat_max']:.3f}")


if __name__ == "__main__":
    main()
