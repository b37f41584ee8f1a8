"""Sweep the PIPELINE's HMC config at the pipeline's own budget.

The pipeline's MCMC fits run 128 chains x ceil(1000/128)=8 draws/chain
(the approximate-analysis budget, identify.py; reference
R/utilities.R:1372) with K.HMC_WARMUP / K.HMC_LEAPFROG — constants that
were previously picked at the BENCH budget (10.5k draws, L=48,
scripts/sweep_hmc.py) and never re-swept at the pipeline's. At 8 draws/chain
rhat/ESS cannot catch step-size under-adaptation, so the quality metric
here is direct: posterior-mean bias of the call-driving block
(6 hyperparameters + the 15 slopes) against a long reference fit, in
units of the reference posterior sd, across seeds.

    python scripts/sweep_pipeline_hmc.py [--json OUT.json]

Runs on JAX's default backend; pass --cpu to validate the harness.
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
    ap.add_argument("--json", default=None)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--warmups", default="30,60")
    ap.add_argument("--leapfrogs", default="16,24,32,48")
    ap.add_argument("--seeds", type=int, default=3)
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
    from ppcseq.infer.hmc import run_hmc
    from ppcseq.model import nb_model
    from ppcseq.norm.tmm import sample_scaling

    # the pipeline's own pass-1 model data: bundled cohort, FDR<0.01 genes
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
    data = nb_model.with_baseline(data, dims)
    logp = nb_model.flat_logp(dims)
    init = jnp.asarray(nb_model.smart_init(data, dims), jnp.float32)

    # the pipeline's ADVI warm start (identify.py)
    warm = fit_advi(
        logp, dims.dim, jax.random.PRNGKey(99), data=data,
        init_mean=init, tol_rel_obj=0.01, learning_rate=0.3,
        eval_every=50, grad_samples=4,
    )
    inv_mass = np.exp(2.0 * np.asarray(warm.log_sd))
    sel = np.r_[0:6, 6 + 2 * dims.G : 6 + 2 * dims.G + dims.n_check]

    # long reference fit: 128 chains x 60 draws, warmup 100, L=48
    ref = run_hmc(
        logp, dims.dim, jax.random.PRNGKey(1234), data=data,
        num_chains=128, num_warmup=100, num_draws=60, num_leapfrog=48,
        init_theta=warm.mean, inv_mass=inv_mass,
    )
    blk = np.asarray(ref.draws[:, :, sel])  # [chains, draws, B]
    ref_mean = blk.mean(axis=(0, 1))
    ref_sd = blk.std(axis=(0, 1)) + 1e-8
    # MC error of a 1024-draw estimate of those means, in sd units: at 8
    # draws/chain draws are near-independent across 128 chains
    mc_z = 1.0 / np.sqrt(1024 / 8)  # ~0.09 per-chain-mean sd units (loose)

    chains, per_chain = 128, 8
    results = []
    for warmup in (int(w) for w in args.warmups.split(",")):
        for L in (int(l) for l in args.leapfrogs.split(",")):
            zs, walls, accepts, divs = [], [], [], 0
            for seed in range(args.seeds):
                def go():
                    return run_hmc(
                        logp, dims.dim, jax.random.PRNGKey(7 * seed + 5), data=data,
                        num_chains=chains, num_warmup=warmup, num_draws=per_chain,
                        num_leapfrog=L, init_theta=warm.mean, inv_mass=inv_mass,
                    )

                if seed == 0:
                    _ = go()  # compile
                t0 = time.time()
                r = go()
                walls.append(time.time() - t0)
                b = np.asarray(r.draws[:, :, sel])
                z = np.abs(b.mean(axis=(0, 1)) - ref_mean) / ref_sd
                zs.append(float(z.max()))
                accepts.append(float(r.accept_prob.mean()))
                divs += int(r.divergences.sum())
            rec = {
                "warmup": warmup, "L": L,
                "chains": chains, "per_chain": per_chain,
                "wall_s_median": round(float(np.median(walls)), 3),
                "draws_per_sec": round(chains * per_chain / float(np.median(walls)), 1),
                "max_bias_z": round(float(np.max(zs)), 3),
                "median_bias_z": round(float(np.median(zs)), 3),
                "accept": round(float(np.mean(accepts)), 3),
                "divergences": divs,
            }
            results.append(rec)
            print(json.dumps(rec), flush=True)

    # decision: configs whose worst-seed bias stays within ~4x the MC error
    # of the estimate itself are statistically indistinguishable from the
    # reference; among those, fastest wins
    ok = [r for r in results if r["max_bias_z"] < 4 * mc_z and r["divergences"] == 0]
    pick = min(ok, key=lambda r: r["wall_s_median"]) if ok else None
    print("\nranked by wall (bias-acceptable in *):")
    for r in sorted(results, key=lambda r: r["wall_s_median"]):
        star = "*" if r in ok else " "
        print(f" {star} w{r['warmup']:3d} L{r['L']:3d}: {r['wall_s_median']*1e3:7.0f} ms  "
              f"bias_z max {r['max_bias_z']:.3f}  acc {r['accept']:.2f}  div {r['divergences']}")
    out = {
        "what": ("pipeline-budget HMC sweep (128 chains x 8 draws, ADVI warm "
                 "start, bundled 15-gene pass-1 data): posterior-mean bias of "
                 "the call-driving block vs a 128x60 w100 L48 reference fit, "
                 f"{args.seeds} seeds per config"),
        "script": "scripts/sweep_pipeline_hmc.py",
        "platform": jax.default_backend(),
        "mc_z_threshold": round(4 * mc_z, 3),
        "reference": {"chains": 128, "warmup": 100, "draws": 60, "L": 48},
        "rows": results,
        "pick": pick,
    }
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
        print(f"wrote {args.json}")


if __name__ == "__main__":
    main()
