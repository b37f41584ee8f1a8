"""Measured CPU baseline proxy for bench.py (replaces the round-1 estimate).

The reference publishes no throughput numbers (BASELINE.md), so round 1
compared against a hand-derived "8-thread Stan NUTS ~= 50 draws/s" constant.
This script replaces the guess with a measurement: it runs THIS repo's own
dynamic-tree NUTS — the same sampler family and model as rstan's — on the
bench configuration (515-gene README subset of `counts`) on the host CPU,
with Stan's own run shape (4 chains, 150 warmup, max_depth 10), and records
draws/s and min-ESS/s. If the host has fewer than 8 cores the 8-thread
figure is extrapolated linearly (generous to the baseline: XLA's CPU backend
already multithreads one chain's gene axis, so perfect linear chain scaling
over 8 threads is an upper bound on what Stan map_rect/TBB achieves).

Writes BASELINE_MEASURED.json, which bench.py picks up for `vs_baseline`.

    JAX_PLATFORMS=cpu python scripts/baseline_cpu.py
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

os.environ.setdefault("JAX_PLATFORMS", "cpu")


def main():
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from ppcseq import load_counts
    from ppcseq.data import ingest
    from ppcseq.formula.design import create_design_matrix
    from ppcseq.infer.diagnostics import summarize as diag_summarize
    from ppcseq.infer.nuts import run_nuts
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

    # Stan's run shape for the pFP=1% detrimental case: chains=4 minimizes
    # draws/chains + 150*chains at ~10.5k draws... argmin is ~8; Stan clamps
    # to [3, cores]. Use 4 chains / 150 warmup / max_depth 10 and measure a
    # 100-draw sampling slice (draws/s is per-draw steady-state; full 10.5k
    # draws would take hours on 2 cores for no extra information).
    chains, warmup, draws = 4, 150, 100
    t0 = time.time()
    res = run_nuts(
        logp, dims.dim, jax.random.PRNGKey(0), data=data,
        num_chains=chains, num_warmup=warmup, num_draws=draws,
        max_depth=10, init_theta=init,
    )
    total_s = time.time() - t0

    # timed run without compile: reuse cached runners
    t0 = time.time()
    res = run_nuts(
        logp, dims.dim, jax.random.PRNGKey(1), data=data,
        num_chains=chains, num_warmup=warmup, num_draws=draws,
        max_depth=10, init_theta=init,
    )
    elapsed = time.time() - t0

    total_draws = chains * draws
    draws_per_sec = total_draws / elapsed
    sel = np.r_[0:6, 6 + 2 * dims.G : 6 + 2 * dims.G + dims.n_check]
    diag = diag_summarize(res.draws[:, :, sel])
    ncores = os.cpu_count() or 1
    scale_to_8 = max(1.0, 8.0 / ncores)
    out = {
        "metric": "cpu_nuts_draws_per_sec_counts515",
        "draws_per_sec_measured": round(draws_per_sec, 2),
        "cores": ncores,
        "draws_per_sec_8thread_extrapolated": round(draws_per_sec * scale_to_8, 2),
        "ess_min": round(diag["ess_min"], 1),
        "ess_per_sec_measured": round(diag["ess_min"] / elapsed, 3),
        "rhat_max": round(diag["rhat_max"], 3),
        "config": {
            "sampler": "dynamic-tree NUTS (infer/nuts.py), max_depth=10",
            "chains": chains, "warmup": warmup, "draws_per_chain": draws,
            "leapfrogs_total": int(res.num_leapfrog),
        },
        "elapsed_s": round(elapsed, 1),
        "first_run_incl_compile_s": round(total_s, 1),
        "note": (
            "Measured proxy for 8-thread Stan NUTS on the same model "
            "(reference publishes no numbers). Linear extrapolation from "
            f"{ncores} cores is generous to the baseline."
        ),
    }
    print(json.dumps(out, indent=1))
    with open(os.path.join(os.path.dirname(__file__), "..", "BASELINE_MEASURED.json"), "w") as f:
        json.dump(out, f, indent=1)
    print("wrote BASELINE_MEASURED.json")


if __name__ == "__main__":
    main()
