"""Benchmark: posterior draws/sec on the bundled `counts` dataset, on the GPU.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline"}.

Configuration mirrors the reference's headline use case (README.md:58-74):
the 15 FDR<0.01 genes + 500 negative controls of `counts` (G=515, S=21,
~10.8k data points), pFP=1% detrimental-only => ~10.5k posterior draws
needed (R/methods.R:155-167). The flagship path is the pipeline's MCMC
engine: meanfield-ADVI warm start (init + diagonal mass matrix) feeding
jittered-trajectory HMC with 128 vmapped chains, all compiled to one XLA
program per phase (ppcseq/infer/hmc.py). Model data rides as a jit
operand, so the timed run reuses the compiled executables — the same way
the two passes of identify_outliers share one compile.

Baseline: the reference publishes no throughput numbers (BASELINE.md). The
primary baseline is MEASURED: scripts/baseline_cpu.py runs this repo's own
dynamic-tree NUTS (the same sampler family rstan uses) on the same 515-gene
model on host CPU and extrapolates to 8 threads; its result is committed as
BASELINE_MEASURED.json and loaded here. The round-1 hand-derived estimate
(~50 draws/s for 8-thread Stan map_rect/TBB) is kept only as a fallback.
The detail block also carries leapfrogs/s (deterministic compute) and
min-ESS/s (the statistical throughput).

    python bench.py [--cpu]   # fails without a GPU unless --cpu is given
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

STAN_8THREAD_DRAWS_PER_SEC_ESTIMATE = 50.0  # round-1 fallback


def _baseline():
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "BASELINE_MEASURED.json")
    try:
        with open(path) as f:
            m = json.load(f)
        return (
            float(m["draws_per_sec_8thread_extrapolated"]),
            m.get("ess_per_sec_measured"),
            "measured CPU NUTS proxy (BASELINE_MEASURED.json, scripts/baseline_cpu.py)",
        )
    except (OSError, KeyError, ValueError):
        return (
            STAN_8THREAD_DRAWS_PER_SEC_ESTIMATE,
            None,
            "est. 8-thread Stan NUTS on same model = 50 draws/s",
        )


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true", help="measure the CPU backend")
    args = ap.parse_args(argv)
    from ppcseq.utils import device

    if args.cpu:
        device.force_cpu()
    import jax
    import jax.numpy as jnp

    from ppcseq.utils.compilation_cache import enable as enable_xla_cache

    dev_info = device.describe(cpu=args.cpu)
    enable_xla_cache()

    from ppcseq import load_counts
    from ppcseq.data import ingest
    from ppcseq.formula.design import create_design_matrix
    from ppcseq.infer.advi import fit_advi
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

    # Draw budget of the reference's pFP=1% detrimental run:
    # thr2 = 0.01/21*2, draws = 10/thr2 = 10500 (R/methods.R:155-167).
    # Sampler shape from earlier sweeps (scripts/sweep_hmc.py): L=48 mixed
    # ~4x better than L=32, and with the ADVI warm start supplying init and
    # mass matrix, 30 dual-averaging iterations tuned the step size as well
    # as 60 (rhat <= 1.02, 0 divergences). Their cost on the GPU is not
    # re-swept yet.
    num_chains = 128
    num_warmup = 30
    per_chain = 83  # 128 * 83 = 10624 >= 10500
    num_leapfrog = 48
    total_draws = num_chains * per_chain

    def one_run(seed):
        t0 = time.time()
        warm = fit_advi(
            logp, dims.dim, jax.random.PRNGKey(seed + 7), data=data,
            init_mean=init, tol_rel_obj=0.01, learning_rate=0.3,
            eval_every=50, grad_samples=4,
        )
        inv_mass = np.exp(2.0 * np.asarray(warm.log_sd))
        t_advi = time.time() - t0
        t0 = time.time()
        r = run_hmc(
            logp, dims.dim, jax.random.PRNGKey(seed), data=data,
            num_chains=num_chains, num_warmup=num_warmup, num_draws=per_chain,
            num_leapfrog=num_leapfrog,
            init_theta=warm.mean, inv_mass=inv_mass,
        )
        jax.block_until_ready(r.draws)
        return r, t_advi, time.time() - t0

    # warm the compile cache with one full run (compiled executables are
    # cached per (log-density fn, config); data is an operand)
    _ = one_run(1)

    # draws/s uses the FULL fit time (ADVI warm start included — it is part
    # of the procedure); the roofline fields divide HMC leapfrog flops by the
    # HMC phase alone so the utilization numbers describe the hot loop,
    # consistent with scripts/bench_scale.py.
    res, t_advi, t_hmc = one_run(0)
    elapsed = t_advi + t_hmc

    draws_per_sec = total_draws / elapsed
    div_frac = float(res.divergences.sum()) / total_draws
    # convergence evidence: slope block + hyperparameters
    from ppcseq.infer.diagnostics import summarize as diag_summarize

    sel = np.r_[0:6, 6 + 2 * dims.G : 6 + 2 * dims.G + dims.n_check]
    diag = diag_summarize(res.draws[:, :, sel])
    baseline_dps, baseline_ess_ps, baseline_note = _baseline()
    ess_per_sec = diag["ess_min"] / elapsed

    # roofline: XLA-counted flops/bytes of the hot op (one batched
    # logp+gradient over all chains = one leapfrog's compute), scaled by the
    # executed batched-leapfrog count (res.num_leapfrog counts per-chain)
    from ppcseq.utils.roofline import cost_of, utilization

    z_batch = jnp.tile(init[None, :], (num_chains, 1))
    hot = cost_of(
        lambda z, d: jax.vmap(jax.value_and_grad(logp), in_axes=(0, None))(z, d),
        z_batch, data,
    )
    batched_lf = res.num_leapfrog / num_chains
    util = {} if args.cpu else utilization(
        None if hot["flops"] is None else hot["flops"] * batched_lf / t_hmc,
        None if hot["bytes"] is None else hot["bytes"] * batched_lf / t_hmc,
        jax.devices()[0],
    )
    result = {
        "metric": "posterior_draws_per_sec_1chip_counts515",
        "value": round(draws_per_sec, 1),
        "unit": "draws/s",
        "vs_baseline": round(draws_per_sec / baseline_dps, 1),
        "detail": {
            # noise-robust primary metrics first: leapfrogs/s is
            # compute-deterministic, min-ESS/s is the statistical throughput
            "leapfrogs_per_sec": round(res.num_leapfrog / t_hmc, 1),
            "hmc_phase_s": round(t_hmc, 2),
            "ess_per_sec": round(ess_per_sec, 1),
            "ess_per_sec_vs_baseline": (
                round(ess_per_sec / baseline_ess_ps, 1) if baseline_ess_ps else None
            ),
            "baseline_measured_draws_per_sec": baseline_dps,
            "total_draws": total_draws,
            "chains": num_chains,
            "sampler": "jittered-HMC (ADVI warm start), infer/hmc.py",
            "elapsed_s": round(elapsed, 2),
            "leapfrog_steps": res.num_leapfrog,
            "divergence_frac": round(div_frac, 5),
            "mean_accept": round(float(res.accept_prob.mean()), 3),
            "step_size": round(res.step_size, 4),
            "rhat_max": round(diag["rhat_max"], 3),
            "ess_min": round(diag["ess_min"], 0),
            **dev_info,
            "baseline_note": baseline_note,
            **util,
        },
    }
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
