"""Multi-seed call-frequency study of the README 15-gene run (parity item).

The reference README table (README.md:75-92) is ONE stochastic VB run:
CYP1A1 and LYZ each 1 deleterious outlier, 13 genes 0. Our round-1 result
additionally called CCNA1 and MMP8 in ~2/3 of seeds. This harness runs the
identical configuration across many seeds — in one process, so every fit
after the first reuses the compiled executables — and records per-gene call
frequencies, turning "seed-dependent" into a measured number.

    python scripts/seed_study.py --seeds 50 --out PARITY_SEEDS_vb.json
    python scripts/seed_study.py --nuts --seeds 10 --out PARITY_SEEDS_nuts.json
    python scripts/seed_study.py --cpu ...   (default: JAX's default platform)
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, default=50)
    ap.add_argument("--start", type=int, default=1, help="first seed")
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--mcmc", action="store_true", help="jittered HMC instead of VB")
    ap.add_argument("--nuts", action="store_true", help="NUTS instead of VB")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    if args.cpu:
        os.environ["JAX_PLATFORMS"] = "cpu"
        import jax

        jax.config.update("jax_platforms", "cpu")

    from ppcseq import identify_outliers, load_counts
    from ppcseq.utils.compilation_cache import enable as enable_xla_cache

    enable_xla_cache()

    counts = load_counts()
    counts = counts.assign(is_significant=counts.FDR < 0.01)

    method = "nuts" if args.nuts else ("hmc" if args.mcmc else "vb")
    per_gene_del: dict[str, list[int]] = {}
    per_gene_ppc: dict[str, list[int]] = {}
    per_seed = []
    t_all = time.time()
    for i in range(args.seeds):
        seed = args.start + i
        t0 = time.time()
        res = identify_outliers(
            counts,
            formula="~ Label",
            sample="sample",
            transcript="symbol",
            abundance="value",
            significance="PValue",
            do_check="is_significant",
            percent_false_positive_genes=5,
            seed=seed,
            approximate_posterior_inference=method == "vb",
            mcmc_sampler=method if method != "vb" else "hmc",
        )
        dt = time.time() - t0
        calls = dict(zip(res.symbol, res.tot_deleterious_outliers))
        fails = dict(zip(res.symbol, res.ppc_samples_failed))
        for sym in calls:
            per_gene_del.setdefault(sym, []).append(int(calls[sym]))
            per_gene_ppc.setdefault(sym, []).append(int(fails[sym]))
        nonzero = {s: v for s, v in calls.items() if v > 0}
        per_seed.append({"seed": seed, "elapsed_s": round(dt, 1), "nonzero": nonzero})
        print(json.dumps(per_seed[-1]), flush=True)

    summary = {
        "config": {
            "method": method,
            "percent_false_positive_genes": 5,
            "n_seeds": args.seeds,
            "first_seed": args.start,
            "reference_expected": {"CYP1A1": 1, "LYZ": 1},
        },
        "elapsed_total_s": round(time.time() - t_all, 1),
        "per_gene": {
            sym: {
                "deleterious_call_freq": sum(1 for v in per_gene_del[sym] if v > 0)
                / len(per_gene_del[sym]),
                "mean_deleterious": sum(per_gene_del[sym]) / len(per_gene_del[sym]),
                "mean_ppc_failed": sum(per_gene_ppc[sym]) / len(per_gene_ppc[sym]),
            }
            for sym in sorted(per_gene_del)
        },
        "per_seed": per_seed,
    }
    out = args.out or f"PARITY_SEEDS_{method}.json"
    with open(out, "w") as f:
        json.dump(summary, f, indent=1)
    print(f"wrote {out}")
    flagged = {
        s: round(v["deleterious_call_freq"], 2)
        for s, v in summary["per_gene"].items()
        if v["deleterious_call_freq"] > 0
    }
    print("call frequencies:", json.dumps(flagged))


if __name__ == "__main__":
    main()
