"""Two-pass amplification analysis of the knife-edge README calls (parity).

The remaining README-run deviation (docs/PARITY.md) is that CCNA1/MMP8 are
sometimes called deleterious here but not in the reference's single VB run.
PARITY_BUDGET.json showed the pass-2 calls sit on the decision threshold;
this study pins down WHERE the coin is actually flipped: pass 1.

Mechanism (R/methods.R:292-300 / pipeline/identify.py): a cell flagged
deleterious by the permissive pass-1 fit is EXCLUDED from the pass-2
likelihood. Exclusion lowers the refit mean for that gene, which narrows the
upper predictive bound at the excluded cell — so a pass-1 flag makes the
final pass-2 call much more likely (the procedure is intentionally
self-reinforcing; truncation_compensation=0.7352941 only partly offsets it).
A cell whose pass-1 tail probability straddles the permissive bound is
therefore a coin flip whose outcome is AMPLIFIED into a near-deterministic
pass-2 call.

For each seed this records, per gene of interest: (a) whether pass 1
excluded any of its cells (result.attrs["pass1_excluded"]), (b) the final
deleterious call. The output contingency table shows
P(call | excluded in pass 1) vs P(call | not excluded).

    python scripts/amplification_study.py --seeds 50 [--nuts] [--cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

GENES_OF_INTEREST = ("CYP1A1", "LYZ", "CCNA1", "MMP8")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, default=50)
    ap.add_argument("--start", type=int, default=1)
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--nuts", action="store_true")
    ap.add_argument("--mcmc", action="store_true", help="jittered HMC")
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
        excl = res.attrs["pass1_excluded"]
        excluded_genes = set(excl["symbol"]) if len(excl) else set()
        calls = dict(zip(res.symbol, res.tot_deleterious_outliers))
        rec = {
            "seed": seed,
            "elapsed_s": round(time.time() - t0, 1),
            "pass1_excluded_cells": int(len(excl)),
            "genes": {
                g: {
                    "pass1_excluded": g in excluded_genes,
                    "called": int(calls.get(g, 0)) > 0,
                }
                for g in GENES_OF_INTEREST
            },
        }
        per_seed.append(rec)
        print(json.dumps(rec), flush=True)

    # contingency per gene: P(call | pass-1 excluded) vs P(call | not)
    table = {}
    for g in GENES_OF_INTEREST:
        n_ee = sum(1 for r in per_seed if r["genes"][g]["pass1_excluded"] and r["genes"][g]["called"])
        n_en = sum(1 for r in per_seed if r["genes"][g]["pass1_excluded"] and not r["genes"][g]["called"])
        n_ne = sum(1 for r in per_seed if not r["genes"][g]["pass1_excluded"] and r["genes"][g]["called"])
        n_nn = sum(1 for r in per_seed if not r["genes"][g]["pass1_excluded"] and not r["genes"][g]["called"])
        ne, nn = n_ee + n_en, n_ne + n_nn
        table[g] = {
            "seeds_pass1_excluded": ne,
            "seeds_not_excluded": nn,
            "p_call_given_excluded": round(n_ee / ne, 3) if ne else None,
            "p_call_given_not_excluded": round(n_ne / nn, 3) if nn else None,
            "counts": {"excl_called": n_ee, "excl_not": n_en, "notexcl_called": n_ne, "notexcl_not": n_nn},
        }

    summary = {
        "config": {
            "method": method,
            "percent_false_positive_genes": 5,
            "n_seeds": args.seeds,
            "first_seed": args.start,
        },
        "elapsed_total_s": round(time.time() - t_all, 1),
        "contingency": table,
        "per_seed": per_seed,
    }
    out = args.out or f"PARITY_AMPLIFICATION_{method}.json"
    with open(out, "w") as f:
        json.dump(summary, f, indent=1)
    print(f"wrote {out}")
    print(json.dumps({g: {k: v for k, v in t.items() if k != "counts"} for g, t in table.items()}, indent=1))


if __name__ == "__main__":
    main()
