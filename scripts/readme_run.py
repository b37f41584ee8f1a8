"""The reference README's headline run (README.md:58-92), for parity checks.

All 15 FDR<0.01 transcripts of the bundled cohort, pFP=5%, 500 negative
controls, VB. The reference reports CYP1A1 and LYZ each with 1 failed PPC /
1 deleterious outlier and 0 for the other 13 genes.

Runs on JAX's default platform (the GPU where there is one); --cpu pins
the CPU:
    python scripts/readme_run.py [--cpu]
"""

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

EXPECTED_NONZERO = {"CYP1A1": 1, "LYZ": 1}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true", help="run on the CPU backend")
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--mcmc", action="store_true", help="full MCMC (jittered HMC) instead of VB")
    ap.add_argument("--nuts", action="store_true", help="full MCMC with the NUTS sampler")
    args = ap.parse_args()

    if args.cpu:
        from ppcseq.utils.device import force_cpu

        force_cpu()

    from ppcseq import identify_outliers, load_counts

    counts = load_counts()
    counts = counts.assign(is_significant=counts.FDR < 0.01)
    n_sig = counts.loc[counts.is_significant, "symbol"].nunique()
    print(f"{n_sig} significant transcripts (FDR<0.01)")

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
        seed=args.seed,
        approximate_posterior_inference=not (args.mcmc or args.nuts),
        mcmc_sampler="nuts" if args.nuts else "hmc",
    )
    elapsed = time.time() - t0

    print(res[["symbol", "ppc_samples_failed", "tot_deleterious_outliers"]].to_string(index=False))
    print(f"elapsed: {elapsed:.1f}s")

    got = dict(zip(res.symbol, res.tot_deleterious_outliers))
    ok = True
    for sym, expected in EXPECTED_NONZERO.items():
        if got.get(sym) != expected:
            print(f"MISMATCH: {sym} expected {expected}, got {got.get(sym)}")
            ok = False
    extra = {s: v for s, v in got.items() if v > 0 and s not in EXPECTED_NONZERO}
    if extra:
        print(f"EXTRA calls (reference has none): {extra}")
        ok = False
    print("README parity:", "OK" if ok else "FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
