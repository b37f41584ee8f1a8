"""End-to-end wall-clock benchmark of identify_outliers — the product, not
just the sampler.

The reference's only runnable workload is its own test/README configuration
(tests/testthat/test-ppcSeq.R: 3 check genes + 50 negative controls, VB;
README.md:58-74: 15 FDR<0.01 genes + 500 controls). This times the full
two-pass pipeline — ingest, TMM, design, ADVI/HMC fits, PPC simulation,
extraction, merge — for those configurations (chip_smoke.bundled_configs,
with their pinned calls), cold (includes compilation) and warm (compiled
executables cached; the steady-state cost of repeated cohort analyses, e.g.
across contrasts).

Writes one JSON line with every configuration. On the CPU (--cpu) it
doubles as a regression guard for compile-cache behavior (warm must be
several times faster).

Usage: python scripts/bench_pipeline.py [--quick] [--cpu]
  (--quick: 3-gene VB only; fails without a GPU unless --cpu is given)
"""

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main(quick=False, cpu=False):
    from ppcseq.utils import device

    if cpu:
        device.force_cpu()
    dev_info = device.describe(cpu=cpu)

    from chip_smoke import bundled_configs, run_identify
    from ppcseq import load_counts

    configs = bundled_configs(load_counts())
    rows = []
    for tag, df, check, kwargs in configs[:1] if quick else configs:
        runs = run_identify(tag, df, check, **kwargs)
        rows.append({
            "config": tag,
            "cold_s": runs[0]["wall_s"],
            "warm_s": runs[1]["wall_s"],
            "genes_checked": len(runs[1]["calls"]),
            "tot_deleterious_outliers": runs[1]["calls"],
        })

    out = {
        "metric": "identify_outliers_wall_clock",
        **dev_info,
        "rows": rows,
        "note": (
            "cold includes XLA compilation; warm reuses the compiled "
            "executables (data rides as a jit operand). The reference "
            "publishes no end-to-end timings and the R/rstan stack is not "
            "runnable here; BASELINE_MEASURED.json carries the measured "
            "sampler-level CPU proxy used by bench.py."
        ),
    }
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--cpu", action="store_true", help="measure the CPU backend")
    args = ap.parse_args()
    main(quick=args.quick, cpu=args.cpu)
