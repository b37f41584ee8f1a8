"""The PRODUCT at 50k genes: one `identify_outliers` end to end on the GPU.

The 50k-gene figure in the README was previously sampler-level only
(scripts/bench_scale.py); this runs the real two-pass product — threshold
math, TMM, both fits, PPC chunking, result assembly — on a synthetic
50,000-transcript x 100-sample cohort (reference product surface
R/methods.R:74-367). The fit covers ALL 50k genes: 100 checked +
49,900 negative controls (the reference caps controls at 500 by default;
here the control count is raised so the fitted model really is the
at-scale configuration the README advertises).

Records wall clock (cold + warm via checkpoint-free rerun), peak device
memory, and calls-sanity against the injected outlier truth.

    python scripts/bench_pipeline_scale.py [--json OUT.json] [--cpu]
        [--genes 50000 --samples 100 --check 100]

It fails without a GPU unless --cpu is given.
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
    ap.add_argument("--genes", type=int, default=50000)
    ap.add_argument("--samples", type=int, default=100)
    ap.add_argument("--check", type=int, default=100)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()

    from ppcseq.utils import device

    if args.cpu:
        device.force_cpu()
    import jax

    dev_info = device.describe(cpu=args.cpu)

    from chip_smoke import flagged_cells, run_identify, scale_cohort

    df, spiked, kwargs = scale_cohort(args.genes, args.samples, args.check)
    print(f"cohort: {args.genes} genes x {args.samples} samples, "
          f"{args.check} checked, {len(spiked)} injected outlier cells", flush=True)

    runs = run_identify("synthetic", df, lambda got: None, **kwargs)
    stats = jax.local_devices()[0].memory_stats() or {}
    peak = stats.get("peak_bytes_in_use")  # None where the backend has no stats
    res_cold = runs[0]["result"]
    wall_cold, wall_warm = runs[0]["wall_s"], runs[1]["wall_s"]
    calls = int(res_cold.tot_deleterious_outliers.sum())
    ppc_failed = int(res_cold.ppc_samples_failed.sum())
    hits = len(spiked & flagged_cells(res_cold))

    out = {
        "what": ("identify_outliers END TO END at 50k-gene scale: two "
                 "passes, VB + approximated CI, fit covers all genes "
                 "(100 checked + rest as controls)"),
        "script": "scripts/bench_pipeline_scale.py",
        **dev_info,
        "genes": args.genes,
        "samples": args.samples,
        "checked": args.check,
        "wall_cold_s": wall_cold,
        "wall_warm_s": wall_warm,
        "peak_device_bytes": None if peak is None else int(peak),
        "peak_device_gib": None if peak is None else round(peak / 2**30, 2),
        "total_deleterious_calls": calls,
        "total_ppc_failed": ppc_failed,
        "injected_outlier_cells": len(spiked),
        "injected_cells_flagged": hits,
        "result_rows": int(len(res_cold)),
        "calls_match_across_runs": runs[0]["calls"] == runs[1]["calls"],
    }
    print(json.dumps(out, indent=1), flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
        print(f"wrote {args.json}")


if __name__ == "__main__":
    main()
