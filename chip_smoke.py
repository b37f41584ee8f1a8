"""Smoke run of ppcseq on the GPU: the main path at real widths, checked.

    python chip_smoke.py             # one GPU: phases 1-4
    python chip_smoke.py --cards 4   # four GPUs: phase 5 only (mesh vs one card)

Phases, in one process (each raises on failure, so the script then exits
non-zero and never prints the verdict line):

1. Environment: versions, optional imports, the native host library, the
   card's name and power limit, JAX's devices and the compile-cache
   directory. Stops unless JAX's first device is a GPU.
2. Likelihood variants at two real widths — the bundled cohort at the
   README config (G=515, S=21; the 128-chain batched value+grad of one
   leapfrog) and the 50k-gene x 100-sample synthetic cohort (the VB
   gradient batch of 1) — each timed in float32 with the delta-form
   baseline, and each checked against the float64 `plain` reference, which
   is itself checked against the same computation on the CPU.
3. identify_outliers on the bundled cohort, cold then warm, against the
   reference's pinned calls.
4. identify_outliers on the 50k x 100 synthetic cohort with every gene in
   the fit, cold then warm: walls, peak device memory, injected outlier
   cells flagged, and calls equal across the two runs.
5. (--cards 4 only) a `genes`-mesh VB run of the phase-4 cohort and a
   `chains`-mesh HMC run of the 3-gene config on four cards, each compared
   with the same mesh code on one card.

The last line of standard output is the verdict
{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.metadata
import json
import statistics
import sys
import time

import numpy as np

VARIANTS = ("plain", "analytic", "fused", "fast")
REF3 = ["SLC16A12", "CYP1A1", "ART3"]
# f64 GPU vs f64 CPU (the tolerances tests/test_nb_fast.py uses)
F64_VALUE_RTOL = 1e-9
F64_GRAD_TOL = 1e-6
# f32 variant vs the f64 reference: f32 summation order over up to 5M points
F32_VALUE_RTOL = 1e-4
F32_GRAD_FRAC = 1e-3


def say(*parts) -> None:
    print(*parts, flush=True)


def require(ok: bool, what: str) -> None:
    """Fail the phase (and so the script) unless `ok`."""
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def verdict_line(devices) -> str:
    """The contract's last line, from the devices JAX reports."""
    d = devices[0]
    return json.dumps(
        {"ok": True, "device": {"platform": d.platform, "kind": d.device_kind,
                                "count": len(devices)}}
    )


def require_gpu(devices) -> None:
    """Stop at once unless JAX's first device is a GPU (never run on the CPU)."""
    d = devices[0]
    if d.platform != "gpu":
        raise SystemExit(
            f"chip_smoke: JAX found no GPU (first device: {d.platform}, "
            f"{d.device_kind}); refusing to run on it"
        )


# --- phase 1 ---------------------------------------------------------------


def _version(dist: str) -> str:
    try:
        return importlib.metadata.version(dist)
    except importlib.metadata.PackageNotFoundError:
        return "not installed"


def phase1_environment():
    say(f"phase1 python {sys.version.split()[0]}")
    for dist in ("jax", "jaxlib", "jax-cuda12-plugin", "jax-cuda12-pjrt"):
        say(f"phase1 {dist} {_version(dist)}")
    for mod in ("pandas", "pyarrow", "optax"):
        try:
            m = importlib.import_module(mod)
            say(f"phase1 import {mod} ok {getattr(m, '__version__', '')}")
        except ImportError as e:
            say(f"phase1 import {mod} MISSING ({e})")

    from ppcseq.utils.compilation_cache import enable

    cache_dir = enable()  # before anything compiles
    import jax

    from ppcseq import _native
    from ppcseq.utils.device import nvidia_smi

    say(f"phase1 native host library: {_native.status()}")
    say("phase1 nvidia-smi --query-gpu=name,power.limit:")
    say(nvidia_smi())
    devices = jax.devices()
    d = devices[0]
    say(f"phase1 jax platform={d.platform} device_kind={d.device_kind} "
        f"device_count={len(devices)}")
    say(f"phase1 compile cache: {cache_dir}")
    require_gpu(devices)
    return devices


# --- phase 2 ---------------------------------------------------------------


def bundled_arrays(controls: int = 500, fdr: float = 0.01):
    """(counts, X, exposure, n_check) of the README config: the bundled
    cohort's FDR < 0.01 genes plus `controls` negative controls."""
    from ppcseq import load_counts
    from ppcseq.data import ingest
    from ppcseq.formula.design import create_design_matrix
    from ppcseq.norm.tmm import sample_scaling

    counts = load_counts()
    work = counts.assign(do_check___=counts.FDR < fdr)
    my_df = ingest.format_input(
        work, "~ Label", "sample", "symbol", "value", "do_check___", "PValue", controls
    )
    X, _, xr = create_design_matrix(my_df, "~ Label", "sample")
    scal = sample_scaling(my_df, "sample", "symbol", "value")
    md = ingest.build_model_data(
        my_df, "sample", "symbol", "value", "do_check___",
        X, list(xr["sample"]), dict(zip(scal["sample"], scal.exposure_rate)),
    )
    return md.counts, md.X, md.exposure_rate, md.n_check


def synthetic_arrays(n_genes: int, n_samples: int, n_check: int = 100):
    from ppcseq.utils.synthetic import synthetic_cohort

    counts, X, exposure, _ = synthetic_cohort(n_genes, n_samples, n_check=n_check, seed=0)
    return counts, X, exposure, n_check


def _batched_value_and_grad(logp):
    import jax

    return jax.vmap(jax.value_and_grad(logp), in_axes=(0, None))


def _time_per_call(logp, data, thetas, steps: int, reps: int) -> float:
    """Median seconds of one batched value+grad, timed inside a lax.scan of
    `steps` dependent calls (as the samplers run it), closed by
    block_until_ready."""
    import jax

    vg = _batched_value_and_grad(logp)

    @jax.jit
    def run(z, data):
        def step(z, _):
            lp, g = vg(z, data)
            return z + 1e-7 * g, lp

        return jax.lax.scan(step, z, None, length=steps)

    jax.block_until_ready(run(thetas, data))  # compile + warm up
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(run(thetas, data))
        times.append((time.perf_counter() - t0) / steps)
    return statistics.median(times)


def _evaluate(logp, data, thetas):
    import jax

    v, g = jax.jit(_batched_value_and_grad(logp))(thetas, data)
    return np.asarray(v, np.float64), np.asarray(g, np.float64)


def likelihood_width(name, arrays, batch: int, steps: int, reps: int = 5,
                     variants=VARIANTS) -> dict:
    """Time every variant at one width and check it against the f64 reference.

    Returns {"name", "batch", "G", "S", "seconds": {variant: s}, "winner"}.
    Raises AssertionError when an error exceeds its bound.
    """
    import jax
    import jax.numpy as jnp

    from ppcseq.model import nb_model

    counts, X, exposure, n_check = arrays
    rng = np.random.default_rng(0)

    # float64 `plain` reference, on the accelerator and on the CPU device
    with jax.enable_x64(True):
        data64, dims = nb_model.prepare_data(counts, X, exposure, n_check, dtype=jnp.float64)
        theta0 = nb_model.smart_init(data64, dims)
        thetas = theta0[None, :] + 0.05 * rng.standard_normal((batch, dims.dim))
        ref = nb_model.flat_logp(dims, "plain")
        v64, g64 = _evaluate(ref, data64, jnp.asarray(thetas))
        cpu = jax.devices("cpu")[0]
        v_cpu, g_cpu = _evaluate(
            ref, jax.device_put(data64, cpu), jax.device_put(jnp.asarray(thetas), cpu)
        )
    v_err = float(np.max(np.abs(v64 - v_cpu) / np.abs(v_cpu)))
    g_excess = float(np.max(np.abs(g64 - g_cpu) - F64_GRAD_TOL * np.abs(g_cpu)))
    say(f"phase2 {name} f64 plain accelerator vs CPU: value_rel_err={v_err:.3e} "
        f"(bound {F64_VALUE_RTOL:g}); grad max(|err| - rtol*|ref|)={g_excess:.3e} "
        f"(bound atol {F64_GRAD_TOL:g})")
    require(v_err <= F64_VALUE_RTOL, f"{name}: f64 value differs from CPU")
    require(g_excess <= F64_GRAD_TOL, f"{name}: f64 gradient differs from CPU")

    data32, dims32 = nb_model.prepare_data(counts, X, exposure, n_check, dtype=jnp.float32)
    data32 = nb_model.with_baseline(data32, dims32)
    th32 = jnp.asarray(thetas, jnp.float32)
    g_scale = float(np.max(np.abs(g64)))
    seconds = {}
    for v in variants:
        logp = nb_model.flat_logp(dims32, v)
        val, grad = _evaluate(logp, data32, th32)
        val_err = float(np.max(np.abs(val - v64) / np.abs(v64)))
        grad_frac = float(np.max(np.abs(grad - g64))) / g_scale
        seconds[v] = _time_per_call(logp, data32, th32, steps, reps)
        say(f"phase2 {name} G={dims32.G} S={dims32.S} batch={batch} f32 {v:9s} "
            f"us_per_value_grad={seconds[v] * 1e6:.3f} "
            f"value_rel_err={val_err:.3e} (bound {F32_VALUE_RTOL:g}) "
            f"grad_err/max|grad|={grad_frac:.3e} (bound {F32_GRAD_FRAC:g})")
        require(np.isfinite(val).all() and np.isfinite(grad).all(), f"{name} {v}: non-finite")
        require(val_err <= F32_VALUE_RTOL, f"{name} {v}: value error {val_err}")
        require(grad_frac <= F32_GRAD_FRAC, f"{name} {v}: gradient error {grad_frac}")
    winner = min(seconds, key=seconds.get)
    auto = nb_model._resolve_auto("auto")
    say(f"phase2 {name} fastest={winner} auto_resolves_to={auto} "
        + " ".join(f"{v}/plain={seconds[v] / seconds['plain']:.3f}" for v in variants))
    return {"name": name, "batch": batch, "G": dims32.G, "S": dims32.S,
            "seconds": seconds, "winner": winner}


def phase2_likelihoods():
    return [
        likelihood_width("counts515", bundled_arrays(), batch=128, steps=64),
        likelihood_width("synth50k", synthetic_arrays(50000, 100), batch=1, steps=16),
    ]


# --- phases 3-5: identify_outliers end to end ------------------------------


def expect_calls(fixed: dict, free=()):
    """Check that the named genes have their pinned totals, genes in `free`
    are 0 or 1, and every other gene is 0."""

    def check(got: dict) -> None:
        missing = set(fixed) - set(got)
        require(not missing, f"genes missing from the result: {missing}")
        for gene, n in got.items():
            if gene in free:
                require(n in (0, 1), f"{gene}: {n} not in (0, 1)")
            else:
                require(n == fixed.get(gene, 0), f"{gene}: {n} != {fixed.get(gene, 0)}")

    return check


def run_identify(tag: str, df, check, runs=("cold", "warm"), **kwargs) -> list[dict]:
    """identify_outliers once per run label; prints each wall and the calls."""
    from ppcseq import identify_outliers

    transcript = kwargs["transcript"]
    out = []
    for label in runs:
        t0 = time.perf_counter()
        res = identify_outliers(df, **kwargs)
        wall = time.perf_counter() - t0
        got = {str(k): int(v) for k, v in zip(res[transcript], res.tot_deleterious_outliers)}
        nonzero = {k: v for k, v in got.items() if v}
        say(f"{tag} {label}: wall_s={wall:.3f} genes={len(got)} nonzero_calls={nonzero}")
        check(got)
        out.append({"wall_s": wall, "calls": got, "result": res})
    return out


_BUNDLED = dict(
    formula="~ Label", sample="sample", transcript="symbol", abundance="value",
    significance="PValue", do_check="is_significant", seed=42,
)


def bundled_configs(counts):
    """(tag, table, check, kwargs) of the three pinned bundled-cohort runs."""
    ref3 = counts.assign(is_significant=counts.symbol.isin(REF3))
    readme = counts.assign(is_significant=counts.FDR < 0.01)
    pinned3 = expect_calls({"SLC16A12": 0, "CYP1A1": 1, "ART3": 0})
    return [
        ("ref3_vb_approx", ref3, pinned3,
         dict(_BUNDLED, percent_false_positive_genes=5, how_many_negative_controls=50)),
        ("ref3_hmc_exact", ref3, pinned3,
         dict(_BUNDLED, percent_false_positive_genes=5, how_many_negative_controls=50,
              approximate_posterior_inference=False,
              approximate_posterior_analysis=False)),
        # CCNA1 and MMP8 are the documented knife-edge calls (docs/PARITY.md)
        ("ref15_vb_approx", readme,
         expect_calls({"CYP1A1": 1, "LYZ": 1}, free=("CCNA1", "MMP8")),
         dict(_BUNDLED, percent_false_positive_genes=5, how_many_negative_controls=500)),
    ]


def phase3_bundled(configs) -> dict:
    walls = {}
    for tag, df, check, kwargs in configs:
        runs = run_identify(f"phase3 {tag}", df, check, **kwargs)
        walls[tag] = [r["wall_s"] for r in runs]
    return walls


def scale_cohort(n_genes: int, n_samples: int, n_check: int):
    """(tidy table, injected outlier cells, identify_outliers kwargs) of the
    synthetic cohort with every gene in the fit, VB + approximated CI."""
    from ppcseq.utils.synthetic import synthetic_cohort, synthetic_tidy

    df = synthetic_tidy(n_genes=n_genes, n_samples=n_samples, n_check=n_check,
                        outlier_frac=0.002, seed=0)
    _, _, _, truth = synthetic_cohort(n_genes=n_genes, n_samples=n_samples,
                                      n_check=n_check, outlier_frac=0.002, seed=0)
    kwargs = dict(
        formula="~ Label", sample="sample", transcript="transcript", abundance="count",
        significance="PValue", do_check="do_check", percent_false_positive_genes=1.0,
        how_many_negative_controls=n_genes - n_check,
        approximate_posterior_inference=True, approximate_posterior_analysis=True,
        seed=42,
    )
    return df, set(map(tuple, truth["outliers"])), kwargs


def flagged_cells(res) -> set:
    """(S, G) cells whose posterior predictive check failed."""
    import pandas as pd

    swd = pd.concat(list(res["sample_wise_data"]), ignore_index=True)
    bad = swd[~swd["posterior_predictive_check_succeded"].astype(bool)]
    return set(zip(bad["S"].astype(int), bad["G"].astype(int)))


def phase4_scale(n_genes=50000, n_samples=100, n_check=100) -> dict:
    import jax

    df, spiked, kwargs = scale_cohort(n_genes, n_samples, n_check)
    say(f"phase4 cohort: {n_genes} genes x {n_samples} samples, {n_check} checked, "
        f"{len(spiked)} injected outlier cells")
    runs = run_identify(f"phase4 synth{n_genes}", df, lambda got: None, **kwargs)
    stats = jax.devices()[0].memory_stats() or {}
    peak = stats.get("peak_bytes_in_use")
    hits = len(spiked & flagged_cells(runs[0]["result"]))
    equal = runs[0]["calls"] == runs[1]["calls"]
    say(f"phase4 peak_bytes_in_use={peak} injected_cells_flagged={hits}/{len(spiked)} "
        f"total_calls={sum(runs[0]['calls'].values())} calls_equal_across_runs={equal}")
    require(equal, "phase 4 calls differ between the cold and the warm run")
    require(len(runs[0]["calls"]) == n_check, f"{n_check} checked genes in the result")
    return {"walls": [r["wall_s"] for r in runs], "peak_bytes_in_use": peak,
            "flagged": hits, "injected": len(spiked)}


def phase5_mesh(devices, n_genes=50000, n_samples=100, n_check=100, counts=None) -> dict:
    """Four-card meshes against the same mesh code on one card."""
    from jax.sharding import Mesh

    from ppcseq.model import nb_model
    from ppcseq.parallel.sharding import shard_data

    require(len(devices) >= 4, f"--cards 4 needs four devices, JAX has {len(devices)}")
    four = list(devices[:4])
    out = {}

    df, _, kwargs = scale_cohort(n_genes, n_samples, n_check)
    calls = {}
    for n in (4, 1):
        mesh = Mesh(np.array(four[:n]), ("genes",))
        runs = run_identify(f"phase5 genes_mesh_vb synth{n_genes} cards={n}", df,
                            lambda got: None, **kwargs, mesh=mesh)
        calls[n] = runs[-1]["calls"]
        out[f"genes_vb_walls_{n}"] = [r["wall_s"] for r in runs]
        if n == 4:
            # the CPU backend keeps no memory stats; a GPU always does
            peaks = [(d.memory_stats() or {}).get("peak_bytes_in_use") for d in four]
            say(f"phase5 genes mesh peak_bytes_in_use per card: {peaks}")
            require(four[0].platform == "cpu" or all(p and p > 0 for p in peaks),
                    "every card of the mesh held data")
    require(calls[4] == calls[1], "genes-mesh calls differ between 4 cards and 1")
    say("phase5 genes_mesh_vb calls equal on 4 cards and 1: True")

    # where the sharded model data lands: one [S, G/4] shard on each card
    arrays = synthetic_arrays(n_genes, n_samples, n_check)
    data, _ = nb_model.prepare_data(*arrays)
    sh = shard_data(data, Mesh(np.array(four), ("genes",)))
    placed = {s.device for s in sh.counts.addressable_shards}
    shapes = {s.data.shape for s in sh.counts.addressable_shards}
    say(f"phase5 counts shards: devices={sorted(d.id for d in placed)} shapes={shapes}")
    require(placed == set(four) and shapes == {(n_samples, n_genes // 4)},
            "one [S, G/4] counts shard on each of the four cards")

    if counts is None:
        from ppcseq import load_counts

        counts = load_counts()
    tag, ref3, check, kw = bundled_configs(counts)[1]  # ref3_hmc_exact
    calls = {}
    for n in (4, 1):
        mesh = Mesh(np.array(four[:n]), ("chains",))
        runs = run_identify(f"phase5 chains_mesh_hmc {tag} cards={n}", ref3, check,
                            **kw, mesh=mesh)
        calls[n] = runs[-1]["calls"]
        out[f"chains_hmc_walls_{n}"] = [r["wall_s"] for r in runs]
    require(calls[4] == calls[1], "chains-mesh calls differ between 4 cards and 1")
    say("phase5 chains_mesh_hmc calls equal on 4 cards and 1: True")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cards", type=int, choices=(1, 4), default=1,
                    help="4: run only the four-card mesh phase")
    args = ap.parse_args(argv)

    t_start = time.perf_counter()
    devices = phase1_environment()
    if args.cards == 4:
        phase5_mesh(devices)
        devices = devices[:4]
    else:
        from ppcseq import load_counts

        phase2_likelihoods()
        phase3_bundled(bundled_configs(load_counts()))
        phase4_scale()
        devices = devices[:1]
    from ppcseq.utils.device import nvidia_smi

    say(f"chip_smoke total_wall_s={time.perf_counter() - t_start:.3f}")
    say(nvidia_smi())
    print(verdict_line(devices), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
