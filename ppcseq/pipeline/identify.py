"""Two-pass Bayesian outlier identification (reference R/methods.R:74-367).

`identify_outliers` runs:
  1. validation + threshold/draw-count math (R/methods.R:110-195)
  2. data prep: gene selection, indexing, design matrix, TMM exposure
     (R/methods.R:198-238)
  3. PASS 1 "discovery": permissive CI fit flags candidate outliers
     (R/methods.R:268-300)
  4. PASS 2 "test": refit excluding those points from the likelihood
     (truncation), draw CIs at the user FP level (R/methods.R:320-342)
  5. merge into a per-transcript nested result (R/methods.R:344-365)

Inference is JAX ADVI (default) or vectorized multi-chain NUTS; posterior
predictive CIs are simulated on device (ppcseq.ppc).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Any

import numpy as np
import pandas as pd

import jax
import jax.numpy as jnp

from ppcseq.data import ingest
from ppcseq.formula.design import create_design_matrix, parse_formula
from ppcseq.infer.advi import advi_sample, fit_advi, vb_iterative
from ppcseq.infer.chains import chains_for_run, mcmc_iterations
from ppcseq.infer.hmc import run_hmc
from ppcseq.infer.nuts import run_nuts
from ppcseq.model import nb_model
from ppcseq.norm.tmm import sample_scaling
from ppcseq.ppc.rng import approximated_ci, exact_ci
from ppcseq.utils import constants as K
from ppcseq.utils.log import timed


@dataclass
class InferenceResult:
    """Per-(sample, checked-gene) results of one fit (reference do_inference)."""

    table: pd.DataFrame
    total_draws: int
    fit: Any = None
    counts_rng: np.ndarray | None = None  # [n_draws, S, K] when exact path ran
    # posterior draws of user-requested constrained parameters
    # (reference additional_parameters_to_save, R/methods.R:90)
    additional_parameters: dict[str, np.ndarray] = field(default_factory=dict)


def _available_memory_bytes(mesh=None) -> float:
    """Memory of the device that will hold the posterior draws.

    On an accelerator this is the allocator's limit (`bytes_limit`); on the
    CPU backend the draws live in host RAM.
    """
    dev = mesh.devices.flat[0] if mesh is not None else jax.devices()[0]
    if dev.platform == "cpu":
        return float(os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES"))
    return float(dev.memory_stats()["bytes_limit"])


def do_inference(
    my_df: pd.DataFrame,
    formula: str,
    sample: str,
    transcript: str,
    abundance: str,
    do_check: str,
    *,
    approximate_posterior_inference: bool,
    approximate_posterior_analysis: bool,
    X: np.ndarray,
    sorted_sample_names: list[str],
    exposure_by_sample: dict[str, float],
    adj_prob_theshold: float,
    how_many_posterior_draws: float,
    cores: int,
    seed: int,
    to_exclude: pd.DataFrame | None = None,
    truncation_compensation: float = 1.0,
    save_generated_quantities: bool = False,
    additional_parameters_to_save: tuple[str, ...] = (),
    tol_rel_obj: float = 0.01,
    pass_fit: bool = False,
    mcmc_sampler: str = "hmc",
    hmc_adapt_trajectory: bool = False,
    mesh=None,
    dtype=jnp.float32,
) -> InferenceResult:
    """One fit + CI extraction + outlier annotation (reference R/utilities.R:1321-1547).

    With `mesh` (a jax.sharding.Mesh) the fit itself runs multi-device — the
    equivalent of the parallelism the reference runs INSIDE every
    Stan fit (map_rect gene fan-out, stan:226-240; chain processes,
    R/utilities.R:1497-1502). The mesh's axis names select the layout:

    - a `genes` axis: gene-data-parallel. The gene count is padded to the
      shard count, per-gene model data/parameters carry `genes`
      NamedShardings, and the fit runs on the pytree state (ADVI and the
      tree-state jittered HMC); XLA GSPMD inserts the log-density psums.
    - a `chains` axis (without `genes`): the flat-state samplers shard their
      chain batch across devices (pure data parallelism; ADVI warm start
      stays replicated — it is a single small optimization).
    - both axes (2-D mesh): gene-sharded state with the chain batch sharded
      too.

    The posterior draws stay sharded on device; CI extraction and the PPC
    consume them in place.
    """
    from ppcseq.utils.log import breadcrumb

    breadcrumb("executing do_inference")
    md = ingest.build_model_data(
        my_df, sample, transcript, abundance, do_check,
        X, sorted_sample_names, exposure_by_sample,
        exclude=to_exclude,
    )
    mesh_genes = mesh is not None and "genes" in mesh.axis_names
    mesh_chains = mesh is not None and "chains" in mesh.axis_names
    if mesh is not None and not (mesh_genes or mesh_chains):
        raise ValueError(
            f"mesh axes {mesh.axis_names} unknown: name them 'genes' and/or 'chains'"
        )
    if mesh_chains and not mesh_genes and approximate_posterior_inference:
        import warnings

        warnings.warn(
            "mesh with a 'chains' axis has no effect on the variational fit "
            "(it is a single small optimization): the fits will run on one "
            "device. Use a 'genes' axis to shard VB, or "
            "approximate_posterior_inference=False for chain-sharded MCMC.",
            stacklevel=3,
        )
    pad_to = None
    if mesh_genes:
        from ppcseq.parallel.sharding import pad_genes

        pad_to = pad_genes(md.counts.shape[1], mesh)
    # Centered parametrization by default: with ~20 informative samples per
    # gene the centered geometry mixes better (51 vs 383 leapfrogs/draw on
    # the bundled data); the non-centered option in nb_model remains for
    # weak-data regimes.
    data, dims = nb_model.prepare_data(
        md.counts, md.X, md.exposure_rate, md.n_check,
        exclude_mask=md.exclude_mask,
        pad_genes_to=pad_to,
        dtype=dtype,
    )
    # delta-form likelihood baseline: float32-smooth evaluation
    data = nb_model.with_baseline(data, dims)
    if mesh_genes:
        if hmc_adapt_trajectory:
            raise ValueError(
                "hmc_adapt_trajectory is not supported with a 'genes' mesh "
                "axis (the trajectory-adaptive runner is flat-state only)"
            )
        return _do_inference_gene_sharded(
            my_df=my_df, md=md, data=data, dims=dims, mesh=mesh,
            formula=formula, sample=sample, transcript=transcript,
            abundance=abundance, do_check=do_check, X=X,
            approximate_posterior_inference=approximate_posterior_inference,
            approximate_posterior_analysis=approximate_posterior_analysis,
            adj_prob_theshold=adj_prob_theshold,
            how_many_posterior_draws=how_many_posterior_draws,
            sorted_sample_names=sorted_sample_names,
            seed=seed, truncation_compensation=truncation_compensation,
            save_generated_quantities=save_generated_quantities,
            additional_parameters_to_save=additional_parameters_to_save,
            pass_fit=pass_fit, mcmc_sampler=mcmc_sampler, dtype=dtype,
        )
    # FLAT [D] state everywhere in this driver: every integrator/optimizer
    # op is one fused vector op (the pytree state costs ~10 small ops per
    # step and is reserved for gene-sharded multi-chip, parallel/sharding).
    # flat_logp(dims) has stable identity and takes `data` as an operand, so
    # the two passes (same shapes, different masks) share ONE compile.
    logp = nb_model.flat_logp(dims)
    init_flat = jnp.asarray(nb_model.smart_init(data, dims), dtype)

    # If CI analysis is approximated, only ~1000 actual draws are needed
    # (reference R/utilities.R:1372)
    draws_practical = (
        K.APPROX_ANALYSIS_PRACTICAL_DRAWS
        if approximate_posterior_analysis
        else int(np.ceil(how_many_posterior_draws))
    )

    key = jax.random.PRNGKey(seed)
    k_fit, k_draws, k_ci = jax.random.split(key, 3)

    fit_info: dict[str, Any] = {}
    if approximate_posterior_inference:
        with timed("variational fit"):
            res = vb_iterative(
                logp, dims.dim, k_fit,
                data=data,
                max_iter=K.VB_MAX_ITER,
                tol_rel_obj=K.VB_TOL_REL_OBJ,  # hard-coded in reference R/utilities.R:1493
                init_mean=init_flat,
                dtype=dtype,
            )
        thetas = advi_sample(res, k_draws, draws_practical, dtype=dtype)
        fit_info = {"method": "advi", "elbo": res.elbo, "iterations": res.iterations}
        fit_obj = res
    else:
        # ADVI warm start: a quick meanfield fit supplies the sampler's
        # initial point and diagonal mass matrix. Cold Welford adaptation
        # over ~1000 dims from 150 warmup iterations is fragile (and
        # bifurcates into a tiny-step basin under f32 evaluation
        # roughness); the ADVI scales make step-size search start in the
        # right regime.
        warm = fit_advi(
            logp, dims.dim, jax.random.fold_in(k_fit, 99),
            data=data,
            init_mean=init_flat, tol_rel_obj=0.01, learning_rate=0.3,
            eval_every=50, grad_samples=4,
            dtype=dtype,
        )
        inv_mass = np.exp(2.0 * np.asarray(warm.log_sd))
        chain_mesh = mesh if mesh_chains else None
        breadcrumb(f"executing {mcmc_sampler} fit")
        if mcmc_sampler == "hmc":
            chains = K.HMC_CHAINS
            if mesh_chains:
                # chain batch must divide evenly across the chain shards
                n_dev = mesh.shape["chains"]
                chains = -(-chains // n_dev) * n_dev
            per_chain = int(np.ceil(draws_practical / chains))
            # divergence-retry ladder (the MCMC analog of vb_iterative,
            # reference R/utilities.R:246-278): tighten target accept if
            # more than 2% of proposals diverge
            for attempt, ta in enumerate((0.8, 0.95, 0.99)):
                res = run_hmc(
                    logp, dims.dim, jax.random.fold_in(k_fit, attempt),
                    data=data,
                    num_chains=chains,
                    num_warmup=K.HMC_WARMUP,
                    num_draws=per_chain,
                    num_leapfrog=K.HMC_LEAPFROG,
                    target_accept=ta,
                    init_theta=warm.mean,
                    inv_mass=inv_mass,
                    mesh=chain_mesh,
                    adapt_trajectory=hmc_adapt_trajectory,
                    dtype=dtype,
                )
                if res.divergences.sum() <= 0.02 * chains * per_chain:
                    break
                print(f"ppcseq says: {int(res.divergences.sum())} divergent "
                      f"transitions at target_accept={ta}; retrying tighter")
            fit_info = {
                "method": "hmc",
                "chains": chains,
                "divergences": res.divergences.tolist(),
                "step_size": res.step_size,
                "target_accept": ta,
            }
            if res.trajectory_length is not None:
                fit_info["trajectory_length"] = res.trajectory_length
        elif mcmc_sampler == "nuts":
            chains = chains_for_run(draws_practical, cores)
            if mesh_chains:
                n_dev = mesh.shape["chains"]
                chains = max(chains, n_dev) if chains % n_dev == 0 else -(-chains // n_dev) * n_dev
            per_chain = mcmc_iterations(draws_practical, chains)
            res = run_nuts(
                logp, dims.dim, k_fit,
                data=data,
                num_chains=chains,
                num_warmup=K.MCMC_WARMUP,
                num_draws=per_chain,
                init_theta=jnp.asarray(warm.mean, dtype),
                inv_mass_init=jnp.asarray(inv_mass, dtype),
                mesh=chain_mesh,
                dtype=dtype,
            )
            fit_info = {
                "method": "nuts",
                "chains": chains,
                "divergences": res.divergences.tolist(),
                "step_size": res.step_size.tolist(),
            }
        else:
            raise ValueError(f"unknown mcmc_sampler {mcmc_sampler!r} (use 'hmc' or 'nuts')")
        # convergence diagnostics on the parameters that drive the calls
        # (slope block + the 6 hyperparameters); the reference drops rstan's
        # n_eff/Rhat (R/utilities.R:699) — we surface them instead
        from ppcseq.infer.diagnostics import summarize as diag_summarize

        # slice the diagnostic block ON DEVICE so only [chains, draws, ~21]
        # floats cross the host link, not the full [chains, draws, D] stack
        if getattr(res.draws, "ndim", 0) == 3 and res.draws.shape[1] >= 4:
            sel = np.r_[0:6, 6 + 2 * dims.G : 6 + 2 * dims.G + dims.n_check]
            d = diag_summarize(np.asarray(res.draws[:, :, sel]))
            fit_info["rhat_max"] = d["rhat_max"]
            fit_info["ess_min"] = d["ess_min"]
        thetas = jnp.reshape(res.draws, (-1, dims.dim))
        fit_obj = res

    return _finish_inference(
        thetas=thetas, fit=fit_obj if pass_fit else fit_info,
        md=md, data=data, dims=dims, my_df=my_df, formula=formula,
        sample=sample, transcript=transcript, abundance=abundance,
        do_check=do_check, X=X, sorted_sample_names=sorted_sample_names,
        approximate_posterior_analysis=approximate_posterior_analysis,
        adj_prob_theshold=adj_prob_theshold,
        how_many_posterior_draws=how_many_posterior_draws,
        truncation_compensation=truncation_compensation,
        save_generated_quantities=save_generated_quantities,
        additional_parameters_to_save=additional_parameters_to_save,
        pass_fit=pass_fit, k_ci=k_ci, dtype=dtype, mesh=mesh,
    )


def _finish_inference(
    *, thetas, fit, md, data, dims, my_df, formula, sample, transcript,
    abundance, do_check, X, sorted_sample_names,
    approximate_posterior_analysis, adj_prob_theshold,
    how_many_posterior_draws, truncation_compensation,
    save_generated_quantities, additional_parameters_to_save,
    pass_fit, k_ci, dtype, mesh=None,
) -> InferenceResult:
    """CI extraction + PPC decision + outlier annotation, from posterior draws.

    The second half of the reference's do_inference (R/utilities.R:1516-1544);
    shared by the single-device (flat-state) and mesh (pytree-state) drivers.
    `thetas` is a flat [n, D] array or a stacked pytree — either may be
    sharded over a mesh; all extraction/PPC math consumes it in place.
    """
    from ppcseq.utils.log import timed as _timed

    lambda_log_draws, sigma_raw_draws = nb_model.extract_lambda_sigma_draws(thetas, data, dims)
    alpha1_draws = nb_model.extract_alpha_sub_1_draws(thetas, dims)
    if mesh is not None and jax.process_count() > 1:
        # Multi-host: the fit ran sharded across processes, but everything
        # from here on is host-side table assembly over the (small)
        # checked-gene block — all-gather it to every process so np.asarray
        # sees fully-addressable arrays (the reference's analog is rstan
        # collecting draws on the driver after MPI map_rect, SURVEY §5).
        from jax.sharding import NamedSharding, PartitionSpec as P

        rep = jax.jit(lambda t: t, out_shardings=NamedSharding(mesh, P()))
        lambda_log_draws, sigma_raw_draws, alpha1_draws = rep(
            (lambda_log_draws, sigma_raw_draws, alpha1_draws)
        )
    slope_mean = np.asarray(jnp.mean(alpha1_draws, axis=0))  # posterior mean per checked gene

    # Extra constrained-parameter draws the user asked to keep (reference
    # additional_parameters_to_save, R/methods.R:90, R/utilities.R:1506-1510)
    additional: dict[str, np.ndarray] = {}
    if additional_parameters_to_save:
        if isinstance(thetas, dict):
            constrained = jax.vmap(
                lambda t: nb_model.unpack_tree(t, dims.non_centered)[0]
            )(thetas)
        else:
            constrained = jax.vmap(
                lambda th: nb_model.unpack(th, dims)[0]
            )(thetas)
        derived = {
            "sigma": lambda: jnp.exp(constrained["sigma_raw"]) ** -1,
            "lambda_log_param": lambda: lambda_log_draws,
            "counts_rng": lambda: None,  # handled by save_generated_quantities
        }
        for name in additional_parameters_to_save:
            if name in constrained:
                additional[name] = np.asarray(constrained[name])
            elif name in derived:
                v = derived[name]()
                if v is not None:
                    additional[name] = np.asarray(v)
            else:
                raise ValueError(
                    f"unknown parameter {name!r}; available: "
                    f"{sorted(constrained.keys() | derived.keys())}"
                )

    counts_rng = None
    if approximate_posterior_analysis:
        # reference breadcrumb: "executing fit_to_counts_rng_approximated"
        # (R/utilities.R:736)
        with _timed("CI extraction (approximated)"):
            ci = approximated_ci(
                k_ci, lambda_log_draws, sigma_raw_draws,
                jnp.asarray(md.exposure_rate, dtype),
                adj_prob_theshold, int(np.ceil(how_many_posterior_draws)),
                truncation_compensation,
            )
    else:
        # the full [draws, S, K] counts_rng is only kept on host when the
        # user asked for generated quantities; otherwise the gene-chunked
        # summaries suffice and the exact path stays O(tile) in memory
        # (reference breadcrumb "executing fit_to_counts_rng", R/utilities.R:687)
        with _timed("CI extraction (exact)"):
            ci, rng_draws = exact_ci(
                k_ci, lambda_log_draws, sigma_raw_draws,
                jnp.asarray(md.exposure_rate, dtype),
                adj_prob_theshold, truncation_compensation,
                return_draws=save_generated_quantities or pass_fit,
            )
        counts_rng = None if rng_draws is None else np.asarray(rng_draws)

    # Assemble the per-(S, checked G) table
    nc = dims.n_check
    check_df = my_df[my_df[do_check].astype(bool)][
        [transcript, sample, abundance, "S", "G"] + parse_formula(formula)
    ].copy()
    check_df = check_df[check_df["G"] < nc].reset_index(drop=True)
    s_idx = check_df["S"].to_numpy()
    g_idx = check_df["G"].to_numpy()
    check_df[".lower"] = ci["lower"][s_idx, g_idx]
    check_df[".upper"] = ci["upper"][s_idx, g_idx]
    check_df["mean"] = ci["mean"][s_idx, g_idx]
    check_df["sd"] = ci["sd"][s_idx, g_idx]

    # PPC decision (reference check_if_within_posterior, R/utilities.R:651-663)
    counts_vals = check_df[abundance].to_numpy()
    check_df["ppc"] = (counts_vals >= check_df[".lower"]) & (counts_vals <= check_df[".upper"])
    check_df["is higher than mean"] = (~check_df["ppc"]) & (counts_vals > check_df["mean"])

    # Slope = posterior mean of alpha_sub_1[G] (R/utilities.R:1531)
    check_df["slope"] = slope_mean[g_idx]

    # Deleterious annotation (reference add_deleterious_if_covariate_exists,
    # R/utilities.R:493-513): only when the design has a covariate
    if X.shape[1] > 1:
        pos_in_sorted = {name: i for i, name in enumerate(sorted_sample_names)}
        foi = np.asarray(X, dtype=np.float64)[:, 1]
        foi_by_s = foi[[pos_in_sorted[s] for s in md.sample_names]]
        is_group_right = foi_by_s[s_idx] > foi.mean()
        slope = check_df["slope"].to_numpy()
        is_group_high = ((slope > 0) & is_group_right) | ((slope < 0) & ~is_group_right)
        check_df["deleterious_outliers"] = (~check_df["ppc"]) & (
            check_df["is higher than mean"].to_numpy() == is_group_high
        )

    if save_generated_quantities:
        if counts_rng is None:
            raise ValueError("generated quantities require the exact CI path")
        gq = [
            pd.DataFrame({".draw": np.arange(counts_rng.shape[0]) + 1,
                          ".value": counts_rng[:, s, g]})
            for s, g in zip(s_idx, g_idx)
        ]
        check_df["generated quantities"] = gq

    total_draws = int(dims.S * nc * how_many_posterior_draws)
    return InferenceResult(
        table=check_df,
        total_draws=total_draws,
        fit=fit,
        counts_rng=counts_rng,
        additional_parameters=additional,
    )


def _do_inference_gene_sharded(
    *, my_df, md, data, dims, mesh, formula, sample, transcript, abundance,
    do_check, X, approximate_posterior_inference, approximate_posterior_analysis,
    adj_prob_theshold, how_many_posterior_draws, sorted_sample_names, seed,
    truncation_compensation, save_generated_quantities,
    additional_parameters_to_save, pass_fit, mcmc_sampler, dtype,
) -> InferenceResult:
    """Gene-sharded fit: the map_rect analog inside the product pipeline.

    The reference fans the likelihood across threads/MPI ranks on EVERY fit
    (map_rect, stan:226-240, R/utilities.R:1479); here the state is the
    parameter pytree whose per-gene leaves ([G] = intercept, sigma_raw, and
    the [S, G] model data) carry `genes` NamedShardings over the mesh, so
    every elementwise leapfrog/ELBO op stays local per gene shard and XLA
    GSPMD inserts psums only for the scalar log-density reductions. Both
    inference branches run sharded: ADVI (the VB default) and the tree-state
    jittered HMC / NUTS. When the mesh also names a `chains` axis, the chain
    batch is device-sharded too (2-D chain x gene parallelism). Draws stay
    sharded on device; extraction and the PPC consume them in place.
    """
    from ppcseq.infer.hmc import run_hmc_tree
    from ppcseq.model.params import SCALAR_NAMES, zeros_tree
    from ppcseq.parallel.sharding import shard_data, shard_params

    logp = nb_model.tree_logp(dims)
    init_tree = jax.tree.map(
        lambda x: jnp.asarray(x, dtype), nb_model.smart_init(data, dims, as_tree=True)
    )
    data_sh = shard_data(data, mesh)
    init_sh = shard_params(init_tree, mesh, dims)
    proto_sh = shard_params(zeros_tree(dims, dtype), mesh, dims)

    draws_practical = (
        K.APPROX_ANALYSIS_PRACTICAL_DRAWS
        if approximate_posterior_analysis
        else int(np.ceil(how_many_posterior_draws))
    )
    key = jax.random.PRNGKey(seed)
    k_fit, k_draws, k_ci = jax.random.split(key, 3)

    fit_info: dict[str, Any] = {"mesh": dict(mesh.shape)}
    if approximate_posterior_inference:
        with timed("variational fit (gene-sharded)"):
            res = vb_iterative(
                logp, proto_sh, k_fit, data=data_sh,
                max_iter=K.VB_MAX_ITER, tol_rel_obj=K.VB_TOL_REL_OBJ,
                init_mean=init_sh, dtype=dtype,
            )
        thetas = advi_sample(res, k_draws, draws_practical, dtype=dtype)
        fit_info.update(method="advi", elbo=res.elbo, iterations=res.iterations)
        fit_obj = res
    else:
        warm = fit_advi(
            logp, proto_sh, jax.random.fold_in(k_fit, 99), data=data_sh,
            init_mean=init_sh, tol_rel_obj=0.01, learning_rate=0.3,
            eval_every=50, grad_samples=4, dtype=dtype,
        )
        inv_mass = jax.tree.map(lambda ls: jnp.exp(2.0 * ls), warm.log_sd)
        if mcmc_sampler == "hmc":
            chains = K.HMC_CHAINS
            if "chains" in mesh.axis_names:
                n_dev = mesh.shape["chains"]
                chains = -(-chains // n_dev) * n_dev
            per_chain = int(np.ceil(draws_practical / chains))
            # same divergence-retry ladder as the flat driver
            for attempt, ta in enumerate((0.8, 0.95, 0.99)):
                res = run_hmc_tree(
                    logp, proto_sh, jax.random.fold_in(k_fit, attempt),
                    data=data_sh,
                    num_chains=chains,
                    num_warmup=K.HMC_WARMUP,
                    num_draws=per_chain,
                    num_leapfrog=K.HMC_LEAPFROG,
                    target_accept=ta,
                    init_theta=warm.mean,
                    inv_mass=inv_mass,
                    mesh=mesh, dims=dims, dtype=dtype,
                )
                if res.divergences.sum() <= 0.02 * chains * per_chain:
                    break
                print(f"ppcseq says: {int(res.divergences.sum())} divergent "
                      f"transitions at target_accept={ta}; retrying tighter")
            fit_info.update(
                method="hmc", chains=chains, step_size=res.step_size,
                divergences=res.divergences.tolist(), target_accept=ta,
            )
        elif mcmc_sampler == "nuts":
            # gene-sharded NUTS compiles (tests/test_sharding.py) but GSPMD
            # partitioning of the dynamic tree build is slow at large G —
            # HMC is the at-scale gene-sharded mode (docs/ARCHITECTURE.md §6)
            from ppcseq.infer.nuts import run_nuts as _run_nuts

            chains = 4
            if "chains" in mesh.axis_names:
                # like the HMC branch: the chain batch must divide across
                # the chain shards
                n_dev = mesh.shape["chains"]
                chains = -(-chains // n_dev) * n_dev
            per_chain = int(np.ceil(draws_practical / chains))
            res = _run_nuts(
                logp, proto_sh, k_fit, data=data_sh,
                num_chains=chains, num_warmup=K.MCMC_WARMUP,
                num_draws=per_chain, init_theta=warm.mean,
                inv_mass_init=inv_mass,
                mesh=mesh, dims=dims, dtype=dtype,
            )
            fit_info.update(
                method="nuts", chains=chains,
                divergences=res.divergences.tolist(),
            )
        else:
            raise ValueError(f"unknown mcmc_sampler {mcmc_sampler!r} (use 'hmc' or 'nuts')")
        # convergence diagnostics on the call-driving block (hyperparameters
        # + slopes), assembled from the pytree draws
        from ppcseq.infer.diagnostics import summarize as diag_summarize

        if per_chain >= 4:
            blk = np.concatenate(
                [
                    np.stack([np.asarray(res.draws[n]) for n in SCALAR_NAMES], axis=-1),
                    np.asarray(res.draws["alpha_sub_1"]),
                ],
                axis=-1,
            )
            d = diag_summarize(blk)
            fit_info["rhat_max"] = d["rhat_max"]
            fit_info["ess_min"] = d["ess_min"]
        # flatten [chains, draws, ...] -> [n, ...]; gene leaves keep their
        # `genes` sharding, so extraction below stays on-mesh
        thetas = jax.tree.map(lambda x: x.reshape((-1,) + x.shape[2:]), res.draws)
        fit_obj = res

    return _finish_inference(
        thetas=thetas, fit=fit_obj if pass_fit else fit_info,
        md=md, data=data_sh, dims=dims, my_df=my_df, formula=formula,
        sample=sample, transcript=transcript, abundance=abundance,
        do_check=do_check, X=X, sorted_sample_names=sorted_sample_names,
        approximate_posterior_analysis=approximate_posterior_analysis,
        adj_prob_theshold=adj_prob_theshold,
        how_many_posterior_draws=how_many_posterior_draws,
        truncation_compensation=truncation_compensation,
        save_generated_quantities=save_generated_quantities,
        additional_parameters_to_save=additional_parameters_to_save,
        pass_fit=pass_fit, k_ci=k_ci, dtype=dtype, mesh=mesh,
    )


def identify_outliers(
    data: pd.DataFrame,
    formula: str = "~ 1",
    sample: str = "sample",
    transcript: str = "transcript",
    abundance: str = "count",
    significance: str = "PValue",
    do_check: str = "do_check",
    scaling_factor: str | None = None,
    percent_false_positive_genes: float = 1.0,
    how_many_negative_controls: int = 500,
    approximate_posterior_inference: bool = True,
    approximate_posterior_analysis: bool | None = True,
    draws_after_tail: int = 10,
    save_generated_quantities: bool = False,
    additional_parameters_to_save: tuple[str, ...] = (),
    cores: int | None = None,
    pass_fit: bool = False,
    do_check_only_on_detrimental: bool | None = None,
    tol_rel_obj: float = 0.01,
    just_discovery: bool = False,
    seed: int | None = None,
    adj_prob_theshold_2: float | None = None,
    mcmc_sampler: str = "hmc",
    hmc_adapt_trajectory: bool = False,
    checkpoint_dir: str | None = None,
    mesh=None,
    dtype=jnp.float32,
) -> pd.DataFrame:
    """Identify deleterious outlier observations per significant transcript.

    Mirrors the reference's public API (R/methods.R:74-98). Returns a nested
    DataFrame: one row per checked transcript with columns [transcript,
    sample_wise_data, ppc_samples_failed, tot_deleterious_outliers*]
    (*when do_check_only_on_detrimental). Provenance is in `.attrs`
    (formula, column names, total_draws; `fit 1`/`fit 2` with pass_fit;
    `additional_parameters` when requested).

    Beyond the reference surface:
    - mcmc_sampler: "hmc" (default; jittered-trajectory HMC, 128 vmapped
      chains — the batched fast path) or "nuts" (dynamic-tree sampler)
      for the approximate_posterior_inference=False route.
    - hmc_adapt_trajectory: opt-in SNAPER/ChEES trajectory-length
      adaptation for the HMC sampler (infer/hmc.py:adapt_trajectory) — use
      on cohorts whose posterior geometry may differ from the bundled
      data's, where the swept fixed trajectory (utils/constants.py) could
      be mistuned. Costs a fresh compile per shape; flat-state driver only
      (with a `genes` mesh axis it raises).
    - additional_parameters_to_save: names of constrained parameters whose
      posterior draws to keep (reference R/methods.R:90); also "sigma" and
      "lambda_log_param".
    - checkpoint_dir: persist each pass's results keyed by a config+data
      fingerprint; an identical rerun resumes without refitting.
    - mesh: a jax.sharding.Mesh — BOTH passes' fits run multi-device, the
      equivalent of the parallelism the reference runs inside every fit
      (map_rect gene fan-out + chain processes, R/utilities.R:1479-1512).
      Name the axes `genes` (gene-data-parallel: sharded model data +
      per-gene parameters, works for VB, HMC and NUTS) and/or `chains`
      (device-sharded chain batch for the MCMC samplers). E.g.
      `Mesh(np.array(jax.devices()).reshape(4, 2), ("chains", "genes"))`.
    - dtype: float32 (default) or float64 (CPU validation).
    """
    if cores is None:
        cores = os.cpu_count() or 1
    if tol_rel_obj != 0.01:
        # Faithful reference quirk: the user-facing tol_rel_obj argument is
        # accepted but the VB fit hard-codes 0.005 (R/utilities.R:1491-1493);
        # we mirror the behavior (utils/constants.VB_TOL_REL_OBJ) but — unlike
        # the reference — tell the caller instead of silently ignoring it.
        import warnings

        warnings.warn(
            "ppcseq says: tol_rel_obj is accepted for API parity but ignored — "
            f"the VB fit uses the reference's hard-coded {K.VB_TOL_REL_OBJ} "
            "(reference R/utilities.R:1491-1493; see docs/PARITY.md)"
        )
    if do_check_only_on_detrimental is None:
        do_check_only_on_detrimental = len(parse_formula(formula)) > 0
    if seed is None:
        seed = int(np.random.default_rng().integers(1, 1_000_000))

    # ---- validation (R/methods.R:110-153) --------------------------------
    ingest.check_columns_exist(data, [sample, transcript, abundance, significance])
    ingest.check_if_any_na(data, [sample, transcript, abundance, significance] + parse_formula(formula))

    if not data[do_check].astype(bool).any():
        import warnings

        warnings.warn("ppcseq says: there are no transcripts with the .do_check category. Empty result returned.")
        empty = pd.DataFrame(
            {transcript: [], "sample_wise_data": [], "ppc_samples_failed": [],
             "tot_deleterious_outliers": []}
        )
        return empty

    if approximate_posterior_inference and save_generated_quantities:
        raise ValueError(
            "Variational Bayes does not support saving generated quantities, use sampling"
        )
    if not (0 <= percent_false_positive_genes <= 100) or np.isnan(percent_false_positive_genes):
        raise ValueError("percent_false_positive_genes must be between 0 and 100")
    if data[transcript].isna().any():
        raise ValueError("There are NAs in the .transcript. Please filter those records")
    ingest.check_integer_counts(data, abundance)

    # ---- thresholds and draw counts (R/methods.R:155-167) ----------------
    n_samples = data[sample].nunique()
    if adj_prob_theshold_2 is None:
        adj_prob_theshold_2 = (
            percent_false_positive_genes / 100 / n_samples
            * (2 if do_check_only_on_detrimental else 1)
        )
    adj_prob_theshold_1 = max(0.05, adj_prob_theshold_2 * 2)
    how_many_posterior_draws_1 = max(draws_after_tail / adj_prob_theshold_1, 1000)
    how_many_posterior_draws_2 = max(draws_after_tail / adj_prob_theshold_2, 1000)

    # auto-switch to approximated CI analysis (R/methods.R:169-195)
    if approximate_posterior_analysis is None:
        approximate_posterior_analysis = how_many_posterior_draws_2 > K.APPROX_ANALYSIS_DRAW_THRESHOLD
    if not approximate_posterior_analysis:
        intercept_b, slope_b = (
            K.MEM_REGRESSION_MCMC if not approximate_posterior_inference else K.MEM_REGRESSION_VB
        )
        required = intercept_b + how_many_posterior_draws_2 * slope_b
        if required > _available_memory_bytes(mesh):
            import warnings

            warnings.warn(
                "Not enough memory to analyse the posterior with full MCMC draws; "
                "approximate_posterior_analysis set to True"
            )
            approximate_posterior_analysis = True

    # ---- data prep (R/methods.R:198-238) ---------------------------------
    work = data.assign(do_check___=data[do_check].astype(bool))
    my_df = ingest.format_input(
        work, formula, sample, transcript, abundance, "do_check___",
        significance, how_many_negative_controls,
    )
    X, x_names, x_rows = create_design_matrix(my_df, formula, sample)
    sorted_sample_names = list(x_rows[sample])

    if scaling_factor is not None:
        scal = (
            data[[sample, scaling_factor]]
            .drop_duplicates()
            .rename(columns={scaling_factor: "multiplier"})
        )
        scal["exposure_rate"] = -np.log(scal["multiplier"])
        scal["exposure_multiplier"] = np.exp(scal["exposure_rate"])
    else:
        scal = sample_scaling(my_df, sample, transcript, abundance)
    exposure_by_sample = dict(zip(scal[sample], scal["exposure_rate"]))

    common = dict(
        formula=formula,
        sample=sample,
        transcript=transcript,
        abundance=abundance,
        do_check="do_check___",
        X=X,
        sorted_sample_names=sorted_sample_names,
        exposure_by_sample=exposure_by_sample,
        cores=cores,
        tol_rel_obj=tol_rel_obj,
        mcmc_sampler=mcmc_sampler,
        hmc_adapt_trajectory=hmc_adapt_trajectory,
        mesh=mesh,
        dtype=dtype,
    )

    # ---- PASS 1: discovery (R/methods.R:268-286) -------------------------
    from ppcseq.utils import checkpoint as ckpt

    # mesh and dtype change the computation (gene padding, chain counts,
    # sharded executables; f32 vs f64 densities) — they must invalidate
    # checkpoints like any other config change
    mesh_desc = (
        None if mesh is None
        else tuple((a, int(mesh.shape[a])) for a in mesh.axis_names)
    )
    base_cfg = dict(
        formula=formula, approx_inf=approximate_posterior_inference,
        seed=seed, sampler=mcmc_sampler,
        adapt_trajectory=hmc_adapt_trajectory,
        mesh=mesh_desc, dtype=str(jnp.dtype(dtype)),
    )
    # resume is only sound when no unserialized outputs were requested —
    # same guard as pass 2 below: a pass-1 checkpoint stores the table (and
    # total_draws) but not the fit object, so with `pass_fit` requested a
    # resume would silently hand back `fit 1 = None`
    resumable1 = not pass_fit
    fp1 = ckpt.config_fingerprint(
        my_df, which="pass1", thr=adj_prob_theshold_1,
        draws=how_many_posterior_draws_1, **base_cfg,
    ) if (checkpoint_dir and resumable1) else ""
    table1 = ckpt.load_pass(checkpoint_dir, "pass1", fp1) if resumable1 else None
    if table1 is not None:
        import json as _json

        with open(os.path.join(checkpoint_dir, "meta.json")) as f:
            meta1 = _json.load(f).get("pass1", {})
        res_discovery = InferenceResult(
            table=table1, total_draws=int(meta1.get("total_draws", 0))
        )
    else:
        with timed("pass 1 (discovery fit)"):
            res_discovery = do_inference(
                my_df,
                approximate_posterior_inference=approximate_posterior_inference,
                approximate_posterior_analysis=False,
                adj_prob_theshold=adj_prob_theshold_1,
                how_many_posterior_draws=how_many_posterior_draws_1,
                # only retain the fit object (and the counts_rng host copy
                # the exact path makes for it) when the caller asked —
                # hard-coding True here shipped [draws, S, n_check] counts
                # to host on every default run
                pass_fit=pass_fit,
                seed=seed,
                **common,
            )
        if checkpoint_dir and resumable1:
            ckpt.save_pass(
                checkpoint_dir, "pass1", res_discovery.table, fp1,
                extra={"total_draws": res_discovery.total_draws},
            )
    if just_discovery:
        return res_discovery.table

    # points to exclude in pass 2 (R/methods.R:292-300)
    disc = res_discovery.table
    if do_check_only_on_detrimental:
        to_exclude = disc.loc[disc["deleterious_outliers"], ["S", "G"]]
    else:
        to_exclude = disc.loc[~disc["ppc"], ["S", "G"]]
    to_exclude = to_exclude.drop_duplicates()

    # ---- PASS 2: test at the user FP level (R/methods.R:320-342) ---------
    # resume is only sound when no unserialized outputs were requested
    resumable2 = not (pass_fit or save_generated_quantities or additional_parameters_to_save)
    fp2 = ckpt.config_fingerprint(
        my_df, which="pass2", thr=adj_prob_theshold_2,
        draws=how_many_posterior_draws_2,
        approx_analysis=approximate_posterior_analysis,
        excluded=sorted(map(tuple, to_exclude.to_numpy().tolist())),
        **base_cfg,
    ) if (checkpoint_dir and resumable2) else ""
    table2 = ckpt.load_pass(checkpoint_dir, "pass2", fp2) if resumable2 else None
    if table2 is not None:
        import json as _json

        with open(os.path.join(checkpoint_dir, "meta.json")) as f:
            meta2 = _json.load(f).get("pass2", {})
        res_test = InferenceResult(table=table2, total_draws=int(meta2.get("total_draws", 0)))
    else:
        with timed("pass 2 (truncated test fit)"):
            res_test = do_inference(
                my_df,
                approximate_posterior_inference=approximate_posterior_inference,
                approximate_posterior_analysis=approximate_posterior_analysis,
                adj_prob_theshold=adj_prob_theshold_2,
                how_many_posterior_draws=how_many_posterior_draws_2,
                to_exclude=to_exclude,
                truncation_compensation=K.TRUNCATION_COMPENSATION_PASS2,
                save_generated_quantities=save_generated_quantities,
                additional_parameters_to_save=tuple(additional_parameters_to_save),
                pass_fit=pass_fit,
                # the reference reuses the same seed for both passes
                # (R/methods.R:284, 340-341)
                seed=seed,
                **common,
            )
        if checkpoint_dir and resumable2:
            ckpt.save_pass(
                checkpoint_dir, "pass2", res_test.table, fp2,
                extra={"total_draws": res_test.total_draws},
            )

    # ---- merge (reference merge_results, R/utilities.R:539-608) ----------
    result = merge_results(
        res_discovery.table, res_test.table, formula,
        transcript, abundance, sample,
        do_check_only_on_detrimental, scal.rename(columns={sample: "__sample__"}),
        sample_colname=sample,
    )
    result.attrs["total_draws"] = res_test.total_draws
    # provenance: which (sample, gene) cells pass 1 excluded from the pass-2
    # likelihood (the reference computes but does not expose this set,
    # R/methods.R:292-300); exposed here because the two-pass procedure
    # amplifies pass-1 flags — an excluded point lowers the refit mean,
    # making the pass-2 call near-certain (docs/PARITY.md)
    excl = to_exclude.merge(
        res_discovery.table[["S", "G", transcript, sample]].drop_duplicates(),
        on=["S", "G"], how="left",
    )
    result.attrs["pass1_excluded"] = excl.reset_index(drop=True)
    result.attrs["transcript_column"] = transcript
    result.attrs["abundance_column"] = abundance
    result.attrs["sample_column"] = sample
    result.attrs["formula"] = formula
    if res_test.additional_parameters:
        result.attrs["additional_parameters"] = res_test.additional_parameters
    if pass_fit:
        result.attrs["fit 1"] = res_discovery.fit
        result.attrs["fit 2"] = res_test.fit
    return result


def merge_results(
    disc: pd.DataFrame,
    test: pd.DataFrame,
    formula: str,
    transcript: str,
    abundance: str,
    sample: str,
    do_check_only_on_detrimental: bool,
    sample_exposure: pd.DataFrame,
    sample_colname: str,
) -> pd.DataFrame:
    """Nest per-transcript results (reference R/utilities.R:539-608)."""
    covariates = parse_formula(formula)
    left = disc[["S", "G", transcript, abundance, sample] + covariates].copy()
    left["slope_before_outlier_filtering"] = disc["slope"]

    right_cols = ["S", "G", ".lower", ".upper"]
    right = test[right_cols].copy()
    right["slope_after_outlier_filtering"] = test["slope"]
    right["posterior_predictive_check_succeded"] = test["ppc"]
    if "deleterious_outliers" in test.columns:
        right["deleterious_outliers"] = test["deleterious_outliers"]
    if "generated quantities" in test.columns:
        right["generated quantities"] = test["generated quantities"]

    merged = left.merge(right, on=["S", "G"], how="left")
    exp_map = sample_exposure.set_index("__sample__")
    merged["exposure_rate"] = merged[sample].map(exp_map["exposure_rate"])
    merged["multiplier"] = merged[sample].map(exp_map["multiplier"])

    rows = []
    for name, grp in merged.groupby(transcript, sort=False):
        entry = {
            transcript: name,
            "sample_wise_data": grp.drop(columns=[transcript]).reset_index(drop=True),
            "ppc_samples_failed": int((~grp["posterior_predictive_check_succeded"]).sum()),
        }
        if do_check_only_on_detrimental:
            entry["tot_deleterious_outliers"] = int(grp["deleterious_outliers"].sum())
        rows.append(entry)
    return pd.DataFrame(rows)
