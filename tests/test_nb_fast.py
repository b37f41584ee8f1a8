"""ops/nb_fast: the hoisted fused value+gradient likelihood.

Ground truth is float64 autodiff of the naive lpmf (where it is itself
accurate) and the established stable forms (ops.nb.nb2_log_lpmf_stable /
nb_model.delta_likelihood) elsewhere. The 'fast' path must be a drop-in for
'plain'/'analytic': same values, same gradients, f32-moderate.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ppcseq.model import nb_model
from ppcseq.ops import nb_fast
from ppcseq.ops.nb import nb2_log_lpmf, nb2_part1
from ppcseq.ops.nb_grad import phi_digamma_diff


def _toy(S=13, G=37, seed=0):
    rng = np.random.default_rng(seed)
    X = np.column_stack([np.ones(S), rng.integers(0, 2, S).astype(float)])
    exposure = rng.normal(0, 0.3, S)
    counts = np.concatenate([
        np.arange(10), [100, 1000, 10000, 100000],
        rng.poisson(np.exp(rng.normal(4, 2, S * G - 14))),
    ]).reshape(S, G).astype(np.int32)
    mask = (rng.random((S, G)) > 0.1).astype(float)
    return map(jnp.asarray, (X, exposure, counts, mask))


_REGIMES = [
    ("moderate", None),
    ("phi_huge", 75.0),
    ("phi_capped", 90.0),
    ("phi_tiny", -35.0),
]


@pytest.mark.parametrize("name,lp_fill", _REGIMES)
def test_glm_plain_matches_stable_and_autodiff(name, lp_fill):
    X, exposure, counts, mask = _toy()
    rng = np.random.default_rng(1)
    G = counts.shape[1]
    alpha = jnp.asarray(np.vstack([rng.normal(5, 1, G), rng.normal(0, 0.5, G)]))
    log_phi = jnp.asarray(
        np.full(G, lp_fill) if lp_fill is not None else rng.normal(1, 1.5, G)
    )

    data = nb_model.ModelData(
        counts=counts.astype(jnp.int32), X=X, exposure_rate=exposure,
        like_mask=mask, gene_mask=mask[0],
    )
    v_ref = nb_model.masked_likelihood(data, alpha, log_phi)
    v = nb_fast.glm_plain(X, exposure, counts, mask, alpha, log_phi, want_grads=False)
    v2, da, dp = nb_fast.glm_plain(X, exposure, counts, mask, alpha, log_phi, want_grads=True)
    np.testing.assert_allclose(float(v), float(v_ref), rtol=1e-9)
    np.testing.assert_allclose(float(v2), float(v_ref), rtol=1e-9)

    def naive(a, l):
        eta = exposure[:, None] + X @ a
        return jnp.sum(mask * nb2_log_lpmf(counts, eta, jnp.broadcast_to(l[None, :], eta.shape)))

    da_ref, dp_ref = jax.grad(naive, argnums=(0, 1))(alpha, log_phi)
    if name in ("phi_huge", "phi_capped"):
        # the naive lgamma difference breaks down in f64 at phi = e^75; the
        # value agreement above (vs the stable decomposition) carries the
        # burden, and dlogphi is checked against the analytic module instead
        from ppcseq.ops.nb_grad import likelihood_grads

        da_ref, dp_ref = likelihood_grads(X, exposure, counts, mask, alpha, log_phi)
    np.testing.assert_allclose(np.asarray(da), np.asarray(da_ref), rtol=1e-6, atol=1e-6)
    scale = 1.0 + np.abs(np.asarray(dp_ref))
    assert (np.abs(np.asarray(dp) - np.asarray(dp_ref)) / scale < 5e-7).all()


def test_glm_delta_matches_delta_likelihood():
    X, exposure, counts, mask = _toy(seed=2)
    rng = np.random.default_rng(3)
    S, G = counts.shape
    dims = nb_model.ModelDims(S=S, G=G, C=2, n_check=5, G_unpadded=G)
    data, _ = nb_model.prepare_data(
        np.asarray(counts), np.asarray(X), np.asarray(exposure), 5, dtype=jnp.float64
    )
    data = nb_model.with_baseline(data, dims)
    alpha = jnp.asarray(np.vstack([rng.normal(5, 1, G), rng.normal(0, 0.5, G)]))
    log_phi = jnp.asarray(rng.normal(1, 1.5, G))

    v_ref = nb_model.delta_likelihood(data, alpha, log_phi)
    args = (data.X, data.exposure_rate, data.counts, data.like_mask,
            data.alpha0, data.sigma_raw0, data.d0, data.sp_d0,
            data.sig_neg_d0, data.y_sp0, alpha, log_phi)
    v = nb_fast.glm_delta(*args, want_grads=False)
    v2, da, dp = nb_fast.glm_delta(*args, want_grads=True)
    np.testing.assert_allclose(float(v), float(v_ref), rtol=1e-9)
    np.testing.assert_allclose(float(v2), float(v_ref), rtol=1e-9)

    def naive(a, l):
        eta = data.exposure_rate[:, None] + data.X @ a
        return jnp.sum(data.like_mask * nb2_log_lpmf(
            data.counts, eta, jnp.broadcast_to(l[None, :], eta.shape)))

    da_ref, dp_ref = jax.grad(naive, argnums=(0, 1))(alpha, log_phi)
    np.testing.assert_allclose(np.asarray(da), np.asarray(da_ref), rtol=1e-6, atol=1e-6)
    scale = 1.0 + np.abs(np.asarray(dp_ref))
    assert (np.abs(np.asarray(dp) - np.asarray(dp_ref)) / scale < 5e-7).all()


def test_part1_and_digamma_branch_grid():
    """Every (y-branch x phi-branch) cell vs the reference stable forms."""
    ys = np.array([0, 1, 3, 7, 8, 9, 20, 100, 1000, 100000], dtype=np.float64)
    log_phis = np.array([-35.0, -2.0, 0.0, 1.5, 2.078, 2.2, 5.0, 20.0, 75.0])
    Y = np.tile(ys[:, None], (1, len(log_phis)))
    gt = nb_fast._gene_tables(jnp.asarray(log_phis), jnp.float64)
    dt = nb_fast._data_tables(jnp.asarray(Y.astype(np.int64)), jnp.float64)
    p1, pd = nb_fast._part1_and_digamma(gt, dt, want_grads=True)

    phi = np.exp(np.minimum(log_phis, 80.0))
    P = jnp.asarray(np.tile(phi[None, :], (len(ys), 1)))
    LP = jnp.asarray(np.tile(np.minimum(log_phis, 80.0)[None, :], (len(ys), 1)))
    p1_ref = nb2_part1(jnp.asarray(Y), P, LP)
    pd_ref = phi_digamma_diff(jnp.asarray(Y), P, LP)
    np.testing.assert_allclose(np.asarray(p1), np.asarray(p1_ref), rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(np.asarray(pd), np.asarray(pd_ref), rtol=1e-9, atol=1e-9)


def test_fast_log_joint_matches_plain_both_forms():
    """Through the full joint: likelihood='fast' == 'plain' (value + grad),
    with and without the delta baseline."""
    rng = np.random.default_rng(5)
    for with_base in (False, True):
        S, G, n_check = 5, 9, 3
        counts = rng.integers(0, 4000, size=(S, G)).astype(np.int32)
        X = np.column_stack([np.ones(S), rng.integers(0, 2, S).astype(float)])
        data, dims = nb_model.prepare_data(
            counts, X, rng.normal(0, 0.3, S), n_check, dtype=jnp.float64
        )
        if with_base:
            data = nb_model.with_baseline(data, dims)
        theta = jnp.asarray(rng.normal(0.0, 0.4, dims.dim), jnp.float64)
        lp_plain = nb_model.flat_logp(dims, "plain")(theta, data)
        lp_fast = nb_model.flat_logp(dims, "fast")(theta, data)
        np.testing.assert_allclose(float(lp_fast), float(lp_plain), rtol=1e-9)
        g_plain = jax.grad(nb_model.flat_logp(dims, "plain"))(theta, data)
        g_fast = jax.grad(nb_model.flat_logp(dims, "fast"))(theta, data)
        np.testing.assert_allclose(
            np.asarray(g_fast), np.asarray(g_plain), rtol=1e-6, atol=1e-6
        )


def test_fast_float32_moderation():
    """f32 evaluation keeps absolute accuracy on count-amplified terms
    (the property that makes float32 NUTS energies usable)."""
    X, exposure, counts, mask = _toy(seed=7)
    rng = np.random.default_rng(8)
    G = counts.shape[1]
    alpha = np.vstack([rng.normal(5, 1, G), rng.normal(0, 0.5, G)])
    log_phi = rng.normal(1, 1.5, G)

    v64, da64, dp64 = nb_fast.glm_plain(
        X, exposure, counts, mask, jnp.asarray(alpha), jnp.asarray(log_phi),
        want_grads=True,
    )
    v32, da32, dp32 = nb_fast.glm_plain(
        X.astype(jnp.float32), exposure.astype(jnp.float32),
        counts.astype(jnp.int32), mask.astype(jnp.float32),
        jnp.asarray(alpha, jnp.float32), jnp.asarray(log_phi, jnp.float32),
        want_grads=True,
    )
    # value: per-point absolute error ~1e-2 x sqrt(N) accumulation budget
    assert abs(float(v32) - float(v64)) < 2e-3 * abs(float(v64))
    y = np.asarray(counts, np.float64)
    tol = 1e-5 * (1.0 + np.abs(y).max(axis=0)) + 3e-6 * np.abs(np.asarray(dp64)) + 1e-2
    assert (np.abs(np.asarray(dp32, np.float64) - np.asarray(dp64)) < tol).all()
    tol_a = 1e-5 * (1.0 + np.abs(y).max(axis=0)) + 3e-6 * np.abs(np.asarray(da64)) + 1e-2
    assert (np.abs(np.asarray(da32, np.float64) - np.asarray(da64)) < tol_a).all()


# --- XLA-path likelihood forms against the unfolded reference ------------


def _case(S=21, G=300, C=2, n_check=4, seed=0, exclude_frac=0.05):
    rng = np.random.default_rng(seed)
    X = np.column_stack([np.ones(S)] + [rng.integers(0, 2, S).astype(float) for _ in range(C - 1)])
    alpha = rng.normal(4.0, 1.0, size=(C, G))
    alpha[1:] = rng.normal(0, 0.5, size=(C - 1, G))
    log_phi = rng.normal(0.0, 1.0, size=G)
    exposure = rng.normal(0.0, 0.3, size=S)
    eta = exposure[:, None] + X @ alpha
    counts = rng.poisson(np.minimum(np.exp(eta), 1e6)).astype(np.int64)
    exclude = rng.uniform(size=(S, G)) < exclude_frac
    data, dims = nb_model.prepare_data(
        counts, X, exposure, n_check, exclude_mask=exclude, dtype=jnp.float64
    )
    return data, dims, jnp.asarray(alpha, jnp.float64), jnp.asarray(log_phi, jnp.float64)


def _unfolded_loglik(X, alpha, log_phi, exposure, counts, mask):
    """Plain-JAX unfolded semantic reference: the naive lpmf, summed."""
    eta = exposure[:, None] + X @ alpha
    return jnp.sum(mask * nb2_log_lpmf(counts, eta, jnp.broadcast_to(log_phi[None, :], eta.shape)))


def _reference_value(data, alpha, log_phi):
    return _unfolded_loglik(
        jnp.asarray(data.X, jnp.float64),
        jnp.asarray(alpha, jnp.float64),
        jnp.asarray(log_phi, jnp.float64),
        jnp.asarray(data.exposure_rate, jnp.float64),
        data.counts,
        jnp.asarray(data.like_mask, jnp.float64),
    )


def test_stable_likelihood_equals_unfolded():
    data, dims, alpha, log_phi = _case()
    stable = nb_model.masked_likelihood(data, alpha, log_phi)
    want = _reference_value(data, alpha, log_phi)
    np.testing.assert_allclose(float(stable), float(want), rtol=1e-10)


def test_delta_likelihood_equals_unfolded():
    data, dims, alpha, log_phi = _case(seed=3)
    datab = nb_model.with_baseline(data, dims)
    delta = nb_model.masked_likelihood(datab, alpha, log_phi)  # auto-dispatches
    want = _reference_value(data, alpha, log_phi)
    # log1p/expm1_precise are float32-targeted polynomials (~1e-7 relative)
    np.testing.assert_allclose(float(delta), float(want), rtol=1e-6)
    # gradients agree with the plain form
    g_delta = jax.grad(lambda a, p: nb_model.delta_likelihood(datab, a, p), (0, 1))(alpha, log_phi)
    g_plain = jax.grad(
        lambda a, p: _unfolded_loglik(
            data.X, a, p, data.exposure_rate, data.counts, data.like_mask
        ),
        (0, 1),
    )(alpha, log_phi)
    for gd, gp in zip(g_delta, g_plain):
        np.testing.assert_allclose(np.asarray(gd), np.asarray(gp), rtol=2e-3, atol=1e-3)


def _baseline_case(S=10, G=64, n_check=4, seed=5):
    data, dims, alpha, log_phi = _case(S=S, G=G, n_check=n_check, seed=seed)
    data = nb_model.with_baseline(data, dims)
    theta = jnp.asarray(nb_model.smart_init(data, dims), jnp.float64)
    return data, dims, theta


def test_fused_xla_value_and_grad_match_autodiff():
    """The fused-XLA likelihood ('fused': gradients computed in the forward)
    must match the delta-form autodiff path: identical value, gradients
    within analytic-vs-autodiff tolerance."""
    data, dims, theta = _baseline_case()
    ref = nb_model.flat_logp(dims, "plain")  # delta form via baseline
    fused = nb_model.flat_logp(dims, "fused")
    v0, g0 = jax.value_and_grad(ref)(theta, data)
    v1, g1 = jax.value_and_grad(fused)(theta, data)
    np.testing.assert_allclose(float(v1), float(v0), rtol=1e-12)
    a0 = np.asarray(g0)
    # analytic-series error is ~1e-9 RELATIVE per point; entries that nearly
    # cancel across samples see it amplified, so bound absolutely against
    # the gradient's scale (counts here reach 1e6)
    np.testing.assert_allclose(
        np.asarray(g1), a0, rtol=1e-4, atol=1e-6 * (1 + np.abs(a0).max())
    )


def test_fused_xla_primal_has_no_grad_work():
    """Outside differentiation the primal computes the value alone and still
    equals the reference."""
    data, dims, theta = _baseline_case()
    ref = nb_model.flat_logp(dims, "plain")
    fused = nb_model.flat_logp(dims, "fused")
    np.testing.assert_allclose(
        float(fused(theta, data)), float(ref(theta, data)), rtol=1e-12
    )


# --- the float32 variants against the float64 `plain` reference ------------


@pytest.mark.parametrize("variant", ["plain", "analytic", "fused", "fast"])
@pytest.mark.parametrize("case", ["unaligned_genes", "masked_points"])
def test_f32_variant_matches_f64_plain(variant, case):
    """Each f32 likelihood (delta baseline attached, as the pipeline runs it)
    against f64 `plain`, at a gene count no tile divides and with a fifth of
    the points masked out; the bounds are chip_smoke.py's phase-2 bounds."""
    G, frac = (37, 0.0) if case == "unaligned_genes" else (64, 0.2)
    data64, dims, _, _ = _case(S=13, G=G, n_check=3, seed=4, exclude_frac=frac)
    counts = np.asarray(data64.counts)
    X = np.asarray(data64.X)
    exposure = np.asarray(data64.exposure_rate)
    exclude = np.asarray(data64.like_mask) == 0
    theta = jnp.asarray(
        nb_model.smart_init(data64, dims)
        + 0.05 * np.random.default_rng(1).standard_normal(dims.dim)
    )
    v64, g64 = jax.value_and_grad(nb_model.flat_logp(dims, "plain"))(theta, data64)

    def f32_value_and_grad(counts):
        data32, dims32 = nb_model.prepare_data(
            counts, X, exposure, 3, exclude_mask=exclude, dtype=jnp.float32
        )
        data32 = nb_model.with_baseline(data32, dims32)
        fn = jax.value_and_grad(nb_model.flat_logp(dims32, variant))
        v, g = fn(jnp.asarray(theta, jnp.float32), data32)
        return float(v), np.asarray(g, np.float64)

    v32, g32 = f32_value_and_grad(counts)
    g64 = np.asarray(g64)
    assert abs(v32 - float(v64)) <= 1e-4 * abs(float(v64))
    assert np.abs(g32 - g64).max() <= 1e-3 * np.abs(g64).max()
    if frac:
        # masked points contribute nothing, whatever their counts
        v_alt, g_alt = f32_value_and_grad(np.where(exclude, counts * 7 + 3, counts))
        np.testing.assert_allclose(v_alt, v32, rtol=1e-6)
        np.testing.assert_allclose(g_alt, g32, rtol=1e-5, atol=1e-5 * np.abs(g32).max())


@pytest.mark.parametrize("backend,want", [("cpu", "plain"), ("gpu", "fast")])
def test_auto_likelihood_per_backend(monkeypatch, backend, want):
    """'auto' resolves to the measured winner per backend (chip_smoke.py
    phase 2 on the GPU); named choices pass through unchanged."""
    monkeypatch.setattr(nb_model.jax, "default_backend", lambda: backend)
    assert nb_model._resolve_auto("auto") == want
    assert nb_model._resolve_auto("analytic") == "analytic"
