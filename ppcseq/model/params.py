"""Unconstrained-parameter pytree: structure, transforms, flat-vector bridge.

The sampler state is a dict pytree rather than a flat vector so that per-gene
leaves (`intercept`, `sigma_raw`) can carry a `genes`-axis sharding over a
device mesh while scalars stay replicated — XLA GSPMD then keeps every
elementwise leapfrog/ELBO op local and inserts psums only for the scalar
reductions. (A flat vector would interleave scalars and gene blocks across
shard boundaries and force constant resharding.)

Leaves (all unconstrained; see nb_model for the constrained meaning):
  lambda_mu, lambda_sigma, lambda_skew, sigma_slope, sigma_intercept,
  sigma_sigma                                 -> scalars ()
  intercept, sigma_raw                        -> [G]
  alpha_sub_1                                 -> [K]
  alpha_2                                     -> [C-2, K] (present iff C > 2)
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

SCALAR_NAMES = (
    "lambda_mu",
    "lambda_sigma",
    "lambda_skew",
    "sigma_slope",
    "sigma_intercept",
    "sigma_sigma",
)
GENE_NAMES = ("intercept", "sigma_raw")


def zeros_tree(dims, dtype=jnp.float32) -> dict:
    tree = {name: jnp.zeros((), dtype) for name in SCALAR_NAMES}
    tree["intercept"] = jnp.zeros(dims.G, dtype)
    tree["sigma_raw"] = jnp.zeros(dims.G, dtype)
    tree["alpha_sub_1"] = jnp.zeros(dims.n_check, dtype)
    if dims.C > 2:
        tree["alpha_2"] = jnp.zeros((dims.C - 2, dims.n_check), dtype)
    return tree


def tree_size(tree) -> int:
    return sum(int(np.prod(jnp.shape(leaf))) for leaf in jax.tree.leaves(tree))


# --- generic pytree vector algebra (used by NUTS/ADVI) ---------------------


def tree_add(a, b):
    return jax.tree.map(jnp.add, a, b)


def tree_sub(a, b):
    return jax.tree.map(jnp.subtract, a, b)


def tree_scale(c, a):
    return jax.tree.map(lambda x: c * x, a)


def tree_axpy(c, x, y):
    """y + c * x"""
    return jax.tree.map(lambda xi, yi: yi + c * xi, x, y)


def tree_mul(a, b):
    return jax.tree.map(jnp.multiply, a, b)


def tree_dot(a, b):
    parts = jax.tree.leaves(jax.tree.map(lambda x, y: jnp.vdot(x, y), a, b))
    return jnp.sum(jnp.stack(parts))


def tree_where(pred, a, b):
    return jax.tree.map(lambda x, y: jnp.where(pred, x, y), a, b)


def tree_normal_like(key, tree):
    leaves, treedef = jax.tree.flatten(tree)
    keys = jax.random.split(key, len(leaves))
    out = [jax.random.normal(k, jnp.shape(l), jnp.asarray(l).dtype) for k, l in zip(keys, leaves)]
    return jax.tree.unflatten(treedef, out)


def tree_uniform_like(key, tree, minval, maxval):
    leaves, treedef = jax.tree.flatten(tree)
    keys = jax.random.split(key, len(leaves))
    out = [
        jax.random.uniform(k, jnp.shape(l), jnp.asarray(l).dtype, minval, maxval)
        for k, l in zip(keys, leaves)
    ]
    return jax.tree.unflatten(treedef, out)


def tree_ones_like(tree):
    return jax.tree.map(jnp.ones_like, tree)


def tree_isfinite_all(tree):
    parts = jax.tree.leaves(jax.tree.map(lambda x: jnp.all(jnp.isfinite(x)), tree))
    return jnp.all(jnp.stack(parts))
