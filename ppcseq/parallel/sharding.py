"""Gene-axis sharding over a device mesh.

The reference shards genes round-robin into map_rect shards fanned across
TBB threads / MPI ranks (R/utilities.R:125-174, stan:226-240), marshalling a
packed parameter vector per evaluation. The equivalent here is XLA SPMD:
per-gene arrays carry a NamedSharding over a 1-D `genes` mesh axis;
elementwise model math stays local per shard, the matmul X[S,C] @ alpha[C,G]
needs no communication (X replicated, alpha gene-sharded), and the scalar
reductions in the log-density / NUTS dot products become all-reduces, which
XLA hands to NCCL on GPUs. The cards of one host are joined all to all, so
the mesh is a flat axis and follows the algorithm alone.
Nothing is marshalled: parameters live sharded on device across the whole
trajectory.

Chains sit in a leading vmap axis and can optionally occupy a second mesh
axis when there are more devices than genes warrant.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ppcseq.model import nb_model
from ppcseq.model.params import GENE_NAMES, SCALAR_NAMES


def gene_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """1-D mesh over the `genes` axis."""
    if devices is None:
        devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.array(devices), ("genes",))


def pad_genes(G: int, mesh: Mesh) -> int:
    """Smallest gene count >= G that splits evenly across the `genes` shards.

    The padded genes are masked out of the likelihood and the hierarchical
    priors (nb_model.prepare_data), so padding never changes a call.
    """
    n = mesh.shape["genes"]
    return -(-G // n) * n


def data_shardings(mesh: Mesh, chain_axis: bool = False):
    """NamedShardings for ModelData fields ([S, G] arrays gene-sharded)."""
    sg = NamedSharding(mesh, P(None, "genes"))
    g = NamedSharding(mesh, P("genes"))
    rep = NamedSharding(mesh, P())
    return nb_model.ModelData(
        counts=sg,
        X=rep,
        exposure_rate=rep,
        like_mask=sg,
        gene_mask=g,
        alpha0=sg,  # [C, G]
        sigma_raw0=g,
        d0=sg,
        sp_d0=sg,
        sig_neg_d0=sg,
        y_sp0=sg,
    )


def param_shardings(mesh: Mesh, dims: nb_model.ModelDims, chain_axis=False) -> dict:
    """Shardings for the unconstrained parameter pytree.

    Per-gene leaves shard over `genes`; scalars and the (small) checked-gene
    coefficient blocks replicate. chain_axis controls the leading dimension
    of stacked [chains, ...] states: False = no leading dim, True = leading
    replicated dim, or a mesh-axis name (e.g. "chains") to shard the chain
    batch too (2-D chain x gene parallelism).
    """
    if chain_axis is False:
        lead = ()
    elif chain_axis is True:
        lead = (None,)
    else:
        lead = (chain_axis,)
    tree = {name: NamedSharding(mesh, P(*lead)) for name in SCALAR_NAMES}
    for name in GENE_NAMES:
        tree[name] = NamedSharding(mesh, P(*lead, "genes"))
    tree["alpha_sub_1"] = NamedSharding(mesh, P(*lead))
    if dims.C > 2:
        tree["alpha_2"] = NamedSharding(mesh, P(*lead, None))
    return tree


def shard_data(data: nb_model.ModelData, mesh: Mesh) -> nb_model.ModelData:
    """device_put every (non-None) ModelData field with its mesh sharding."""
    import dataclasses

    sh = data_shardings(mesh)
    kwargs = {}
    for f in dataclasses.fields(nb_model.ModelData):
        v = getattr(data, f.name)
        kwargs[f.name] = None if v is None else jax.device_put(v, getattr(sh, f.name))
    return nb_model.ModelData(**kwargs)


def shard_params(tree: dict, mesh: Mesh, dims: nb_model.ModelDims, chain_axis=False) -> dict:
    sh = param_shardings(mesh, dims, chain_axis=chain_axis)
    return {k: jax.device_put(v, sh[k]) for k, v in tree.items()}
