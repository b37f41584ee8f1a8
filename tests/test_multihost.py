"""2-process jax.distributed tests (CPU backend): cluster bring-up AND a
REAL fit spanning process boundaries.

The reference's MPI mode ships shard data to ranks and evaluates the
likelihood there on every sampler step (map_rect,
/root/reference/inst/stan/negBinomial_MPI.stan:226-240); it was never
multi-process-tested (SURVEY.md §4). Here two subprocesses each expose 2
virtual CPU devices, join one jax.distributed cluster (4 global devices),
and then actually *fit* across the process boundary:

- the gene-sharded log-density/gradient agree with a process-local
  evaluation (the psums really reduce across processes), and the lowered
  HLO contains cross-process all-reduces;
- `run_hmc_tree` runs warmup + sampling with gene leaves sharded over both
  processes, and its posterior moments agree with a process-local fit;
- `identify_outliers(mesh=pod_mesh(...))` — the PRODUCT — runs both passes
  gene-sharded across the cluster and returns the same outlier calls as a
  process-local run.

Process 0 writes a MULTIHOST artifact (wall clocks, collective counts,
agreement numbers) to $PPCSEQ_MULTIHOST_OUT when set.
"""

import os
import socket
import subprocess
import sys

_WORKER = r"""
import os, sys, time, json
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=2"
)
sys.path.insert(0, os.environ["PPCSEQ_REPO"])

import numpy as np
import jax

jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp

from ppcseq.parallel import multihost

pid = int(sys.argv[1])
multihost.initialize(
    coordinator_address=os.environ["PPCSEQ_COORD"],
    num_processes=2,
    process_id=pid,
)
assert jax.process_count() == 2, jax.process_count()
assert jax.device_count() == 4, jax.device_count()
assert jax.local_device_count() == 2

mesh = multihost.pod_mesh()
assert set(mesh.axis_names) == {"chains", "genes"}
assert mesh.devices.size == 4

from jax.sharding import NamedSharding, PartitionSpec as P

# ---- smoke: psum-backed reduction over a gene-sharded array ---------------
gene_mesh = multihost.pod_mesh(chains_axis=1)  # (chains=1, genes=4): the
# gene axis spans BOTH processes
span = {d.process_index for d in gene_mesh.devices.reshape(-1)}
assert span == {0, 1}, span
G = 8
sharding = NamedSharding(gene_mesh, P(None, "genes"))
local = np.arange(G, dtype=np.float32)[None, :]
arr = jax.make_array_from_process_local_data(sharding, local, (1, G))
total = jax.jit(jnp.sum, out_shardings=NamedSharding(gene_mesh, P()))(arr)
val = float(np.asarray(total))
assert val == float(np.arange(G).sum()), val

artifact = {"process_count": 2, "device_count": 4}

# ---- a REAL model fit across the process boundary -------------------------
from ppcseq.model import nb_model
from ppcseq.model.params import zeros_tree
from ppcseq.infer.hmc import run_hmc_tree
from ppcseq.parallel.sharding import shard_data, shard_params

rng = np.random.default_rng(0)
S, GG, n_check = 6, 64, 4
counts = rng.poisson(40.0, size=(S, GG))
X = np.column_stack([np.ones(S), rng.integers(0, 2, size=S).astype(float)])
exposure = rng.normal(0, 0.2, size=S)
data, dims = nb_model.prepare_data(counts, X, exposure, n_check, dtype=jnp.float32)
logp = nb_model.tree_logp(dims, likelihood="plain")
init = nb_model.smart_init(data, dims, as_tree=True)
local_dev = jax.local_devices()[0]

# 1) cross-process log-density == process-local log-density (the psum
#    really reduces over both processes' gene shards)
data_sh = shard_data(data, gene_mesh)
init_sh = shard_params(init, gene_mesh, dims)
lp_sh = float(np.asarray(
    jax.jit(logp, out_shardings=NamedSharding(gene_mesh, P()))(init_sh, data_sh)
))
with jax.default_device(local_dev):
    lp_loc = float(jax.jit(logp)(init, data))
assert abs(lp_sh - lp_loc) <= 1e-4 * abs(lp_loc) + 1e-3, (lp_sh, lp_loc)
artifact["logp_sharded"] = lp_sh
artifact["logp_local"] = lp_loc

# 2) the lowered gradient HLO carries cross-process all-reduces
hlo = (
    jax.jit(jax.value_and_grad(logp))
    .lower(init_sh, data_sh)
    .compile()
    .as_text()
)
n_ar = hlo.count("all-reduce(")  # incl. fusions' all-reduce ops
assert n_ar >= 1, "no all-reduce in the cross-process gradient HLO"
artifact["grad_all_reduces"] = n_ar

# 3) gene-sharded HMC spanning both processes: warmup + sampling, finite
#    draws, moments agree with a process-local fit
kw = dict(num_chains=4, num_warmup=30, num_draws=40, num_leapfrog=8)
t0 = time.time()
res_sh = run_hmc_tree(
    logp, zeros_tree(dims), jax.random.PRNGKey(2), data=data,
    init_theta=init, mesh=gene_mesh, dims=dims, **kw,
)
# all-gather to every process before host conversion (the compiler may
# leave even small output leaves sharded across processes)
rep = jax.jit(lambda x: x, out_shardings=NamedSharding(gene_mesh, P()))
a1_sh = np.asarray(rep(res_sh.draws["alpha_sub_1"]))
wall_sh = time.time() - t0
assert np.isfinite(a1_sh).all()
ic_finite = bool(np.asarray(jax.jit(
    lambda t: jnp.all(jnp.isfinite(t["intercept"])),
    out_shardings=NamedSharding(gene_mesh, P()),
)(res_sh.draws)))
assert ic_finite, "non-finite gene-sharded intercept draws"
assert 0.2 < res_sh.accept_prob.mean() <= 1.0, res_sh.accept_prob.mean()

with jax.default_device(local_dev):
    res_loc = run_hmc_tree(
        logp, zeros_tree(dims), jax.random.PRNGKey(2), data=data,
        init_theta=init, **kw,
    )
a1_loc = np.asarray(res_loc.draws["alpha_sub_1"])
m_sh, m_loc = a1_sh.mean(axis=(0, 1)), a1_loc.mean(axis=(0, 1))
mc_err = a1_loc.std() / np.sqrt(a1_loc.shape[0] * a1_loc.shape[1]) + 1e-3
np.testing.assert_allclose(m_sh, m_loc, atol=10 * mc_err)
artifact["hmc_wall_s"] = round(wall_sh, 3)
artifact["hmc_draws_per_s"] = round(kw["num_chains"] * kw["num_draws"] / wall_sh, 1)
artifact["hmc_accept"] = round(float(res_sh.accept_prob.mean()), 3)
artifact["hmc_slope_mean_delta"] = float(np.abs(m_sh - m_loc).max())

# 4) the PRODUCT across the cluster: identify_outliers(mesh=) both passes
from ppcseq.pipeline.identify import identify_outliers
from ppcseq.utils.synthetic import synthetic_tidy

df = synthetic_tidy(n_genes=64, n_samples=8, n_check=3, outlier_frac=0.15, seed=0)
t0 = time.time()
res_pipe = identify_outliers(
    df, formula="~ Label", how_many_negative_controls=40,
    approximate_posterior_inference=True, seed=42, mesh=gene_mesh,
)
wall_pipe = time.time() - t0
with jax.default_device(local_dev):
    res_ref = identify_outliers(
        df, formula="~ Label", how_many_negative_controls=40,
        approximate_posterior_inference=True, seed=42,
    )
calls_sh = res_pipe.tot_deleterious_outliers.tolist()
calls_loc = res_ref.tot_deleterious_outliers.tolist()
assert calls_sh == calls_loc, (calls_sh, calls_loc)
assert res_pipe.ppc_samples_failed.tolist() == res_ref.ppc_samples_failed.tolist()
artifact["pipeline_wall_s"] = round(wall_pipe, 2)
artifact["pipeline_calls"] = calls_sh

if pid == 0 and os.environ.get("PPCSEQ_MULTIHOST_OUT"):
    with open(os.environ["PPCSEQ_MULTIHOST_OUT"], "w") as f:
        json.dump(artifact, f, indent=1)

print(f"proc {pid} MULTIHOST-FIT OK devices=4 sum={val} "
      f"calls={calls_sh} hmc_wall={wall_sh:.1f}s", flush=True)
"""


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_distributed_fit(tmp_path):
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    script = tmp_path / "worker.py"
    script.write_text(_WORKER)
    env = dict(os.environ)
    env["PPCSEQ_REPO"] = repo
    env["PPCSEQ_COORD"] = f"127.0.0.1:{_free_port()}"
    env.setdefault("PPCSEQ_MULTIHOST_OUT", str(tmp_path / "multihost.json"))
    env.pop("JAX_PLATFORMS", None)

    procs = [
        subprocess.Popen(
            [sys.executable, str(script), str(pid)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env, text=True,
        )
        for pid in range(2)
    ]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=900)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append(out)
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {pid} failed:\n{out}"
        assert f"proc {pid} MULTIHOST-FIT OK devices=4" in out, out
