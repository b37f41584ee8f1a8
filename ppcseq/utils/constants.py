"""Parity-critical numeric constants of the reference implementation.

Each constant cites the reference file:line it reproduces (see SURVEY.md §2.3).
"""

# Prior location for lambda_mu (reference R/methods.R:218)
LAMBDA_MU_MU = 5.612671

# Pass-2 overdispersion compensation for fitting on truncated data
# ("Taken by approximation study", reference R/methods.R:339)
TRUNCATION_COMPENSATION_PASS2 = 0.7352941

# Default number of negative-control transcripts (reference R/methods.R:83)
DEFAULT_NEGATIVE_CONTROLS = 500

# Default draws wanted beyond the CI tail (reference R/methods.R:87)
DEFAULT_DRAWS_AFTER_TAIL = 10

# Per-chain fixed warmup cost used by the chain-count heuristic and MCMC launch
# (reference R/utilities.R:297, 1502-1504)
MCMC_WARMUP = 150

# VB (ADVI) settings hard-coded in the reference (R/utilities.R:1487-1494)
VB_MAX_ITER = 50000
VB_TOL_REL_OBJ = 0.005

# Auto-switch to approximated CI analysis above this many required draws
# (reference R/methods.R:171)
APPROX_ANALYSIS_DRAW_THRESHOLD = 20000

# Memory-cost regressions (reference R/methods.R:184-188)
MEM_REGRESSION_MCMC = (1.044e6, 3.777e-2)
MEM_REGRESSION_VB = (1.554e6, 7.327e-2)

# When CI analysis is approximated, only this many actual posterior draws are
# needed from the sampler (reference R/utilities.R:1372)
APPROX_ANALYSIS_PRACTICAL_DRAWS = 1000

# Jittered-HMC (infer/hmc.py) defaults — no reference equivalent (the
# reference's chain heuristic, R/utilities.R:291-303, is CPU-process
# economics; here chains are a batch dimension of one program). Quality
# evidence from an earlier sweep at the PIPELINE's own budget
# (scripts/sweep_pipeline_hmc.py: 128 chains x 8 draws, ADVI warm start,
# warmup {30, 60} x L in {16, 24, 32, 48}): the posterior-mean bias of the
# call-driving block against a long L=48 reference fit was at the MC-noise
# floor for every config with 0 divergences, and warmup 30 matched 60 (the
# ADVI warm start supplies init + mass; dual averaging only tunes the step
# size). So the cheapest such config is the default. Which config is
# cheapest on the GPU has not been re-measured.
HMC_CHAINS = 128
HMC_WARMUP = 30
HMC_LEAPFROG = 16
