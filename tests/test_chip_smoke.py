"""chip_smoke.py on the CPU: its guard, its verdict line and its phases at
tiny size (the script itself only runs on a GPU)."""

import os
import shutil
import subprocess
import sys
from types import SimpleNamespace

import pytest

import chip_smoke
from ppcseq.utils.synthetic import synthetic_tidy

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run_script(cwd):
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "PPCSEQ_COMPILATION_CACHE": "0"}
    return subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=300,
    )


def test_device_guard_refuses_cpu():
    proc = _run_script(ROOT)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    assert "no GPU" in proc.stderr
    assert "phase1 jax platform=cpu" in proc.stdout


def test_fails_without_the_repo(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    proc = _run_script(tmp_path)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_verdict_line_is_the_contract_line():
    dev = SimpleNamespace(platform="gpu", device_kind="NVIDIA H100 80GB HBM3")
    assert chip_smoke.verdict_line([dev]) == (
        '{"ok": true, "device": {"platform": "gpu", '
        '"kind": "NVIDIA H100 80GB HBM3", "count": 1}}'
    )
    assert chip_smoke.verdict_line([dev] * 4).endswith('"count": 4}}')


def test_expect_calls_pins_fixed_free_and_other_genes():
    check = chip_smoke.expect_calls({"CYP1A1": 1, "LYZ": 1}, free=("MMP8",))
    check({"CYP1A1": 1, "LYZ": 1, "MMP8": 1, "ART3": 0})
    check({"CYP1A1": 1, "LYZ": 1, "MMP8": 0})
    for bad in (
        {"CYP1A1": 0, "LYZ": 1},  # pinned gene missed
        {"CYP1A1": 1, "LYZ": 1, "ART3": 1},  # unpinned gene called
        {"CYP1A1": 1, "LYZ": 1, "MMP8": 2},  # free gene out of {0, 1}
        {"CYP1A1": 1},  # pinned gene absent
    ):
        with pytest.raises(RuntimeError):
            check(bad)


def test_phase2_likelihood_width_tiny():
    out = chip_smoke.likelihood_width(
        "tiny", chip_smoke.synthetic_arrays(37, 13, n_check=3), batch=4, steps=2, reps=1
    )
    assert set(out["seconds"]) == set(chip_smoke.VARIANTS)
    assert out["winner"] in chip_smoke.VARIANTS
    assert (out["G"], out["S"], out["batch"]) == (37, 13, 4)


_TINY = dict(
    formula="~ Label", sample="sample", transcript="transcript", abundance="count",
    significance="PValue", do_check="do_check", percent_false_positive_genes=5,
    how_many_negative_controls=30, seed=1,
)


def test_phase3_runs_cold_and_warm_tiny():
    seen = []
    df = synthetic_tidy(n_genes=48, n_samples=8, n_check=3, seed=2)
    walls = chip_smoke.phase3_bundled([("tiny", df, seen.append, _TINY)])
    assert len(walls["tiny"]) == 2 and all(w > 0 for w in walls["tiny"])
    assert len(seen) == 2 and seen[0] == seen[1]
    assert sorted(seen[0]) == ["g0000", "g0001", "g0002"]


def test_phase4_scale_tiny():
    out = chip_smoke.phase4_scale(n_genes=48, n_samples=8, n_check=3)
    assert len(out["walls"]) == 2
    assert 0 <= out["flagged"] <= out["injected"]
