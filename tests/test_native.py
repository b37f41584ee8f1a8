"""Native C++ host runtime vs NumPy reference implementations."""

import os

import numpy as np
import pytest

from ppcseq import _native
from ppcseq.norm.tmm import tmm_norm_factors


@pytest.fixture
def native_lib():
    if not _native.available():
        pytest.skip(f"native library: {_native.status()}")
    return _native._load()


def test_native_builds_from_source_when_absent(tmp_path, monkeypatch):
    path = str(tmp_path / "libppcseq_native.so")
    monkeypatch.setattr(_native, "_LIB_PATH", path)
    monkeypatch.setattr(_native, "_LIB", None)
    monkeypatch.setattr(_native, "_TRIED", False)
    assert not os.path.exists(path)
    lib = _native._load()
    assert lib is not None and os.path.exists(path)
    assert "built from source" in _native.status()
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".tmp")]
    got = _native.pivot_counts(np.array([0, 1]), np.array([2, 0]), np.array([7, 9]), 2, 3)
    np.testing.assert_array_equal(got, [[0, 0, 7], [9, 0, 0]])


def test_native_fallback_is_reported(tmp_path, monkeypatch):
    monkeypatch.setattr(_native, "_LIB_PATH", str(tmp_path / "libppcseq_native.so"))
    monkeypatch.setattr(_native, "_LIB", None)
    monkeypatch.setattr(_native, "_TRIED", False)
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    with pytest.warns(RuntimeWarning, match="NumPy fallback"):
        assert not _native.available()
    assert "NumPy fallback" in _native.status()


def test_pivot_counts_matches_numpy(native_lib):
    rng = np.random.default_rng(0)
    S, G = 13, 57
    s = np.repeat(np.arange(S), G)
    g = np.tile(np.arange(G), S)
    v = rng.integers(0, 1000, size=S * G)
    got = _native.pivot_counts(s, g, v, S, G)
    want = np.zeros((S, G), dtype=np.int64)
    want[s, g] = v
    np.testing.assert_array_equal(got, want)


def test_native_tmm_matches_numpy(native_lib):
    rng = np.random.default_rng(1)
    lam = rng.gamma(2.0, 50.0, size=800)
    counts = np.column_stack([rng.poisson(lam * d) for d in (1.0, 2.5, 0.7, 1.4)]).astype(float)
    f_native = tmm_norm_factors(counts, ref_column=0, use_native=True)
    f_numpy = tmm_norm_factors(counts, ref_column=0, use_native=False)
    np.testing.assert_allclose(f_native, f_numpy, rtol=1e-12)


def test_quantile7_matches_r(native_lib):
    import ctypes

    x = np.arange(1.0, 11.0)
    # R: quantile(1:10, .1, type=7) == 1.9
    got = native_lib.quantile7_sorted(x.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), 10, 0.1)
    assert np.isclose(got, 1.9)
