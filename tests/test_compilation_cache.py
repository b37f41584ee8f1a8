"""utils/compilation_cache: placed from outside, or a fixed path in the checkout."""

import os

import jax
import pytest

from ppcseq.utils import compilation_cache

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def updates(monkeypatch):
    """Record jax.config.update calls instead of changing the process config."""
    calls = []
    monkeypatch.setattr(jax.config, "update", lambda k, v: calls.append((k, v)))
    monkeypatch.delenv("PPCSEQ_COMPILATION_CACHE", raising=False)
    return calls


def test_env_var_is_honoured_and_no_other_dir_is_set(updates, monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compilation_cache.enable() == str(tmp_path)
    assert not [k for k, _ in updates if k == "jax_compilation_cache_dir"]


def test_default_is_a_fixed_path_in_the_checkout(updates, monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    want = os.path.join(ROOT, ".jax_cache")
    assert compilation_cache.DEFAULT_DIR == want
    assert compilation_cache.enable() == want
    assert ("jax_compilation_cache_dir", want) in updates
    assert os.path.isdir(want)


def test_zero_turns_the_cache_off(updates, monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    monkeypatch.setenv("PPCSEQ_COMPILATION_CACHE", "0")
    assert compilation_cache.enable() is None
    assert updates == []
