"""The compile-cache rule every entry point follows (utils/jaxcache.py)."""
from pathlib import Path

import jax
import pytest

from sicelore_tpu.utils import jaxcache

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture
def restore_config():
    keys = ("jax_compilation_cache_dir",
            "jax_persistent_cache_min_entry_size_bytes",
            "jax_persistent_cache_min_compile_time_secs")
    saved = {k: getattr(jax.config, k) for k in keys}
    yield
    for k, v in saved.items():
        jax.config.update(k, v)


def test_env_dir_wins_and_no_dir_is_set(monkeypatch, tmp_path,
                                        restore_config):
    """With JAX_COMPILATION_CACHE_DIR set, JAX's own setting stands: the
    helper sets no directory in code and reports the variable's."""
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "jc"))
    before = jax.config.jax_compilation_cache_dir
    assert jaxcache.enable_compile_cache() == tmp_path / "jc"
    assert jax.config.jax_compilation_cache_dir == before
    assert jax.config.jax_persistent_cache_min_compile_time_secs == 0


def test_unset_env_uses_fixed_dir_in_checkout(monkeypatch, restore_config):
    """Unset, the cache goes to one fixed, git-ignored path inside the
    checkout — never under $HOME or a temp name."""
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    got = jaxcache.enable_compile_cache()
    assert got == ROOT / ".jax_cache" == jaxcache.CHECKOUT_CACHE
    assert jax.config.jax_compilation_cache_dir == str(got)
    assert ".jax_cache/" in (ROOT / ".gitignore").read_text().split()
