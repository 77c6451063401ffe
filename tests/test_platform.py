"""Host-platform rules: the compile-cache path, device-memory capacity,
and the native library's build key."""

import pathlib

import jax
import pytest

from smafa_tpu import native
from smafa_tpu.parallel import select
from smafa_tpu.utils import platform

REPO = pathlib.Path(__file__).resolve().parent.parent


def test_cache_dir_follows_env(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "c"))
    assert platform.compilation_cache_dir() == tmp_path / "c"


def test_cache_dir_default_is_fixed_and_ignored(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    a = platform.compilation_cache_dir()
    assert a == platform.compilation_cache_dir()  # never varies
    assert a.parent == REPO  # inside the checkout
    ignores = (REPO / ".gitignore").read_text().split()
    assert f"{a.name}/" in ignores, f"{a} is not git-ignored"


class _Dev:
    def __init__(self, platform_, stats, kind="fake"):
        self.platform = platform_
        self.device_kind = kind
        self._stats = stats

    def memory_stats(self):
        return self._stats


def test_hbm_capacity_sums_reported_limits(monkeypatch):
    monkeypatch.delenv("SMAFA_TPU_HBM_BYTES", raising=False)
    devs = [_Dev("gpu", {"bytes_limit": 60 << 30}) for _ in range(4)]
    monkeypatch.setattr(jax, "devices", lambda *a: devs)
    assert select._hbm_capacity() == 240 << 30
    assert select._hbm_capacity(per_device=True) == 60 << 30


def test_hbm_capacity_raises_on_unknown_accelerator(monkeypatch):
    monkeypatch.delenv("SMAFA_TPU_HBM_BYTES", raising=False)
    monkeypatch.setattr(jax, "devices",
                        lambda *a: [_Dev("gpu", {}, "Mystery Card")])
    with pytest.raises(RuntimeError, match="Mystery Card"):
        select._hbm_capacity()
    monkeypatch.setenv("SMAFA_TPU_HBM_BYTES", str(1 << 30))
    assert select._hbm_capacity() == 1 << 30


def test_hbm_capacity_none_on_cpu(monkeypatch):
    monkeypatch.delenv("SMAFA_TPU_HBM_BYTES", raising=False)
    monkeypatch.setattr(jax, "devices", lambda *a: [_Dev("cpu", None)])
    assert select._hbm_capacity() is None


def test_native_build_key():
    src = b"int f() { return 1; }"
    k = native.build_key(src, host="h1")
    assert k == native.build_key(src, host="h1")
    assert k.startswith("libsmafa_native-") and k.endswith(".so")
    assert k != native.build_key(src + b" ", host="h1")
    assert k != native.build_key(src, host="h2")
    assert k != native.build_key(src, flags=("-O2",), host="h1")
    # the default host is this machine's identity, stable in-process
    assert native.build_key(src) == native.build_key(src)


def test_native_library_built_under_its_key():
    lib = native.load()
    if lib is None:
        pytest.skip("no C++ compiler here")
    want = native.build_key((native._HERE / "fastx.cpp").read_bytes())
    assert pathlib.Path(lib._name).name == want
