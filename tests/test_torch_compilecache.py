"""``utils.compilecache.enable_compile_cache``: the directory it resolves
for the nvcc kernel build cache, and its refusal once the kernel library
is loaded from another directory (on the CPU, where nothing is built: the
loaded library is stood in for)."""

import os

import pytest

from bsmr_sddmm_tpu_torch.ops import _build
from bsmr_sddmm_tpu_torch.utils import compilecache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("source", ("argument", "environment", "default"))
def test_enable_compile_cache_resolves_the_directory(source, monkeypatch,
                                                     tmp_path):
    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.delenv(compilecache.ENV, raising=False)
    path = None
    if source == "argument":
        path, want = str(tmp_path / "arg"), str(tmp_path / "arg")
    elif source == "environment":
        monkeypatch.setenv(compilecache.ENV, str(tmp_path / "env"))
        want = str(tmp_path / "env")
    else:
        want = os.path.join(REPO, "build", "torch_kernels")
    got = compilecache.enable_compile_cache(path)
    assert got == want and os.path.isdir(got)
    assert os.environ[compilecache.ENV] == got
    assert _build.kernel_dir() == got
    assert os.path.dirname(os.path.dirname(_build.library_path())) == got


def test_enable_compile_cache_refuses_once_loaded_elsewhere(monkeypatch,
                                                            tmp_path):
    monkeypatch.delenv(compilecache.ENV, raising=False)
    monkeypatch.setattr(_build, "_lib", object())
    monkeypatch.setattr(_build, "build_info", {
        "path": str(tmp_path / "old" / "abc" / "libbsmr_torch_kernels.so")})
    with pytest.raises(RuntimeError, match="already loaded from"):
        compilecache.enable_compile_cache(str(tmp_path / "new"))
    assert compilecache.ENV not in os.environ
    # the directory it was loaded from is accepted
    assert compilecache.enable_compile_cache(str(tmp_path / "old")) == str(
        tmp_path / "old")
