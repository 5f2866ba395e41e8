"""The kernel build cache for harness entry points: the counterpart of
``bsmr_sddmm_tpu.utils.compilecache``.

The JAX package keeps XLA executables in a persistent compilation cache so
that later runs skip their compiles. Here what takes the compile is the
nvcc build of the hand kernels (``ops/_build.py``): one shared library,
under ``<kernel directory>/<hash of sources and flags>/``, built by the
first process that launches a kernel and loaded by every later one while
the sources are unchanged. ``enable_compile_cache`` chooses that kernel
directory for this process and the processes it starts, by setting
``BSMR_TORCH_KERNEL_DIR``, which ``ops._build.kernel_dir()`` reads.

Opt-in per entry point, as in the JAX package: importing the library
changes nothing. Where the JAX function returns None when the runtime
refuses its cache, this one raises: a library already loaded from another
directory stays loaded, so the call could not take effect.
"""

from __future__ import annotations

import os
from typing import Optional

from bsmr_sddmm_tpu_torch.ops import _build

ENV = "BSMR_TORCH_KERNEL_DIR"


def enable_compile_cache(path: Optional[str] = None) -> str:
    """Point the kernel build cache at ``path``, else at
    ``$BSMR_TORCH_KERNEL_DIR``, else at ``build/torch_kernels/`` of the
    checkout, and return that directory (absolute, created). Raises if
    this process has loaded the kernel library from another directory."""
    d = os.path.abspath(path or _build.kernel_dir())
    loaded = _build.build_info.get("path") if _build._lib is not None \
        else None
    if loaded is not None:
        was = os.path.dirname(os.path.dirname(loaded))
        if os.path.realpath(was) != os.path.realpath(d):
            raise RuntimeError(
                f"enable_compile_cache({d!r}): the kernel library is "
                f"already loaded from {was!r}; call it before the first "
                f"kernel launch")
    os.makedirs(d, exist_ok=True)
    os.environ[ENV] = d
    return d
