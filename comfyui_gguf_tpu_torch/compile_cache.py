"""A persistent build directory for the kernel library (the counterpart
of comfyui_gguf_tpu/compile_cache.py).

The port compiles no graph: its compiled artefact is the CUDA kernel
library that ``_build`` links at first use, named by a digest of the
sources, flags and compiler. By default it lives in the package's own
``_build/``; pointing that at a persistent directory lets a serving
reboot, or a read-only install, load the library already built there
instead of running ``nvcc`` again. Opt in through the reference's own
variable::

    GGUF_TPU_COMPILE_CACHE=/path/to/cache  python serve_flux.py ...

or with :func:`enable` before the first kernel launch (the library is
loaded once per process, so a later call changes nothing for this
process).
"""

from __future__ import annotations

import logging
import os
from pathlib import Path

from . import _build

log = logging.getLogger(__name__)


def enable(cache_dir: str) -> None:
    """Build (and look for) the kernel library in ``cache_dir``.
    Idempotent."""
    path = Path(cache_dir)
    path.mkdir(parents=True, exist_ok=True)
    _build.BUILD_DIR = path
    log.info("kernel build cache at %s", path)


enable_compile_cache = enable  # package-level export name


def enable_from_env() -> bool:
    """Honor ``GGUF_TPU_COMPILE_CACHE`` if set; returns whether a build
    cache directory is in use."""
    path = os.environ.get("GGUF_TPU_COMPILE_CACHE", "")
    if path:
        enable(path)
    return _build.BUILD_DIR != _build.CSRC.parent / "_build"
