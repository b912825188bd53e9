"""Build the package's CUDA sources with ``nvcc`` and load them with ctypes.

Each library is one ``nvcc`` call on the ``csrc/`` sources it lists,
compiled for Hopper (``sm_90a``) into a shared object with a plain C
interface. The output lands in ``<repo>/build/repro_torch/<name>-<hash>/``
(``build/`` is git-ignored), keyed on a hash of the sources and the flags,
so the first use after any edit rebuilds and later uses load the cached
library. Builds of several libraries start together and run in parallel.
Nothing here runs at import time: the CPU tests import every module on
machines without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"

# the most dynamic shared memory a block can opt into on the H100 (227 KB):
# every csrc/ file's kMaxSmem, held to this one value by the launch
# contract (analysis/launch_contract.py)
MAX_SMEM = 232448
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# library name -> its sources under csrc/
LIBRARIES: dict[str, tuple[str, ...]] = {
    "gqmm": ("gqmm.cu",),
    "paged_attn": ("paged_attn.cu",),
    "flash_attn": ("flash_attn.cu",),
    "rmsnorm_quant": ("rmsnorm_quant.cu",),
}


@dataclasses.dataclass(frozen=True)
class BuildResult:
    name: str
    path: Path
    seconds: float      # wall time of this process's nvcc call; 0.0 when cached
    log: str            # nvcc's output (ptxas register / spill report)
    cached: bool


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    nvcc = Path(CUDA_HOME) / "bin" / "nvcc"
    if not nvcc.exists():
        raise RuntimeError(f"nvcc not found under CUDA_HOME={CUDA_HOME}")
    return str(nvcc)


def library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in LIBRARIES[name]:
        h.update(src.encode())
        h.update((CSRC / src).read_bytes())
    return BUILD_ROOT / f"{name}-{h.hexdigest()[:16]}" / f"lib{name}.so"


def build_all(names=None) -> dict[str, BuildResult]:
    """Build every listed library not yet built, one ``nvcc`` each, all
    started together. Raises with the compiler's output if any fails."""
    names = list(LIBRARIES if names is None else names)
    results: dict[str, BuildResult] = {}
    running = {}
    for name in names:
        out = library_path(name)
        log = out.parent / "build.log"
        if out.exists():
            results[name] = BuildResult(name, out, 0.0,
                                        log.read_text() if log.exists() else "", True)
            continue
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
               *(str(CSRC / s) for s in LIBRARIES[name])]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        running[name] = (proc, tmp, out, log, time.perf_counter())
    failed = []
    for name, (proc, tmp, out, log, t0) in running.items():
        text, _ = proc.communicate()
        secs = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name} (exit {proc.returncode}):\n{text}")
            continue
        os.replace(tmp, out)    # atomic: a concurrent build never loads a partial file
        log.write_text(text)
        results[name] = BuildResult(name, out, secs, text, False)
    if failed:
        raise RuntimeError("\n".join(failed))
    return results


_LOADED: dict[str, ctypes.CDLL] = {}


def load(name: str) -> ctypes.CDLL:
    """The built library ``name``, building it at first use."""
    if name not in _LOADED:
        _LOADED[name] = ctypes.CDLL(str(build_all([name])[name].path))
    return _LOADED[name]
