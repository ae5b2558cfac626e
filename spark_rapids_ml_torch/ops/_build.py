#
# Build and load the port's hand-written CUDA kernels.
#
# Each source under `csrc/` compiles with `nvcc` into a shared library with
# a plain C interface, loaded with ctypes.  PyTorch's own extension builder
# is not used: it needs `ninja`, and a source that includes PyTorch's
# headers takes minutes to compile where a plain C interface takes
# seconds.  Libraries land in `build/torch_ext/` at the root of a source
# checkout (listed in .gitignore); an installed package (the sources ship
# as package data) builds into a per-user cache instead, `_build_dir`.
# Each library is named by a hash of every file under `csrc/` (so an edited
# header rebuilds the sources that may include it) and the flags, so a
# changed source rebuilds and an unchanged one loads at once.  All
# sources start compiling together, one `nvcc` each.
#
# A missing compiler or a failed build raises: there is no fallback to the
# plain versions.
#
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional, Sequence

_CSRC = Path(__file__).resolve().parent / "csrc"


def _build_dir() -> Path:
    """Where built libraries go: the checkout's build directory when the
    package runs from a source checkout, else a per-user cache under
    $TORCH_EXTENSIONS_DIR (PyTorch's own variable for built extensions)
    or ~/.cache/torch_extensions."""
    root = Path(__file__).resolve().parents[2]
    if (root / "pyproject.toml").is_file():
        return root / "build" / "torch_ext"
    base = os.environ.get("TORCH_EXTENSIONS_DIR")
    base = Path(base) if base else Path.home() / ".cache" / "torch_extensions"
    return base / "spark_rapids_ml_torch"


_BUILD_DIR = _build_dir()
_NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}
# nvcc's output (the ptxas report) of each source built by this process;
# chip_smoke.py prints the registers and spills from it
BUILD_LOG: Dict[str, str] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    found = shutil.which("nvcc")
    if found is None and CUDA_HOME:
        cand = Path(CUDA_HOME) / "bin" / "nvcc"
        found = str(cand) if cand.exists() else None
    if found is None:
        raise RuntimeError(
            "nvcc not found (PATH, CUDA_HOME): the port's CUDA kernels are "
            "built from source at first use and need the CUDA toolkit"
        )
    return found


def _target(source: str, csrc: Path = _CSRC) -> Path:
    """The library built from `source`: named by a hash of the flags and
    of every file under `csrc`, the source's own directory."""
    h = hashlib.sha256(" ".join(_NVCC_FLAGS).encode())
    for path in sorted(p for p in csrc.rglob("*") if p.is_file()):
        h.update(str(path.relative_to(csrc)).encode() + b"\0" + path.read_bytes())
    return _BUILD_DIR / f"{Path(source).stem}_{h.hexdigest()[:16]}.so"


def _start(source: str):
    """Start one nvcc (or nothing, when the library is already built)."""
    out = _target(source)
    if out.exists():
        BUILD_LOG.setdefault(source, "(built earlier)")
        return None
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp.so")
    cmd = [_nvcc(), *_NVCC_FLAGS, "-o", str(tmp), str(_CSRC / source)]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    return proc, tmp, out


def _finish(source: str, started) -> Optional[str]:
    """Wait for one nvcc; the error text if it failed."""
    if started is None:
        return None
    proc, tmp, out = started
    log, _ = proc.communicate()
    BUILD_LOG[source] = log
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        return f"nvcc failed on {source}:\n{log}"
    os.replace(tmp, out)  # atomic: concurrent builders load a whole file
    return None


def build(sources: Sequence[str]) -> Dict[str, ctypes.CDLL]:
    """Build (all at once) and load the given sources under `csrc/`."""
    with _lock:
        todo = [s for s in sources if s not in _loaded]
        started = {s: _start(s) for s in todo}
        # wait for every nvcc before raising, so none is left running
        errors = [e for e in (_finish(s, started[s]) for s in todo) if e]
        if errors:
            raise RuntimeError("\n".join(errors))
        for s in todo:
            _loaded[s] = ctypes.CDLL(str(_target(s)))
        return {s: _loaded[s] for s in sources}


def load(source: str) -> ctypes.CDLL:
    return build([source])[source]


def all_sources() -> list:
    return sorted(p.name for p in _CSRC.glob("*.cu"))
