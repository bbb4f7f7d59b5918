"""Build the port's CUDA sources at first use and load them with ``ctypes``.

Each kernel source is a ``.cu`` file with a plain C interface (no PyTorch
headers, so ``nvcc`` takes seconds).  It is compiled for Hopper with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC

into ``build/kernels/`` at the repository root (listed in ``.gitignore``),
under a name keyed by a hash of the source, the shared headers in
``kernels/csrc/`` and the flags, so an edited source is rebuilt and an
unchanged one is loaded as it is.  A missing ``nvcc`` or a failed build raises
with the compiler's output.

:func:`entry` gives a source's C entry point, typed, and :func:`launch` calls
it on PyTorch's current stream of a device and raises on a CUDA error.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

_REPO_ROOT = Path(__file__).resolve().parents[3]
BUILD_DIR = _REPO_ROOT / "build" / "kernels"
INCLUDE_DIR = Path(__file__).resolve().parent / "csrc"  # headers the sources share
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # register/shared-memory report, kept in BUILD_LOGS
)

# source path -> ptxas report of its last build in this process
BUILD_LOGS: dict[str, str] = {}
_LIBS: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError(
        "nvcc not found (looked on PATH and in $CUDA_HOME/bin); the port's "
        "CUDA kernels are compiled at first use and need the CUDA toolkit"
    )


def _target(source: Path) -> Path:
    h = hashlib.sha256(source.read_bytes())
    for header in sorted(INCLUDE_DIR.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{source.stem}-{h.hexdigest()[:16]}.so"


def build(source: Path) -> Path:
    """Compile ``source`` unless its hashed library exists; returns the path."""
    out = _target(source)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}) for {source.name}:\n"
            f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}"
        )
    BUILD_LOGS[str(source)] = proc.stdout + proc.stderr
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    return out


def ptxas_report(source: Path) -> list[str]:
    """One line per kernel of ``source``'s last build in this process (its
    mangled name, registers and spills) and ptxas's warnings."""
    lines, name, frame = [], "?", ""
    for line in BUILD_LOGS.get(str(source), "").splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1]
        elif "spill" in line:
            frame = line.strip()
        elif "registers" in line:
            lines.append(f"{name}: {line.split(':', 1)[1].strip()}; {frame}")
        elif "ptxas" in line and "warning" in line:
            lines.append(line.strip())
    return lines


def load(source: Path) -> ctypes.CDLL:
    """Build (if needed) and load ``source``'s shared library, once per process."""
    key = str(source)
    with _LOCK:
        if key not in _LIBS:
            _LIBS[key] = ctypes.CDLL(str(build(source)))
        return _LIBS[key]


@functools.lru_cache(maxsize=None)
def entry(source: Path, symbol: str, argtypes: tuple, constants: tuple = ()):
    """The C function ``symbol`` of ``source``'s library, returning a
    cudaError_t as an int and taking ``argtypes`` then the stream.  Each
    ``(name, value)`` of ``constants`` is a constant the binding relies on,
    checked against the library's function ``name``."""
    lib = load(source)
    for name, want in constants:
        got = getattr(lib, name)()
        if got != want:
            raise RuntimeError(f"{source.name} has {name}() = {got}; its binding expects {want}")
    fn = getattr(lib, symbol)
    fn.restype = ctypes.c_int
    fn.argtypes = [*argtypes, ctypes.c_void_p]
    return fn


def launch(fn, device: torch.device, *args) -> None:
    """Call ``fn`` (from :func:`entry`) with ``args`` and the current stream
    of ``device``, that device current; raise if it returns a CUDA error.
    Does not synchronise."""
    # the raw stream handle, as torch's generated code takes it: building a
    # torch.cuda.Stream object for it costs several microseconds a launch
    current = torch.cuda.current_device()
    index = current if device.index is None else device.index
    if index == current:
        err = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    else:
        with torch.cuda.device(index):
            err = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    if err:
        raise RuntimeError(f"{fn.__name__} failed with cudaError {err}")
