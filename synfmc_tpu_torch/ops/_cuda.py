"""Build and load the hand-written CUDA kernels under ``csrc/``.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface and loaded with ``ctypes``.  Libraries are
keyed by a hash of their sources, built at first use into
``build/torch_kernels/`` next to the package (``SYNFMC_TORCH_BUILD_DIR``
overrides it), and shared by every later process.  ``build_all`` starts one
``nvcc`` per source at once.

There is no fallback: a missing ``nvcc`` or a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = ("flash_fwd", "flash_bwd", "temporal_fwd", "temporal_bwd", "group_norm")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_libs: dict[str, ctypes.CDLL] = {}
_entries: dict[tuple[str, str], ctypes._CFuncPtr] = {}
_lock = threading.Lock()


def build_dir() -> Path:
    env = os.environ.get("SYNFMC_TORCH_BUILD_DIR")
    if env:
        return Path(env)
    return _CSRC.parent.parent / "build" / "torch_kernels"


def find_nvcc() -> str:
    """Path of ``nvcc``; raises with a clear message when there is none."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (PATH, CUDA_HOME, /usr/local/cuda): the CUDA kernels of "
        "synfmc_tpu_torch are built from csrc/ at first use and need the CUDA toolkit"
    )


def _source_hash(name: str) -> str:
    h = hashlib.sha256()
    for p in sorted(_CSRC.glob("*.cuh")) + [_CSRC / f"{name}.cu"]:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def lib_path(name: str) -> Path:
    return build_dir() / f"lib{name}-{_source_hash(name)}.so"


def _start_build(name: str, nvcc: str):
    out = lib_path(name)
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-I", str(_CSRC), "-o", str(tmp), str(_CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def build_all(names=SOURCES) -> dict[str, str]:
    """Compile every source whose library is missing, all ``nvcc`` runs in
    parallel.  Returns each build's compiler output (ptxas resource lines)."""
    todo = [n for n in names if not lib_path(n).is_file()]
    if not todo:
        return {}
    nvcc = find_nvcc()
    running = {n: _start_build(n, nvcc) for n in todo}
    logs, failed = {}, []
    for n, (proc, tmp, out) in running.items():
        text, _ = proc.communicate()
        logs[n] = text
        if proc.returncode != 0:
            failed.append(n)
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
            (out.with_suffix(".log")).write_text(text)
    if failed:
        raise RuntimeError(
            "nvcc failed for " + ", ".join(failed) + ":\n"
            + "\n".join(logs[n] for n in failed)
        )
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            if not lib_path(name).is_file():
                build_all((name,))
            lib = ctypes.CDLL(str(lib_path(name)))
            _libs[name] = lib
        return lib


def check(err: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a C entry point."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def entry(name: str, fn: str, argtypes) -> ctypes._CFuncPtr:
    """C entry point ``fn`` of ``csrc/<name>.cu``, declared once per process
    (pointers and the stream as c_void_p, returning cudaError_t)."""
    f = _entries.get((name, fn))
    if f is None:
        f = getattr(load(name), fn)
        f.argtypes = list(argtypes)
        f.restype = ctypes.c_int
        _entries[(name, fn)] = f
    return f


P = ctypes.c_void_p
I = ctypes.c_int
F32 = ctypes.c_float
