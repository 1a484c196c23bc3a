"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` is compiled for Hopper (``sm_90a``) by its own ``nvcc``
process, all started together, and the objects are linked into one shared
library with a plain C interface, loaded with ``ctypes``.  The library lands
in ``build/kernels/`` under the checkout, named by a hash of the sources and
flags, so it is rebuilt when a source changes.  Nothing is compiled or loaded
at import time: the first kernel launch calls ``load()``.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}   # csrc/common.cuh DType

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
SIGNATURES = {
    # name: (argtypes, restype)
    "rmsnorm_fwd": ([_P, _P, _P, _LL, _I, _F, _I, _I, _P], _I),
    "flash_attn_fwd": ([_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                        _F, _I, _I, _I, _I, _I, _I, _I, _I, _P], _I),
    "ssd_chunk_fwd": ([_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P], _I),
    "ssd_chunk_smem_bytes": ([_I, _I, _I], _LL),
    "kernels_error_string": ([_I], ctypes.c_char_p),
}


def sources(csrc: Path = CSRC):
    return sorted(csrc.glob("*.cu"))


def source_hash(csrc: Path = CSRC) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(csrc.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME, /usr/local/cuda); "
                       "the CUDA kernels are built on the machine with the card")


def library_path(csrc: Path = CSRC) -> Path:
    return BUILD_DIR / f"libreprotorch_{source_hash(csrc)}.so"


def build(csrc: Path = CSRC) -> Path:
    """Compile the sources (in parallel) and link the library, unless a
    library of the same sources exists.  ``build/kernels/build.log`` keeps
    nvcc's output (``-Xptxas -v``: registers, shared memory, spills).
    ``csrc``: another copy of the sources (a version of one kernel to time
    beside the repo's, as ``examples/ssd_chunk_bench.py`` does)."""
    so = library_path(csrc)
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc, tag = nvcc_path(), f"{source_hash(csrc)}.{os.getpid()}"
    jobs = []
    for src in sources(csrc):
        obj = BUILD_DIR / f"{src.stem}.{tag}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
        jobs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    log, failed = [], []
    for src, _obj, proc in jobs:
        out, _ = proc.communicate()
        log.append(f"$ nvcc -c {src.name}  (exit {proc.returncode})\n{out}")
        if proc.returncode:
            failed.append(src.name)
    tmp = so.with_name(so.name + f".{os.getpid()}.tmp")
    if not failed:
        link = subprocess.run(
            [nvcc, "-shared", "-o", str(tmp), *(str(o) for _, o, _ in jobs)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        log.append(f"$ nvcc -shared  (exit {link.returncode})\n{link.stdout}")
        if link.returncode:
            failed.append("link")
    (BUILD_DIR / "build.log").write_text("\n".join(log))
    for _, obj, _ in jobs:
        obj.unlink(missing_ok=True)
    if failed:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"kernel build failed ({', '.join(failed)}):\n"
                           + "\n".join(log)[-6000:])
    os.replace(tmp, so)
    return so


@functools.cache
def load() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    for name, (argtypes, restype) in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, restype
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error (a refused launch never runs,
    and a later synchronize would not report it)."""
    if err:
        msg = lib.kernels_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def stream_ptr(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def aligned16(*tensors: torch.Tensor) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in tensors)
