"""Build the port's CUDA sources with nvcc and bind them with ctypes.

Each `csrc/<name>.cu` compiles on its own into a shared library with a
plain C interface (`nvcc -gencode arch=compute_90a,code=sm_90a -shared`).
Sources may include the shared headers of `csrc/` (the decode-attention walk
of `paged_qattn` and `decode_qattn`).  Libraries land in `build/kernels/`
at the repository root, named by a hash of their source, the shared headers
and the flags, so an edited source or header never loads a stale build.
`build_all` starts one nvcc per source, all at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, List, Optional

import torch

_KERNELS_DIR = Path(__file__).resolve().parent
BUILD_DIR = _KERNELS_DIR.parents[2] / "build" / "kernels"
SOURCES = ("cst_quant", "probe_flash", "decode_qattn", "paged_qattn")
# IEEE division and sqrt are the defaults; --use_fast_math must never be
# added: the CST codes are held bit-identical to the reference.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
                 shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); the port's kernels build on a CUDA host")


def source(name: str) -> Path:
    return _KERNELS_DIR / name / "csrc" / f"{name}.cu"


def headers() -> List[Path]:
    """The shared headers every source may include."""
    return sorted((_KERNELS_DIR / "csrc").glob("*.cuh"))


def library_path(name: str) -> Path:
    digest = hashlib.sha256(source(name).read_bytes())
    for hdr in headers():
        digest.update(hdr.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def ptxas_report(name: str) -> str:
    """The `-Xptxas -v` register / shared-memory / spill report of a build."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def build_all(names: Iterable[str] = SOURCES) -> Dict[str, float]:
    """Compile every missing library, one nvcc per source started together.

    Returns {name: seconds} for the builds that ran; raises with the
    compiler's output if any of them fails.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return {}
    nvcc = _nvcc()
    procs = []
    t0 = time.perf_counter()
    for name in todo:
        out = library_path(name)
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        log = open(out.with_suffix(".log"), "w")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(source(name))]
        procs.append((name, tmp, log, subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT)))
    times: Dict[str, float] = {}
    failed: List[str] = []
    for name, tmp, log, proc in procs:
        rc = proc.wait()
        log.close()
        times[name] = time.perf_counter() - t0
        if rc != 0:
            failed.append(f"{name} (nvcc exit {rc}):\n{ptxas_report(name)}")
        else:
            os.replace(tmp, library_path(name))
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return times


class CudaLibrary:
    """One compiled source, loaded on first use."""

    def __init__(self, name: str):
        self.name = name
        self._handle: Optional[ctypes.CDLL] = None

    def handle(self) -> ctypes.CDLL:
        if self._handle is None:
            build_all([self.name])
            lib = ctypes.CDLL(str(library_path(self.name)))
            lib.zc_error_string.argtypes = [ctypes.c_int]
            lib.zc_error_string.restype = ctypes.c_char_p
            self._handle = lib
        return self._handle


# every launch counter of the port, so that a captured step
# (`launch.steps`) can add what its capture counted once per replay
COUNTERS: List["Counter"] = []


class Counter:
    """How often a path ran: `launches`, reset by writing 0 to it.

    A wrapper adds one where it launches its kernel.  Inside a CUDA graph
    capture nothing runs, so the captured step takes the capture's counts
    back and adds them again at every replay.
    """

    def __init__(self) -> None:
        self.launches = 0
        COUNTERS.append(self)


class CudaKernel(Counter):
    """A C entry point of a `CudaLibrary` plus its launch counter.

    Calling it launches the kernel on the given stream; a non-zero
    `cudaGetLastError()` raises.  `launches` counts successful launches.
    The launch is asynchronous: a wrapper may drop its scratch tensors and
    contiguous copies when it returns, because PyTorch's caching allocator
    hands their memory only to work queued later on the same stream.
    """

    def __init__(self, library: CudaLibrary, symbol: str, argtypes: list):
        super().__init__()
        self.library = library
        self.symbol = symbol
        self.argtypes = argtypes
        self._fn = None

    def __call__(self, *args) -> None:
        if self._fn is None:
            fn = getattr(self.library.handle(), self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        err = self._fn(*args)
        if err != 0:
            msg = self.library.handle().zc_error_string(err).decode()
            raise RuntimeError(f"{self.symbol}: CUDA error {err} ({msg})")
        self.launches += 1


P = ctypes.c_void_p
I = ctypes.c_int
F = ctypes.c_float


def ptr(t: torch.Tensor) -> int:
    return t.data_ptr()


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream
