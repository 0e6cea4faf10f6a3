"""Build and load the port's hand-written CUDA kernels.

At first use, every ``.cu`` file under ``dorknet_tpu_torch/csrc/`` is
compiled with ``nvcc`` for Hopper (``sm_90a``) into one shared library with a
plain C interface, which is loaded with ``ctypes``. No PyTorch headers are
involved, so the build takes seconds. The library lands in
``build/dorknet_tpu_torch_kernels/`` at the root of the checkout, and its file
name carries a hash of the sources and flags, so an edited source rebuilds.

Nothing here runs at import time: the CPU tests import every module on a
machine with no ``nvcc``.
"""

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from dataclasses import dataclass
from pathlib import Path

_PKG_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = _PKG_DIR / "csrc"
BUILD_DIR = _PKG_DIR.parent / "build" / "dorknet_tpu_torch_kernels"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


@dataclass(frozen=True)
class KernelLibrary:
    lib: ctypes.CDLL
    path: Path
    build_seconds: float  # 0.0 when the library was already built
    compiler_log: str  # nvcc's stderr (ptxas register/spill report)


def _sources():
    return sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh"))


def _find_nvcc():
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        candidate = Path(cuda_home) / "bin" / "nvcc"
        if candidate.exists():
            nvcc = str(candidate)
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found (PATH or $CUDA_HOME/bin): the CUDA kernels of "
            "dorknet_tpu_torch are built from source at first use")
    return nvcc


def _bind(lib):
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.dorknet_depthwise3x3_fwd.argtypes = [vp, vp, vp, ci, ci, ci, ci, ci,
                                             ci, vp, ci]
    lib.dorknet_depthwise3x3_fwd.restype = ci
    lib.dorknet_cuda_error_string.argtypes = [ci]
    lib.dorknet_cuda_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def load_library():
    """Compile (if needed) and load the kernel library. Raises RuntimeError
    with nvcc's stderr if the build fails."""
    sources = _sources()
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    path = BUILD_DIR / "libdorknet_kernels_{}.so".format(digest.hexdigest()[:16])
    seconds, log = 0.0, ""
    if not path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        cu = [str(s) for s in sources if s.suffix == ".cu"]
        # build to a temporary name and rename, so a concurrent process never
        # loads a half-written library
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        t0 = time.perf_counter()
        proc = subprocess.run([_find_nvcc(), *NVCC_FLAGS, "-o", tmp, *cu],
                              capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        log = proc.stderr
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError("nvcc failed (exit {}):\n{}{}".format(
                proc.returncode, proc.stdout, proc.stderr))
        os.replace(tmp, path)
    return KernelLibrary(_bind(ctypes.CDLL(str(path))), path, seconds, log)


def check(lib, err, what):
    """Raise if a C entry point returned a CUDA error code."""
    if err != 0:
        raise RuntimeError("{} failed: CUDA error {} ({})".format(
            what, err, lib.dorknet_cuda_error_string(err).decode()))
