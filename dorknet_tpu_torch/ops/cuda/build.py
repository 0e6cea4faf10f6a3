"""Build and load the port's hand-written CUDA kernels.

At first use, every ``.cu`` file under ``dorknet_tpu_torch/csrc/`` is
compiled with ``nvcc`` for Hopper (``sm_90a``: the tensor-core GEMM's
``wgmma`` exists only for that target), one ``nvcc`` process per source, all
started together, and the objects are linked into one shared library with a
plain C interface, which is loaded with ``ctypes``. No PyTorch headers are
involved, so the build takes seconds. The library needs no ``-lcuda``: the
one driver function it uses (``cuTensorMapEncodeTiled``) is found through
the CUDA runtime. The library lands in
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

import torch

_PKG_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = _PKG_DIR / "csrc"
BUILD_DIR = _PKG_DIR.parent / "build" / "dorknet_tpu_torch_kernels"

# the dtype codes of the C entry points' ``dtype`` arguments
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


@dataclass(frozen=True)
class KernelLibrary:
    lib: ctypes.CDLL
    path: Path
    build_seconds: float  # 0.0 when the library was already built
    compiler_log: str  # nvcc's stderr at the build (ptxas register/spill report)


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
                                             ci, ci, ci, vp, ci]
    lib.dorknet_depthwise3x3_fwd.restype = ci
    lib.dorknet_depthwise3x3_dx.argtypes = [vp, vp, vp, ci, ci, ci, ci, ci,
                                            ci, ci, ci, vp, ci]
    lib.dorknet_depthwise3x3_dx.restype = ci
    lib.dorknet_depthwise3x3_dw.argtypes = [vp, vp, vp, vp, ci, ci, ci, ci,
                                            ci, ci, ci, ci, vp, ci]
    lib.dorknet_depthwise3x3_dw.restype = ci
    lib.dorknet_depthwise7x7_dw.argtypes = [vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, vp, ci]
    lib.dorknet_depthwise7x7_dw.restype = ci
    lib.dorknet_depthwise7x7_dw_bands.argtypes = [ci, ci, ci, ci]
    lib.dorknet_depthwise7x7_dw_bands.restype = ci
    lib.dorknet_augment_planes.argtypes = [vp, vp, vp, ci, ci, ci, ci, ci, ci,
                                           ctypes.c_float, ci, ci, ci, ci, ci, ci, vp, ci]
    lib.dorknet_augment_planes.restype = ci
    lib.dorknet_bn_stats.argtypes = [vp, vp, vp, vp, ctypes.c_longlong, ci, ci, ci, vp, ci]
    lib.dorknet_bn_stats.restype = ci
    ll, cf = ctypes.c_longlong, ctypes.c_float
    lib.dorknet_bn_apply.argtypes = [vp, vp, vp, vp, vp, cf, vp, vp, ll, ci, ci, ci, ll, ci, vp,
                                     ci]
    lib.dorknet_bn_apply.restype = ci
    lib.dorknet_bn_bwd_reduce.argtypes = [vp, vp, vp, vp, vp, vp, vp, vp, ll, ci, ci, ci, ci,
                                          ci, ci, ci, vp, ci]
    lib.dorknet_bn_bwd_reduce.restype = ci
    lib.dorknet_bn_bwd_dx.argtypes = [vp, vp, vp, vp, vp, vp, vp, ll, ci, ci, ci, ll, ci, vp,
                                      ci]
    lib.dorknet_bn_bwd_dx.restype = ci
    lib.dorknet_bias_act.argtypes = [vp, vp, vp, ll, ci, ci, ci, ll, ci, vp, ci]
    lib.dorknet_bias_act.restype = ci
    lib.dorknet_matmul.argtypes = [vp, vp, vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, ci, ci,
                                   ci, vp, ci]
    lib.dorknet_matmul.restype = ci
    lib.dorknet_max_block_smem.argtypes = [ci]
    lib.dorknet_max_block_smem.restype = ci
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
    log_path = path.with_suffix(".log")  # the compiler log, kept beside the library
    seconds = 0.0
    if not path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        # build in a private directory and rename the library into place, so
        # a concurrent process never loads a half-written one
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
            log = _compile([s for s in sources if s.suffix == ".cu"],
                           Path(tmp), Path(tmp) / "lib.so")
            (Path(tmp) / "lib.log").write_text(log)
            os.replace(Path(tmp) / "lib.log", log_path)
            os.replace(Path(tmp) / "lib.so", path)
        seconds = time.perf_counter() - t0
    log = log_path.read_text() if log_path.exists() else ""
    return KernelLibrary(_bind(ctypes.CDLL(str(path))), path, seconds, log)


def _run_all(commands):
    """Start every command at once, wait for all of them, and raise with the
    stderr of those that failed. Returns the stderr of all, joined."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for cmd in commands]
    outs = [p.communicate() for p in procs]
    failed = ["{} (exit {}):\n{}{}".format(" ".join(cmd), p.returncode, out, err)
              for cmd, p, (out, err) in zip(commands, procs, outs) if p.returncode]
    if failed:
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
    return "".join(err for _, err in outs)


def _compile(cu_sources, tmp_dir, out):
    """One ``nvcc -c`` per source, in parallel, then one link into ``out``."""
    nvcc = _find_nvcc()
    objs = [tmp_dir / (src.stem + ".o") for src in cu_sources]
    log = _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
                    for src, obj in zip(cu_sources, objs)])
    return log + _run_all([[nvcc, "-shared", "-o", str(out), *map(str, objs)]])


def check(lib, err, what):
    """Raise if a C entry point returned a CUDA error code."""
    if err != 0:
        raise RuntimeError("{} failed: CUDA error {} ({})".format(
            what, err, lib.dorknet_cuda_error_string(err).decode()))
