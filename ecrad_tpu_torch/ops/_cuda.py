"""Build, load and call the port's CUDA kernels.

All sources under ecrad_tpu_torch/csrc/ compile with one `nvcc` call for
sm_90a into a shared library with a plain C interface, loaded with
ctypes (no PyTorch headers: seconds to build rather than minutes). The
build happens at first use, into ecrad_tpu_torch/_build/ (listed in
.gitignore), under a name that hashes the sources, so an edited kernel
is rebuilt. Nothing here runs at import time.

Every C entry point launches on the stream it is given, returns
cudaGetLastError() as an int, and allocates nothing: the wrappers
allocate outputs and scratch with torch.empty.
"""
from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
from typing import Optional

import torch

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(os.path.dirname(_HERE), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
# -fmad=false: no contraction of a*b+c into one FMA, so a kernel rounds
# like its plain version's separate tensor ops and the two agree to the
# order of summation. No --use_fast_math: the exact expf/logf are needed
# (an approximate exp biased clear-sky SW by ~1.2 W/m2 on the TPU).
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v", "-lineinfo"]

# C signatures: p = device pointer, i = int; the stream is appended
_SIGS = {
    "taumol_lw": "pppppipp",
    "taumol_sw": "pppppipp",
    "sw_adding": "pppppppppiiipppp",
    "lw_noscat": "pppppiiipp",
    "lw_adding": "ppppppiiippp",
    "mcica_sw_optics": "ppppppppppiiiiip",
    "mcica_lw_optics": "ppppppiiiip",
    "tc_sw_sweeps": "ppppppppppppiiiipppp",
    "tc_lw_sweeps": "ppppppppppiiiippp",
}

_lib: Optional[ctypes.CDLL] = None
#: compiler report of the last build (registers, shared memory, spills)
build_log = ""


def sources():
    return sorted(glob.glob(os.path.join(CSRC, "*.cu"))
                  + glob.glob(os.path.join(CSRC, "*.cuh")))


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    cand = [os.path.join(CUDA_HOME, "bin", "nvcc")] if CUDA_HOME else []
    cand.append(shutil.which("nvcc") or "")
    for c in cand:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels are built with "
                       "the CUDA toolkit's nvcc (set CUDA_HOME)")


def build() -> str:
    """Compile csrc/*.cu into the shared library (if not built yet) and
    return its path. Raises with the compiler output on failure."""
    global build_log
    h = hashlib.sha256()
    for path in sources():
        with open(path, "rb") as f:
            h.update(os.path.basename(path).encode() + f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    lib = os.path.join(BUILD_DIR, f"libecrad_kernels_{h.hexdigest()[:12]}.so")
    if os.path.exists(lib):
        return lib
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.tmp"
    cus = [p for p in sources() if p.endswith(".cu")]
    res = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, *cus],
                         capture_output=True, text=True)
    build_log = res.stdout + res.stderr
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{build_log}")
    os.replace(tmp, lib)
    return lib


def library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        for name, sig in _SIGS.items():
            fn = getattr(lib, name)
            fn.argtypes = [ctypes.c_void_p if s == "p" else ctypes.c_int
                           for s in sig] + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def check(t: torch.Tensor, dtype, shape, name: str) -> None:
    """Raise unless t is a contiguous CUDA tensor of dtype (and shape)."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: the kernel takes {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: the kernel takes contiguous tensors")


def launch(name: str, *args) -> None:
    """Call C entry point `name` on the current stream; raise if the
    launch was refused (cudaGetLastError() != 0)."""
    fn = getattr(library(), name)
    sig = _SIGS[name]
    if len(args) != len(sig):
        raise TypeError(f"{name} takes {len(sig)} arguments")
    conv = [a.data_ptr() if s == "p" else int(a) for s, a in zip(sig, args)]
    stream = torch.cuda.current_stream().cuda_stream
    err = fn(*conv, stream)
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {err}")
