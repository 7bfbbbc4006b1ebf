"""Build and load the hand-written CUDA kernels.

All sources under ``lynsedb_tpu_torch/csrc`` compile with ``nvcc`` for
``sm_90a`` into one shared library with a plain C interface, bound with
ctypes: one ``nvcc -c`` per source, all started together, then one link.
The library is built at first use into ``build/lynsedb_tpu_torch`` beside
the package and is keyed on a hash of the sources and flags, so an edited
source rebuilds and an unchanged one loads in milliseconds. Nothing here
runs at import time: the CPU tests import every module on a machine without
``nvcc``.

Every C entry point launches on the stream it is given, allocates nothing and
returns the ``cudaError_t`` of its launch; :func:`call` raises on a non-zero
return.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC.parent.parent / "build" / "lynsedb_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-lineinfo", "-Xptxas", "-v", "-Xcompiler", "-fPIC",
)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# argtypes of every entry point: each pointer and the stream is c_void_p, so
# no 64-bit address is ever passed as a 32-bit int
_SIGNATURES = {
    "lt_topk_select": (_P, _P, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P),
    "lt_topk_merge_runs": (_P, _P, _I, _I, _I, _I, _P, _P, _P, _P),
    "lt_gemm_metric_scores": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P,
                              _P),
    "lt_binary_scores": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P),
    "lt_elementwise_scores": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P,
                              _P),
    "lt_elementwise_topc": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P),
    "lt_elementwise_bf16_keys": (_P, _P, _P, _P, _I, _I, _I, _I, _P, _P),
    "lt_bf16_centered_topc": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P,
                              _P, _P),
    "lt_rescore_topk": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P),
    "lt_rescore_keys": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P),
    "lt_kmeans_assign": (_P, _P, _P, _I, _I, _I, _I, _P, _P),
    "lt_kmeans_update": (_P, _P, _P, _P, _I, _I, _I, _P, _P, _P, _P, _P, _P),
    "lt_kmeans_reduce_shards": (_P, _P, _P, _I, _I, _I, _P, _P, _P),
    "lt_ivf_scan_blocks": (_P, _P, _P, _I, _I, _P, _I, _I, _P, _I, _P, _P, _P, _I, _I, _I, _I, _F,
                           _P, _P, _P),
    "lt_fwht_rotate": (_P, _P, _I, _I, _I, _P, _P),
    "lt_int8_code_scores": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P,
                            _P, _P, _P),
    "lt_pq_adc_scores": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P),
    "lt_bf16_gather_scores": (_P, _P, _P, _I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P,
                              _P),
    "lt_bf16_gather_topc": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P,
                            _P),
    "lt_beam_search": (_I, _P, _I, _P, _P, _I, _P, _P, _P, _P, _I, _I, _P, _I, _I, _P, _I, _I, _I,
                       _I, _I, _I, _I, _P, _I, _P, _P, _P, _I, _P),
    "lt_topl_scan": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P,
                     _P),
    "lt_robust_prune": (_P, _I, _I, _P, _P, _P, _I, _I, _I, _I, _F, _F, _I, _I, _P, _P, _P, _P),
    "lt_pointer_chase": (_P, _I, _I, _P, _P),
    "lt_ivf_binary_blocks": (_P, _P, _P, _I, _I, _P, _I, _I, _P, _P, _P, _P, _I, _I, _I, _P,
                             _P),
}

_LOCK = threading.Lock()
_LIB: list = []  # the loaded library, once built


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    path = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: set CUDA_HOME or put the CUDA toolkit's bin on PATH")
    return str(path)


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def build() -> tuple[Path, str]:
    """Compile the kernels if this exact source set is not built yet.
    Returns (library path, compiler output — empty when already built)."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    lib_path = BUILD_DIR / f"liblynse_kernels_{digest.hexdigest()[:16]}.so"
    if lib_path.exists():
        return lib_path, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        cmds = [[nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(Path(tmp) / f"{src.stem}.o")]
                for src in sorted(CSRC.glob("*.cu"))]
        cmds.append([nvcc, *NVCC_FLAGS, "-shared", "-o", str(Path(tmp) / "lib.so"),
                     *(c[-1] for c in cmds)])
        log = []
        for step in (cmds[:-1], cmds[-1:]):  # every source at once, then the link
            procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                            text=True)) for cmd in step]
            for cmd, proc in procs:
                out = proc.communicate()[0]
                log.append(out)
                if proc.returncode != 0:
                    for _, other in procs:
                        other.wait()
                    raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{out}")
        # atomic: a concurrent process never loads half a file
        os.replace(Path(tmp) / "lib.so", lib_path)
    return lib_path, "".join(log)


def library() -> ctypes.CDLL:
    with _LOCK:
        if not _LIB:
            path, _ = build()
            lib = ctypes.CDLL(str(path))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            lib.lt_topk_scratch.argtypes = [_I, _I, _I]
            lib.lt_topk_merge_scratch.argtypes = [_I, _I, _I, _I]
            lib.lt_kmeans_update_scratch.argtypes = [_I, _I]
            for name in ("lt_topk_scratch", "lt_topk_merge_scratch", "lt_kmeans_update_scratch"):
                getattr(lib, name).restype = ctypes.c_longlong
            for name in ("lt_topc_spans", "lt_topc_scratch"):
                getattr(lib, name).argtypes = [_I, _I, _I, _I]
                getattr(lib, name).restype = ctypes.c_longlong
            lib.lt_ivf_scan_scratch.argtypes = [_I, _I, ctypes.c_longlong]
            lib.lt_ivf_scan_scratch.restype = ctypes.c_longlong
            lib.lt_elem_topc_plan.argtypes = [_I] * 8
            lib.lt_elem_topc_plan.restype = ctypes.c_longlong
            for name in ("lt_topl_spans", "lt_topl_scratch"):
                getattr(lib, name).argtypes = [_I, _I, _I, _I, _I, _I]
                getattr(lib, name).restype = ctypes.c_longlong
            lib.lt_error_string.argtypes = [_I]
            lib.lt_error_string.restype = ctypes.c_char_p
            _LIB.append(lib)
        return _LIB[0]


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def ptr(t) -> int | None:
    return None if t is None else t.data_ptr()


def call(name: str, *args) -> None:
    """Launch one entry point; raise if the launch reported an error."""
    lib = library()
    err = getattr(lib, name)(*args)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} ({lib.lt_error_string(err).decode()})")


def require_cuda(name: str, *tensors) -> None:
    """Device, contiguity and common-device checks every wrapper runs
    (None stands for a pointer the kernel does not read)."""
    dev = tensors[0].device
    for t in tensors:
        if t is None:
            continue
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{name}: every tensor must be on {dev}, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
