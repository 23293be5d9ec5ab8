"""Build the hand-written CUDA kernels and load them with ctypes.

Each source under ``csrc/`` is compiled by ``nvcc`` into a shared library
with a plain C interface, at first use, into ``kernels/build/`` (listed in
``.gitignore``). The library name carries a hash of the source, the shared
headers (``csrc/*.cuh``) and the flags, so an edited source or header is
rebuilt and a stale library is never loaded.
Nothing is built when the module is imported: machines without ``nvcc``
(the CPU test runs) import it freely.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")

# -fmad=false: no multiply-add contraction, so the PS(mu) accumulation keeps
# its two FP32 roundings per step (the kernels also spell them out with
# __fmul_rn / __fadd_rn). Never --use_fast_math: expf / logf feed the LAMP
# selection thresholds.
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# source file -> {C function: (argtypes, restype)}
_P, _I, _F, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
SIGNATURES: Dict[str, Dict[str, tuple]] = {
    "paged_attention.cu": {
        "lamp_paged_mixed_attention": (
            [_P] * 11 + [_I] * 15 + [_F, _I, _P], _I),
        "lamp_paged_decode_attention": (
            [_P] * 10 + [_I] * 14 + [_F, _I, _P], _I),
        "lamp_paged_attention_workspace": ([_I] * 7, _LL),
        "lamp_paged_attention_arrivals": ([_I] * 3, _LL),
        "lamp_round_to_mantissa": ([_P, _P, _LL, _I, _P], _I),
    },
    "flash_decode.cu": {
        "lamp_flash_decode": ([_P] * 7 + [_I] * 6 + [_F, _F] + [_I] * 3 + [_P],
                              _I),
        "lamp_flash_decode_workspace": ([_I, _I, _I], _LL),
    },
    "lamp_attention.cu": {
        "lamp_flash_attention": ([_P] * 5 + [_I] * 8 + [_F, _F, _P], _I),
        "lamp_flash_attention_smem": ([_I, _I], _LL),
    },
    "ps_matmul.cu": {
        "lamp_ps_matmul": ([_P] * 3 + [_I] * 5 + [_P], _I),
        "lamp_tf32_split": ([_P, _P, _LL, _P], _I),
    },
    "rmsnorm.cu": {
        "lamp_rmsnorm": ([_P] * 3 + [_LL, _I, _I, _F, _P], _I),
        "lamp_rmsnorm_vector_path": ([_P] * 3 + [_I, _I], _I),
    },
}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
build_logs: Dict[str, str] = {}     # source -> nvcc's output (registers, spills)


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def _lib_path(source: str) -> str:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(n for n in os.listdir(CSRC) if n.endswith(".cuh"))
    for name in [source] + headers:
        with open(os.path.join(CSRC, name), "rb") as f:
            digest.update(f.read())
    stem = os.path.splitext(source)[0]
    return os.path.join(BUILD_DIR, f"lib{stem}-{digest.hexdigest()[:16]}.so")


def _compile(source: str) -> str:
    path = _lib_path(source)
    if os.path.exists(path):
        if source not in build_logs and os.path.exists(path + ".log"):
            with open(path + ".log") as f:
                build_logs[source] = f.read()
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, source)],
            capture_output=True, text=True, check=False)
        build_logs[source] = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {source}:\n{build_logs[source]}")
        with open(path + ".log", "w") as f:
            f.write(build_logs[source])
        os.replace(tmp, path)    # atomic: a half-written library is never loaded
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return path


def ptxas_usage(source: str) -> Dict[str, Dict[str, int]]:
    """Registers a thread and bytes of spill stores that ptxas reported for
    each kernel (mangled name) of `source`, from its build log (built first
    if needed)."""
    _compile(source)
    usage: Dict[str, Dict[str, int]] = {}
    name = None
    for line in build_logs.get(source, "").splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = m.group(1)
            usage[name] = {}
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and name:
            usage[name]["spill_stores"] = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            usage[name]["registers"] = int(m.group(1))
    return usage


def build_all() -> None:
    """Compile every kernel source, one nvcc per source, all at once."""
    sources = list(SIGNATURES)
    with ThreadPoolExecutor(max_workers=len(sources)) as ex:
        for fut in [ex.submit(_compile, s) for s in sources]:
            fut.result()


def check_launch(err: int, what: str) -> None:
    """Raise if a kernel launch returned a CUDA error (0 = cudaSuccess): a
    refused launch never runs, and no later synchronize reports it."""
    if err != 0:
        raise RuntimeError(f"{what} failed to launch: CUDA error {err}")


def load(source: str) -> ctypes.CDLL:
    """The loaded library of `source`, built first if needed, with every C
    function's argtypes and restype declared."""
    with _lock:
        lib = _libs.get(source)
        if lib is None:
            lib = ctypes.CDLL(_compile(source))
            for name, (argtypes, restype) in SIGNATURES[source].items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = restype
            _libs[source] = lib
        return lib
