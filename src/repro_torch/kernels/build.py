"""Build and load the port's CUDA kernels: ``nvcc`` into a shared library
with a plain C interface, loaded with ``ctypes``.

Each source under ``kernels/*/csrc/`` compiles on first use (the fused-RNN
source twice: fp and int8 weight instances) into
``build/kernels/`` at the repository root, named by a hash of its content, so
an edited source rebuilds and an unchanged one loads what is there. Nothing
happens at import: this module imports on a machine with no ``nvcc`` and no
card, and a failed build raises.

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC [-DFUSED_RNN_INT8] -o build/kernels/<name>-<hash>.so <source>.cu
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
from typing import Dict, List

_PKG = pathlib.Path(__file__).resolve().parent
BUILD_DIR = _PKG.parents[2] / "build" / "kernels"

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

_FUSED_RNN_SRC = _PKG / "fused_rnn" / "csrc" / "fused_rnn_layer.cu"
_FUSED_RNN_FNS = {
    "fused_rnn_layer_launch": [_I, _I] + [_P] * 11 + [_I] * 9 + [_P],
    "fused_rnn_stack_layer_launch": [_I, _I] + [_P] * 11 + [_I] * 4 + [_F, _I, _I, _P],
    "fused_rnn_info": [_I] * 12 + [_P],
    "fused_rnn_cluster_slots": [_P],
}

#: name -> (source, {C function: argtypes}, nvcc defines). Pointers and the
#: stream are ``c_void_p`` (a plain ``int`` would be cut to 32 bits). The
#: fused-RNN source builds twice, its fp and its int8 weight instances apart,
#: so that the two halves compile in parallel.
SOURCES: Dict[str, tuple] = {
    "fused_rnn_layer": (_FUSED_RNN_SRC, _FUSED_RNN_FNS, ()),
    "fused_rnn_layer_int8": (_FUSED_RNN_SRC, _FUSED_RNN_FNS, ("-DFUSED_RNN_INT8",)),
    "linear_scan": (
        _PKG / "linear_scan" / "csrc" / "linear_scan.cu",
        {"linear_scan_launch": [_I] + [_P] * 4 + [_I] * 3 + [_P] * 3,
         "linear_scan_bwd_launch": [_I] + [_P] * 7 + [_I] * 3 + [_P] * 3},
        (),
    ),
    "gqa_decode": (
        _PKG / "gqa_decode" / "csrc" / "gqa_decode.cu",
        {"gqa_decode_launch": [_I] + [_P] * 8 + [_I] * 7 + [_P],
         "gqa_decode_info": [_I] * 3 + [_P]},
        (),
    ),
    "ssd": (
        _PKG / "ssd" / "csrc" / "ssd.cu",
        {"ssd_launch": [_I, _I] + [_P] * 9 + [_I] * 7 + [_P, _P],
         "ssd_info": [_I] * 3 + [_P]},
        (),
    ),
}

_LIBS: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is")


def nvcc_version() -> str:
    out = subprocess.run([nvcc_path(), "--version"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[-1]


def _target(name: str) -> pathlib.Path:
    src, _, defines = SOURCES[name]
    digest = hashlib.sha256(src.read_bytes() + " ".join(defines).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def _command(name: str, out: pathlib.Path) -> List[str]:
    return [
        nvcc_path(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
        "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", *SOURCES[name][2], "-o", str(out),
        str(SOURCES[name][0]),
    ]


def build_all(names=None) -> Dict[str, str]:
    """Compile every missing library, one ``nvcc`` per source, all started
    together. Returns each name's ``ptxas`` report (empty when the library
    was already built)."""
    names = list(SOURCES) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = _target(name)
        if not out.exists():
            tmp = out.with_suffix(f".{os.getpid()}.tmp.so")
            procs[name] = (subprocess.Popen(
                _command(name, tmp), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True,
            ), tmp, out)
    reports = {name: "" for name in names}
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name} ({proc.returncode}):\n{log}")
        os.replace(tmp, out)
        reports[name] = log
    return reports


def library(name: str) -> ctypes.CDLL:
    """The loaded library for ``name``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        build_all([name])
        lib = ctypes.CDLL(str(_target(name)))
        for fn, argtypes in SOURCES[name][1].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        _LIBS[name] = lib
    return lib


def check(rc: int, what: str) -> None:
    """Raise on a launcher's non-zero return (a ``cudaError_t``, or a
    negative code for arguments the launcher refused)."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with code {rc}")
