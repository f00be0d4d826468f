"""Builds the port's CUDA kernels at first use and loads them with ctypes.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface (no PyTorch headers, so a build
takes seconds). The libraries go to ``build/repro_torch/<hash>/`` at the
root of the checkout; the hash covers the source, the ``csrc`` headers it
includes (``hopper.cuh``) and the flags, so an edited kernel or header is
rebuilt and an unchanged one is reused. ``load_all`` starts one ``nvcc``
per source, all at once, and waits for them.

Nothing is built when a module is imported: the CPU tests import every
module of the port on machines without ``nvcc``. A missing ``nvcc`` or a
failed build raises ``KernelBuildError``; nothing falls back.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
ARCH = "-gencode=arch=compute_90a,code=sm_90a"
COMMON_FLAGS = [ARCH, "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                "-lineinfo"]
# per-source flags: the quantizer must not contract a multiply into an FMA
# (its result is held byte-exact against the plain version)
EXTRA_FLAGS: Dict[str, List[str]] = {"kmeans": [], "quantize": ["-fmad=false"],
                                     "flash_attention": [],
                                     "flash_attention_bwd": [],
                                     "decode_attention": []}
SOURCES = tuple(EXTRA_FLAGS)

_P, _I, _LL, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_float)
# the C entry points of each source: name -> (argtypes, restype), bound once
# when the library is loaded, so a launch does no ctypes set-up of its own
SIGNATURES: Dict[str, Dict[str, tuple]] = {
    "kmeans": {
        # ..., n, k, d, then the row plan (kernels/kmeans.py RowPlan), stream
        "repro_kmeans_pairwise_dist": ([_P] * 3 + [_LL] + [_I] * 8 + [_P],
                                       _I),
        "repro_kmeans_lloyd": ([_P] * 8 + [_LL] + [_I] * 8 + [_P], _I),
        "repro_error_string": ([_I], ctypes.c_char_p),
    },
    "quantize": {
        # x, mask, q, scratch, n, d, then the plan (kernels/quantize.py
        # QuantizePlan: grid, smem bytes, resident), stream
        "repro_quantize_affine": ([_P] * 4 + [_I] * 5 + [_P], _I),
        # ..., clients, n, d, then the cohort plan (kernels/quantize.py
        # CohortPlan: per_client, grid, smem bytes, resident), stream
        "repro_quantize_affine_cohort": ([_P] * 4 + [_I] * 7 + [_P], _I),
        # (resident, smem bytes, cohort kernel?) / (cohort kernel?)
        "repro_quantize_blocks_per_sm": ([_I, _I, _I], _I),
        "repro_quantize_max_smem": ([_I], _I),
        "repro_error_string": ([_I], ctypes.c_char_p),
    },
    "flash_attention": {
        # q, k, v, out, lse (or null), dtype, b, s, sk, h, kv, d, causal,
        # window, scale, stream
        "repro_flash_attention": ([_P] * 5 + [_I] * 9 + [_F, _P], _I),
        "repro_flash_attention_tc": ([_P] * 5 + [_I] * 8 + [_F, _P], _I),
        "repro_error_string": ([_I], ctypes.c_char_p),
    },
    "flash_attention_bwd": {
        # q, k, v, out, dout, lse, dd, dq, dk, dv, dtype, b, s, sk, h, kv,
        # d, causal, window, scale, stream
        "repro_flash_attention_bwd": ([_P] * 10 + [_I] * 9 + [_F, _P], _I),
        # the same without dtype (bf16 only)
        "repro_flash_attention_bwd_tc": ([_P] * 10 + [_I] * 8 + [_F, _P],
                                         _I),
        "repro_error_string": ([_I], ctypes.c_char_p),
    },
    "decode_attention": {
        "repro_flash_decode": ([_P] * 7 + [_I] * 9 + [_F, _P], _I),
        "repro_flash_decode_tile": ([_I], _I),
        "repro_flash_decode_max_g": ([], _I),
        "repro_error_string": ([_I], ctypes.c_char_p),
    },
}

_loaded: Dict[str, ctypes.CDLL] = {}
# source name -> the ``-Xptxas -v`` report of its build in this process
ptxas_logs: Dict[str, str] = {}


class KernelBuildError(RuntimeError):
    """nvcc is missing, or it refused a source."""


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise KernelBuildError("nvcc not found on PATH or in /usr/local/cuda/bin; "
                           "the CUDA kernels of repro_torch cannot be built")


def _flags(name: str) -> List[str]:
    return COMMON_FLAGS + EXTRA_FLAGS[name]


def _sources(path: Path, seen: List[Path]) -> List[Path]:
    """``path`` and every ``csrc`` header it includes with ``#include
    "..."``, recursively, each once."""
    if path not in seen:
        seen.append(path)
        for inc in re.findall(r'^\s*#include "([^"]+)"', path.read_text(),
                              re.M):
            _sources(path.parent / inc, seen)
    return seen


def _digest(name: str) -> str:
    h = hashlib.sha256()
    for path in _sources(CSRC / f"{name}.cu", []):
        h.update(path.read_bytes())
    h.update(" ".join(_flags(name)).encode())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    """Where the shared library of ``csrc/<name>.cu`` is (or will be)."""
    return BUILD_ROOT / _digest(name) / f"lib{name}.so"


def load_all(verbose: bool = False) -> Dict[str, ctypes.CDLL]:
    """Build every kernel source that is not built yet (one ``nvcc`` per
    source, started together) and load them all. Returns name -> CDLL."""
    missing = [n for n in SOURCES
               if n not in _loaded and not library_path(n).exists()]
    procs = []
    if missing:
        nvcc = _nvcc()
        for name in missing:
            out = library_path(name)
            out.parent.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *_flags(name), "-Xptxas", "-v", "-o", str(tmp),
                   str(CSRC / f"{name}.cu")]
            procs.append((name, tmp, out, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
    failed = []
    for name, tmp, out, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"--- nvcc {name}.cu (exit {proc.returncode})\n{log}")
            continue
        os.replace(tmp, out)          # atomic: a concurrent build is harmless
        ptxas_logs[name] = log
        if verbose:
            print(f"built {out}\n{log}", end="")
    if failed:
        raise KernelBuildError("\n".join(failed))
    for name in SOURCES:
        if name not in _loaded:
            lib = ctypes.CDLL(str(library_path(name)))
            for fn_name, (argtypes, restype) in SIGNATURES[name].items():
                fn = getattr(lib, fn_name)
                fn.argtypes, fn.restype = argtypes, restype
            _loaded[name] = lib
    return dict(_loaded)


def ptxas_usage(log: str) -> Dict[str, Dict[str, int]]:
    """Per kernel entry of an ``-Xptxas -v`` report: registers per thread,
    stack frame and spill stores / loads in bytes, keyed by the (mangled)
    name."""
    usage: Dict[str, Dict[str, int]] = {}
    fn = None
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)|"
                      r"Compiling entry function '([^']+)'", line)
        if m:
            fn = m.group(1) or m.group(2)
            usage.setdefault(fn, dict.fromkeys(
                ("registers", "stack_frame", "spill_stores", "spill_loads"),
                0))
            continue
        if fn is None:
            continue
        m = re.search(r"(\d+) bytes stack frame", line)
        if m:
            usage[fn]["stack_frame"] = int(m.group(1))
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            usage[fn]["spill_stores"] = int(m.group(1))
            usage[fn]["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            usage[fn]["registers"] = int(m.group(1))
    return usage


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, building it on first use."""
    if name not in _loaded:
        load_all()
    return _loaded[name]


def check_launch(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a C entry point returned a non-zero ``cudaGetLastError``
    (a launch CUDA refused never runs, and a later synchronize would
    not report it)."""
    if err != 0:
        msg = lib.repro_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
