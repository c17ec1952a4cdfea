"""Build the port's native sources and load them through ctypes.

Each `csrc/<name>.cu` exposes a plain C interface (`extern "C"` launchers that
return `cudaGetLastError()`), so nvcc compiles it in seconds without
PyTorch's headers. `native/<name>.cc` is host C++ (the DBN decoder, the
aligner's banded DTW, the polyphase resampler), built with g++. Each shared
library lands in `build/kernels/` at the repository root (listed in
.gitignore), named by a hash of its source directory and flags (and, for
host code, of the CPU it is built for): a rebuild with unchanged sources is
a cache hit. Nothing is built or loaded when this module is imported; the
first use of a library builds it.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import platform
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Tuple

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
NATIVE_DIR = PKG_DIR / "native"
BUILD_DIR = PKG_DIR.parent / "build" / "kernels"
CUDA_SOURCES = ("decode_attention", "dilated_attention", "dilated_attention_bwd")  # csrc/<name>.cu
HOST_SOURCES = ("dbn_viterbi", "dtw_band", "resample_fir")  # native/<name>.cc
SOURCES = CUDA_SOURCES + HOST_SOURCES
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)
# As the JAX package builds its copies (etude_tpu/native/__init__.py), so
# that the two give the same bits (-march=native lets g++ contract the
# resampler's multiply-adds). The library's name hashes the host's CPU with
# the flags, since code built for one CPU may not run on another.
GXX_FLAGS = ("-O3", "-march=native", "-std=c++17", "-shared", "-fPIC")

_loaded: Dict[str, ctypes.CDLL] = {}
_load_lock = threading.Lock()
_launch_lock = threading.Lock()


def count_launch(wrapper) -> None:
    """Add one to `wrapper.launches` (a kernel wrapper's count of launches
    since it was last set to 0). Safe from several threads: the streams of a
    sweep spread over cards launch from one thread per card."""
    with _launch_lock:
        wrapper.launches += 1


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin)")


def _gxx() -> str:
    found = shutil.which("g++")
    if found:
        return found
    raise RuntimeError("g++ not found on PATH")


def source_path(name: str) -> Path:
    if name in CUDA_SOURCES:
        return CSRC_DIR / f"{name}.cu"
    if name in HOST_SOURCES:
        return NATIVE_DIR / f"{name}.cc"
    raise KeyError(f"no native source named {name!r}")


def _flags(name: str) -> Tuple[str, ...]:
    return NVCC_FLAGS if name in CUDA_SOURCES else GXX_FLAGS


def _compiler(name: str) -> Tuple[str, ...]:
    """The compile command for `name`, up to the output and source paths."""
    return (_nvcc() if name in CUDA_SOURCES else _gxx(), *_flags(name))


@functools.cache
def _host_cpu() -> str:
    """The host CPU's model and flags, as /proc/cpuinfo gives them
    (`platform.processor()` where there is no such file)."""
    try:
        lines = Path("/proc/cpuinfo").read_text().splitlines()
    except OSError:
        return platform.processor()
    keep = [ln for ln in lines if ln.split(":")[0].strip() in ("model name", "flags")]
    return "\n".join(dict.fromkeys(keep))


def library_path(name: str) -> Path:
    """Where the library for `name` lives for the current sources, flags and
    host CPU (every file beside its source is hashed, so a shared header
    counts)."""
    src = source_path(name)
    digest = hashlib.sha256(" ".join(_flags(name)).encode())
    if name in HOST_SOURCES:
        digest.update(_host_cpu().encode())
    for path in sorted(src.parent.iterdir()):
        if path.is_file():
            digest.update(path.name.encode())
            digest.update(path.read_bytes())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build(names: Iterable[str] = SOURCES) -> Dict[str, Tuple[float, str]]:
    """Compile every named source whose library is missing: one compiler per
    source, all started together. Returns {name: (seconds, compiler output)}
    for the sources it compiled; raises with the compiler's output on a failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = {}   # every command first, so a missing compiler starts nothing
    for name in names:
        out = library_path(name)
        if not out.exists():
            tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
            todo[name] = ([*_compiler(name), "-o", str(tmp), str(source_path(name))],
                          tmp, out)
    started = {}
    for name, (cmd, tmp, out) in todo.items():
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        started[name] = (proc, tmp, out, time.perf_counter())
    built, failed = {}, []
    for name, (proc, tmp, out, t0) in started.items():  # wait for every compiler
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"building {source_path(name).name} failed:\n{log}")
            continue
        os.replace(tmp, out)  # atomic: a concurrent build never sees half a file
        built[name] = (time.perf_counter() - t0, log)
    if failed:
        raise RuntimeError("\n".join(failed))
    return built


def load(name: str) -> ctypes.CDLL:
    """The loaded library for `name`, built first if needed (one thread
    builds it; the others wait)."""
    with _load_lock:
        lib = _loaded.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(library_path(name)))
            _loaded[name] = lib
    return lib
