"""Build, load and count the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by nvcc, at first use, into
``build/kernels/lib<name>-<hash>.so`` at the repository root: a shared
library with a plain C interface, loaded with ctypes. No PyTorch headers
are involved, so a build takes seconds. The file name carries a hash of
the sources and flags, so an edited kernel is rebuilt and a stale library
is never loaded. ``build()`` starts one nvcc per source, all at once.

Every C entry point returns ``cudaGetLastError()`` after its launch;
``check`` raises on anything but 0. A wrapper bumps ``LAUNCHES[name]``
exactly where it launches its kernel, so a run can show which kernels its
main path went through; a captured CUDA graph adds the counts its
capture recorded on each replay (``add_launches``). ``scratch`` holds the
split kernels' shared partials and tickets. Each nvcc build counts as a
program made, and each library loaded that this process did not build
as a cache hit (``utils/compile_watch``).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, Mapping

from ..utils import compile_watch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
SOURCES = ("paged_write", "paged_attention", "norm_quant", "mixed_matmul",
           "wo_matmul", "flash_attention")
# no --use_fast_math: the write kernels rely on exact IEEE division
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

LAUNCHES: Dict[str, int] = {}
BUILD_LOGS: Dict[str, str] = {}

_libs: Dict[str, ctypes.CDLL] = {}
_built = set()          # the libraries this process compiled
_lock = threading.Lock()

P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
LL = ctypes.c_longlong


def count_launch(name: str) -> None:
    LAUNCHES[name] = LAUNCHES.get(name, 0) + 1


def add_launches(counts: Mapping[str, int]) -> None:
    """Add a captured graph's launch counts (one replay)."""
    for name, n in counts.items():
        LAUNCHES[name] = LAUNCHES.get(name, 0) + n


def reset_launches() -> None:
    LAUNCHES.clear()


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels are built on the "
                       "machine with the card (CUDA toolkit on PATH or in "
                       "CUDA_HOME)")


def _lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: Iterable[str] = SOURCES) -> Dict[str, Path]:
    """Compile the named sources that are not built yet, in parallel.
    Returns {name: library path}; raises with nvcc's output on failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {n: _lib_path(n) for n in names}
    procs = {}
    for n, path in paths.items():
        if path.exists():
            continue
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        compile_watch.note_program()
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp)
    failed = []
    for n, (proc, tmp) in procs.items():
        log, _ = proc.communicate()
        BUILD_LOGS[n] = log
        if proc.returncode != 0:
            failed.append(f"{n}.cu (exit {proc.returncode}):\n{log}")
        else:
            os.replace(tmp, paths[n])
            _built.add(n)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return paths


def load(name: str) -> ctypes.CDLL:
    with _lock:
        if name not in _libs:
            path = build([name])[name]
            if name not in _built:
                compile_watch.note_cache_hit()
            _libs[name] = ctypes.CDLL(str(path))
        return _libs[name]


def bind(lib_name: str, fn_name: str, argtypes) -> ctypes._CFuncPtr:
    """The C entry point with its argument types declared (ctypes passes
    an undeclared Python int as a 32-bit int and would cut a pointer)."""
    fn = getattr(load(lib_name), fn_name)
    if fn.argtypes is None:
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return fn


def check(lib_name: str, err: int, what: str) -> None:
    if err != 0:
        es = load(lib_name).mixq_error_string
        es.argtypes, es.restype = [ctypes.c_int], ctypes.c_char_p
        raise RuntimeError(f"{what}: CUDA error {err} "
                           f"({es(err).decode()})")


def aligned(t):
    """``t`` contiguous and 16-byte aligned (the kernels load 16 bytes at a
    time), copied only when it is not already."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


# device -> the buffers every split kernel (K2, K4, K12, K13, K7) reuses
# launch after launch on the device's stream: the tickets (zeros, left
# zeroed by every launch: the last block of a tile resets its counter) and
# the partials (4-byte elements: f32 sums, or K2's int32 ones). A buffer
# that is outgrown is kept, never freed: a captured graph may still hold
# its pointer.
_TICKETS: Dict = {}
_PARTIALS: Dict = {}
_OUTGROWN: list = []


def _grown(cache: dict, dev, n: int, make):
    buf = cache.get(dev)
    if buf is None or buf.numel() < n:
        import torch
        if torch.cuda.is_available() and \
                torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                f"scratch: {n} elements asked during a CUDA graph capture "
                f"(held {0 if buf is None else buf.numel()}); a rung's warm "
                "pass must grow the buffers before its capture")
        if buf is not None:
            _OUTGROWN.append(buf)
        buf = make(max(n, 4096))
        cache[dev] = buf
    return buf


def scratch(dev, n_part: int, n_tickets: int):
    """(pointer to at least ``n_part`` 4-byte partials, or None where
    ``n_part`` is 0; pointer to at least ``n_tickets`` zeroed tickets) on
    ``dev``, shared by every split kernel's launches. Raises if they would
    grow while the current stream is capturing a graph."""
    import torch
    part = (_grown(_PARTIALS, dev, n_part,
                   lambda size: torch.empty((size,), dtype=torch.float32,
                                            device=dev))
            if n_part else None)
    tickets = _grown(_TICKETS, dev, n_tickets,
                     lambda size: torch.zeros((size,), dtype=torch.int32,
                                              device=dev))
    return None if part is None else part.data_ptr(), tickets.data_ptr()


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device ``index`` (the split
    kernels' plans fill them)."""
    import torch
    return torch.cuda.get_device_properties(index).multi_processor_count


def device_sms(dev) -> int:
    import torch
    return sm_count(dev.index if dev.index is not None
                    else torch.cuda.current_device())


def stream_ptr(device) -> int:
    """The current CUDA stream of ``device``, as the C entry points take it."""
    import torch
    return torch.cuda.current_stream(device).cuda_stream
