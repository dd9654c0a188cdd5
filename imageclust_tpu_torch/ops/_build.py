"""Build and load the port's CUDA kernels (``csrc/*.cu``).

Every source (the merge kernels include ``lexmin.cuh``, the shared
lexicographic reduce, and K1 and K3 ``cache_key.cuh``, their cached row
minimum's key) is compiled by ``nvcc`` for ``sm_90a`` into a position-
independent object (one ``nvcc`` process per source, all started together)
and the objects are linked into ``build/kernels/<hash>/libimageclust_kernels.so``
at the repository root. The sources expose a plain C interface, loaded with
``ctypes`` (no PyTorch headers, so a build takes seconds). The directory is
keyed on a hash of the sources and flags: an edited kernel is rebuilt at its
first use, an unchanged one is loaded as it is.

Nothing here runs at import time; :func:`load_kernels` builds on first call.
:func:`launch` is the one way the port's wrappers run a kernel: it checks
alignment, launches on the current stream, raises on a CUDA error and
counts the launch by kernel name.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from collections import Counter
from pathlib import Path

import torch

__all__ = ["load_kernels", "build_info", "launch", "count_replay", "launches",
           "captured", "KERNELS", "SOURCES", "HEADERS"]

_PKG = Path(__file__).resolve().parent.parent
_CSRC = _PKG / "csrc"
_BUILD_ROOT = _PKG.parent / "build" / "kernels"
SOURCES = ("merge_update_argmin.cu", "merge_update_argmin_batched.cu",
           "merge_loop_whole.cu", "short_seq_attention.cu",
           "pref_topk_block.cu", "bn_act.cu")
HEADERS = ("lexmin.cuh", "cache_key.cuh")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
_LIB_NAME = "libimageclust_kernels.so"

_lock = threading.Lock()
_lib = None
_info: dict = {}


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME", ""), "/usr/local/cuda"):
        path = os.path.join(cand, "bin", "nvcc") if cand else ""
        if path and os.path.exists(path):
            return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH): the CUDA kernels cannot be built")
    return found


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((_CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def _compile(nvcc: str, out_dir: Path) -> str:
    """Compile every source in parallel, then link; returns nvcc's output."""
    procs = []
    for name in SOURCES:
        obj = out_dir / (Path(name).stem + ".o")
        cmd = [nvcc, *NVCC_FLAGS, "-c", str(_CSRC / name), "-o", str(obj)]
        procs.append((name, cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    logs = []
    failed = []
    for name, cmd, proc in procs:
        out, _ = proc.communicate()
        logs.append(f"$ {' '.join(cmd)}\n{out}")
        if proc.returncode != 0:
            failed.append(name)
    if failed:
        raise RuntimeError(
            f"nvcc failed for {failed}:\n" + "\n".join(logs))
    objs = [str(out_dir / (Path(n).stem + ".o")) for n in SOURCES]
    cmd = [nvcc, "-shared", "-o", str(out_dir / _LIB_NAME), *objs]
    proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True)
    logs.append(f"$ {' '.join(cmd)}\n{proc.stdout}")
    if proc.returncode != 0:
        raise RuntimeError("nvcc link failed:\n" + "\n".join(logs))
    return "\n".join(logs)


_p, _i = ctypes.c_void_p, ctypes.c_int
# Each kernel's C entry point and argument types, by the name it is counted
# and reported under. Every entry point takes the stream last and returns a
# CUDA error code, 0 for none.
KERNELS = {
    "merge_update_argmin": (
        "ic_merge_update_argmin", [_p] * 6 + [_i] * 2 + [_p] * 7),
    "merge_update_argmin_batched": (
        "ic_lockstep_step", [_p] * 6 + [_i] * 4 + [_p] * 8),
    "merge_loop_whole": (
        "ic_merge_loop_whole", [_p] * 3 + [_i] * 4 + [_p] * 5),
    "short_seq_attention": (
        "ic_short_seq_attention",
        [_p] * 4 + [_i] * 4 + [ctypes.c_float, _i]),
    "pref_topk_block": ("ic_pref_topk_block", [_p] * 3 + [_i] * 6 + [_p] * 2),
    "bn_act": ("ic_bn_act", [_p] * 9 + [ctypes.c_longlong] + [_i] * 5),
}

# Launches of each kernel by name: those made on a stream, and those
# recorded into a CUDA graph while its stream was captured, which run
# nothing until a replay (count_replay adds them then).
launches: Counter = Counter()
captured: Counter = Counter()


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.ic_merge_workspace_bytes.argtypes = [_i]
    lib.ic_merge_workspace_bytes.restype = ctypes.c_longlong
    lib.ic_lockstep_workspace_bytes.argtypes = [_i, _i]
    lib.ic_lockstep_workspace_bytes.restype = ctypes.c_longlong
    lib.ic_merge_loop_whole_max_b.argtypes = []
    lib.ic_merge_loop_whole_max_b.restype = _i
    lib.ic_cuda_error_string.argtypes = [_i]
    lib.ic_cuda_error_string.restype = ctypes.c_char_p
    for symbol, args in KERNELS.values():
        fn = getattr(lib, symbol)
        fn.argtypes = [*args, _p]
        fn.restype = _i
    return lib


def load_kernels() -> ctypes.CDLL:
    """The loaded kernel library, built first if this source hash has no
    library yet. Raises if ``nvcc`` is missing or the build fails."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        t0 = time.perf_counter()
        out_dir = _BUILD_ROOT / _digest()
        lib_path = out_dir / _LIB_NAME
        log = "(cached)"
        if not lib_path.exists():
            _BUILD_ROOT.mkdir(parents=True, exist_ok=True)
            tmp = Path(tempfile.mkdtemp(prefix="tmp-", dir=_BUILD_ROOT))
            try:
                log = _compile(_nvcc(), tmp)
                try:
                    os.replace(tmp, out_dir)  # atomic against a racing build
                except OSError:
                    if not lib_path.exists():
                        raise
            finally:
                shutil.rmtree(tmp, ignore_errors=True)
        _lib = _bind(ctypes.CDLL(str(lib_path)))
        _info.update(path=str(lib_path), seconds=time.perf_counter() - t0,
                     log=log)
        return _lib


def launch(name: str, device, aligned, *args) -> None:
    """Launches kernel ``name`` (a key of :data:`KERNELS`) with the C
    arguments ``args`` on ``device``'s current stream, and counts it in
    :data:`launches`, or in :data:`captured` while that stream is being
    captured into a CUDA graph. Raises ValueError if a tensor of
    ``aligned`` is not 16-byte aligned, and RuntimeError if the launch
    returns a CUDA error."""
    lib = load_kernels()
    for t in aligned:
        if t.data_ptr() % 16:
            raise ValueError("kernel operands must be 16-byte aligned")
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(lib, KERNELS[name][0])(*args, stream)
        capturing = torch.cuda.is_current_stream_capturing()
    if rc != 0:
        msg = lib.ic_cuda_error_string(rc).decode()
        raise RuntimeError(f"{name} launch failed: {msg} ({rc})")
    (captured if capturing else launches)[name] += 1


def count_replay(per_replay: Counter) -> None:
    """Counts one replay of a CUDA graph whose capture added ``per_replay``
    to :data:`captured`."""
    launches.update(per_replay)


def build_info() -> dict:
    """Path, build seconds and nvcc output (incl. ptxas register/spill
    report) of the loaded library; empty before :func:`load_kernels`."""
    return dict(_info)
