"""Build and load the hand-written CUDA kernels.

The kernels in ``csrc/*.cu`` (and the headers ``csrc/*.cuh`` they include)
have a plain C interface. On the first call that needs them, ``nvcc``
compiles each source for ``sm_90a`` (all sources at once, one process each)
and links them into ``build/kernels/libtorcheval_kernels.so`` beside the
package; ``ctypes`` loads the result. Nothing is built or loaded
when a module is imported, so the package imports on a machine with no
``nvcc`` and no GPU, where every wrapper runs its plain PyTorch version on
CPU tensors.

The wrappers (``ops/hist.py``, ``ops/stream_compact.py``, ``ops/topk.py``,
``ops/scatter.py``) take the plain version only for a tensor on the CPU (:func:`runs_plain`);
``ops/curves.py`` sends the exact binary AUROC to ``ops/roc_stream.py``'s
kernels only off the CPU.
For any other tensor they call :func:`library`, which builds the kernels or
raises: there is no fallback.
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
from pathlib import Path
from typing import Optional

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "kernels"
LIB_NAME = "libtorcheval_kernels.so"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_SIGNATURES = {
    "tc_hist_i32": ([_P, _I64, _I64, _P, _P], ctypes.c_int),
    "tc_hist_i64": ([_P, _I64, _I64, _P, _P], ctypes.c_int),
    "tc_stream_compact_scratch": ([_I64], _I64),
    "tc_stream_compact": (
        [_P, _I64, _P, _P, _P, ctypes.c_int, _P, _P, _P],
        ctypes.c_int,
    ),
    "tc_topk_workspace": ([_I64, _I64, ctypes.c_int], _I64),
    "tc_topk": (
        [_P, _I64, _I64, ctypes.c_int, _P, _P, _P, _P],
        ctypes.c_int,
    ),
    "tc_segment_sum": (
        [ctypes.c_int, ctypes.c_int, _P, _P, _I64, _I64, _I64, ctypes.c_int, _P, _P],
        ctypes.c_int,
    ),
    "tc_score_segment_sum": (
        [ctypes.c_int, _P, _P, _I64, ctypes.c_int, ctypes.c_int, _P, _P, _P],
        ctypes.c_int,
    ),
    "tc_roc_keys": ([ctypes.c_int, _P, _P, _I64, _P, _P, _P, _P], ctypes.c_int),
    "tc_roc_sort_scratch": ([_I64], _I64),
    "tc_roc_sort": (
        [_P, _P, _P, _P, _I64, _P, _I64, ctypes.POINTER(ctypes.c_int), _P],
        ctypes.c_int,
    ),
    "tc_roc_integrate_scratch": ([_I64], _I64),
    "tc_roc_integrate": ([_P, _P, _I64, _P, _P, _P, _P], ctypes.c_int),
    "tc_error_string": ([ctypes.c_int], ctypes.c_char_p),
}


class _Loaded:
    """The loaded library and what its build reported."""

    def __init__(self) -> None:
        self.lib: Optional[ctypes.CDLL] = None
        self.build_seconds: Optional[float] = None  # None: reused a build
        self.build_log = ""
        self.lock = threading.Lock()


_loaded = _Loaded()


def runs_plain(t: torch.Tensor) -> bool:
    """True when a wrapper must run its plain PyTorch version: the tensor
    lies on the CPU. Every other device goes to the kernel."""
    return t.device.type == "cpu"


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [
        str(Path(cuda_home) / "bin" / "nvcc") if cuda_home else None,
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ]
    for c in candidates:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc was not found (CUDA_HOME, PATH, /usr/local/cuda): the CUDA "
        "kernels of torcheval_tpu_torch cannot be built, so CUDA tensors "
        "cannot be processed. Pass CPU tensors (device='cpu') to use the "
        "plain PyTorch versions."
    )


def _sources_digest(sources) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()


def _compile(nvcc: str, sources, out_dir: Path) -> str:
    """Compile every source at once (one nvcc each), then link one .so."""
    procs = []
    for src in sources:
        obj = out_dir / (src.stem + ".o")
        cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
        procs.append(
            (cmd, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            ))
        )
    log, failed = [], []
    for cmd, _, proc in procs:
        out, _ = proc.communicate()
        log.append(f"$ {' '.join(cmd)}\n{out}")
        if proc.returncode != 0:
            failed.append(cmd)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(log))
    lib = out_dir / LIB_NAME
    cmd = [nvcc, "-shared", "-o", str(lib), *(str(o) for _, o, _ in procs)]
    res = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    log.append(f"$ {' '.join(cmd)}\n{res.stdout}")
    if res.returncode != 0:
        raise RuntimeError("nvcc link failed:\n" + "\n".join(log))
    return "\n".join(log)


def library() -> ctypes.CDLL:
    """The kernels' shared library: built from ``csrc/*.cu`` on first use
    (rebuilt when a source or a header changes), loaded once per process.
    Raises when it cannot be built."""
    with _loaded.lock:
        if _loaded.lib is not None:
            return _loaded.lib
        sources = sorted(CSRC.glob("*.cu"))
        digest = _sources_digest([*sources, *sorted(CSRC.glob("*.cuh"))])
        lib_path = BUILD_DIR / LIB_NAME
        stamp = BUILD_DIR / "sources.sha256"
        if not (
            lib_path.is_file()
            and stamp.is_file()
            and stamp.read_text().strip() == digest
        ):
            nvcc = _nvcc()
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            t0 = time.perf_counter()
            with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
                _loaded.build_log = _compile(nvcc, sources, Path(tmp))
                os.replace(Path(tmp) / LIB_NAME, lib_path)
            stamp.write_text(digest + "\n")
            _loaded.build_seconds = time.perf_counter() - t0
        lib = ctypes.CDLL(str(lib_path))
        for name, (argtypes, restype) in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = restype
        _loaded.lib = lib
        return lib


def loaded() -> bool:
    """True once this process has loaded the kernels' library."""
    return _loaded.lib is not None


def build_report() -> tuple:
    """``(seconds, log)`` of this process's build; seconds is None when an
    earlier build was reused."""
    return _loaded.build_seconds, _loaded.build_log


def check(err: int, kernel: str) -> None:
    """Raise when a C entry returned a CUDA error (a refused launch never
    runs, and ``torch.cuda.synchronize()`` would not report it)."""
    if err != 0:
        msg = _loaded.lib.tc_error_string(err).decode()
        raise RuntimeError(f"CUDA kernel {kernel} failed to launch: {msg} ({err}).")


def stream_of(t: torch.Tensor) -> int:
    """The raw handle of PyTorch's current stream on ``t``'s device."""
    return torch.cuda.current_stream(t.device).cuda_stream


def require_cuda(kernel: str, *tensors: torch.Tensor) -> None:
    """The kernels take contiguous CUDA tensors on one device only."""
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(
                f"{kernel}: expected CUDA tensors on one device, got {t.device}."
            )
        if not t.is_contiguous():
            raise ValueError(f"{kernel}: expected contiguous tensors.")
