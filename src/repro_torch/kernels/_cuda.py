"""Build, load and launch the hand-written CUDA kernels (``csrc/*.cu``).

Each source compiles with ``nvcc`` for ``sm_90a`` into a shared library with
a plain C interface, loaded with ``ctypes``.  The build happens at first
use, into ``_build/`` beside this file, and is keyed by a hash of the
source and the flags, so an edited source rebuilds and an unchanged one
loads the library already built.  Nothing is built or loaded at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).with_name("csrc")
BUILD_DIR = Path(__file__).with_name("_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: dict = {}
build_log: dict = {}   # source name -> nvcc/ptxas output of its build


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels are built with the "
                       "CUDA toolkit on the machine with the card")


def build(source: str) -> Path:
    """Compile ``csrc/<source>`` (if not built yet) and return the library."""
    src = CSRC / source
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"{src.stem}-{digest}.so"
    if out.is_file():
        return out
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    res = subprocess.run(cmd, capture_output=True, text=True, check=False)
    if res.returncode:
        raise RuntimeError(f"nvcc failed on {source} ({res.returncode}):\n"
                           f"{res.stdout}{res.stderr}")
    build_log[source] = res.stdout + res.stderr
    os.replace(tmp, out)
    return out


def segment_probe_lib() -> ctypes.CDLL:
    """The segment-probe library, built and loaded once per process."""
    with _lock:
        lib = _libs.get("segment_probe")
        if lib is None:
            lib = ctypes.CDLL(str(build("segment_probe.cu")))
            fn = lib.segment_probe_launch
            fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 8
                           + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 4)
            fn.restype = ctypes.c_int
            _libs["segment_probe"] = lib
    return lib


MODE_PROBE, MODE_PROBE_FP, MODE_MUTATE = 0, 1, 2


def _need(t: torch.Tensor, name: str, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != torch.int32:
        raise ValueError(f"{name} must be int32 words, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def launch_segment_probe(mode: int, rows, indicators, fps, prio, pairs,
                         parity, qkeys, qfp):
    """Check the operands and launch one segment-probe kernel on the
    current stream.  Returns ``(match, empty, flip)`` (flip None unless
    mutate).  Raises on any operand it does not take or a failed launch."""
    dev = rows.device
    if dev.type != "cuda":
        raise ValueError(f"the CUDA kernel needs CUDA tensors, got {dev}")
    if rows.dim() != 2 or rows.shape[1] % 4:
        raise ValueError(f"rows must be (P, S*4), got {tuple(rows.shape)}")
    P, S = rows.shape[0], rows.shape[1] // 4
    B = qkeys.shape[0]
    if not 1 <= S <= 32:
        raise ValueError(f"one warp per query takes S <= 32 slots, got {S}")
    _need(rows, "rows", (P, 4 * S), dev)
    _need(indicators, "indicators", (P, 1), dev)
    _need(prio, "prio", (2, S), dev)
    _need(pairs, "pairs", (B,), dev)
    _need(parity, "parity", (B,), dev)
    _need(qkeys, "qkeys", (B, 4), dev)
    if mode != MODE_PROBE:
        _need(fps, "fps", (P, 2), dev)
        _need(qfp, "qfp", (B,), dev)
    for name, t in (("rows", rows), ("qkeys", qkeys)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned (uint4 loads)")
    match = torch.empty(B, dtype=torch.int32, device=dev)
    empty = torch.empty(B, dtype=torch.int32, device=dev)
    flip = (torch.empty(B, dtype=torch.int32, device=dev)
            if mode == MODE_MUTATE else None)
    if B == 0:
        return match, empty, flip
    lib = segment_probe_lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.segment_probe_launch(
            mode, rows.data_ptr(), indicators.data_ptr(),
            fps.data_ptr() if mode != MODE_PROBE else None,
            prio.data_ptr(), pairs.data_ptr(), parity.data_ptr(),
            qkeys.data_ptr(), qfp.data_ptr() if mode != MODE_PROBE else None,
            B, P, S, match.data_ptr(), empty.data_ptr(),
            flip.data_ptr() if flip is not None else None, stream)
    if err:
        raise RuntimeError(f"segment_probe_launch failed: cudaError {err}")
    return match, empty, flip
