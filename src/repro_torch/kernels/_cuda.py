"""Build, load and launch the hand-written CUDA kernels (``csrc/*.cu``).

Each source compiles with ``nvcc`` for ``sm_90a`` into a shared library with
a plain C interface, loaded with ``ctypes``.  The build happens at first
use, into ``_build/`` beside this file, and is keyed by a hash of the
source and the flags, so an edited source rebuilds and an unchanged one
loads the library already built; ``build_all`` runs one ``nvcc`` per
source in parallel.  Nothing is built or loaded at import.
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

import torch

CSRC = Path(__file__).with_name("csrc")
BUILD_DIR = Path(__file__).with_name("_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

SOURCES = ("segment_probe.cu", "paged_attn.cu", "scan_walk.cu")

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


def _target(source: str) -> Path:
    src = CSRC / source
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{src.stem}-{digest}.so"


def build_all(sources=SOURCES) -> dict:
    """Compile every source not built yet, one ``nvcc`` each, all started
    together; returns ``{source: library path}``.  Raises if any fails."""
    started = {}
    for source in sources:
        out = _target(source)
        if out.is_file():
            continue
        BUILD_DIR.mkdir(exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / source)]
        started[source] = (out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for source, (out, tmp, proc) in started.items():
        log, _ = proc.communicate()
        if proc.returncode:
            failed.append(f"nvcc failed on {source} "
                          f"({proc.returncode}):\n{log}")
            continue
        build_log[source] = log
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    return {source: _target(source) for source in sources}


def build(source: str) -> Path:
    """Compile ``csrc/<source>`` (if not built yet) and return the library."""
    return build_all((source,))[source]


def _library(source: str, symbol: str, argtypes) -> ctypes.CDLL:
    """The library of ``source``, built and loaded once per process, with
    ``symbol``'s C signature declared."""
    with _lock:
        lib = _libs.get(source)
        if lib is None:
            lib = ctypes.CDLL(str(build(source)))
            fn = getattr(lib, symbol)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _libs[source] = lib
    return lib


def segment_probe_lib() -> ctypes.CDLL:
    """The segment-probe library, built and loaded once per process."""
    return _library("segment_probe.cu", "segment_probe_launch",
                    [ctypes.c_int] + [ctypes.c_void_p] * 8
                    + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 3
                    + [ctypes.c_int, ctypes.c_void_p])


def paged_attn_lib() -> ctypes.CDLL:
    """The paged-attention library, built and loaded once per process."""
    return _library("paged_attn.cu", "paged_attn_launch",
                    [ctypes.c_int] + [ctypes.c_void_p] * 7
                    + [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_void_p])


def scan_walk_lib() -> ctypes.CDLL:
    """The serial-walk library, built and loaded once per process."""
    return _library("scan_walk.cu", "scan_walk_launch",
                    [ctypes.c_int] + [ctypes.c_void_p] * 13
                    + [ctypes.c_int] * 6 + [ctypes.c_void_p] * 4)


MODE_PROBE, MODE_PROBE_FP, MODE_MUTATE = 0, 1, 2
PROBE_TILE = 32       # most queries per warp tile (csrc/segment_probe.cu)
PROBE_WARPS = 8       # warps per block (kWarps there)


def probe_grid(B: int, sms: int, resident: int, direct_resident: int) -> tuple:
    """``(blocks, tile)`` of the segment-probe launch for ``B`` queries on
    ``sms`` SMs, of which each holds ``resident`` blocks of the tiled kernel
    and ``direct_resident`` of the one-warp-per-query kernel.  A batch that
    one wave of one-warp-per-query blocks covers takes that kernel (tile
    0): its chain of memory trips is the shortest.  A larger one takes the
    smallest power-of-two tile (at most ``PROBE_TILE`` queries per warp)
    that one wave of tiled blocks covers, so each warp issues few row
    copies, and no more blocks than the tiles need."""
    if B <= direct_resident * sms * PROBE_WARPS:
        return max(1, -(-B // PROBE_WARPS)), 0
    per_warp = -(-B // (resident * sms * PROBE_WARPS))
    tile = min(PROBE_TILE, 1 << (per_warp - 1).bit_length())
    tiles = -(-B // tile)
    return max(1, min(resident * sms, -(-tiles // PROBE_WARPS))), tile


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


@functools.lru_cache(maxsize=None)
def probe_resident_blocks(index: int, mode: int, S: int, direct: bool) -> int:
    """Segment-probe blocks that one SM of CUDA device ``index`` holds at
    once for ``mode`` and ``S`` slots, of the tiled kernel or (``direct``)
    the one-warp-per-query kernel: the runtime's occupancy of the
    instantiation the launch picks, with its shared memory (asked once per
    process; a host call, no device sync)."""
    fn = segment_probe_lib().segment_probe_resident_blocks
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    blocks = ctypes.c_int(0)
    with torch.cuda.device(index):
        err = fn(mode, S, 0 if direct else PROBE_TILE, ctypes.byref(blocks))
    if err or blocks.value < 1:
        raise RuntimeError(f"segment_probe_resident_blocks failed: cudaError "
                           f"{err}, {blocks.value} blocks")
    return blocks.value


def probe_smem_bytes(S: int) -> int:
    """Dynamic shared memory of one block of the tiled segment-probe kernel
    (the one-warp-per-query kernel takes none)."""
    fn = segment_probe_lib().segment_probe_smem_bytes
    fn.argtypes = [ctypes.c_int]
    fn.restype = ctypes.c_int
    return fn(S)


def launch_segment_probe(mode: int, rows, indicators, fps, prio, pairs,
                         parity, qkeys, qfp, *, grid=None):
    """Check the operands and launch one segment-probe kernel on the
    current stream.  Returns ``(match, empty, flip)`` (flip None unless
    mutate).  ``grid`` None lets the host pick ``(blocks, tile)``
    (``probe_grid``; tile 0 is the one-warp-per-query kernel); tests pass
    another grid of the same kind, to run the tiled kernel on a small
    batch.  Reads nothing back from the device.  Raises on any operand it
    does not take or a failed launch."""
    dev = rows.device
    if dev.type != "cuda":
        raise ValueError(f"the CUDA kernel needs CUDA tensors, got {dev}")
    if rows.dim() != 2 or rows.shape[1] % 4:
        raise ValueError(f"rows must be (P, S*4), got {tuple(rows.shape)}")
    P, S = rows.shape[0], rows.shape[1] // 4
    B = qkeys.shape[0]
    if not 1 <= S <= 32:
        raise ValueError(f"two fp words carry the fields of at most 32 "
                         f"slots, got S = {S}")
    _need(rows, "rows", (P, 4 * S), dev)
    _need(indicators, "indicators", (P, 1), dev)
    _need(prio, "prio", (2, S), dev)
    _need(pairs, "pairs", (B,), dev)
    _need(parity, "parity", (B,), dev)
    _need(qkeys, "qkeys", (B, 4), dev)
    aligned = [("rows", rows, 16), ("qkeys", qkeys, 16)]
    if mode != MODE_PROBE:
        _need(fps, "fps", (P, 2), dev)
        _need(qfp, "qfp", (B,), dev)
        aligned.append(("fps", fps, 8))
    for name, t, align in aligned:
        if t.data_ptr() % align:
            raise ValueError(f"{name} must be {align}-byte aligned (the "
                             f"kernels read it {align} bytes at a time)")
    if grid is not None and not (
            grid[0] >= 1 and 0 <= grid[1] <= PROBE_TILE
            and grid[1] & (grid[1] - 1) == 0
            and (grid[1] or grid[0] * PROBE_WARPS >= B)):
        raise ValueError(f"grid must be (blocks >= 1, a power-of-two tile up "
                         f"to {PROBE_TILE}) or (blocks of {PROBE_WARPS} warps, "
                         f"one per query, 0), got {grid}")
    match = torch.empty(B, dtype=torch.int32, device=dev)
    empty = torch.empty(B, dtype=torch.int32, device=dev)
    flip = (torch.empty(B, dtype=torch.int32, device=dev)
            if mode == MODE_MUTATE else None)
    if B == 0:
        return match, empty, flip
    index = dev.index
    blocks, tile = grid or probe_grid(
        B, sm_count(index), probe_resident_blocks(index, mode, S, False),
        probe_resident_blocks(index, mode, S, True))
    lib = segment_probe_lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.segment_probe_launch(
            mode, rows.data_ptr(), indicators.data_ptr(),
            fps.data_ptr() if mode != MODE_PROBE else None,
            prio.data_ptr(), pairs.data_ptr(), parity.data_ptr(),
            qkeys.data_ptr(), qfp.data_ptr() if mode != MODE_PROBE else None,
            B, P, S, tile, match.data_ptr(), empty.data_ptr(),
            flip.data_ptr() if flip is not None else None, blocks, stream)
    if err:
        raise RuntimeError(f"segment_probe_launch failed: cudaError {err}")
    return match, empty, flip


PAGED_ATTN_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_SPLITS = 1024     # the merge kernel's limit (csrc/paged_attn.cu)


def paged_attn_splits(seq_heads: int, max_pages: int, sms: int,
                      resident: int) -> int:
    """Splits of each sequence's page range for ``seq_heads`` = B * KVH
    (sequence, kv head) pairs: as many as fill one wave of resident blocks
    (``resident`` on each of ``sms`` SMs; a second wave would pay every
    block's fixed start and merge again), at least one, at most one per
    page, and none left without a page."""
    want = resident * sms // max(seq_heads, 1)
    splits = max(1, min(max_pages, want))
    return -(-max_pages // -(-max_pages // splits))


def split_pages(max_pages: int, splits: int) -> list:
    """The logical page range ``[begin, end)`` of each split, as the kernel
    cuts them: ``ceil(max_pages / splits)`` pages each, in order; a split
    past the last page is empty."""
    per = -(-max_pages // splits)
    return [(min(s * per, max_pages), min((s + 1) * per, max_pages))
            for s in range(splits)]


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """The SM count of CUDA device ``index`` (read once per process)."""
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=None)
def resident_blocks(index: int, dtype: int, D: int) -> int:
    """Split-kernel blocks that one SM of CUDA device ``index`` holds at
    once for operands of ``dtype`` (a ``PAGED_ATTN_DTYPES`` code) and head
    dim ``D``: the runtime's occupancy of the instantiation the launch
    picks, with its registers and shared memory (asked once per process;
    a host call, no device sync)."""
    fn = paged_attn_lib().paged_attn_resident_blocks
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    blocks = ctypes.c_int(0)
    with torch.cuda.device(index):
        err = fn(dtype, D, ctypes.byref(blocks))
    if err or blocks.value < 1:
        raise RuntimeError(f"paged_attn_resident_blocks failed: cudaError "
                           f"{err}, {blocks.value} blocks")
    return blocks.value


def launch_paged_attn(q, kpool, vpool, page_table, seq_lens, scale: float,
                      splits: int = 0):
    """Check the operands and launch the paged-attention kernels (the split
    kernel and the merge) on the current stream; returns the (B, H, D)
    output in q's dtype.  ``splits`` 0 lets the host choose
    (``paged_attn_splits``); tests pass others.  Reads nothing back from
    the device.  Raises on any operand it does not take or a failed
    launch."""
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"the CUDA kernel needs CUDA tensors, got {dev}")
    if q.dtype not in PAGED_ATTN_DTYPES:
        raise ValueError(f"q must be float32 or bfloat16, got {q.dtype}")
    if q.dim() != 3 or kpool.dim() != 4:
        raise ValueError(f"q must be (B, H, D) and the pools (NP, KVH, PS, "
                         f"D), got {tuple(q.shape)} and {tuple(kpool.shape)}")
    B, H, D = q.shape
    NP, KVH, PS, Dk = kpool.shape
    MAXP = page_table.shape[-1]
    if Dk != D or H % KVH:
        raise ValueError(f"q {tuple(q.shape)} does not fit pools "
                         f"{tuple(kpool.shape)}")
    if D % 8 or D > 256:
        raise ValueError(f"head dim must be a multiple of 8 up to 256, got {D}")
    for name, t in (("q", q), ("kpool", kpool), ("vpool", vpool)):
        if t.device != dev or t.dtype != q.dtype:
            raise ValueError(f"{name} must be {q.dtype} on {dev}, got "
                             f"{t.dtype} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned (uint4 loads)")
    if tuple(vpool.shape) != tuple(kpool.shape):
        raise ValueError(f"vpool {tuple(vpool.shape)} differs from kpool "
                         f"{tuple(kpool.shape)}")
    _need(page_table, "page_table", (B, MAXP), dev)
    _need(seq_lens, "seq_lens", (B,), dev)
    if not 0 <= splits <= MAX_SPLITS:
        raise ValueError(f"splits must be 0 (host's choice) to {MAX_SPLITS}, "
                         f"got {splits}")
    if NP * KVH * PS >= 2 ** 31:
        raise ValueError(f"pools of {NP * KVH * PS} rows: the kernel indexes "
                         f"rows with 32-bit integers")
    out = torch.empty_like(q)
    if B == 0:
        return out
    if not splits:
        splits = paged_attn_splits(
            B * KVH, MAXP, sm_count(dev.index),
            resident_blocks(dev.index, PAGED_ATTN_DTYPES[q.dtype], D))
    workspace = torch.empty(B * H * splits * (D + 2), dtype=torch.float32,
                            device=dev)
    lib = paged_attn_lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.paged_attn_launch(
            PAGED_ATTN_DTYPES[q.dtype], q.data_ptr(), kpool.data_ptr(),
            vpool.data_ptr(), page_table.data_ptr(), seq_lens.data_ptr(),
            out.data_ptr(), workspace.data_ptr(), B, H, KVH, D, NP, PS, MAXP,
            splits, float(scale), stream)
    if err:
        raise RuntimeError(f"paged_attn_launch failed: cudaError {err}")
    return out


SCAN_WALK_MODES = {("level", "insert"): 0, ("level", "update"): 1,
                   ("level", "delete"): 2, ("pfarm", "insert"): 3,
                   ("pfarm", "update"): 4, ("pfarm", "delete"): 5}


def _need_dtype(t: torch.Tensor, name: str, dtype, device) -> None:
    if t.device != device or t.dtype != dtype or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous {dtype} tensor on "
                         f"{device}, got {t.dtype} on {t.device}")


def launch_scan_walk(scheme: str, op: str, cfg, table, keys, vals, active):
    """Check the operands and launch the serial walk (prologue + one-warp
    walk) on the current stream; the table updates in place.  Returns
    ``(ok, pm)``, each (B,) int32.  Reads nothing back from the device.
    Raises on any operand it does not take or a failed launch."""
    dev = keys.device
    if dev.type != "cuda":
        raise ValueError(f"the CUDA kernel needs CUDA tensors, got {dev}")
    mode = SCAN_WALK_MODES[(scheme, op)]
    B = keys.shape[0]
    bs = cfg.bucket_slots
    if scheme == "level":
        a = (table.tkeys, table.tvals, table.ttok)
        b = (table.bkeys, table.bvals, table.btok)
        n_a, n_b, window, max_chain = cfg.num_top, cfg.num_bottom, 0, 0
        chain = (None, None, None)
        if 4 * bs > 32:
            raise ValueError(f"4 candidate buckets x {bs} slots exceed a warp")
    else:
        a = (table.keys, table.vals, table.tok)
        b = (table.okeys, table.ovals, table.otok)
        n_a, n_b = cfg.num_buckets, cfg.pool_blocks
        window, max_chain = cfg.window, cfg.max_chain
        chain = (table.head, table.onext, table.ocount)
        for name, t in zip(("head", "onext", "ocount"), chain):
            _need_dtype(t, name, torch.int32, dev)
        if window * bs > 32:
            raise ValueError(f"a window of {window} x {bs} slots exceeds a "
                             f"warp")
    if not (1 <= bs <= 8) or n_a >= 2 ** 31 or n_b >= 2 ** 31:
        raise ValueError(f"unsupported geometry: {cfg}")
    for name, (n, t) in zip(("keys_a", "vals_a", "keys_b", "vals_b"),
                            ((n_a, a[0]), (n_a, a[1]), (n_b, b[0]),
                             (n_b, b[1]))):
        _need(t, name, (n, bs, 4), dev)
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    _need_dtype(a[2], "tok_a", torch.uint8, dev)
    _need_dtype(b[2], "tok_b", torch.uint8, dev)
    _need_dtype(table.count, "count", torch.int32, dev)
    _need(keys, "keys", (B, 4), dev)
    if (op == "delete") != (vals is None):
        raise ValueError("vals go with insert and update only")
    if vals is not None:
        _need(vals, "vals", (B, 4), dev)
    _need_dtype(active, "active", torch.bool, dev)
    for name, t in (("keys", keys), ("vals", vals)):
        if t is not None and t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    ok = torch.empty(B, dtype=torch.int32, device=dev)
    pm = torch.empty(B, dtype=torch.int32, device=dev)
    if B == 0:
        return ok, pm
    cand = torch.empty(B * (4 if scheme == "level" else 1), dtype=torch.int32,
                       device=dev)
    lib = scan_walk_lib()

    def ptr(t):
        return None if t is None else t.data_ptr()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.scan_walk_launch(
            mode, *(ptr(t) for t in a + b + chain), table.count.data_ptr(),
            keys.data_ptr(), ptr(vals), active.data_ptr(), B, n_a, n_b, bs,
            window, max_chain, cand.data_ptr(), ok.data_ptr(), pm.data_ptr(),
            stream)
    if err:
        raise RuntimeError(f"scan_walk_launch failed: cudaError {err}")
    return ok, pm


def launch_scan_walk_hash(keys: torch.Tensor):
    """The serial walk's device ``hash128`` and ``hash128_2`` of (B, 4) key
    words, as two (B,) int32 tensors holding the uint32 bits."""
    dev = keys.device
    if dev.type != "cuda":
        raise ValueError(f"the CUDA kernel needs CUDA tensors, got {dev}")
    B = keys.shape[0]
    _need(keys, "keys", (B, 4), dev)
    if keys.data_ptr() % 16:
        raise ValueError("keys must be 16-byte aligned")
    h1 = torch.empty(B, dtype=torch.int32, device=dev)
    h2 = torch.empty(B, dtype=torch.int32, device=dev)
    fn = scan_walk_lib().scan_walk_hash_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 3
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        err = fn(keys.data_ptr(), B, h1.data_ptr(), h2.data_ptr(),
                 torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"scan_walk_hash_launch failed: cudaError {err}")
    return h1, h2


def launch_scan_walk_chase(data: torch.Tensor, elem: int, steps: int,
                           seed: int) -> torch.Tensor:
    """The serial walk's latency chase over the contiguous uint8 ``data``
    (``scan_walk.chase``); returns the final state as a (1,) int32 tensor
    holding its uint32 bits.  Reads nothing back from the device."""
    dev = data.device
    if dev.type != "cuda":
        raise ValueError(f"the CUDA kernel needs CUDA tensors, got {dev}")
    _need_dtype(data, "data", torch.uint8, dev)
    if data.dim() != 1 or not (1 <= elem <= data.shape[0]) or steps < 0:
        raise ValueError(f"chase takes a 1-d array of at least one element "
                         f"of {elem} bytes and steps >= 0")
    out = torch.empty(1, dtype=torch.int32, device=dev)
    fn = scan_walk_lib().scan_walk_chase_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                   ctypes.c_int, ctypes.c_uint, ctypes.c_void_p,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(dev):
        err = fn(data.data_ptr(), data.shape[0], elem, steps,
                 seed & 0xFFFFFFFF, out.data_ptr(),
                 torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"scan_walk_chase_launch failed: cudaError {err}")
    return out
