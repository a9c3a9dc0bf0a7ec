"""The paged-attention kernel's page-token slice mode broken down by phase,
on one card.

    python3 tools/attention_breakdown.py [--raw DIR]

Builds ``csrc/paged_attn.cu`` with ``PAGED_ATTN_STAMPS`` defined into a
build directory of its own (``_cuda.ATTN_STAMPS``; the library the port
loads is built without it), then launches the tensor-core split kernel's
slice mode on ``chip_smoke.py`` phase 4's inputs at Yi-6B's B 32 decode
shape (H 32, KVH 4, D 128, pages of 16, 2,111 tokens of 132 pages): bf16
pools and int8 pools under bf16 q, each page's tokens cut into m = 1, 2
and 4 slices, slice 0's launch at the host's split count.  Each block
records ``%globaltimer`` and ``%clock64`` at five points: its start; the
length, q and first page ids loaded and the first tiles issued; warp 0's
first tile landed; every warp's tile loop done; warps merged and partials
written (and the warps' states in shared memory, and each warp's own loop
end).  ``--raw DIR`` also writes each case's stamps, (blocks, words)
int64, to ``DIR/stamps_<route>_m<m>.npy``.  Prints one JSON line per case:

- ``device_us``: the launch's device time (``chip_smoke._device_ms``), of
  the port's build and of the stamped one;
- ``span_us``: the last block's end less the first block's start
  (globaltimer), ``outside_us`` what the device time holds beyond it
  (launch and drain); ``gaps_us``: from a one-thread kernel's globaltimer
  just before the launch to its first block's start (this holds the
  host's enqueue of the launch: the clock kernel runs at once), and from
  its last block's end to another's just after (device time);
- ``starts_us`` / ``ends_us``: block starts and ends after the first start
  (min, median, max);
- ``phases_us``: the median block's time in each phase (clock64, at the
  cycles per ns the blocks' own globaltimer spans give): ``setup``,
  ``first_tile``, ``loop``, ``merge`` (``merge_smem``: the warps' states
  into shared memory; ``merge_out``: combined and written);
  ``warp_skew_us``: the median spread
  of the warps' loop ends in a block; ``tiles``: warp 0's tiles (median,
  max);

then a headline per route.  ``chip_smoke.py`` phase 4 prints the
headlines through ``run``.
"""

import contextlib
import ctypes
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

SLICE_COUNTS = (1, 2, 4)


def _stamped_lib():
    from repro_torch.kernels import _cuda
    path = _cuda.build_all((), variants=(_cuda.ATTN_STAMPS,))[
        _cuda.ATTN_STAMPS]
    lib = ctypes.CDLL(str(path))
    lib.paged_attn_set_stamps.argtypes = [ctypes.c_void_p]
    lib.paged_attn_set_stamps.restype = ctypes.c_int
    lib.paged_attn_stamp_words.argtypes = []
    lib.paged_attn_stamp_words.restype = ctypes.c_int
    lib.paged_attn_stamp_clock.argtypes = [ctypes.c_void_p] * 2
    lib.paged_attn_stamp_clock.restype = ctypes.c_int
    return lib


@contextlib.contextmanager
def using(lib):
    """Inside the block the port's attention wrappers launch through
    ``lib``, another build of ``csrc/paged_attn.cu`` with the same C
    interface (the stamped one, or another checkout's)."""
    from repro_torch.kernels import _cuda
    port = _cuda.paged_attn_lib()
    lib.paged_attn_launch.argtypes = port.paged_attn_launch.argtypes
    lib.paged_attn_launch.restype = ctypes.c_int
    _cuda._libs["paged_attn.cu"] = lib
    try:
        yield
    finally:
        _cuda._libs["paged_attn.cu"] = port


def _stats(xs) -> list:
    xs = sorted(xs)
    return [xs[0], xs[len(xs) // 2], xs[-1]]


def _summarise(st, points) -> dict:
    """The per-block stamps ``st`` (blocks, words) int64 on the host."""
    import numpy as np
    gt = st[:, 0:2 * points:2].astype(np.float64)
    ck = st[:, 1:2 * points:2].astype(np.float64)
    done = st[:, 2 * 4] > 0                 # every block stamps its end
    full = done & (st[:, 2 * 3] > 0)        # ... and live ones their loop
    start0 = gt[:, 0].min()
    ends = gt[:, 4]
    span = (ends.max() - start0) / 1e3
    # cycles per ns from the blocks' own spans (globaltimer may tick in µs)
    spans = gt[full, 4] - gt[full, 0]
    cyc = ck[full, 4] - ck[full, 0]
    per_ns = cyc.sum() / max(spans.sum(), 1.0)

    def us(a, b):
        return round(float(np.median(ck[full, b] - ck[full, a]))
                     / per_ns / 1e3, 3)
    warp_ends = ck[full, 6:points]
    skew = (warp_ends.max(1) - warp_ends.min(1)) / per_ns / 1e3
    diffs = np.diff(np.unique(gt[gt > 0]))
    tiles = st[full, 2 * points + 1]
    return {
        "blocks": int(len(st)), "empty_blocks": int((done & ~full).sum()),
        "sms": int(len(set(st[:, 2 * points].tolist()))),
        "span_us": round(span, 3),
        "starts_us": [round((x - start0) / 1e3, 3)
                      for x in _stats(gt[:, 0])],
        "ends_us": [round((x - start0) / 1e3, 3) for x in _stats(ends)],
        "phases_us": {"setup": us(0, 1), "first_tile": us(1, 2),
                      "loop": us(2, 3), "merge": us(3, 4),
                      "merge_smem": us(3, 5), "merge_out": us(5, 4)},
        "warp_skew_us": round(float(np.median(skew)), 3),
        "tiles": [int(np.median(tiles)), int(tiles.max())],
        "cycles_per_ns": round(float(per_ns), 4),
        "globaltimer_tick_ns": float(diffs.min()) if len(diffs) else None,
    }


def run(torch, cs, seed=60, raw=None, iters=50) -> list:
    """The breakdown of every case; ``cs`` is the ``chip_smoke`` module
    (its inputs, slicing and device timing).  Returns one dict per case;
    ``raw``: a directory to write each case's stamps to (``.npy``);
    ``iters``: timed launches per device time."""
    import numpy as np
    from repro_torch.kernels import _cuda
    lib = _stamped_lib()
    words = lib.paged_attn_stamp_words()
    points = (words - 2) // 2
    H, KVH, D, PS = 32, 4, 128, cs.PAGE_SIZE
    B, MAXP = cs.SERVE_B, -(-(cs.PROMPT_LEN + cs.GEN) // PS)
    last = cs.PROMPT_LEN + cs.GEN - 1
    bf16 = [cs._attn_case(torch, seed + i, B, H, KVH, D, PS, MAXP,
                          NP=B * MAXP, lens=[last] * B, dtype=torch.bfloat16,
                          q_scale=4.0) for i in range(2)]
    routes = {"bf16": [(a, {}) for a in bf16],
              "int8": [cs._quantized(a) for a in bf16]}
    scale = 1.0 / D ** 0.5
    rows = []
    for mode, batches in routes.items():
        for m in SLICE_COUNTS:
            sliced = [cs._slices(torch, a, kw, m)[0] for a, kw in batches]

            def launch(sl):
                args, kw, off = sl
                return _cuda.launch_paged_attn_slice(
                    *args, scale, PS, off, **kw)

            def stamped(sl):
                with using(lib):
                    return launch(sl)
            acc, ml = launch(sliced[0])
            sacc, sml = stamped(sliced[0])
            cs._check(torch.equal(acc, sacc) and torch.equal(ml, sml),
                      f"{mode}, m = {m}: the stamped build computes the "
                      f"port's partials bit for bit")
            splits = acc.shape[2]
            blocks = B * KVH * splits * -(-(H // KVH) // 16)
            buf = torch.zeros(blocks * words, dtype=torch.int64,
                              device="cuda")
            torch.cuda.synchronize()
            clock = torch.zeros(2, dtype=torch.int64, device="cuda")
            stream = torch.cuda.current_stream().cuda_stream
            cs._check(lib.paged_attn_set_stamps(buf.data_ptr()) == 0,
                      "the stamp buffer is set")
            lib.paged_attn_stamp_clock(clock.data_ptr(), stream)
            stamped(sliced[1])          # the other batch: a cold L2
            lib.paged_attn_stamp_clock(clock.data_ptr() + 8, stream)
            torch.cuda.synchronize()
            cs._check(lib.paged_attn_set_stamps(None) == 0,
                      "the stamp buffer is cleared")
            st = buf.view(blocks, words).cpu().numpy().astype(np.int64)
            if raw is not None:
                Path(raw).mkdir(parents=True, exist_ok=True)
                np.save(Path(raw) / f"stamps_{mode}_m{m}.npy", st)
            row = {"mode": mode, "slices": m, "rows_per_page": PS // m,
                   "splits": splits}
            row["device_us"] = {
                "port": round(1e3 * cs._device_ms(
                    torch, launch, sliced, iters, cs.KERNEL_SLEEP), 3),
                "stamped": round(1e3 * cs._device_ms(
                    torch, stamped, sliced, iters, cs.KERNEL_SLEEP), 3)}
            row.update(_summarise(st, points))
            pre, post = clock.tolist()
            row["gaps_us"] = [round((int(st[:, 0].min()) - pre) / 1e3, 3),
                              round((post - int(st[:, 8].max())) / 1e3, 3)]
            row["outside_us"] = round(row["device_us"]["stamped"]
                                      - row["span_us"], 3)
            rows.append(row)
            del sliced, acc, ml, sacc, sml, buf
    del bf16, routes
    torch.cuda.empty_cache()
    return rows


def headline(rows) -> list:
    """One line per route: where each slice count's device time goes."""
    out = []
    for mode in dict.fromkeys(r["mode"] for r in rows):
        parts = []
        for r in (r for r in rows if r["mode"] == mode):
            p = r["phases_us"]
            parts.append(
                f"m={r['slices']} ({r['splits']} splits): "
                f"{r['device_us']['port']:.2f} us = "
                f"{r['outside_us']:.2f} outside the blocks + span "
                f"{r['span_us']:.2f} (starts over {r['starts_us'][2]:.2f}; "
                f"median block: setup {p['setup']:.2f}, first tile "
                f"{p['first_tile']:.2f}, loop {p['loop']:.2f} for "
                f"{r['tiles'][0]}-{r['tiles'][1]} tiles, merge "
                f"{p['merge']:.2f}; ends over {r['ends_us'][0]:.2f}-"
                f"{r['ends_us'][2]:.2f})")
        out.append(f"breakdown, {mode} slice mode: " + "; ".join(parts))
    return out


def main() -> int:
    import torch
    import chip_smoke as cs
    if not torch.cuda.is_available():
        print("attention_breakdown: no CUDA device is available",
              file=sys.stderr)
        return 2
    from repro_torch.kernels import _cuda
    _cuda.build_all(("paged_attn.cu",), variants=(_cuda.ATTN_STAMPS,))
    raw = sys.argv[sys.argv.index("--raw") + 1] if "--raw" in sys.argv \
        else None
    rows = run(torch, cs, raw=raw)
    for r in rows:
        print(json.dumps(r), flush=True)
    for line in headline(rows):
        print(line)
    print(cs._smi())
    return 0


if __name__ == "__main__":
    sys.exit(main())
