"""The paged-attention kernel's four routes at Yi-6B's decode shape, by
split count, on one card.

    python3 tools/attention_modes.py

Builds the attention kernel, then times each route at Yi-6B's last decode
step of ``chip_smoke.py`` phase 4 (B 32, H 32, KVH 4, D 128, page size
16, 2,111 tokens of 132 pages) with ``chip_smoke._device_ms``, at the
host's split count (0) and at 1, 2, 3, 4, 8 and 16 splits:

- ``bf16``: bf16 q and pools (tensor cores);
- ``int8``: bf16 q over ``quant_store``'d pools (the bf16 kernel's ring
  and tensor cores, rows widened in shared memory), with its output held
  bit-equal to the bf16 mode's on the plain version's dequantized pools
  at every split count timed;
- ``float32``: float32 q and pools (the CUDA-core loop);
- ``int8_f32``: float32 q over the int8 pools (the CUDA-core loop).

Each route is held against its plain version at the host's count first
(float32 q 2e-5, bf16 q within ``chip_smoke._attn_limit``).  Prints one
JSON line per route: {"mode", "splits", "max_abs_err", "bound_us",
"us": {splits: µs}} (and for int8 "bit_equal_bf16": {splits: bool}).

Then the page-token slice mode of the two tensor-core routes (``bf16``,
``int8``) at m = 2 and 4 slices of each page (``chip_smoke._slices``):
slice 0's launch timed at the host's split count (0) and at each of
``SLICE_SPLITS``, one JSON line per route and m: {"mode", "slices",
"splits", "us": {splits: µs}}.

Last, whole pages of bf16 through the slice mode's instantiation (its
2-tile ring and three blocks per SM): the slice launch over the whole
pools as slice 0 of pages of 2 * PS tokens, each length stretched so that
the same rows are live, and the merge.  At 2 splits (the whole-page
launch's host count) and 3 (a wave of three blocks per SM) its output is
held bit-equal to the whole-page launch's at the same count, and both are
timed in the order whole, slice ring, slice ring, whole: one JSON line
{"mode": "bf16_whole_pages_on_the_slice_ring", "splits", "bit_equal",
"us": {"whole": {splits: µs}, "slice_ring": {splits: µs}}}.
"""

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

SPLITS = (0, 1, 2, 3, 4, 8, 16)
SLICE_SPLITS = (0, 1, 2, 3, 4, 6, 8)


def main() -> int:
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import _cuda
    from repro_torch.kernels.paged_attn_ref import dequant, paged_attention_ref
    if not torch.cuda.is_available():
        print("attention_modes: no CUDA device is available", file=sys.stderr)
        return 2
    _cuda.build_all(("paged_attn.cu",))
    B, H, KVH, D, PS, last = 32, 32, 4, 128, cs.PAGE_SIZE, 2111
    MAXP = -(-(cs.PROMPT_LEN + cs.GEN) // PS)
    bf16 = [cs._attn_case(torch, 40 + i, B, H, KVH, D, PS, MAXP,
                          NP=B * MAXP, lens=[last] * B,
                          dtype=torch.bfloat16, q_scale=4.0)
            for i in range(4)]

    def widened(a):
        return tuple(t.float() if t.dtype == torch.bfloat16 else t
                     for t in a), {}

    def f32_q(a):
        args, kw = a
        return (args[0].float(), *args[1:]), kw
    int8 = [cs._quantized(a) for a in bf16]
    modes = {"bf16": ([(a, {}) for a in bf16], "bf16"),
             "int8": (int8, "int8"),
             "float32": ([widened(a) for a in bf16[:2]], "float32"),
             "int8_f32": ([f32_q(a) for a in int8], "int8")}
    scale = 1.0 / D ** 0.5
    index = torch.cuda.current_device()
    for mode, (batches, kind) in modes.items():
        args, kw = batches[0]
        q = args[0]
        code = (_cuda.PAGED_ATTN_INT8 if kw else _cuda.PAGED_ATTN_DTYPES)[
            q.dtype]
        host = _cuda.paged_attn_splits(
            B * KVH, MAXP, _cuda.sm_count(index),
            _cuda.resident_blocks(index, code, D, H // KVH))
        got = _cuda.launch_paged_attn(*args, scale, **kw).float()
        want = paged_attention_ref(*args, **kw).float()
        limit = 2e-5 if q.dtype == torch.float32 else cs._attn_limit(want)
        err = float((got - want).abs().max())
        cs._check(err <= limit, f"{mode} route within {limit:.3g} of its "
                  f"plain version ({err})")
        line = {"mode": mode, "splits": host, "max_abs_err": err}
        if mode == "int8":            # bit for bit against the bf16 mode
            deq = (dequant(args[1], kw["kscale"], torch.bfloat16),
                   dequant(args[2], kw["vscale"], torch.bfloat16))
            line["bit_equal_bf16"] = {
                sp: torch.equal(
                    _cuda.launch_paged_attn(*args, scale, splits=sp or host,
                                            **kw),
                    _cuda.launch_paged_attn(args[0], *deq, *args[3:], scale,
                                            splits=sp or host))
                for sp in SPLITS}
            cs._check(all(line["bit_equal_bf16"].values()), "the int8 route "
                      "equals the bf16 mode on the dequantized pools")
            del deq
        us = {}
        for sp in SPLITS:
            us[sp] = 1e3 * cs._device_ms(
                torch, lambda a, sp=sp: _cuda.launch_paged_attn(
                    *a[0], scale, splits=sp, **a[1]),
                batches, 50, cs.KERNEL_SLEEP)
        nbytes = cs._attn_bytes(kind, B, H, KVH, D, MAXP, last)
        if mode == "int8_f32":       # float32 q and out
            nbytes += 2 * B * H * D * 2
        line.update(bound_us=nbytes / cs.HBM_BYTES_PER_S * 1e6, us=us)
        print(json.dumps(line), flush=True)
        del batches, args, kw
        modes[mode] = None
        torch.cuda.empty_cache()
    slices = {"bf16": [(a, {}) for a in bf16], "int8": int8}
    for mode, batches in slices.items():
        for m in (2, 4):
            sliced = [cs._slices(torch, a, kw, m)[0] for a, kw in batches]
            host = _cuda.launch_paged_attn_slice(
                *sliced[0][0], scale, PS, 0, **sliced[0][1])[0].shape[2]
            us = {sp: 1e3 * cs._device_ms(
                torch, lambda sl, sp=sp: _cuda.launch_paged_attn_slice(
                    *sl[0], scale, PS, sl[2], splits=sp, **sl[1]),
                sliced, 50, cs.KERNEL_SLEEP) for sp in SLICE_SPLITS}
            print(json.dumps({"mode": mode, "slices": m, "splits": host,
                              "us": us}), flush=True)
            del sliced
        torch.cuda.empty_cache()
    stretched = [(q, kp, vp, pt, lens // PS * 2 * PS + lens % PS)
                 for q, kp, vp, pt, lens in bf16]

    def on_ring(a, sp):
        acc, ml = _cuda.launch_paged_attn_slice(*a, scale, 2 * PS, 0,
                                                splits=sp)
        return _cuda.launch_paged_attn_merge(acc, ml, torch.bfloat16)
    host = _cuda.launch_paged_attn_slice(*stretched[0], scale, 2 * PS,
                                         0)[0].shape[2]
    line = {"mode": "bf16_whole_pages_on_the_slice_ring", "splits": host,
            "bit_equal": {}, "us": {"whole": {}, "slice_ring": {}}}
    for sp in (2, 3):
        line["bit_equal"][sp] = torch.equal(
            on_ring(stretched[0], sp),
            _cuda.launch_paged_attn(*bf16[0], scale, splits=sp))
        fns = {"whole": (lambda a, sp=sp: _cuda.launch_paged_attn(
                   *a, scale, splits=sp), bf16),
               "slice_ring": (lambda a, sp=sp: on_ring(a, sp), stretched)}
        t = {k: [] for k in fns}
        for k in ("whole", "slice_ring", "slice_ring", "whole"):
            t[k].append(1e3 * cs._device_ms(torch, fns[k][0], fns[k][1], 50,
                                            cs.KERNEL_SLEEP))
        for k, v in t.items():
            line["us"][k][sp] = sum(v) / len(v)
    cs._check(all(line["bit_equal"].values()), "whole pages through the "
              "slice instantiation equal the whole-page launch")
    print(json.dumps(line), flush=True)
    print(cs._smi())
    return 0


if __name__ == "__main__":
    sys.exit(main())
