"""The paged-attention kernel's three modes at Yi-6B's decode shape, by
split count, on one card.

    python3 tools/attention_modes.py

Builds the attention kernel, then times the bf16 mode, the float32 mode
and the int8 mode (bf16 q over ``quant_store``'d pools) at Yi-6B's last
decode step of ``chip_smoke.py`` phase 4 (B 32, H 32, KVH 4, D 128, page
size 16, 2,111 tokens of 132 pages) with ``chip_smoke._device_ms``: at
the host's split count (0) and at 1, 2, 3, 4, 8 and 16 splits.  Each mode
is held against its plain version at the host's count first (float32
2e-5, bf16 and int8 within ``chip_smoke._attn_limit``).  Prints one JSON
line per mode: {"mode", "bound_us", "us": {splits: µs}}.
"""

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

SPLITS = (0, 1, 2, 3, 4, 8, 16)


def main() -> int:
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import _cuda
    from repro_torch.kernels.paged_attn_ref import paged_attention_ref
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
    modes = {"bf16": [(a, {}) for a in bf16],
             "float32": [widened(a) for a in bf16[:2]],
             "int8": [cs._quantized(a) for a in bf16]}
    scale = 1.0 / D ** 0.5
    for mode, batches in modes.items():
        args, kw = batches[0]
        got = _cuda.launch_paged_attn(*args, scale, **kw).float()
        want = paged_attention_ref(*args, **kw).float()
        limit = 2e-5 if mode == "float32" else cs._attn_limit(want)
        err = float((got - want).abs().max())
        cs._check(err <= limit, f"{mode} mode within {limit:.3g} of its plain "
                  f"version ({err})")
        us = {}
        for sp in SPLITS:
            us[sp] = 1e3 * cs._device_ms(
                torch, lambda a, sp=sp: _cuda.launch_paged_attn(
                    *a[0], scale, splits=sp, **a[1]),
                batches, 50, cs.KERNEL_SLEEP)
        nbytes = cs._attn_bytes(mode, B, H, KVH, D, MAXP, last)
        print(json.dumps({"mode": mode, "max_abs_err": err,
                          "bound_us": nbytes / cs.HBM_BYTES_PER_S * 1e6,
                          "us": us}), flush=True)
        del batches, args, kw
        modes[mode] = None
        torch.cuda.empty_cache()
    print(cs._smi())
    return 0


if __name__ == "__main__":
    sys.exit(main())
