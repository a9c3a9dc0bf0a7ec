"""The attention kernel's whole-page routes against another build of
``csrc/paged_attn.cu``, on one card.

    python3 tools/attention_ab.py OTHER.cu

Builds ``OTHER.cu`` (another commit's ``paged_attn.cu``, say, unpacked
with ``git archive``) with the port's ``nvcc`` flags into
``_build/other/``, beside the port's own build.  Then, at Yi-6B's B 32
decode shape (``chip_smoke.py`` phase 4's: H 32, KVH 4, D 128, pages of
16, 2,111 tokens of 132 pages), it launches each whole-page route through
both builds at the port's host split count:

- ``bf16``: bf16 q and pools;
- ``int8``: bf16 q over ``quant_store``'d pools;
- ``float32``: float32 q and pools;
- ``int8_f32``: float32 q over the int8 pools.

The two builds' outputs are held equal bit for bit, and each build is
timed with ``chip_smoke._device_ms`` in the order port, other, other,
port.  Prints one JSON line per route: {"mode", "splits", "bit_equal",
"us": {"port", "other"}} (each the mean of its two timings), then the
card's name and power limit.
"""

import ctypes
import hashlib
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))


def main() -> int:
    import torch
    import chip_smoke as cs
    from attention_breakdown import using
    from repro_torch.kernels import _cuda
    if not torch.cuda.is_available() or len(sys.argv) != 2:
        print("attention_ab: needs a CUDA device and the other paged_attn.cu",
              file=sys.stderr)
        return 2
    src = Path(sys.argv[1]).resolve()
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    out = _cuda.BUILD_DIR / "other" / f"paged_attn-{digest}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    proc = subprocess.Popen([_cuda.nvcc_path(), *_cuda.NVCC_FLAGS, "-o",
                             str(out), str(src)], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    _cuda.build_all(("paged_attn.cu",))
    log, _ = proc.communicate()
    cs._check(proc.returncode == 0, f"nvcc built {src}:\n{log}")
    other = ctypes.CDLL(str(out))

    B, H, KVH, D, PS, last = cs.SERVE_B, 32, 4, 128, cs.PAGE_SIZE, 2111
    MAXP = -(-(cs.PROMPT_LEN + cs.GEN) // PS)
    bf16 = [(cs._attn_case(torch, 60 + i, B, H, KVH, D, PS, MAXP,
                           NP=B * MAXP, lens=[last] * B,
                           dtype=torch.bfloat16, q_scale=4.0), {})
            for i in range(4)]
    int8 = [cs._quantized(a) for a, _ in bf16]

    def f32_q(a):
        args, kw = a
        return tuple(t.float() if t.dtype == torch.bfloat16 else t
                     for t in args), kw
    routes = {"bf16": bf16, "int8": int8, "float32": [f32_q(a) for a in bf16],
              "int8_f32": [f32_q(a) for a in int8]}
    scale = 1.0 / D ** 0.5
    index = torch.cuda.current_device()
    for mode, batches in routes.items():
        args, kw = batches[0]
        code = (_cuda.PAGED_ATTN_INT8 if kw else _cuda.PAGED_ATTN_DTYPES)[
            args[0].dtype]
        splits = _cuda.paged_attn_splits(
            B * KVH, MAXP, _cuda.sm_count(index),
            _cuda.resident_blocks(index, code, D, H // KVH))

        def port(a):
            return _cuda.launch_paged_attn(*a[0], scale, splits=splits,
                                           **a[1])

        def theirs(a):
            with using(other):
                return port(a)
        same = torch.equal(port(batches[0]), theirs(batches[0]))
        t = {"port": [], "other": []}
        for name in ("port", "other", "other", "port"):
            fn = port if name == "port" else theirs
            t[name].append(1e3 * cs._device_ms(torch, fn, batches, 50,
                                               cs.KERNEL_SLEEP))
        print(json.dumps({"mode": mode, "splits": splits, "bit_equal": same,
                          "us": {k: sum(v) / len(v) for k, v in t.items()}}),
              flush=True)
        routes[mode] = None
    print(cs._smi())
    return 0


if __name__ == "__main__":
    sys.exit(main())
