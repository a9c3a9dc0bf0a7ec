"""Phase 6b of ``chip_smoke.py`` alone, on one card.

    python3 tools/families_phase.py

Builds the kernels, then runs ``chip_smoke.families_phase``: granite-moe-
3b-a800m served at full width, mamba2-370m and hymba-1.5b at full width
(recurrent decode held against the forward), and the ten smoke twins,
whose CPU runs are computed here in this process instead of the smoke's
twins process.  Prints the phase's lines, then one JSON line of the moe
path's launches, the attention kernel's timing at granite's decode shape
and the phase's seconds.
"""

import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


class _CpuTwins:
    """The twins' CPU runs, computed on demand in this process."""

    def get(self, phase, name):
        import chip_smoke
        return chip_smoke._family_twin(name, "cpu"), 0.0


def main() -> int:
    import torch
    import chip_smoke
    from repro_torch.kernels import _cuda
    if not torch.cuda.is_available():
        print("families_phase: no CUDA device is available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = chip_smoke._smi()
    print(f"card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}", flush=True)
    _cuda.build_all()
    t0 = time.perf_counter()
    launches, timing = chip_smoke.families_phase(torch, card, _CpuTwins())
    print(json.dumps({"moe_launches": launches, "moe_shape_attention": dict(
        zip(("max_abs_err", "ms", "plain_ms", "bound_ms", "library_ms"),
            timing)), "seconds": time.perf_counter() - t0}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
