"""Phase 7b of ``chip_smoke.py`` alone, on one card.

    python3 tools/multidevice_phase.py

Builds the kernels, makes what phase 5 records for (c) (Yi-6B served
unsharded at full width: the prefill and 2 greedy steps,
``chip_smoke.dist_serve_record``), then runs
``chip_smoke.multidevice_phase``: a world-1 NCCL group in this process,
(a) the sharded continuity store at the reference's service size (2^22
buckets, load factor 0.6 through ``make_write``, every key read back,
the unsharded store's found set and values equal, the routed walk's
mixed batch against its plain version on a host copy), (b) Yi-6B's
8-layer cut trained 2 steps on a (1, 1) mesh against the same steps
unsharded, (c) Yi-6B's paged serving on a (1, 1) mesh (the slice mode of
the attention kernel) equal to the unsharded run bit for bit.  Prints
the phase's lines, then one JSON line of the routed walk's record, the
phase's kernel launches and its seconds.
"""

import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))


def main() -> int:
    import torch
    import chip_smoke
    from repro_torch.kernels import _cuda
    if not torch.cuda.is_available():
        print("multidevice_phase: no CUDA device is available",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = chip_smoke._smi()
    print(f"card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}", flush=True)
    _cuda.build_all()
    record = chip_smoke.dist_serve_record(torch)
    t0 = time.perf_counter()
    routed, launches = chip_smoke.multidevice_phase(torch, card, record)
    print(json.dumps({"routed": routed, "dist_launches": launches,
                      "seconds": time.perf_counter() - t0}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
