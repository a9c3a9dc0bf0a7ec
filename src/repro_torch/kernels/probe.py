"""Segment-probe kernel: the client read's one-contiguous-row probe.

Replaces the TPU kernel ``src/repro/kernels/probe.py`` ``probe_segments``
(``_probe_kernel`` and ``_probe_kernel_fp``) with the CUDA kernel in
``csrc/segment_probe.cu`` (modes 0 and 1).

Bound: device-memory bytes — per query one random 16*S-byte key row plus
the pair's indicator and fp words, its key, pair, parity and fingerprint,
and 8 bytes out (about 368 B at S = 20).  Design: a batch that one wave
of one-warp-per-query blocks covers takes one warp per query (lanes over
the slots, the shortest chain of memory trips); a larger one takes one
wave of persistent warps, each walking tiles of up to 32 queries (one per
lane), each lane copying its query's row with one TMA bulk copy into
shared memory and resolving the rank argmins from bit masks there; see
the source for the details.

On a CPU tensor the wrapper runs the plain version (``probe_ref``); on a
CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

from repro_torch.kernels import _cuda
from repro_torch.kernels.probe_ref import probe_ref


def probe_segments(rows, indicators, prio, pairs, parity, qkeys,
                   fps=None, qfp=None):
    """Probe one contiguous segment row per query.

    Args mirror ``probe_ref.probe_ref`` (int32 words throughout; ``pairs``,
    ``parity`` and ``qfp`` int32 on the card); ``fps``/``qfp`` (both or
    neither) enable the fingerprint pre-filter.  Returns (match_slot,
    empty_slot), each (B,) int32 with -1 for miss/full.
    """
    if (fps is None) != (qfp is None):
        raise ValueError("fps and qfp go together")
    if rows.device.type == "cpu":
        return probe_ref(rows, indicators, prio, pairs, parity, qkeys,
                         fps, qfp)
    mode = _cuda.MODE_PROBE if fps is None else _cuda.MODE_PROBE_FP
    match, empty, _ = _cuda.launch_segment_probe(
        mode, rows, indicators, fps, prio, pairs, parity, qkeys, qfp)
    if qkeys.shape[0]:            # an empty batch launches nothing
        probe_segments.launches += 1
    return match, empty


probe_segments.launches = 0   # kernel launches since the last reset
