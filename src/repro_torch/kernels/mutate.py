"""Mutation-plan kernel: the update/delete peer of the segment probe.

Replaces the TPU kernel ``src/repro/kernels/mutate.py`` ``mutate_segments``
(``_mutate_kernel``) with the CUDA kernel in ``csrc/segment_probe.cu``
(mode 2).  Per query it resolves, from the one contiguous segment row, the
MATCH slot (the key's current home, the bit update/delete clears), the
VICTIM slot (first empty probe candidate, the bit update sets) and
``flip``, the one-word XOR mask an uncontended op would commit.  The
fingerprint filter is always on.

Bound: device-memory bytes, as the probe (about 372 B per query at
S = 20).  Design: the probe kernel's (one warp per query for a batch
that one wave covers, else persistent warps with tiles of up to 32
queries, one TMA row copy per query); see the source.

On a CPU tensor the wrapper runs the plain version (``mutate_ref``); on a
CUDA tensor it launches the kernel or raises.
"""

from __future__ import annotations

from repro_torch.kernels import _cuda
from repro_torch.kernels.mutate_ref import mutate_ref


def mutate_segments(rows, indicators, fps, prio, pairs, parity, qkeys, qfp):
    """Resolve the mutation plan for one contiguous segment row per query.

    Args mirror ``probe.probe_segments`` with the fp word mandatory.
    Returns ``(match_slot, victim_slot, flip)``: (B,) int32, -1 for
    miss/full, ``flip`` the commit mask as an int32 word.
    """
    if rows.device.type == "cpu":
        return mutate_ref(rows, indicators, fps, prio, pairs, parity, qkeys,
                          qfp)
    out = _cuda.launch_segment_probe(_cuda.MODE_MUTATE, rows, indicators, fps,
                                     prio, pairs, parity, qkeys, qfp)
    if qkeys.shape[0]:            # an empty batch launches nothing
        mutate_segments.launches += 1
    return out


mutate_segments.launches = 0   # kernel launches since the last reset
