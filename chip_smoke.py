#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one card.

    python3 chip_smoke.py

Phases, in order:

1. Header: the card's name and power limit, torch and CUDA versions, and
   the build of the CUDA kernels from ``src/repro_torch/kernels/csrc`` (one
   ``nvcc`` per source, started together, with the attention kernel's
   stamped build for phase 4's breakdown beside them).
2. Store kernels vs plain: a table of the paper's geometry at full size
   (2**23 buckets: 16 B keys and values, 4-slot buckets, 3 SBuckets, 10 %
   extension pool, no stash) loaded with 50,331,648 YCSB records (load
   factor 0.6); the probe and mutate kernels held against their plain
   PyTorch versions on it (exact integer equality) at B 4,224, 65,531,
   65,536 and 1,048,576 and on synthetic rows, and timed beside their
   bound at the serving path's lookup batch (4,224), the main path's batch
   (65,536) and the store's read-back batch (1,048,576); the card's store
   held against the CPU store on a small input.
3. The store's request path, with every kernel's launch count set to 0
   just before: ``make_store("continuity", ...)`` on ``cuda`` bulk-loads
   the same records in 48 insert batches, reads every acknowledged key
   back, looks up absent keys, runs YCSB-A read/update batches, a
   distinct-key update and delete batch (paper Table I: 2 / 2 / 1 PM
   writes per op), and compares the kernel lookup policy with the gather
   policy.  Its tables and records are freed afterwards.
3b. The serial-walk kernel (level and P-FaRM-KV writes) against its plain
   version, exact in every mode (insert / update / delete) on small tables
   at high load with masks and duplicates, and on crafted states that take
   level's move and logged paths and pfarm's displacement, chain and full
   pool.
3c. The baselines at the continuity cell's size, the serial walk's launches
   counted from 0: ``make_store("level" | "pfarm", table_slots=83,886,080)``
   loads the same records, reads every acknowledged key back, looks up
   absent keys, runs YCSB-A and a distinct-key update and delete batch;
   Table I of all three schemes (continuity 2 / 2 / 1, pfarm 5 / 5 / 5,
   level 2 / 2-4 / 1), reads per lookup from the verb plans and each
   scheme's rates.  Uncounted, on clones of each loaded table: every mode
   of the serial walk against its plain version (on a host copy: inserts
   at 2**17, updates and deletes at 65,536; on the card's tensors at
   2,048) and timed beside its bound.
3d. The end-to-end simulator, launches counted from 0: ``run_ycsb`` on the
   card equals the CPU run key for key for continuity, level and pfarm x
   A-F at 800 records / 1,000 ops / batches of 250 (with the orderings of
   ``tests/test_rdma.py``), then the same cells at 1,048,576 records /
   65,536 ops (16 rounds, cut from 64 for the smoke's time limit) /
   batches of 4,096, their simulated ops/s and latencies
   (``LinkModel`` outputs) beside each cell's wall time on the card.
3e. The continuity store's maintenance and crash-consistency surface, every
   store kernel's launch count set to 0 just before and read after: a fresh
   full-size table (as phase 2's) loaded; (a) ``insert_serial`` /
   ``update_serial`` / ``delete_serial`` on clones of it, batches of 2,048
   distinct and zipf-with-duplicates keys, each equal to the wave engine on
   a twin clone in every field, ok and the ledger (µs per op), then a small
   table whose inserts spill into its stash (card serial, card wave and CPU
   serial equal); (b) ``continuity.resize`` of the loaded table to 2**24
   buckets, every one of the 50,331,648 keys looked up through the probe
   kernel (acknowledged ones found with their values), count kept, every
   new version above the old unsigned maximum; (c) the online split at full
   size, ``begin_resize(step_slo_us=25)`` then 300 steps interleaved with
   routed update / delete / insert batches and dual reads, held against a
   host oracle (nothing lost or duplicated), ms per step beside
   ``LinkModel.cohort_move_us``; then a 2**11-bucket stash table split to
   completion and cut over, on the card and on the CPU, byte-equal; (d)
   ``consistency.matrix.run_rows`` on the card equal to the CPU's rows (4
   schemes x insert/update/delete and continuity's resize cell), and the
   baselines' one-step resize on the card equal to the CPU's; (e) the
   continuous batcher under ``ExecPolicy(transport="sim")``: its transport
   counters on the card equal the CPU's.
3f. The cluster, every store kernel's launch count set to 0 just before
   and each probe / mutate launch on the card held in place against its
   plain version: (a) at the reference's smoke sizes, ``cluster.sim.
   run_cluster`` (600 records, 1,200 YCSB-A ops in batches of 240, join
   ``pmJ`` at op 400, kill ``primary`` at op 800), ``durability_drill``,
   ``migration_drill``, the crash matrix's 14 rows (``migrate`` included)
   and the same cell on default-stash nodes of 280 slots that spill into
   their stash: every payload on the card equals the CPU's, field for
   field; (b) the full-size cluster: continuity nodes ``pm0``-``pm3`` of
   the store's defaults (1/8 stash) sized by the reference's formula
   (75,497,728 slots each), R 2, 50,331,648 YCSB records, 196,608 YCSB-A
   ops (zipf 0.99, 3 rounds, cut from 4 for the smoke's time limit) in
   batches of 65,536, join ``pmJ`` after the first round and kill
   ``primary`` after the second: zero committed loss, the join
   within 1/N + 5 %, the kill detected and promoted log-free; load,
   round, join, failover and audit seconds, the ``LinkModel``'s simulated
   ops/s and latencies, peak device memory.  (b) runs in a process of its
   own on the card from the start of phase 3d (beside 3d, 3e, 3f (a) and
   3g, all host-bound and timing no kernel), under its own launch counts
   and in-place checks (added to (a)'s); its report is read after 3g.
3g. The client cache and the chaos matrix, every store kernel's launch
   count set to 0 just before and each probe / mutate launch on the card
   held in place against its plain version: (a) the reference's own cells,
   the fan-in ``--smoke`` cell (``cache.fanin``: continuity, 100 clients,
   14 rounds x 16 ops, 2 writes per round, 1,200 records, 4 nodes, R 2,
   hotspot 0.02 / 0.95, capacity 128, budget 12, ``trust_window`` 0, the
   uncached and the cached pass) and the 14-cell chaos grid at seed 0
   (``chaos.matrix``, ``smoke`` profile): every payload on the card equals
   the CPU's, field for field, and the fan-in's and the matrix's gates
   hold; (b) the same fan-in cell at phase 3f (b)'s 50,331,648 records
   (nodes of 62,914,816 slots by the fan-in's formula, the load inserted
   in batches of 65,536, the two passes sharing it): no stale read served,
   no wrong read in either pass, every stale ack detected, the join within
   1/N + 5 %, log-free failover, the request stream's self-check; hit
   rate, read doorbell and byte reductions and the ``LinkModel`` p50 / p99
   recorded (the fan-in's performance gates are held on (a) only), the
   host seconds of load, rounds, resync, join and failover, peak device
   memory.  (a)'s card runs go in a second process on the card beside
   (b), under their own launch counts and in-place checks (summed).
4. Paged attention vs plain: the kernel against ``paged_attn_ref`` in
   float32 (2e-5) and bfloat16 (6e-2) on the shapes of
   ``tests/test_kernels.py``, G = 1 and 8, lengths on page boundaries and
   one past them, a length of 0 (zeros), poisoned unmapped pages, and
   Yi-6B's decode shape on a pool of phase 5's size at batch 32 and at the
   launcher's batch of 4 (there also within 2 % of the largest plain
   output, a limit that an output one token or one page short is shown to
   break); timed at both batches beside its bound, its plain version,
   and ``scaled_dot_product_attention`` over the same tokens laid out
   densely; the float32 mode (the CUDA-core loop) at batch 32 held within
   2e-5 of its plain version and timed the same way, SDPA in float32.
   The page-token slice mode (``slice_timing``) at the same B 32 shape:
   each page's 16 tokens cut into m = 2 and 4 slices on one card, m slice
   launches and the merge over every slice's partials, for the bf16 and
   int8 routes held within the bf16 limit of the whole-page kernel and of
   the plain version and timed (one slice's launch, the m launches with
   the merge, and the merge alone) beside their bounds, and SDPA over one
   slice's dense tokens (bf16); with one slice bit-equal to the
   whole-page launch; the int8 route's partials at m = 2 and 4 equal to
   the bf16 route's on the dequantized pools bit for bit; the float32
   route within 2e-5 at m = 2.  Then ``tools/attention_breakdown.py``'s
   breakdown of one slice's launch by phase (the stamped build), its
   headline printed.
5. Serving Yi-6B at full width (32 layers, d 4096, 32/4 heads, vocab
   64,000; bf16 weights from a seeded generator, residual output
   projections scaled by 1/sqrt(2L)) through the port's ``launch/serve``
   path, with every launch count set to 0 just before: 32 prompts of
   2,048 tokens prefilled, 63 greedy decode steps against the hash-paged
   pool (page size 16, 132 pages per sequence), one more step run with the
   plain attention and with the kernel (each layer's kernel output held
   against the plain version on that layer's inputs: the bf16 check of the
   kernel in the step) and timed part by part, the whole step timed
   ``STEP_REPS`` times (median and range) and once more under
   ``torch.profiler`` (its device-busy time against that median), then
   every sequence released.  Page-table contents are checked exactly
   against the host-computed bump allocation; the last step's logits
   against the dense forward over the same tokens; a float32 twin (4
   sequences, 256-token prompts) against its float32 forward, and one
   float32 step with the kernel against the same step with the plain
   attention (within 6e-2), at the launcher's init and on the served
   weights.  The checks run outside the count: the launches reported are
   prefill's, the 63 steps' and the releases'.  The float32 twins'
   prefill and decode count the float32-q loop's launches, each from 0.
   The prefill's and the first 2 steps' logits, the page tables after
   them and the pools are kept for phase 7b (c).
5b. Int8 KV pages at full width on phase 5's weights, launches counted
   from 0: an int8 geometry of phase 5's shape (page size 16, 4,224
   pages), the same 32 prompts prefilled and 31 greedy decode steps
   through the paged-attention kernel's int8 mode, page tables exact, the
   int8 prompt pages and their scales equal to ``quant_store`` of phase
   5's bf16 prompt pages byte for byte (the port's int8 prefill repair);
   the greedy tokens' agreement with phase 5's recorded; one more step
   with every layer's int8 kernel output held in place against the int8
   plain version, and the same step through the merged path
   (``merged_attn``), which must launch no attention kernel; every
   sequence released; the int8 kernel timed at B 32 beside its bound, its
   plain version and the bf16 kernel on the same tokens unquantized, and
   its output at the host's split count equal to the bf16 mode's on the
   plain version's dequantized pools bit for bit.
6. The continuous batcher on the same weights answers 48 requests in 32
   slots.
6b. The other families at full width, through ``launch/serve``'s
   functions, every launch count set to 0 before each: (a)
   granite-moe-3b-a800m (32 layers, d 1536, 24 / 8 heads of 64, 40
   experts top-8 of d_ff 512, vocab 49,155, tied; bf16 from a seeded
   generator): 16 prompts of 512 tokens prefilled, 32 greedy decode steps
   against the hash-paged pool (page size 16), page tables exact against
   the host's bump allocation; one more step with every layer's kernel
   attention (D 64, G 3) held in place against the plain version and the
   share of MoE assignments dropped at B 16, the whole step timed; every
   sequence released; the MoE layer run twice on one input, bit-identical;
   a float32 twin (4 sequences, 512-token prompts, 8
   steps, capacity factor num_experts / top_k so nothing drops) against
   its own forward (3e-3 / 1e-3); the attention kernel timed at this
   decode shape beside its bound, plain version and SDPA.  (b) mamba2-370m
   (48 layers, d 1024, d_state 128): in float32, 8 prompts of 256 tokens
   prefilled recurrently and 32 decode steps, every step's logits held
   against the chunked ``ssd_forward``'s over the same 288 tokens
   (3e-3 / 1e-3); then 32 bf16 steps timed (the launcher's step, a CUDA
   graph of ``serve_step``, ``launch.serve.GraphedStep``) beside 8 eager
   ``serve_step`` calls; no kernel launched.  (c) hymba-1.5b (32 layers,
   d 1600, 25 / 5 heads of 64, window 1,024, global layers {0, 16, 31},
   d_state 16): in float32, 2 sequences run recurrently over 1,104 tokens
   (every ring wrapped), every step held against the forward (banded
   window attention, chunked SSD); the same tokens with the ring slot
   shifted by one must leave that tolerance; then 32 bf16 steps timed as
   (b)'s; no kernel launched.  (d) The smoke twins of all ten configs,
   one prefill (from embeddings for musicgen and llava) or recurrent pass
   plus 8 decode steps on the card, equal to the same run in the CPU
   twins' process: integer state exact (page tables, ``seq_lens``, top-k
   ids), floats within 2e-5.
7. Training at full width, every launch count set to 0 before: (a)
   Yi-6B at its published widths cut to 8 of its 32 layers (float32
   masters, remat "full"), 2 sequences of train_4k's 4,096 tokens in 2
   microbatches: the bf16-compute loss and gradient norm against a
   float32-compute step's on the same masters (1e-2 / 5 %), then 6 AdamW
   steps of ``make_train_step`` on the repeated batch (finite, falling),
   seconds per step, tokens/s and peak memory; (b) the ten smoke twins, 3
   steps each on the launcher's batches, card losses within 1e-4 relative
   of the CPU twins' process; (c) the restart drill on the yi-6b twin: 6
   steps with an async save after step 4, an uncommitted .tmp save
   ignored, a restore into a fresh init through a new manager and 2 more
   steps whose losses equal the uninterrupted run's exactly.  The
   training path launches no kernel (asserted).
7b. The multi-device layer at world 1, every launch count set to 0
   before each part: a one-rank NCCL group in this process (torn down at
   the end).  (a) The sharded continuity store (``core.distributed``) at
   the reference's service size (``dryrun.lower_kv_cell``: 2^22 buckets,
   ext-free, ~1.38 GB): 10,066,329 seeded records (load factor 0.3 of
   its 33,554,432 segment slots, cut from 0.6 for the smoke's time limit)
   written through ``make_write`` in batches of 65,536 (the routed walk,
   ``scan_walk.routed_write``), the acknowledged count recorded; every
   record and 65,536 absent keys read back through ``make_lookup``:
   found set and values equal to the acknowledged records and to an
   unsharded ``ContinuityStore`` of the
   same geometry loaded with them; 256 client batches of 4,096 timed; one
   mixed batch of 4,096 (updates, deletes, fresh and present inserts, 64
   keys taking eight ops each) through the walk on a clone, its status
   and every table field equal to the plain version's on a host copy byte
   for byte, then timed beside its latency floor (a dependent chase over
   the table's rows).  (b) Phase 7's Yi-6B cut, 2 steps on a (1, 1)
   ``("data", "model")`` mesh (DTensor parameters and ZeRO-1 moments)
   against the same 2 steps unsharded: loss within 1e-3, every leaf atol
   2e-4 / rtol 2e-3 (``tests/test_distributed.py``'s tolerances); no
   kernel launched.  (c) Phase 5's Yi-6B serving (its bf16 weights drawn
   again from its seed, its 32 prompts of 2,048 tokens, page size 16) on
   a (1, 1) mesh, the cache this rank's shard (``kvcache.shard_cache``):
   the prefill and 2 decode steps fed phase 5's greedy tokens, attention
   through the kernel's slice mode and the merge; the logits, the page
   tables and sequence fields and every written pool row equal phase 5's
   bit for bit; one slice launch and one merge per layer per step.
8. Report: one JSON line of every kernel's launches (the TPU kernels' on
   the serving path, phase 5; the serial walk's on the baselines path,
   phase 3c; probe and mutate also on the cluster path, phase 3f, as
   ``cluster_launches``, and on the cache and chaos path, phase 3g, as
   ``cache_launches``; every kernel's on the moe path, phase 6b (a), as
   ``moe_launches``, on the training path, phase 7, as
   ``train_launches``, on the multi-device path, phase 7b (a), as
   ``dist_launches``, and the walk's routed mode timed there as the walk
   row's ``routed``; the slice mode as its own row,
   ``paged_attention_slice``, with its launches (and the merge's) on the
   multi-device serving path, phase 7b (c), its times by route and slice
   count under ``slices`` (with the merge alone and SDPA over one slice's
   tokens) and phase 4's breakdown of one slice's launch under
   ``breakdown``; attention's times at the moe path's decode
   shape as ``moe_shape``; the int8 mode as its own row,
   ``int8_attention``, with its launches on the int8 path of phase 5b,
   and the merged path's attention launches as ``merged_launches``; the
   float32-q loop as ``float32_attention``, with its launches on the
   float32 twins of phases 5 and 6b (a)),
   error, times and bound; the card's name and power limit;
   last ``{"ok": true, "device": {...}}``.

The CPU twins that phases 3e ((c)'s small split), 3f (a), 3g (a), 6b
(d) and 7 (b) hold the card against run in a spawned process of their
own from the start; every process the script starts is ended before it
exits.  Any failed
check raises.  Without a CUDA device it exits non-zero and prints no
result.
"""

from __future__ import annotations

import json
import multiprocessing
import subprocess
import sys
import time
import traceback
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

NUM_BUCKETS = 2 ** 23          # 4,194,304 segment pairs, 83.9 M main slots
N_RECORDS = 50_331_648         # load factor 0.6
LOAD_BATCH = 2 ** 20           # 48 insert batches
READ_BATCH = 2 ** 20
QUERY_B = 65_536               # kernel comparison and YCSB batch size
SMALL_B = 4_224                # the serving path's page-table lookups
ODD_B = 65_531
YCSB_BATCHES = 4
SEED = 0
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device-memory rate (data sheet)
# phase 4/5: serving Yi-6B
SERVE_B = 32                   # global batch (sequences)
PROMPT_LEN = 2048
GEN = 64                       # generated tokens: prefill's + 63 steps
PAGE_SIZE = 16
CHECK_SEQS = 4                 # sequences held against the dense forward
FORWARD_TOL = 0.25             # bf16 logits of two evaluations, std ~1.3
F32_FORWARD_TOL = 1e-3         # the same in float32 (same weights upcast)
F32_STEP_TOL = 6e-2            # float32 step, kernel vs plain attention
ATTN_TOL = {"float32": 2e-5, "bfloat16": 6e-2}
# bf16 comparisons at the serving shape, whose outputs can be far below 1:
# the limit is also held to this share of the largest plain output (~2.5
# bf16 ulps of it), so a dropped page or token cannot pass under it
ATTN_REL = 2e-2
BATCH_REQUESTS = 48
KERNEL_SLEEP = 40_000_000      # device-sleep cycles ahead of a timed kernel
PLAIN_SLEEP = 200_000_000     # ... of a timed plain version (~100 ms)
LAUNCHER_B = 4                 # launch.serve's default batch
STEP_REPS = 9                  # timings of the whole decode step
# phases 3b-3d: the baselines and the end-to-end simulator
BASE_SLOTS = 83_886_080        # the continuity cell's main slots
WALK_B = 2_048                 # the serial walk's timed batch
WALK_INSERT_CHECK_B = 2 ** 17  # the walk's full-size insert check (host copy)
CHASE_STEPS = 65_536           # dependent loads timed for the walk's floor
CHASE_COLD_STEPS = 8_192       # ... from a cold L2 (few lines touched twice)
E2E_SCHEMES = ("continuity", "level", "pfarm")
E2E_SMALL = dict(num_records=800, num_ops=1000, batch=250)
E2E_LARGE = dict(num_records=1_048_576, num_ops=65_536, batch=4_096)
SLICES = (2, 4)                # page-token slices of phase 4's slice mode


def _check(cond, what: str) -> None:
    if not bool(cond):
        raise AssertionError(f"check failed: {what}")


def _smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


TWIN_THREADS = 2               # torch CPU threads of the twins' process
CHILD_WAIT_S = 900             # the longest wait for a child process


def _cpu_twin_runs(torch) -> dict:
    """{(phase, name): fn(device)}: the runs whose card payloads phases
    3e, 3f (a), 3g (a), 6b (d) and 7 (b) hold against the same run on the
    CPU."""
    from repro_torch import api, convert
    from repro_torch.data import ycsb
    runs = {("3e", "small split"): lambda d: _small_split(
        torch, api, convert, ycsb, d)}
    runs.update({("3f", n): fn for n, fn in _cluster_runs().items()})
    runs.update({("3g", n): fn for n, fn in _cache_runs().items()})
    from repro_torch.configs import ARCHS
    runs.update({("6b", n): (lambda d, n=n: _family_twin(n, d))
                 for n in ARCHS})
    runs.update({("7", n): (lambda d, n=n: _train_twin(n, d))
                 for n in ARCHS})
    return runs


def _twins_main(queue) -> None:
    """The twins' process: every CPU twin in phase order, as
    {(phase, name): (payload, seconds)}."""
    def run():
        sys.path.insert(0, str(ROOT / "src"))
        import torch
        torch.set_num_threads(TWIN_THREADS)
        out = {}
        for key, fn in _cpu_twin_runs(torch).items():
            t0 = time.perf_counter()
            out[key] = (fn("cpu"), time.perf_counter() - t0)
        return out
    _child_result(queue, run)


def _child_result(queue, run) -> None:
    """Put ("ok", run()) or ("error", its traceback) on ``queue``."""
    try:
        queue.put(("ok", run()))
    except BaseException:
        queue.put(("error", traceback.format_exc()))


_CHILDREN = []                 # every process started, ended by main


class _Child:
    """``target(queue)`` in a spawned process (no state shared with this
    one: a process of its own on the same card, or on the CPU only);
    ``result`` waits for what it puts, ``stop`` ends it in any case."""

    def __init__(self, target, what: str):
        _CHILDREN.append(self)
        ctx = multiprocessing.get_context("spawn")
        self._what = what
        self._queue = ctx.Queue()
        self._proc = ctx.Process(target=target, args=(self._queue,),
                                 daemon=True)
        self._proc.start()

    def result(self):
        status, out = self._queue.get(timeout=CHILD_WAIT_S)
        _check(status == "ok", f"{self._what} ran: {out}")
        self._proc.join()
        return out

    def stop(self) -> None:
        if self._proc.is_alive():
            self._proc.terminate()
        self._proc.join()


class _Twins(_Child):
    """The CPU twins, computed in their own process while this one drives
    the card (they need no card: the CPU runs take their kernels' plain
    versions); ``get`` waits for them the first time it is called."""

    def __init__(self):
        super().__init__(_twins_main, "the CPU twins")
        self._out = None

    def get(self, phase: str, name: str):
        """(payload, seconds in the twins' process)."""
        if self._out is None:
            self._out = self.result()
        return self._out[(phase, name)]


def _timed(torch, fn):
    """(result, seconds) of ``fn()`` ending in a device synchronize."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _event_ms(torch, fn, batches, iters):
    """Mean milliseconds per call of ``fn(batch)`` called back to back from
    Python, cycling through ``batches`` (distinct query sets, so the rows
    of one call are not left in L2 by the previous one): what a caller
    pays, host overhead included."""
    for b in batches[:2]:
        fn(b)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(batches[i % len(batches)])
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _device_ms(torch, fn, batches, iters, sleep_cycles, before=None):
    """Mean device milliseconds of ``fn(batch)``: each call is enqueued
    behind a device-side sleep of ``sleep_cycles``, so its two events
    bracket the device work alone and not the host's enqueue time.  A call
    whose enqueue outlasted the sleep is not counted (its events would
    hold a host gap); at least 90 % of the calls must count.  ``before()``,
    when given, runs ahead of each call's sleep (it sets the L2 state)."""
    for b in batches[:2]:
        fn(b)
    s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    s.record()
    torch.cuda._sleep(sleep_cycles)
    e.record()
    e.synchronize()
    sleep_ms = s.elapsed_time(e)
    timed = []
    for i in range(iters):
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()     # an empty launch queue never blocks
        if before is not None:
            before()
        torch.cuda._sleep(sleep_cycles)
        t0 = time.perf_counter()
        s.record()
        fn(batches[i % len(batches)])
        e.record()
        timed.append((s, e, (time.perf_counter() - t0) * 1e3 < sleep_ms))
    torch.cuda.synchronize()
    ms = [s.elapsed_time(e) for s, e, ok in timed if ok]
    _check(len(ms) >= 0.9 * iters, f"the host enqueued {len(ms)} of {iters} "
           f"calls within the device sleep ({sleep_ms:.3f} ms)")
    return sum(ms) / len(ms)


def _records(torch, ycsb):
    """The YCSB load set on the card: (keys, values) as int32 words."""
    ids = np.arange(N_RECORDS, dtype=np.int64)
    keys = torch.from_numpy(ycsb.make_key(ids).view(np.int32)).cuda()
    vals = torch.from_numpy(ycsb.make_value(np.random.RandomState(SEED),
                                            N_RECORDS).view(np.int32)).cuda()
    return keys, vals


def _load(store, table, keys, vals):
    """Insert the records in batches of LOAD_BATCH; returns the results."""
    return [store.insert(table, keys[s:s + LOAD_BATCH],
                         vals[s:s + LOAD_BATCH])[1]
            for s in range(0, N_RECORDS, LOAD_BATCH)]


def _last_per_key(ids: np.ndarray) -> np.ndarray:
    """Index of the last occurrence of each distinct id (batch order)."""
    _, first_rev = np.unique(ids[::-1], return_index=True)
    return len(ids) - 1 - first_rev


def _ycsb_ids(keys_np: np.ndarray) -> np.ndarray:
    """Record ids back from YCSB keys (lanes 0/1 hold the id's halves)."""
    k = keys_np.astype(np.int64)
    return k[:, 0] | (k[:, 1] << 32)


def _residual_trips(torch, ch, cfg, keys_np) -> int:
    """Trips of an update batch's residual wave loop: the largest cohort
    of a pair that holds a duplicated key (all keys present)."""
    pair = ch.locate(cfg, torch.from_numpy(keys_np.view(np.int32)))[0].numpy()
    _, inv, cnt = np.unique(_ycsb_ids(keys_np), return_inverse=True,
                            return_counts=True)
    hot = np.unique(pair[cnt[inv] > 1])
    if not len(hot):
        return 0
    return int(np.bincount(np.searchsorted(hot, pair[np.isin(pair, hot)]))
               .max())


# ---------------------------------------------------------------------------
# phase 2: each kernel against its plain version
# ---------------------------------------------------------------------------

def _synthetic_cases(torch):
    """Rows of other widths and fills: all-empty, all-full (20 main bits),
    random words with bit 31 set, S = 32 and 30."""
    for S, fill in ((20, 0), (20, 0xFFFFF), (32, None), (30, None)):
        P, B = 4096, 4099
        rng = np.random.RandomState(S * 7 + (fill or 1))
        rows = rng.randint(0, 2 ** 32, size=(P, 4 * S), dtype=np.uint64)
        ind = (np.full((P, 1), fill, np.uint64) if fill is not None else
               rng.randint(0, 2 ** 32, size=(P, 1), dtype=np.uint64)
               | np.uint64(1 << 31))
        seg = (S * 4) // 5
        prio = np.full((2, S), 0x7FFFFFFF, np.int32)
        prio[0, :seg] = np.arange(seg)
        prio[1, list(range(S - 1, S - 1 - seg, -1))] = np.arange(seg)
        pairs = rng.randint(0, P, size=B)
        q = rng.randint(0, 2 ** 32, size=(B, 4), dtype=np.uint64)
        plant = rng.randint(0, S, size=B)
        q[::2] = rows[pairs[::2]].reshape(-1, S, 4)[
            np.arange(len(plant[::2])), plant[::2]]
        fps = rng.randint(0, 2 ** 32, size=(P, 2), dtype=np.uint64)

        def w(a):
            return torch.from_numpy(a.astype(np.uint32).view(np.int32)).cuda()

        def i32(a):
            return torch.from_numpy(a.astype(np.int32)).cuda()
        yield (f"synthetic S={S}, indicator "
               f"{'random|bit31' if fill is None else hex(fill)}",
               (w(rows), w(ind), i32(prio), i32(pairs),
                i32(rng.randint(0, 2, size=B)), w(q), w(fps),
                i32(rng.randint(0, 4, size=B))))


def kernel_phase(torch, api, ch, ycsb, K, _cuda, probe, mutate, keys, vals,
                 card) -> list:
    """Phase 2 on its own full-size table; returns the kernels' rows."""
    from repro_torch.kernels.mutate_ref import mutate_ref
    from repro_torch.kernels.probe_ref import probe_ref
    store = api.make_store("continuity", num_buckets=NUM_BUCKETS,
                           stash_frac=0.0, device="cuda")
    cfg, S = store.cfg, store.cfg.slots_per_pair
    table = store.create()
    _, t_load = _timed(torch, lambda: _load(store, table, keys, vals))
    print(f"phase 2: full-size table loaded ({int(table.count)} items, "
          f"{t_load:.3f} s)", flush=True)
    rng = np.random.RandomState(SEED + 2)
    prio = torch.as_tensor(K.priority_table(cfg)).cuda()

    def operands(B=QUERY_B):
        half = B // 2
        q = np.concatenate([ycsb.make_key(rng.choice(N_RECORDS, half)),
                            ycsb.negative_keys(rng, N_RECORDS, B - half)])
        q = torch.from_numpy(q.view(np.int32)).cuda()
        pair, parity = ch.locate(cfg, q)
        return (K.table_rows(table), table.indicator[:, None], prio,
                pair.to(torch.int32), parity.to(torch.int32), q, table.fp,
                ch.fingerprint(q).to(torch.int32))

    runs = {
        "probe": (lambda o: probe.probe_segments(*o[:6]),
                  lambda o: probe_ref(*o[:6])),
        "probe_fp": (lambda o: probe.probe_segments(*o),
                     lambda o: probe_ref(*o)),
        "mutate": (lambda o: mutate.mutate_segments(*o[:2], o[6], *o[2:6],
                                                    o[7]),
                   lambda o: mutate_ref(*o[:2], o[6], *o[2:6], o[7])),
    }
    err = dict.fromkeys(runs, 0)

    def compare(case, o):
        for name, (kern, plain) in runs.items():
            for g, w in zip(kern(o), plain(o)):
                torch.cuda.synchronize()
                d = (g.to(torch.int64) - w.to(torch.int64)).abs()
                err[name] = max(err[name], int(d.max()) if d.numel() else 0)
                _check(torch.equal(g, w),
                       f"{name} kernel equals its plain version ({case})")

    full = operands()
    compare(f"full-size table, B={QUERY_B}", full)
    compare(f"full-size table, B={ODD_B}",
            full[:3] + tuple(x[:ODD_B] for x in full[3:6]) + full[6:7]
            + (full[7][:ODD_B],))
    for B in (SMALL_B, READ_BATCH):
        compare(f"full-size table, B={B}", operands(B))
    for case, o in _synthetic_cases(torch):
        compare(case, o)
    print(f"phase 2: probe (fp off and on) and mutate equal their plain "
          f"versions on the full-size table (B={SMALL_B}, {ODD_B}, {QUERY_B}"
          f" and {READ_BATCH}) and on synthetic empty/full/bit-31 rows; "
          f"max_abs_err {err}", flush=True)
    index = torch.cuda.current_device()
    res = [_cuda.probe_resident_blocks(index, _cuda.MODE_PROBE_FP, S, d)
           for d in (False, True)]
    print(f"phase 2: segment probe at S={S}: the tiled kernel holds {res[0]} "
          f"blocks of {_cuda.PROBE_WARPS} warps per SM "
          f"({_cuda.probe_smem_bytes(S)} B of dynamic shared memory per "
          f"block), the one-warp-per-query kernel {res[1]}; grid (blocks, "
          f"tile) at B=" + ", ".join(
              f"{B}: {_cuda.probe_grid(B, _cuda.sm_count(index), *res)}"
              for B in (SMALL_B, QUERY_B, READ_BATCH)), flush=True)

    # times at the serving path's lookup batch, the main path's batch and
    # the store's read-back batch, each beside the bound by bytes: per
    # query one row of S 16-byte keys (counted once per distinct pair), the
    # pair's indicator and fp words, its key, pair, parity, fingerprint,
    # and the outputs; at the main path's batch also the plain version
    rows = []
    specs = [("probe_segments", "src/repro/kernels/probe.py:130",
              runs["probe_fp"], max(err["probe"], err["probe_fp"]), 8),
             ("mutate_segments", "src/repro/kernels/mutate.py:93",
              runs["mutate"], err["mutate"], 12)]
    for B in (SMALL_B, QUERY_B, READ_BATCH):
        batches = [operands(B) for _ in range(4 if B > QUERY_B else 8)]
        uniq = float(np.mean([int(torch.unique(o[3]).numel())
                              for o in batches]))
        for name, replaces, (kern, plain), e, out_bytes in specs:
            ms = _device_ms(torch, kern, batches, 100 if B > QUERY_B else 200,
                            KERNEL_SLEEP)
            nbytes = uniq * (S * 16 + 4 + 8) + B * (16 + 4 + 4 + 4
                                                    + out_bytes)
            bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
            line = (f"{name}: {ms * 1e3:.2f} us on the device per launch at "
                    f"B={B} (bound {bound_ms * 1e3:.2f} us from "
                    f"{nbytes / 1e6:.2f} MB, {bound_ms / ms:.3f} of it")
            if B == QUERY_B:
                plain_ms = _device_ms(torch, plain, batches, 20, PLAIN_SLEEP)
                call_ms = _event_ms(torch, kern, batches, 200)
                rows.append({
                    "name": name, "route": "cuda",
                    "source": "src/repro_torch/kernels/csrc/segment_probe.cu",
                    "replaces": replaces, "max_abs_err": e, "ms": ms,
                    "plain_ms": plain_ms, "bound_ms": bound_ms,
                    "bound_by": "bytes", "library_ms": None})
                line += (f"; plain version {plain_ms * 1e3:.2f} us); "
                         f"{call_ms * 1e3:.2f} us per call back to back "
                         f"from Python")
            else:
                line += ")"
            print(f"{line} [{card}]", flush=True)
        if B == QUERY_B:
            ms_nofp = _device_ms(torch, runs["probe"][0], batches, 200,
                                 KERNEL_SLEEP)
            print(f"probe_segments without the fp filter: "
                  f"{ms_nofp * 1e3:.2f} us on the device per launch at "
                  f"B={QUERY_B} [{card}]", flush=True)
    del table, batches, full
    torch.cuda.empty_cache()
    _small_input_check(torch, api, ycsb)
    return rows


def _small_input_check(torch, api, ycsb) -> None:
    """The card's store (kernel policy) against the CPU store (plain
    versions, which the CPU tests hold against the JAX package) on a
    small input that reaches the extension pool and the stash tier."""
    rng = np.random.RandomState(SEED + 3)
    ids = np.concatenate([np.arange(2400), rng.randint(0, 2400, 64)])
    keys, vals = ycsb.make_key(ids), ycsb.make_value(rng, len(ids))
    vals2 = ycsb.make_value(rng, len(ids))
    q = np.concatenate([keys, ycsb.negative_keys(rng, 2400, 256)])
    out = []
    for dev in ("cpu", "cuda"):
        st = api.make_store("continuity", table_slots=2048, device=dev)
        t = st.create()
        t, r1 = st.insert(t, keys, vals)
        t, r2 = st.update(t, keys[::2], vals2[::2])
        t, r3 = st.delete(t, keys[1::3])
        r4 = st.lookup(t, q)
        out.append([*t, r1.ok, r2.ok, r3.ok, r4.ok, r4.values, r4.reads,
                    *r4.plan])
    _check(int((out[0][12] != 0).sum()) > 0, "small input reaches the stash")
    _check(all(torch.equal(a, b.cpu()) for a, b in zip(*out)),
           "card and CPU stores give byte-equal tables and results")
    print("phase 2: small input (extension pool and stash tier): the card's "
          "store equals the CPU store, tables byte for byte", flush=True)


# ---------------------------------------------------------------------------
# phase 3: the main path
# ---------------------------------------------------------------------------

def main_path(torch, api, ch, ycsb, K, keys, vals, card) -> dict:
    """The port's request path at full size; returns its numbers."""
    store = api.make_store("continuity", num_buckets=NUM_BUCKETS,
                           stash_frac=0.0, device="cuda")
    cfg = store.cfg
    rng = np.random.RandomState(SEED + 4)
    out = {}

    # -- bulk load: 48 insert batches of 2**20 ---------------------------
    table = store.create()
    results, t_ins = _timed(torch, lambda: _load(store, table, keys, vals))
    ok = torch.cat([r.ok for r in results])
    n_ok = int(ok.sum())
    pm = sum(int(r.ledger.pm_writes) for r in results)
    _check(sum(int(r.ledger.ops) for r in results) == N_RECORDS,
           "insert ledger counts every op")
    _check(pm == 2 * n_ok, "Table I: 2 PM writes per committed insert")
    _check(int(table.count) == n_ok, "table count equals acknowledged inserts")
    lf = float(store.load_factor(table))
    out.update(insert_ops_s=N_RECORDS / t_ins)
    print(f"load: {n_ok} of {N_RECORDS} inserts acknowledged in "
          f"{len(results)} batches of {LOAD_BATCH}, {t_ins:.3f} s = "
          f"{N_RECORDS / t_ins:.0f} inserts/s, PM writes per committed "
          f"insert {pm / n_ok}, load factor {lf:.6f}, extension groups "
          f"{int(table.ext_count)}, device memory in use "
          f"{torch.cuda.memory_allocated() / 2 ** 30:.3f} GiB [{card}]",
          flush=True)

    # -- read back every acknowledged key --------------------------------
    def readback():
        hit_all, reads = True, 0
        for s in range(0, N_RECORDS, READ_BATCH):
            res = store.lookup(table, keys[s:s + READ_BATCH])
            o = ok[s:s + READ_BATCH]
            hit_all &= bool(torch.equal(res.ok, o))
            hit_all &= bool(torch.equal(res.values[o],
                                        vals[s:s + READ_BATCH][o]))
            reads += int(res.ledger.rdma_reads)
        return hit_all, reads
    (hit_all, reads), t_read = _timed(torch, readback)
    _check(hit_all, "every acknowledged insert reads back its value, and "
           "no unacknowledged key is found")
    _check(reads >= N_RECORDS, "reads_per_op >= 1")
    out.update(lookup_ops_s=N_RECORDS / t_read,
               reads_per_lookup=reads / N_RECORDS)
    print(f"read-back: {N_RECORDS} lookups in batches of {READ_BATCH}, every "
          f"acknowledged key found with its value, {t_read:.3f} s = "
          f"{N_RECORDS / t_read:.0f} lookups/s, reads per op "
          f"{reads / N_RECORDS:.6f} [{card}]", flush=True)

    neg = ycsb.negative_keys(rng, N_RECORDS, READ_BATCH)
    _check(not bool(store.lookup(table, neg).ok.any()),
           "negative lookups all miss")
    print(f"negatives: {READ_BATCH} absent keys, none found", flush=True)

    # -- YCSB-A: zipf 0.99, 50 % reads / 50 % updates --------------------
    cur = vals.clone()        # the value each key should hold now
    t_rd = t_up = 0.0
    n_rd = n_up = n_fail = 0
    for batch in ycsb.generate("A", N_RECORDS, YCSB_BATCHES * QUERY_B,
                               QUERY_B, seed=SEED + 1):
        bids = _ycsb_ids(batch.keys)
        rsel = batch.ops == ycsb.OP_READ
        usel = batch.ops == ycsb.OP_UPDATE
        rk = torch.from_numpy(batch.keys[rsel].view(np.int32)).cuda()
        ri = torch.from_numpy(bids[rsel]).cuda()
        res, t = _timed(torch, lambda: store.lookup(table, rk))
        t_rd += t
        n_rd += int(rsel.sum())
        _check(torch.equal(res.ok, ok[ri]), "YCSB-A reads find every "
               "acknowledged key and nothing else")
        _check(torch.equal(res.values[res.ok], cur[ri][res.ok]),
               "YCSB-A reads return the current values")
        uk, uv, ui = batch.keys[usel], batch.vals[usel], bids[usel]
        trips = _residual_trips(torch, ch, cfg, uk)
        (_, ures), t = _timed(torch, lambda: store.update(table, uk, uv))
        t_up += t
        n_up += len(ui)
        uok = ures.ok.cpu().numpy()
        uidx = torch.from_numpy(ui).cuda()
        _check(not (uok & ~ok[uidx].cpu().numpy()).any(),
               "no update of an unacknowledged key succeeds")
        n_fail += int((~uok).sum())
        okidx = np.nonzero(uok)[0]
        if len(okidx):    # the last acknowledged update of a key wins
            li = okidx[_last_per_key(ui[okidx])]
            cur[torch.from_numpy(ui[li]).cuda()] = torch.from_numpy(
                uv[li].view(np.int32)).cuda()
        chk = store.lookup(table, uk)
        _check(torch.equal(chk.ok, ok[uidx]) and torch.equal(
            chk.values[chk.ok], cur[uidx][chk.ok]), "updated values read back")
        print(f"YCSB-A batch: {int(rsel.sum())} reads, {len(ui)} updates "
              f"({len(np.unique(ui))} distinct keys, {int((~uok).sum())} "
              f"refused), residual wave trips {trips}, update "
              f"{t * 1e3:.3f} ms", flush=True)
    out.update(ycsb_read_ops_s=n_rd / t_rd, ycsb_update_ops_s=n_up / t_up)
    print(f"YCSB-A: {n_rd} reads in {t_rd:.3f} s = {n_rd / t_rd:.0f} "
          f"lookups/s, {n_up} updates ({n_fail} refused) in {t_up:.3f} s = "
          f"{n_up / t_up:.0f} updates/s (batches of {QUERY_B}) [{card}]",
          flush=True)

    # -- duplicate-free update and delete batches: Table I 2 / 1 ---------
    pick = rng.choice(N_RECORDS, 2 * QUERY_B, replace=False)
    _check(bool(ok[torch.from_numpy(pick).cuda()].all()),
           "picked keys were acknowledged")
    pk = ycsb.make_key(pick)
    nv = ycsb.make_value(rng, QUERY_B)
    before = store.lookup(table, pk[:QUERY_B]).values
    (_, ures), t_u = _timed(torch, lambda: store.update(table, pk[:QUERY_B],
                                                        nv))
    # an out-of-place update needs a free slot in the key's segment (or its
    # extension group); where there is none it is refused and writes nothing
    u_ok = ures.ok
    n_uok = int(u_ok.sum())
    _check(n_uok > 0.9 * QUERY_B, "distinct-key updates of live keys "
           "mostly succeed")
    _check(int(ures.ledger.pm_writes) == 2 * n_uok,
           "Table I: 2 PM writes per committed update")
    chk = store.lookup(table, pk[:QUERY_B])
    want = torch.where(u_ok[:, None],
                       torch.from_numpy(nv.view(np.int32)).cuda(), before)
    _check(bool(chk.ok.all()) and torch.equal(chk.values, want),
           "committed updates read back, refused ones keep the old value")
    count0 = int(table.count)
    (_, dres), t_d = _timed(torch, lambda: store.delete(table, pk[QUERY_B:]))
    _check(bool(dres.ok.all()), "deletes of live keys succeed")
    _check(int(table.count) == count0 - QUERY_B, "count drops by the deletes")
    _check(not bool(store.lookup(table, pk[QUERY_B:]).ok.any()),
           "deleted keys are gone")
    table1 = (pm / n_ok, int(ures.ledger.pm_writes) / n_uok,
              dres.ledger.pm_per_op())
    _check(table1 == (2.0, 2.0, 1.0),
           "Table I: 2 / 2 / 1 PM writes per committed op")
    out.update(update_ops_s=QUERY_B / t_u, delete_ops_s=QUERY_B / t_d,
               table1=table1)
    print(f"Table I (PM writes per committed insert/update/delete): "
          f"{table1}; distinct-key batches of {QUERY_B}: update "
          f"{t_u * 1e3:.3f} ms = {QUERY_B / t_u:.0f} updates/s "
          f"({QUERY_B - n_uok} refused: no free slot in the segment), "
          f"delete {t_d * 1e3:.3f} ms = {QUERY_B / t_d:.0f} deletes/s "
          f"[{card}]", flush=True)

    # -- the kernel policy agrees with the gather policy ----------------
    sample = np.concatenate([ycsb.make_key(rng.choice(N_RECORDS, QUERY_B // 2)),
                             ycsb.negative_keys(rng, N_RECORDS, QUERY_B // 2)])
    gstore = store.with_policy(api.ExecPolicy(probe="gather"))
    a, b = store.lookup(table, sample), gstore.lookup(table, sample)
    _check(torch.equal(a.ok, b.ok) and torch.equal(a.values, b.values)
           and torch.equal(a.reads, b.reads)
           and all(torch.equal(x, y) for x, y in zip(a.plan, b.plan)),
           "kernel and gather policies give the same lookups and plans")
    ra, rb = K.probe_lookup(cfg, table, sample), ch.lookup(cfg, table, sample)
    _check(all(torch.equal(x, y) for x, y in zip(ra, rb)),
           "probe_lookup equals continuity.lookup (found/values/slot/reads)")
    print(f"kernel vs gather policy: {QUERY_B} lookups identical "
          f"({int(a.ok.sum())} found)", flush=True)
    return out


# ---------------------------------------------------------------------------
# phase 3b: the serial-walk kernel against its plain version
# ---------------------------------------------------------------------------

def _walk_tables(scheme):
    """(module, to_numpy, from_numpy) of a baseline scheme's tables."""
    from repro_torch import convert
    from repro_torch.core import level as lv
    from repro_torch.core import pfarm as pf
    if scheme == "level":
        return lv, convert.level_table_to_numpy, convert.level_table_from_numpy
    return pf, convert.pfarm_table_to_numpy, convert.pfarm_table_from_numpy


def _walk_words(torch, ids, vseed, dev):
    from repro_torch.data import ycsb
    ids = np.asarray(ids)
    return (torch.from_numpy(ycsb.make_key(ids).view(np.int32)).to(dev),
            torch.from_numpy(ycsb.make_value(np.random.RandomState(vseed),
                                             len(ids)).view(np.int32)).to(dev))


def _walk_compare(torch, scheme, op, cfg, pre, ids, active, what):
    """One batch through the kernel (card) and the plain version (CPU) from
    the same numpy pre-state; every table field, ok and pm must be equal.
    Returns (CPU table after, ok, pm, max_abs_err)."""
    from repro_torch.kernels import scan_walk
    from repro_torch.kernels.scan_walk_ref import scan_walk_ref
    _, to_np, from_np = _walk_tables(scheme)
    outs = []
    for dev in ("cpu", "cuda"):
        t = from_np(pre, dev)
        k, v = _walk_words(torch, ids, 7, dev)
        a = torch.from_numpy(np.asarray(active, bool)).to(dev)
        fn = scan_walk_ref if dev == "cpu" else scan_walk.scan_walk
        ok, pm = fn(scheme, op, cfg, t, k, None if op == "delete" else v, a)
        outs.append((t, ok.cpu(), pm.cpu()))
    torch.cuda.synchronize()
    (tc, okc, pmc), (tg, okg, pmg) = outs
    want, got = to_np(tc), to_np(tg)
    err = max([int(np.abs(got[f].astype(np.int64) - want[f].astype(np.int64))
                   .max(initial=0)) for f in want]
              + [int((okg - okc).abs().max()), int((pmg - pmc).abs().max())])
    _check(err == 0 and all(np.array_equal(got[f], want[f]) for f in want)
           and torch.equal(okg, okc) and torch.equal(pmg, pmc),
           f"scan_walk equals its plain version ({scheme} {op}, {what})")
    return tc, okc, pmc, err


def walk_phase(torch, card) -> int:
    """Phase 3b: every mode of the serial walk against its plain version on
    small tables at high load, and on crafted states that force level's
    move and logged paths and pfarm's displacement, chain and full pool.
    Returns the largest integer difference seen (0)."""
    from repro_torch.core import level as lv
    from repro_torch.core import pfarm as pf
    err = 0
    forced = {}
    for scheme, cfg, n in (("level", lv.LevelConfig(num_top=1024), 5500),
                           ("pfarm", pf.PFarmConfig(num_buckets=1024), 4600)):
        mod, to_np, _ = _walk_tables(scheme)
        empty = to_np(mod.create(cfg, "cpu"))
        pre, _, _, e = _walk_compare(torch, scheme, "insert", cfg, empty,
                                     np.arange(n), np.ones(n, bool),
                                     f"load to {n} items")
        pre, err = to_np(pre), max(err, e)
        rng = np.random.RandomState(5)
        for op in ("insert", "update", "delete"):
            ids = (np.arange(n, n + WALK_B) if op == "insert" else
                   np.where(rng.rand(WALK_B) < 0.85, rng.randint(0, n, WALK_B),
                            rng.randint(n, 2 * n, WALK_B)))
            ids[rng.rand(WALK_B) < 0.1] = ids[0]          # duplicates
            _, ok, pm, e = _walk_compare(
                torch, scheme, op, cfg, pre, ids, rng.rand(WALK_B) < 0.8,
                f"B={WALK_B} at high load, masked, duplicates")
            err = max(err, e)
            forced[f"{scheme} {op}"] = sorted(set(pm.tolist()))
    # level: a one-movement insert (5), then a logged (4) and a free (2)
    # update, on num_top 4 (tests/test_torch_cuda.py builds the same state)
    cfg = lv.LevelConfig(num_top=4)
    ids = np.arange(200_000)
    cand = lv._cand_buckets(cfg, _walk_words(torch, ids[:20_000], 0,
                                             "cpu")[0]).numpy()
    inner = ids[:20_000][(cand[:, 0] < 2) & (cand[:, 1] < 2)]
    first = ids[:20_000][(cand[:, 0] == 0) & (cand[:, 1] == 2)][:1]
    last = inner[11:][cand[inner[11:], 0] == 0][:1]
    order = np.concatenate([first, inner[:11], last])
    t, _, pm, e = _walk_compare(torch, "level", "insert", cfg,
                                _walk_tables("level")[1](lv.create(cfg, "cpu")),
                                order, np.ones(13, bool), "crafted move")
    _check(pm.tolist() == [2] * 12 + [5], "level's move path was taken")
    _, _, pm2, e2 = _walk_compare(torch, "level", "update", cfg,
                                  _walk_tables("level")[1](t),
                                  np.concatenate([order[[12]], first]),
                                  np.ones(2, bool), "crafted updates")
    _check(pm2.tolist() == [4, 2], "level's logged and free updates")
    err = max(err, e, e2)
    # pfarm: displacement into bucket 6, chains, then a full pool
    cfg = pf.PFarmConfig(num_buckets=16)
    home = pf._home(cfg, _walk_words(torch, ids, 0, "cpu")[0]).numpy()
    ids = np.concatenate([ids[home == 5][:4], ids[home == 0][:61]])
    empty = _walk_tables("pfarm")[1](pf.create(cfg, "cpu"))
    t, ok, _, e = _walk_compare(torch, "pfarm", "insert", cfg, empty, ids,
                                np.ones(len(ids), bool),
                                "crafted displacement, chain, full pool")
    t1, _, _, e2 = _walk_compare(torch, "pfarm", "insert", cfg, empty,
                                 ids[:25], np.ones(25, bool),
                                 "crafted displacement")
    _check(torch.equal(t1.keys[6, 0], _walk_words(torch, ids[:1], 0,
                                                  "cpu")[0][0]),
           "pfarm displaced an item into bucket 6")
    _check(int(t.ocount) == cfg.pool_blocks and not bool(ok.all()),
           "pfarm chained blocks until the pool was full")
    for op in ("update", "delete"):
        _, ok, _, e3 = _walk_compare(torch, "pfarm", op, cfg,
                                     _walk_tables("pfarm")[1](t), ids[::-1],
                                     np.ones(len(ids), bool), "crafted chain")
        _check(bool(ok.any()), f"pfarm {op} finds window and chain items")
        err = max(err, e3)
    err = max(err, e, e2)
    print(f"phase 3b: scan_walk equals its plain version in every mode "
          f"(level and pfarm insert/update/delete at B={WALK_B} on tables "
          f"at high load, masked, with duplicates; PM writes per op seen "
          f"{forced}); crafted states take level's move (5) and logged (4) "
          f"paths and pfarm's displacement, chain and full pool; "
          f"max_abs_err {err}", flush=True)
    return err


# ---------------------------------------------------------------------------
# phase 3c: the baselines at full size
# ---------------------------------------------------------------------------

def _clone(table):
    return type(table)(*(f.clone() for f in table))


def _walk_bytes(scheme, cfg, B, n_ok, pm_total) -> float:
    """Bytes the serial walk must move for B ops: each op's key, value and
    flag read and its ok and pm written; the candidate token bytes read
    (level 4, pfarm the window); per committed op one slot (32 B) and its
    token written; level's moves one more slot read and two written."""
    toks = 4 if scheme == "level" else cfg.window
    moves = (pm_total - 2 * n_ok) // 3 if scheme == "level" else 0
    return B * (16 + 16 + 1 + 8 + toks) + n_ok * 33 + moves * 99


def _walk_check(torch, scheme, op, cfg, table, ids, vseed, plain_dev):
    """One batch through the kernel on a clone of the loaded ``table`` and
    through the plain version on a copy on ``plain_dev`` ("cuda": the
    card's tensors; "cpu": a host copy, several times faster per op for
    large batches): every field, ok and pm must be equal.  Returns (ok,
    pm, plain seconds, max_abs_err)."""
    from repro_torch.kernels import scan_walk
    from repro_torch.kernels.scan_walk_ref import scan_walk_ref

    def words(dev):
        k, v = _walk_words(torch, ids, vseed, dev)
        return (k, None if op == "delete" else v,
                torch.ones(len(ids), dtype=torch.bool, device=dev))
    a = _clone(table)
    (okk, pmk), _ = _timed(torch, lambda: scan_walk.scan_walk(
        scheme, op, cfg, a, *words("cuda")))
    b = (_clone(table) if plain_dev == "cuda" else
         type(table)(*(f.cpu() for f in table)))
    x = words(plain_dev)
    (okp, pmp), t_plain = _timed(torch, lambda: scan_walk_ref(
        scheme, op, cfg, b, *x))
    same = all(torch.equal(f.to(g.device), g) for f, g in zip(a, b))
    del a, b
    torch.cuda.empty_cache()
    okk, pmk = okk.cpu(), pmk.cpu()
    err = max(int((okk - okp.cpu()).abs().max()),
              int((pmk - pmp.cpu()).abs().max()))
    _check(same and err == 0, f"scan_walk equals its plain version on the "
           f"full-size {scheme} table ({op}, B={len(ids)}, plain version on "
           f"{plain_dev})")
    return okk, pmk, t_plain, err


def _chase_us(torch, data, elem, steps, seed, before=None) -> float:
    """Median device µs per dependent load of the walk's latency chase over
    three seeds, ``before()`` run ahead of each (it sets the L2 state)."""
    from repro_torch.kernels import scan_walk
    us = []
    for r in range(3):
        if before is not None:
            before()
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s.record()
        scan_walk.chase(data, elem, steps, seed + r)
        e.record()
        e.synchronize()
        us.append(s.elapsed_time(e) * 1e3 / steps)
    return sorted(us)[1]


def _walk_floor(torch, scheme, table, card) -> dict:
    """The walk's latency floor on the loaded table: a dependent chain of
    random single-byte loads (one warp, ld.cg as the walk's) over its main
    token array, warm (just read through) and cold (after a pass over the
    slot keys), and over its slot keys (16 B apart); the chase is first
    held against its plain version on the same arrays."""
    from repro_torch.kernels import scan_walk
    from repro_torch.kernels.scan_walk_ref import chase_ref
    tok = table.ttok if scheme == "level" else table.tok
    slots = (table.tkeys if scheme == "level" else table.keys)
    slots = slots.view(torch.uint8).reshape(-1)
    for data, elem in ((tok, 1), (slots, 16)):
        got = scan_walk.chase(data, elem, 512, SEED + 9)
        _check(torch.equal(got.cpu(), chase_ref(data, elem, 512, SEED + 9)),
               f"the latency chase equals its plain version ({scheme}, "
               f"{data.numel()} bytes, element {elem} B)")
    def warm():
        torch.count_nonzero(tok)
    def cold():
        torch.count_nonzero(slots)
    out = {"tok_warm_us": _chase_us(torch, tok, 1, CHASE_STEPS, SEED + 10,
                                    warm),
           "tok_cold_us": _chase_us(torch, tok, 1, CHASE_COLD_STEPS,
                                    SEED + 20, cold),
           "slot_us": _chase_us(torch, slots, 16, CHASE_COLD_STEPS,
                                SEED + 30, cold)}
    print(f"scan_walk {scheme} latency floor (one warp, dependent random byte "
          f"loads): token array of {tok.numel()} B {out['tok_warm_us']:.4f} "
          f"us per load warm ({CHASE_STEPS} loads after a pass over it), "
          f"{out['tok_cold_us']:.4f} us cold ({CHASE_COLD_STEPS} loads after "
          f"a pass over the slot keys); slot keys ({slots.numel()} B, 16 B "
          f"apart) {out['slot_us']:.4f} us [{card}]", flush=True)
    return out


def _walk_timing(torch, scheme, store, table, card) -> tuple:
    """The serial walk on the loaded full-size table, uncounted: every mode
    held against the plain version on a clone and a host copy (insert at
    WALK_INSERT_CHECK_B, an eighth of the load's batch, for the smoke's
    time limit; update and delete at the main path's QUERY_B); then per
    mode one batch of WALK_B held against the plain version on the card's
    tensors (its time is the report's plain_ms), the
    kernel's device time over fresh batches of WALK_B, and its latency
    floor.  Returns ({op: numbers}, the floor, max_abs_err)."""
    from repro_torch.kernels import scan_walk
    cfg, rng = store.cfg, np.random.RandomState(SEED + 8)
    out, err = {}, 0
    for op in ("insert", "update", "delete"):
        B = WALK_INSERT_CHECK_B if op == "insert" else QUERY_B
        ids = (4 * N_RECORDS + np.arange(B) if op == "insert" else
               np.where(rng.rand(B) < 0.9, rng.choice(N_RECORDS, B),
                        N_RECORDS + rng.choice(N_RECORDS, B)))
        okk, pmk, t_plain, e = _walk_check(torch, scheme, op, cfg, table,
                                           ids, 100, "cpu")
        err = max(err, e)
        print(f"scan_walk {scheme} {op} equals its plain version at B={B} "
              f"on a clone of the full-size table ({int(okk.sum())} ops "
              f"committed, PM writes per op seen {sorted(set(pmk.tolist()))}"
              f"; plain version on a host copy {t_plain:.1f} s = "
              f"{t_plain / B * 1e6:.1f} us per op) [{card}]", flush=True)

        def timed_ids(i):
            return (2 * N_RECORDS + i * WALK_B + np.arange(WALK_B)
                    if op == "insert" else rng.choice(N_RECORDS, WALK_B))

        def batch(i):
            k, v = _walk_words(torch, timed_ids(i), i, "cuda")
            return (k, None if op == "delete" else v,
                    torch.ones(WALK_B, dtype=torch.bool, device="cuda"))
        okk, pmk, t_plain, e = _walk_check(torch, scheme, op, cfg, table,
                                           timed_ids(0), 0, "cuda")
        err = max(err, e)
        a = _clone(table)
        ms = _device_ms(torch, lambda z: scan_walk.scan_walk(scheme, op, cfg,
                                                             a, *z),
                        [batch(i) for i in range(1, 5)], 8, KERNEL_SLEEP)
        n_ok, pm_total = int(okk.sum()), int(pmk.sum())
        nbytes = _walk_bytes(scheme, cfg, WALK_B, n_ok, pm_total)
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        out[op] = {"ms": ms, "plain_ms": t_plain * 1e3, "bound_ms": bound_ms,
                   "us_per_op": ms * 1e3 / WALK_B}
        print(f"scan_walk {scheme} {op}: {ms * 1e3:.2f} us on the device per "
              f"launch at B={WALK_B} = {ms * 1e3 / WALK_B:.4f} us per op "
              f"(bound {bound_ms * 1e3:.3f} us from {nbytes / 1e6:.3f} MB; "
              f"plain version on the card's tensors {t_plain * 1e3:.1f} ms, "
              f"host clock), {n_ok} ops committed, equal to the plain "
              f"version [{card}]", flush=True)
        del a
        torch.cuda.empty_cache()
    return out, _walk_floor(torch, scheme, table, card), err


def baselines_phase(torch, api, ycsb, keys, vals, card) -> tuple:
    """Phase 3c: level and pfarm at the continuity cell's size, launches of
    the serial walk counted (its checks and timings run uncounted).
    Returns ({scheme: numbers}, launches, {scheme: ``_walk_timing``'s
    (timings, floor, max_abs_err)})."""
    from repro_torch.kernels import mutate, probe, scan_walk
    stats, timing = {}, {}
    for k in (probe.probe_segments, mutate.mutate_segments,
              scan_walk.scan_walk):
        k.launches = 0
    for scheme in ("level", "pfarm"):
        rng = np.random.RandomState(SEED + 7)
        store = api.make_store(scheme, table_slots=BASE_SLOTS, device="cuda")
        table = store.create()
        results, t_ins = _timed(torch, lambda: _load(store, table, keys,
                                                     vals))
        ok = torch.cat([r.ok for r in results])
        n_ok = int(ok.sum())
        pm = sum(int(r.ledger.pm_writes) for r in results)
        _check(sum(int(r.ledger.ops) for r in results) == N_RECORDS,
               f"{scheme}: the insert ledger counts every op")
        _check(int(table.count) == n_ok,
               f"{scheme}: table count equals acknowledged inserts")
        extra = (pm - 2 * n_ok) // 3 if scheme == "level" else 0
        _check(pm == (2 * n_ok + 3 * extra if scheme == "level"
                      else 5 * n_ok),
               f"{scheme}: Table I insert PM writes (level 2, 5 on a move; "
               f"pfarm 5)")
        info = (f"{extra} one-movement inserts" if scheme == "level" else
                f"{int(table.ocount)} of {store.cfg.pool_blocks} pool "
                f"blocks chained")
        print(f"{scheme} load: {n_ok} of {N_RECORDS} inserts acknowledged in "
              f"{len(results)} batches of {LOAD_BATCH}, {t_ins:.3f} s = "
              f"{N_RECORDS / t_ins:.0f} inserts/s "
              f"({t_ins / N_RECORDS * 1e6:.4f} us per insert), PM writes per "
              f"committed insert {pm / n_ok:.6f}, {info}, load factor "
              f"{float(store.load_factor(table)):.6f}, device memory in use "
              f"{torch.cuda.memory_allocated() / 2 ** 30:.3f} GiB [{card}]",
              flush=True)

        def readback():
            hit_all, reads = True, 0
            for s in range(0, N_RECORDS, READ_BATCH):
                res = store.lookup(table, keys[s:s + READ_BATCH])
                o = ok[s:s + READ_BATCH]
                hit_all &= bool(torch.equal(res.ok, o))
                hit_all &= bool(torch.equal(res.values[o],
                                            vals[s:s + READ_BATCH][o]))
                reads += int(res.ledger.rdma_reads)
            return hit_all, reads
        (hit_all, reads), t_read = _timed(torch, readback)
        _check(hit_all, f"{scheme}: every acknowledged insert reads back its "
               f"value, and no unacknowledged key is found")
        neg = store.lookup(table, ycsb.negative_keys(rng, N_RECORDS,
                                                     READ_BATCH))
        _check(not bool(neg.ok.any()), f"{scheme}: negative lookups miss")
        print(f"{scheme} read-back: {N_RECORDS} lookups, every acknowledged "
              f"key found with its value, {t_read:.3f} s = "
              f"{N_RECORDS / t_read:.0f} lookups/s; reads per lookup (verb "
              f"plans) {reads / N_RECORDS:.6f}, per negative lookup "
              f"{neg.ledger.reads_per_op():.6f} [{card}]", flush=True)

        # YCSB-A: zipf 0.99, 50 % reads / 50 % updates
        cur = vals.clone()
        t_rd = t_up = 0.0
        n_rd = n_up = 0
        for batch in ycsb.generate("A", N_RECORDS, YCSB_BATCHES * QUERY_B,
                                   QUERY_B, seed=SEED + 1):
            bids = _ycsb_ids(batch.keys)
            rsel, usel = batch.ops == ycsb.OP_READ, batch.ops == ycsb.OP_UPDATE
            rk = torch.from_numpy(batch.keys[rsel].view(np.int32)).cuda()
            ri = torch.from_numpy(bids[rsel]).cuda()
            res, t = _timed(torch, lambda: store.lookup(table, rk))
            t_rd += t
            n_rd += int(rsel.sum())
            _check(torch.equal(res.ok, ok[ri]) and torch.equal(
                res.values[res.ok], cur[ri][res.ok]),
                f"{scheme}: YCSB-A reads return the current values")
            uk, uv, ui = batch.keys[usel], batch.vals[usel], bids[usel]
            (_, ures), t = _timed(torch, lambda: store.update(table, uk, uv))
            t_up += t
            n_up += len(ui)
            uidx = torch.from_numpy(ui).cuda()
            _check(torch.equal(ures.ok, ok[uidx]), f"{scheme}: an update "
                   f"succeeds exactly where its key was acknowledged")
            uok = ures.ok.cpu().numpy()
            li = np.nonzero(uok)[0]
            li = li[_last_per_key(ui[li])]
            cur[torch.from_numpy(ui[li]).cuda()] = torch.from_numpy(
                uv[li].view(np.int32)).cuda()
        chk = store.lookup(table, keys[:READ_BATCH])
        _check(torch.equal(chk.values[chk.ok], cur[:READ_BATCH][chk.ok]),
               f"{scheme}: updated values read back")
        print(f"{scheme} YCSB-A: {n_rd} reads in {t_rd:.3f} s = "
              f"{n_rd / t_rd:.0f} lookups/s, {n_up} updates in {t_up:.3f} s "
              f"= {n_up / t_up:.0f} updates/s (batches of {QUERY_B}) "
              f"[{card}]", flush=True)

        # distinct-key update and delete batches: Table I
        acked = np.nonzero(ok.cpu().numpy())[0]
        pick = rng.choice(acked, 2 * QUERY_B, replace=False)
        pk, nv = ycsb.make_key(pick), ycsb.make_value(rng, QUERY_B)
        (_, ures), t_u = _timed(torch, lambda: store.update(
            table, pk[:QUERY_B], nv))
        _check(bool(ures.ok.all()), f"{scheme}: updates of live keys succeed")
        chk = store.lookup(table, pk[:QUERY_B])
        _check(bool(chk.ok.all()) and torch.equal(
            chk.values, torch.from_numpy(nv.view(np.int32)).cuda()),
            f"{scheme}: committed updates read back")
        count0 = int(table.count)
        (_, dres), t_d = _timed(torch, lambda: store.delete(
            table, pk[QUERY_B:]))
        _check(bool(dres.ok.all()) and int(table.count) == count0 - QUERY_B,
               f"{scheme}: deletes of live keys succeed")
        _check(not bool(store.lookup(table, pk[QUERY_B:]).ok.any()),
               f"{scheme}: deleted keys are gone")
        upm, dpm = int(ures.ledger.pm_writes), int(dres.ledger.pm_writes)
        table1 = (pm / n_ok, upm / QUERY_B, dpm / QUERY_B)
        if scheme == "pfarm":
            _check(table1 == (5.0, 5.0, 5.0), "Table I: pfarm 5 / 5 / 5")
            info = ""
        else:
            _check(2.0 <= table1[0] <= 2.01 and 2.0 <= table1[1] <= 4.0
                   and table1[2] == 1.0, "Table I: level 2 / 2-4 / 1")
            info = (f"; {extra} one-movement inserts, "
                    f"{(upm - 2 * QUERY_B) // 2} logged updates of "
                    f"{QUERY_B}")
        print(f"{scheme} Table I (PM writes per committed insert/update/"
              f"delete): {table1}{info}; distinct-key batches of {QUERY_B}: "
              f"update {t_u * 1e3:.3f} ms = {QUERY_B / t_u:.0f} updates/s, "
              f"delete {t_d * 1e3:.3f} ms = {QUERY_B / t_d:.0f} deletes/s "
              f"[{card}]", flush=True)
        stats[scheme] = {"table1": table1, "reads_per_lookup":
                         reads / N_RECORDS, "insert_ops_s": N_RECORDS / t_ins,
                         "lookup_ops_s": N_RECORDS / t_read,
                         "ycsb_update_ops_s": n_up / t_up,
                         "update_ops_s": QUERY_B / t_u}
        timing[scheme] = _uncounted(lambda: _walk_timing(
            torch, scheme, store, table, card))
        del table, results, ok, cur
        torch.cuda.empty_cache()
    launches = scan_walk.scan_walk.launches
    _check(launches > 0, "the baselines path launched scan_walk")
    _check(probe.probe_segments.launches == 0
           and mutate.mutate_segments.launches == 0,
           "the baselines run no continuity kernel")
    return stats, launches, timing


def table1_report(cont: dict, base: dict, card) -> None:
    rows = {"continuity": cont, **base}
    for name, r in rows.items():
        print(f"Table I {name}: PM writes per committed insert / update / "
              f"delete {r['table1'][0]:.6f} / {r['table1'][1]:.6f} / "
              f"{r['table1'][2]:.6f}; reads per lookup "
              f"{r['reads_per_lookup']:.6f}; {r['insert_ops_s']:.0f} "
              f"inserts/s, {r['lookup_ops_s']:.0f} lookups/s, "
              f"{r['ycsb_update_ops_s']:.0f} YCSB-A updates/s, "
              f"{r['update_ops_s']:.0f} distinct-key updates/s [{card}]",
              flush=True)
    _check(tuple(cont["table1"]) == (2.0, 2.0, 1.0),
           "Table I: continuity 2 / 2 / 1")


# ---------------------------------------------------------------------------
# phase 3d: the end-to-end YCSB simulator
# ---------------------------------------------------------------------------

def _e2e_order(cells) -> dict:
    """The orderings of tests/test_rdma.py::test_end_to_end_ordering_read_
    heavy on the cells given: {statement: holds}."""
    out = {}
    for wl in ("B", "C"):
        c, l, p = (cells[s][wl]["ops_per_s"] for s in E2E_SCHEMES)
        out[f"{wl}: continuity >= level >= pfarm ops/s"] = c >= l >= p
    for s in ("level", "pfarm"):
        out[f"C: continuity p99 <= {s} p99"] = (
            cells["continuity"]["C"]["p99_us"] <= cells[s]["C"]["p99_us"])
    return out


def e2e_phase(torch, card) -> int:
    """Phase 3d: ``run_ycsb`` on the card equals the CPU run at the small
    size for three schemes x A-F (the orderings checked there), then the
    scale-cut cells; returns the serial walk's launches on the card."""
    from repro_torch.kernels import mutate, probe, scan_walk
    from repro_torch.rdma import sim
    for k in (probe.probe_segments, mutate.mutate_segments,
              scan_walk.scan_walk):
        k.launches = 0
    small = {}
    for s in E2E_SCHEMES:
        for wl in sim.SIM_WORKLOADS:
            got = sim.run_ycsb(s, wl, device="cuda", **E2E_SMALL)
            want = sim.run_ycsb(s, wl, device="cpu", **E2E_SMALL)
            _check(list(got) == list(want) and all(
                abs(got[k] - w) <= 1e-12 * abs(w) for k, w in want.items()),
                f"run_ycsb on the card equals the CPU run ({s} {wl})")
            small.setdefault(s, {})[wl] = got
    order = _e2e_order(small)
    _check(all(order.values()), f"the paper's ordering at the small size "
           f"({order})")
    print(f"phase 3d: run_ycsb on the card equals the CPU run key for key "
          f"for {', '.join(E2E_SCHEMES)} x A-F at {E2E_SMALL}; orderings "
          f"hold there: {order}", flush=True)
    large = {}
    for s in E2E_SCHEMES:
        for wl in sim.SIM_WORKLOADS:
            res, t = _timed(torch, lambda: sim.run_ycsb(
                s, wl, device="cuda", **E2E_LARGE))
            _check(res["ops_per_s"] > 0 and 0 < res["p50_us"] <= res["p99_us"]
                   and all(np.isfinite(v) for v in res.values()),
                   f"finite simulated results ({s} {wl})")
            large.setdefault(s, {})[wl] = res
            print(f"e2e {s} {wl}: simulated by LinkModel: "
                  f"{res['ops_per_s']:.0f} ops/s, p50 {res['p50_us']:.4f} us, "
                  f"p99 {res['p99_us']:.4f} us, verbs/op "
                  f"{res['verbs_per_op']:.4f}; wall time on the card "
                  f"{t:.3f} s [{card}]", flush=True)
    print(f"e2e orderings at {E2E_LARGE} (simulated by LinkModel): "
          f"{_e2e_order(large)}", flush=True)
    launches = {"probe_segments": probe.probe_segments.launches,
                "mutate_segments": mutate.mutate_segments.launches,
                "scan_walk": scan_walk.scan_walk.launches}
    print(f"end-to-end path: kernel launches {launches}", flush=True)
    for name, n in launches.items():
        _check(n > 0, f"the end-to-end path launched {name}")
    return launches["scan_walk"]


# ---------------------------------------------------------------------------
# phase 3e: the continuity store's maintenance and crash-consistency surface
# ---------------------------------------------------------------------------

SERIAL_B = 2_048               # serial-oracle batches on the full-size table
SPLIT_SLO_US = 25.0            # begin_resize's stall target (4 cohorts/step)
SPLIT_STEPS = 300              # bounded online-split steps at full size
SPLIT_WRITES_EVERY = 10        # a routed write batch every this many steps
# the split run to completion, card vs CPU; its size is cut for the
# smoke's time limit (PERF.md section 4)
SMALL_SPLIT_BUCKETS = 2 ** 11
SMALL_SPLIT_LOAD = 0.9         # of its main slots: engages the stash tier


def _same_tables(torch, a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a, b))


def _ids_to_keys(torch, ycsb, ids):
    return torch.from_numpy(ycsb.make_key(np.asarray(ids)).view(
        np.int32)).cuda()


def _serial_vs_wave(torch, ch, cfg, table, op, keys, vals):
    """The serial oracle and the wave engine on twin clones of ``table``:
    every field, ok and the ledger must be equal.  Returns (µs per op of
    the oracle, committed ops)."""
    ts, tw = _clone(table), _clone(table)
    args = (keys,) if op == "delete" else (keys, vals)
    (_, oks, ls), t = _timed(
        torch, lambda: getattr(ch, f"{op}_serial")(cfg, ts, *args))
    _, okw, lw = getattr(ch, op)(cfg, tw, *args)
    _check(_same_tables(torch, ts, tw) and torch.equal(oks, okw)
           and [int(x) for x in ls] == [int(x) for x in lw],
           f"{op}_serial equals the wave engine in every field, ok and "
           f"the ledger")
    return t / keys.shape[0] * 1e6, int(oks.sum())


def _serial_small_stash(torch, ch, convert, ycsb) -> str:
    """The oracles on a small table whose inserts spill into the stash:
    card serial == card wave == CPU serial, for each op."""
    cfg = ch.ContinuityConfig(num_buckets=32, ext_frac=1.0, stash_frac=1 / 8)
    rng = np.random.RandomState(SEED + 31)
    out, stashed = [], {}
    for op in ("insert", "update", "delete"):
        n_base = 192 if op == "insert" else 448
        kb, vb = ycsb.make_key(np.arange(n_base)), ycsb.make_value(rng, n_base)
        start = n_base - 64 if op == "insert" else 0
        ids = np.arange(start, start + 512)
        ids[-64:] = start + rng.randint(0, 256, 64)
        K, V = ycsb.make_key(ids), ycsb.make_value(rng, 512)
        runs = []
        for dev, serial in (("cpu", True), ("cuda", True), ("cuda", False)):
            t = ch.create(cfg, dev)
            ch.insert(cfg, t, kb, vb)
            fn = getattr(ch, f"{op}_serial" if serial else op)
            _, ok, led = fn(cfg, t, *((K,) if op == "delete" else (K, V)))
            runs.append((convert.table_to_numpy(t), ok.cpu().numpy(),
                         [int(x) for x in led]))
        (tc, okc, lc), *rest = runs
        for tg, okg, lg in rest:
            _check(all(np.array_equal(tc[f], tg[f]) for f in tc)
                   and np.array_equal(okc, okg) and lc == lg,
                   f"small stash table: {op} on the card equals the CPU")
        stashed[op] = int((tc["stash_meta"] != 0).sum())
        out.append(f"{op} {int(okc.sum())} ok, stash {stashed[op]}")
    _check(stashed["insert"] > 0, "the small table engaged its stash")
    return "; ".join(out)


def _small_split(torch, api, convert, ycsb, dev):
    """The online split to completion on a small stash table."""
    store = api.make_store("continuity", num_buckets=SMALL_SPLIT_BUCKETS,
                           stash_frac=1 / 8, device=dev)
    cfg = store.cfg
    n = int(SMALL_SPLIT_LOAD * cfg.num_pairs * cfg.slots_per_pair)
    K = ycsb.make_key(np.arange(n))
    V = ycsb.make_value(np.random.RandomState(SEED + 32), n)
    t, _ = store.insert(store.create(), K, V)
    stash = int((t.stash_meta != 0).sum())
    pre = convert.table_to_numpy(t)

    def run():
        rs = store.begin_resize(t)
        while not rs.done:
            rs = store.resize_step(rs, budget=64)
        return rs, store.resize_cutover(rs)
    if dev == "cuda":
        (rs, (_, nt)), sec = _timed(torch, run)
    else:
        t0 = time.perf_counter()
        rs, (_, nt) = run()
        sec = time.perf_counter() - t0
    return (pre, convert.table_to_numpy(t), convert.table_to_numpy(nt),
            rs.moved, rs.n_items, stash, sec, cfg)


def _split_full(torch, api, ch, ycsb, store, table, keys, vals, ok, card):
    """(c) at full size: a bounded online split interleaved with routed
    writes and dual reads, checked against a host oracle.  Returns the
    resize state."""
    from repro_torch.rdma.transport import LinkModel
    cfg = store.cfg
    rng = np.random.RandomState(SEED + 33)
    rs = store.begin_resize(table, step_slo_us=SPLIT_SLO_US)
    budget = rs.step_budget
    limit = budget * SPLIT_STEPS                      # pairs that will move
    pair_all = ch.locate(cfg, keys)[0]
    near = (pair_all < limit).nonzero().squeeze(1).cpu().numpy()
    del pair_all
    fresh = N_RECORDS + np.arange(2 ** 20)
    fpair = ch.locate(cfg, _ids_to_keys(torch, ycsb, fresh))[0].cpu().numpy()
    fresh_near, fresh_far = fresh[fpair < limit], fresh[fpair >= limit]
    cur = vals.clone()                  # the value each record holds now
    live = ok.clone()
    fresh_ok = {}                       # acknowledged fresh inserts
    n_ins = n_del = 0
    step_ms = []
    for step in range(SPLIT_STEPS):
        if step % SPLIT_WRITES_EVERY == 0:
            far = rng.randint(0, N_RECORDS, 64)
            ids = np.unique(np.concatenate([rng.choice(near, 64), far]))
            rng.shuffle(ids)
            upd, dels = ids[: len(ids) // 2], ids[len(ids) // 2:]
            nv = ycsb.make_value(rng, len(upd))
            rs, r = store.resize_write(rs, "update",
                                       _ids_to_keys(torch, ycsb, upd), nv)
            sel = torch.from_numpy(upd).cuda()[r.ok]
            cur[sel] = torch.from_numpy(nv.view(np.int32)).cuda()[r.ok]
            rs, r = store.resize_write(rs, "delete",
                                       _ids_to_keys(torch, ycsb, dels))
            live[torch.from_numpy(dels).cuda()[r.ok]] = False
            n_del += int(r.ok.sum())
            ins = np.concatenate([fresh_near[:16], fresh_far[:16]])
            fresh_near, fresh_far = fresh_near[16:], fresh_far[16:]
            iv = ycsb.make_value(rng, len(ins))
            rs, r = store.resize_write(rs, "insert",
                                       _ids_to_keys(torch, ycsb, ins), iv)
            for i, v, o in zip(ins, iv, r.ok.cpu().numpy()):
                if o:
                    fresh_ok[int(i)] = v
            n_ins += int(r.ok.sum())
        rs, t = _timed(torch, lambda: store.resize_step(rs))
        step_ms.append(t * 1e3)
        if step % SPLIT_WRITES_EVERY == SPLIT_WRITES_EVERY - 1:
            probe_ids = np.concatenate([rng.choice(near, 256),
                                        rng.randint(0, N_RECORDS, 256)])
            lk = store.resize_lookup(rs, _ids_to_keys(torch, ycsb,
                                                      probe_ids))
            pi = torch.from_numpy(probe_ids).cuda()
            _check(torch.equal(lk.ok, live[pi]) and torch.equal(
                lk.values[lk.ok], cur[pi][lk.ok]),
                "mid-split dual reads find every live record with its "
                "current value and no deleted one")
    moved_pairs = rs.opaque.next_pair
    _check(moved_pairs == budget * SPLIT_STEPS, "each step moved its budget")
    # every record of a moved cohort: in the new table only, as the oracle
    kk = _ids_to_keys(torch, ycsb, near)
    pairs = ch.locate(cfg, kk)[0]
    moved = (pairs < moved_pairs).cpu().numpy()
    mk_ids, kk = near[moved], kk[torch.from_numpy(moved).cuda()]
    mi = torch.from_numpy(mk_ids).cuda()
    lk = store.resize_lookup(rs, kk)
    _check(torch.equal(lk.ok, live[mi]) and torch.equal(
        lk.values[lk.ok], cur[mi][lk.ok]),
        "every record of a moved cohort reads back as the oracle says")
    _check(not bool(ch.lookup(cfg, rs.table, kk).found.any()),
           "no moved record is left in the source table (no duplicate)")
    nstore = rs.new_store
    _check(torch.equal(nstore.lookup(rs.new_table, kk).ok, live[mi]),
           "the grown table holds exactly the live moved records")
    fids = np.asarray(sorted(fresh_ok))
    lk = store.resize_lookup(rs, _ids_to_keys(torch, ycsb, fids))
    want = torch.from_numpy(np.stack([fresh_ok[int(i)] for i in fids])
                            .view(np.int32)).cuda()
    _check(bool(lk.ok.all()) and torch.equal(lk.values, want),
           "every acknowledged insert during the split reads back")
    total = int(rs.table.count) + int(rs.new_table.count)
    _check(total == rs.n_items + n_ins - n_del,
           "nothing lost or duplicated: source + grown counts equal the "
           "records at begin + inserts - deletes")
    pred = LinkModel().cohort_move_us(
        read_bytes=float(cfg.row_bytes),
        write_bytes=float(cfg.row_bytes + 16)) * budget
    print(f"phase 3e (c): online split at full size, {SPLIT_STEPS} steps of "
          f"{budget} cohorts (step_slo_us {SPLIT_SLO_US}), {moved_pairs} of "
          f"{cfg.num_pairs} pairs moved ({rs.moved} records), routed writes "
          f"every {SPLIT_WRITES_EVERY} steps ({n_ins} inserts, {n_del} "
          f"deletes acknowledged), dual reads exact, {len(mk_ids)} moved "
          f"records checked; ms per step median "
          f"{float(np.median(step_ms)):.4f} (min {min(step_ms):.4f}, max "
          f"{max(step_ms):.4f}) = "
          f"{float(np.median(step_ms)) * 1e3 / budget:.2f} us per cohort on "
          f"the card, against LinkModel.cohort_move_us {pred:.4f} us per "
          f"step ({pred / budget:.4f} per cohort, a model of the RDMA + PM "
          f"stall, not a card time) [{card}]", flush=True)
    return rs


def _in_situ_segments(torch, run):
    """``run()`` with every segment-probe and mutation-plan kernel call on
    the card also computed by its plain version on the same operands,
    right after the launch and before the caller reads the result (which
    goes on; calls on CPU tensors run the plain version and pass through).
    Fails on the first difference.  Returns ``(run's result, checks)``:
    per kernel the calls checked, their batch sizes and table pairs, and
    the largest absolute difference.  The plain versions launch no
    kernel, so the launch counts stay the path's own."""
    from repro_torch.kernels import ops as K
    from repro_torch.kernels.mutate_ref import mutate_ref
    from repro_torch.kernels.probe_ref import probe_ref
    checks = {name: {"calls": 0, "batches": set(), "pairs": set(),
                     "max_abs_err": 0}
              for name in ("probe_segments", "mutate_segments")}

    def checked(name, kern, plain):
        def call(rows, *args):
            out = kern(rows, *args)
            if rows.device.type == "cpu":   # the plain version ran
                return out
            c = checks[name]
            for g, w in zip(out, plain(rows, *args)):
                d = (g.to(torch.int64) - w.to(torch.int64)).abs()
                c["max_abs_err"] = max(c["max_abs_err"],
                                       int(d.max()) if d.numel() else 0)
                _check(torch.equal(g, w), f"{name} equals its plain version "
                       f"on the maintenance path (B={g.shape[0]}, "
                       f"{rows.shape[0]} pairs)")
            c["calls"] += 1
            c["batches"].add(int(args[4].shape[0]))     # qkeys / pairs
            c["pairs"].add(int(rows.shape[0]))
            return out
        return call
    saved = K.probe_segments, K.mutate_segments
    K.probe_segments = checked("probe_segments", saved[0], probe_ref)
    K.mutate_segments = checked("mutate_segments", saved[1], mutate_ref)
    try:
        return run(), checks
    finally:
        K.probe_segments, K.mutate_segments = saved


def maintenance_phase(torch, api, ch, ycsb, keys, vals, card,
                      twins) -> tuple:
    """Phase 3e, with every store-kernel call held in place against its
    plain version; returns (its kernels' launch counts, set to 0 before;
    the in-place checks)."""
    from repro_torch.kernels import mutate, probe, scan_walk
    probe.probe_segments.launches = 0
    mutate.mutate_segments.launches = 0
    scan_walk.scan_walk.launches = 0
    _, checks = _in_situ_segments(torch, lambda: _maintenance(
        torch, api, ch, ycsb, keys, vals, card, twins))
    launches = {"probe_segments": probe.probe_segments.launches,
                "mutate_segments": mutate.mutate_segments.launches,
                "scan_walk": scan_walk.scan_walk.launches}
    for name, n in launches.items():
        _check(n > 0, f"the maintenance path launched {name}")
    for name, c in checks.items():
        _check(c["calls"] == launches[name] > 0, f"every {name} launch of "
               f"the maintenance path was held against its plain version")
        print(f"phase 3e: {name} held against its plain version at each of "
              f"its {c['calls']} launches on this path, batches "
              f"{sorted(c['batches'])}, tables of {sorted(c['pairs'])} "
              f"pairs, max_abs_err {c['max_abs_err']} [{card}]", flush=True)
    return launches, checks


def _maintenance(torch, api, ch, ycsb, keys, vals, card, twins) -> None:
    """The work of phase 3e, (a)-(d)."""
    from repro_torch import convert
    from repro_torch.consistency import matrix
    from repro_torch.core.words import u32
    store = api.make_store("continuity", num_buckets=NUM_BUCKETS,
                           stash_frac=0.0, device="cuda")
    cfg = store.cfg
    table = store.create()
    results, t_load = _timed(torch, lambda: _load(store, table, keys, vals))
    ok = torch.cat([r.ok for r in results])
    n_ok = int(ok.sum())
    print(f"phase 3e: full-size table loaded ({n_ok} of {N_RECORDS} items "
          f"in {t_load:.3f} s)", flush=True)

    # -- (a) the serial oracles against the wave engine -----------------
    rng = np.random.RandomState(SEED + 30)
    zipf = ycsb.Zipf(N_RECORDS)
    batches = {
        "insert": (N_RECORDS + np.arange(SERIAL_B),
                   N_RECORDS + zipf.sample(rng, SERIAL_B) % 1024),
        "update": (rng.choice(N_RECORDS, SERIAL_B, replace=False),
                   zipf.sample(rng, SERIAL_B)),
        "delete": (rng.choice(N_RECORDS, SERIAL_B, replace=False),
                   zipf.sample(rng, SERIAL_B)),
    }
    lines = []
    for op, pair_of_batches in batches.items():
        for kind, ids in zip(("distinct", "zipf"), pair_of_batches):
            k = _ids_to_keys(torch, ycsb, ids)
            v = torch.from_numpy(ycsb.make_value(rng, SERIAL_B).view(
                np.int32)).cuda()
            us, n = _serial_vs_wave(torch, ch, cfg, table, op, k, v)
            lines.append(f"{op} {kind} ({len(np.unique(ids))} distinct "
                         f"keys, {n} ok) {us:.2f} us/op")
    print(f"phase 3e (a): serial oracles equal the wave engine on twin "
          f"clones of the full-size table (every field, ok, ledger), "
          f"batches of {SERIAL_B}: {'; '.join(lines)} [{card}]", flush=True)
    print(f"phase 3e (a): small stash table, card serial == card wave == "
          f"CPU serial: {_serial_small_stash(torch, ch, convert, ycsb)}",
          flush=True)

    # -- (b) the batched resize at full size -----------------------------
    vmax = int(u32(table.version).max())
    (new_cfg, grown), t_rs = _timed(torch, lambda: ch.resize(cfg, table))
    _check(int(grown.count) == int(table.count) == n_ok,
           "resize keeps the count")
    _check(int(u32(grown.version).min()) > vmax,
           "every new version is above the old unsigned maximum")
    gstore = api.make_store("continuity", num_buckets=new_cfg.num_buckets,
                            stash_frac=0.0, device="cuda")
    _check(gstore.cfg == new_cfg, "the grown store has the resized geometry")

    def readback():
        hit = 0
        for s in range(0, N_RECORDS, READ_BATCH):
            res = gstore.lookup(grown, keys[s:s + READ_BATCH])
            o = ok[s:s + READ_BATCH]
            _check(torch.equal(res.ok, o) and torch.equal(
                res.values[o], vals[s:s + READ_BATCH][o]),
                "every record reads back from the grown table")
            hit += int(res.ok.sum())
        return hit
    hit, t_read = _timed(torch, readback)
    more = sum(x.numel() * x.element_size() for x in grown) - sum(
        x.numel() * x.element_size() for x in table)
    print(f"phase 3e (b): resize {cfg.num_buckets} -> {new_cfg.num_buckets} "
          f"buckets in {t_rs:.3f} s = {n_ok / t_rs:.0f} items/s "
          f"({more / 2 ** 30:.3f} GiB more), "
          f"{hit} of {N_RECORDS} keys read back with their values through "
          f"the probe kernel in {t_read:.3f} s (each launch checked against "
          f"the plain version in that time), count unchanged, versions "
          f"above {vmax} [{card}]", flush=True)
    del grown
    torch.cuda.empty_cache()

    # -- (c) the online split: bounded at full size, then to completion --
    rs = _split_full(torch, api, ch, ycsb, store, table, keys, vals, ok, card)
    del rs, table
    torch.cuda.empty_cache()
    gpu = _small_split(torch, api, convert, ycsb, "cuda")
    cpu = twins.get("3e", "small split")[0]
    _check(all(np.array_equal(a[f], b[f]) for a, b in zip(gpu[:3], cpu[:3])
               for f in a), "the small split on the card equals the CPU's "
           "byte for byte (source, drained source, grown table)")
    _check(gpu[3] == gpu[4] == cpu[3] and gpu[5] > 0,
           "moved == n_items, with the stash engaged")
    print(f"phase 3e (c): split to completion + cutover, "
          f"{SMALL_SPLIT_BUCKETS} buckets at load {SMALL_SPLIT_LOAD} (stash "
          f"1/8, {gpu[5]} stash entries), {gpu[3]} of {gpu[4]} records "
          f"moved over {gpu[7].num_pairs} cohorts: card {gpu[6]:.3f} s, CPU "
          f"{cpu[6]:.3f} s (in the twins' process), tables byte-equal "
          f"[{card}]", flush=True)

    # -- (d) crash consistency: the matrix and the baselines' resize -----
    rows_gpu, t_mat = _timed(torch, lambda: matrix.run_rows(device="cuda"))
    rows_cpu = matrix.run_rows(device="cpu")
    _check(rows_gpu == rows_cpu, "every crash-matrix row on the card "
           "equals the CPU's")
    _check(all(r["ok"] for r in rows_gpu), "every cell meets its expectation")
    cont = [r for r in rows_gpu if r["scheme"] == "continuity"]
    _check(all(r["log_used_points"] == 0 and r["trace_log_records"] == 0
               for r in cont), "continuity recovers with zero log records")
    K = ycsb.make_key(np.arange(600))
    V = ycsb.make_value(np.random.RandomState(SEED + 34), 600)
    for scheme in ("level", "pfarm", "dense"):
        out = []
        for dev in ("cpu", "cuda"):
            st = api.make_store(scheme, table_slots=1000, device=dev)
            t, _ = st.insert(st.create(), K, V)
            _, nt = st.resize_cutover(st.begin_resize(t))
            out.append(getattr(convert, f"{scheme}_table_to_numpy")(nt))
        _check(all(np.array_equal(out[0][f], out[1][f]) for f in out[0]),
               f"{scheme}'s one-step resize on the card equals the CPU's")
    print(f"phase 3e (d): crash matrix on the card equals the CPU row for "
          f"row ({len(rows_gpu)} cells, "
          f"{sum(r['crash_points'] for r in rows_gpu)} crash states, "
          f"{t_mat:.3f} s): " + "; ".join(
              f"{r['scheme']}/{r['op']} {r['crash_points']}/"
              f"{r['torn_points']}/{r['violations']}/{r['log_used_points']}/"
              f"{r['recovery']['duplicates_cleared']} "
              f"{'PASS' if r['ok'] else 'FAIL'}" for r in rows_gpu)
          + "; level, pfarm and dense one-step resize card == CPU", flush=True)


def sim_batcher_check(torch, card) -> None:
    """(e): the batcher under ``ExecPolicy(transport="sim")`` posts the
    same plans on the card as on the CPU."""
    from repro_torch.api import ExecPolicy
    from repro_torch.configs import smoke_config
    from repro_torch.models import transformer as T
    from repro_torch.models.config import ShapeConfig
    from repro_torch.serving import kvcache as KC
    from repro_torch.serving.scheduler import ContinuousBatcher, Request
    cfg = smoke_config("yi-6b")
    params = T.init_params(cfg, torch.Generator().manual_seed(SEED))
    stats = []
    for dev in ("cpu", "cuda"):
        p = {k: v.to(dev) for k, v in params.items() if k != "blocks"}
        p["blocks"] = {k: v.to(dev) for k, v in params["blocks"].items()}
        geom = KC.make_geometry(cfg, ShapeConfig("s", seq_len=128,
                                                 global_batch=4,
                                                 kind="decode"),
                                shards=2, page_size=16,
                                policy=ExecPolicy(transport="sim"),
                                device=dev)
        b = ContinuousBatcher(cfg, geom, p)
        rng = np.random.RandomState(SEED + 35)
        for rid in range(7):
            b.submit(Request(rid=rid, prompt=rng.randint(
                0, cfg.vocab, size=int(rng.randint(3, 10))).astype(np.int32),
                max_new_tokens=4 + rid % 3))
        b.run(max_steps=300)
        stats.append(b.transport.stats())
    _check(stats[0] == stats[1] and stats[0]["posts"] > 0,
           "the batcher's sim transport counters on the card equal the CPU's")
    s = stats[1]
    print(f"phase 3e (e): batcher under ExecPolicy(transport='sim'): "
          f"{s['posts']} posts, {s['doorbells']} doorbells, {s['verbs']} "
          f"verbs, {s['bytes']} bytes, {s['simulated_us']:.3f} simulated us "
          f"(LinkModel), card == CPU [{card}]", flush=True)


# ---------------------------------------------------------------------------
# phase 3f: the cluster
# ---------------------------------------------------------------------------

CLUSTER_RECORDS = 50_331_648   # the paper's record count (§V-A)
CLUSTER_OPS = 196_608          # 3 rounds of YCSB-A (cut from 4)
CLUSTER_BATCH = 65_536
SPILL_NODE_SLOTS = 280         # (a)'s stash cell: nodes this small spill


def _stash_cell(d):
    """The --smoke cell on default-stash nodes small enough to spill."""
    from repro_torch.cluster import sim
    return sim.run_cluster(device=d, node_slots=SPILL_NODE_SLOTS,
                           **sim.smoke_kwargs(True))


def _cluster_runs() -> dict:
    """(a)'s runs, each ``fn(device)``."""
    from repro_torch.cluster import sim
    from repro_torch.consistency import matrix
    return {
        "run_cluster": lambda d: sim.run_cluster(device=d,
                                                 **sim.smoke_kwargs(True)),
        "durability_drill": lambda d: sim.durability_drill(device=d),
        "migration_drill": lambda d: sim.migration_drill(device=d),
        "matrix.run_rows": lambda d: matrix.run_rows(device=d),
        "stash cell": _stash_cell,
    }


def _card_vs_twins(torch, phase, runs, twins) -> tuple:
    """Each run on the card against its CPU twin, field for field: returns
    ({name: card payload}, timing lines)."""
    out, lines = {}, []
    for name, fn in runs.items():
        gpu, t_gpu = _timed(torch, lambda: fn("cuda"))
        cpu, t_cpu = twins.get(phase, name)
        _check(gpu == cpu, f"{name} on the card equals the CPU's payload")
        out[name] = gpu
        lines.append(f"{name} card {t_gpu:.2f} s / CPU {t_cpu:.2f} s")
    return out, lines


def _cluster_small(torch, card, twins) -> str:
    """(a): at the reference's smoke sizes, every payload on the card
    equals the CPU's, field for field."""
    from repro_torch import api
    out, lines = _card_vs_twins(torch, "3f", _cluster_runs(), twins)
    cell = out["run_cluster"]
    _check(cell["committed"] == 600 and cell["committed_lost"] == 0
           and cell["rebalance_within_bound"] and cell["failover_detected"],
           "the smoke cell: 600 committed, 0 lost, join within bound, "
           "failover detected")
    _check(out["durability_drill"]["ok"] and out["migration_drill"]["ok"],
           "both drills pass")
    rows = out["matrix.run_rows"]
    _check(len(rows) == 14 and all(r["ok"] for r in rows)
           and "migrate" in [r["op"] for r in rows],
           "the crash matrix: 14 rows, migrate included, every cell passes")
    spill = out["stash cell"]
    cfg = api.make_store("continuity", table_slots=SPILL_NODE_SLOTS,
                         device="cpu").cfg
    room = (cfg.num_pairs * cfg.slots_per_pair
            + cfg.ext_pool_pairs * cfg.ext_slots)
    over = {n: st["resident"] for n, st in spill["stats"]["nodes"].items()
            if not st["resizing"] and st["resident"] > room}
    _check(over, "a node of the stash cell holds more items than its main "
           "and extension slots (its stash entries are live)")
    join = next(e for e in cell["events"] if e["event"] == "join")
    print(f"phase 3f (a): card == CPU field for field (the CPU in the "
          f"twins' process): {'; '.join(lines)}; "
          f"smoke cell {cell['committed']} committed, "
          f"{cell['committed_lost']} lost, join moved_frac "
          f"{join['moved_frac']:.4f} <= {join['bound']}, "
          f"{cell['ops_per_s']:.0f} simulated ops/s (LinkModel); "
          f"crash matrix {len(rows)} rows; stash cell (node_slots "
          f"{SPILL_NODE_SLOTS}, {room} main + extension slots): residents "
          f"above that {over}, {spill['committed_lost']} of "
          f"{spill['committed']} acked values read back otherwise (a "
          f"member that refuses an update another member applied) [{card}]",
          flush=True)
    return cell


def _cluster_full(torch, card) -> str:
    """(b): the full-size cluster — the deployment the reference's
    ``run_cluster`` describes at the paper's record count; its checks
    made, returns its report line."""
    from repro_torch import api
    from repro_torch.cluster import sim
    kw = dict(num_records=CLUSTER_RECORDS, num_ops=CLUSTER_OPS,
              batch=CLUSTER_BATCH, nodes=4, replicas=2, seed=SEED,
              events=(("join", CLUSTER_OPS // 3, "pmJ"),
                      ("kill", 2 * CLUSTER_OPS // 3, "primary")))
    slots = sim._node_slots("A", CLUSTER_BATCH, CLUSTER_RECORDS, CLUSTER_OPS,
                            4, 2)
    cfg = api.make_store("continuity", table_slots=slots, device="cpu").cfg
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    tm = {}
    cell, t_all = _timed(torch, lambda: sim.run_cluster(
        "continuity", "A", device="cuda", timings=tm, **kw))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    join = next(e for e in cell["events"] if e["event"] == "join")
    fail = [e for e in cell["events"] if e["event"] == "failover"]
    rounds = ", ".join(f"{1e3 * t:.1f}" for t in tm["round"])
    # YCSB-A's one update batch per round: its pre-batch read (`_peek`)
    peeks = ", ".join(f"{1e3 * p:.1f} ms ({p / t:.4f} of its round)"
                      for p, t in zip(tm["peek"], tm["round"]))
    line = (f"phase 3f (b): cluster of 4 nodes (+ pmJ), R 2, continuity "
          f"{cfg.num_pairs} pairs / {cfg.stash_slots} stash slots per node "
          f"(node_slots {slots}), {CLUSTER_RECORDS} records, YCSB-A zipf "
          f"0.99, {CLUSTER_OPS} ops in batches of {CLUSTER_BATCH}: load "
          f"{tm['load'][0]:.3f} s; rounds {rounds} ms; join copy "
          f"{tm['join_copy'][0]:.3f} s, cutover + cleanup "
          f"{tm['join_cutover'][0]:.3f} s, moved_frac "
          f"{join['moved_frac']:.6f} (bound {join['bound']}), copied "
          f"{join['copied']}, cleaned {join['cleaned']}; failover "
          f"{sum(tm['failover']):.3f} s {fail}; audit {tm['audit'][0]:.3f} "
          f"s; committed {cell['committed']}, lost {cell['committed_lost']}, "
          f"replicas rewritten by the torn-update repair "
          f"{tm['torn_repaired'][0]}, its pre-batch reads {peeks}; "
          f"maintenance {cell['maintenance']}; LinkModel "
          f"{cell['ops_per_s']:.0f} simulated ops/s, p50 "
          f"{cell['p50_us']:.4f} us, p99 {cell['p99_us']:.4f} us; whole "
          f"cell {t_all:.1f} s; peak device memory {peak:.3f} GiB [{card}]")
    _check(cell["committed"] == CLUSTER_RECORDS,
           "every record of the load acknowledged")
    _check(cell["committed_lost"] == 0, "zero committed-op loss")
    _check(join["moved_frac"] <= 1 / 5 + 0.05 and
           cell["rebalance_within_bound"], "the join moved <= 1/N + 5 %")
    _check(cell["failover_detected"] and len(fail) == 1 and
           fail[0]["recovery_log_free"], "the kill was detected and "
           "promoted with log-free recovery")
    return line


def _cluster_full_main(queue) -> None:
    """(b) in a process of its own on the card, started with phase 3d and
    read after phase 3g (host-bound, as the phases beside it; none of them
    times a kernel): (its report line, launches, in-place checks), the
    launch counts set to 0 just before."""
    def run():
        sys.path.insert(0, str(ROOT / "src"))
        import torch
        from repro_torch.kernels import mutate, probe
        probe.probe_segments.launches = 0
        mutate.mutate_segments.launches = 0
        t0 = time.perf_counter()
        line, checks = _in_situ_segments(
            torch, lambda: _cluster_full(torch, _smi()))
        torch.cuda.empty_cache()       # hold no memory while it waits
        return (line, time.perf_counter() - t0,
                {"probe_segments": probe.probe_segments.launches,
                 "mutate_segments": mutate.mutate_segments.launches}, checks)
    _child_result(queue, run)


def cluster_phase(torch, card, twins) -> tuple:
    """Phase 3f (a), with every store-kernel call held in place against
    its plain version; returns (its kernels' launch counts, set to 0
    before; the in-place checks)."""
    from repro_torch.kernels import mutate, probe, scan_walk
    probe.probe_segments.launches = 0
    mutate.mutate_segments.launches = 0
    scan_walk.scan_walk.launches = 0
    _, checks = _in_situ_segments(
        torch, lambda: _cluster_small(torch, card, twins))
    return {"probe_segments": probe.probe_segments.launches,
            "mutate_segments": mutate.mutate_segments.launches}, checks


def cluster_finish(card, full, launches, checks) -> None:
    """Phase 3f's end: (b)'s report from its process (``full``), its
    launches and in-place checks added to (a)'s (``launches``,
    ``checks``, updated), and every launch of the path shown checked."""
    line, seconds, full_launches, full_checks = full.result()
    print(f"{line}; in its own process on the card from phase 3d on, "
          f"{seconds:.1f} s", flush=True)
    for name, c in full_checks.items():
        launches[name] += full_launches[name]
        mine = checks[name]
        mine["calls"] += c["calls"]
        mine["batches"] |= c["batches"]
        mine["pairs"] |= c["pairs"]
        mine["max_abs_err"] = max(mine["max_abs_err"], c["max_abs_err"])
    for name, n in launches.items():
        _check(n > 0, f"the cluster path launched {name}")
    for name, c in checks.items():
        _check(c["calls"] == launches[name] > 0, f"every {name} launch of "
               f"the cluster path was held against its plain version")
        print(f"phase 3f: {name} held against its plain version at each of "
              f"its {c['calls']} launches on this path, batches "
              f"{min(c['batches'])}-{max(c['batches'])}, tables of "
              f"{sorted(c['pairs'])} pairs, max_abs_err {c['max_abs_err']} "
              f"[{card}]", flush=True)


# ---------------------------------------------------------------------------
# phase 3g: the client cache and the chaos matrix
# ---------------------------------------------------------------------------

FANIN_RECORDS = 50_331_648     # phase 3f (b)'s record count (paper §V-A)
FANIN_LOAD_BATCH = 65_536      # (b)'s insert batch (the reference: 256)
FANIN_EVENTS = ["partition", "stale", "heal", "resync", "join", "kill",
                "failover"]


def _cache_runs() -> dict:
    """(a)'s runs, each ``fn(device)``."""
    from repro_torch.cache import fanin
    from repro_torch.chaos import matrix
    return {
        "fan-in --smoke": lambda d: fanin.run_fanin(
            device=d, **fanin.smoke_kwargs(True)),
        "chaos matrix": lambda d: matrix.run_matrix(
            seed=0, profile="smoke", verbose=False, device=d),
    }


def _cache_small_main(queue) -> None:
    """(a)'s card runs in a process of their own on the card, while the
    parent drives (b): ({name: (payload, seconds)}, launches, in-place
    checks), the launch counts set to 0 just before."""
    def run():
        sys.path.insert(0, str(ROOT / "src"))
        import torch
        from repro_torch.kernels import mutate, probe
        probe.probe_segments.launches = 0
        mutate.mutate_segments.launches = 0
        out, checks = _in_situ_segments(torch, lambda: {
            name: _timed(torch, lambda: fn("cuda"))
            for name, fn in _cache_runs().items()})
        return out, {"probe_segments": probe.probe_segments.launches,
                     "mutate_segments": mutate.mutate_segments.launches}, \
            checks
    _child_result(queue, run)


def _cache_small(card, twins, runs) -> None:
    """(a): the reference's own cells — the fan-in ``--smoke`` cell and the
    chaos grid at seed 0 with the ``smoke`` profile — on the card (``runs``:
    {name: (payload, seconds)}) equal to the CPU in every payload field,
    with their gates met."""
    from repro_torch.cache import fanin
    out, lines = {}, []
    for name, (gpu, t_gpu) in runs.items():
        cpu, t_cpu = twins.get("3g", name)
        _check(gpu == cpu, f"{name} on the card equals the CPU's payload")
        out[name] = gpu
        lines.append(f"{name} card {t_gpu:.2f} s / CPU {t_cpu:.2f} s")
    cell, grid = out["fan-in --smoke"], out["chaos matrix"]
    bad = fanin.check_gates(cell)
    _check(not bad, f"the fan-in cell's gates hold ({bad})")
    _check(grid["ok"] and all(grid["gates"].values())
           and len(grid["cells"]) == 14, "the chaos matrix: 14 cells, "
           "every gate holds")
    un, ca = cell["uncached"], cell["cached"]
    t = grid["totals"]
    print(f"phase 3g (a): card == CPU field for field (the card's runs "
          f"in a second process beside (b), the CPU's in the twins' "
          f"process): {'; '.join(lines)}; "
          f"fan-in 100 clients x 14 rounds x 16 ops, 1,200 records: hit rate "
          f"{ca['hit_rate']:.4f} (floor {fanin.GATES['hit_rate_floor']}), "
          f"read doorbells {un['read_doorbells']} -> {ca['read_doorbells']} "
          f"({cell['doorbell_reduction']:.4f}x), LinkModel p99 "
          f"{un['p99_us']:.4f} -> {ca['p99_us']:.4f} us (ratio "
          f"{cell['p99_ratio']:.4f}), stale served {ca['stale_served']}; "
          f"chaos matrix {len(grid['cells'])} cells ok, lost "
          f"{t['committed_lost']}, stale acks {t['stale_acks_detected']}/"
          f"{t['stale_acks_injected']}, retries {t['retries']:.0f}, give-ups "
          f"{t['give_ups']:.0f} [{card}]", flush=True)


def _cache_full(torch, card) -> dict:
    """(b): the fan-in cell at the deployment's record count, every other
    parameter the ``--smoke`` cell's.  The guarantees are checked; hit
    rate, reductions and p99 are recorded, not gated."""
    from repro_torch import api
    from repro_torch.cache import fanin
    kw = dict(fanin.smoke_kwargs(True), num_records=FANIN_RECORDS)
    slots = int(FANIN_RECORDS * 2 / 4 * 2.5) + 256
    cfg = api.make_store("continuity", table_slots=slots, device="cpu").cfg
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    tm = {}
    cell, t_all = _timed(torch, lambda: fanin.run_fanin(
        "continuity", device="cuda", load_batch=FANIN_LOAD_BATCH,
        timings=tm, **kw))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    un, ca = cell["uncached"], cell["cached"]

    def secs(part):
        return ", ".join(f"{sum(tm[m].get(part, [])):.3f}"
                         for m in ("uncached", "cached"))
    ev = {e["event"]: e for e in ca["events"]}
    print(f"phase 3g (b): fan-in at {FANIN_RECORDS} records, 4 nodes (+ "
          f"pmJ), R 2, continuity {cfg.num_pairs} pairs / "
          f"{cfg.stash_slots} stash slots per node (node_slots {slots}), "
          f"100 clients x 14 rounds x 16 ops, 2 writes per round, hotspot "
          f"0.02 / 0.95, capacity 128, budget 12, trust_window 0: hit rate "
          f"{ca['hit_rate']:.4f}, read doorbells {un['read_doorbells']} -> "
          f"{ca['read_doorbells']} ({cell['doorbell_reduction']:.4f}x), "
          f"read bytes {un['read_bytes']} -> {ca['read_bytes']} "
          f"({cell['bytes_reduction']:.4f}x), LinkModel p50 "
          f"{un['p50_us']:.4f} -> {ca['p50_us']:.4f} us, p99 "
          f"{un['p99_us']:.4f} -> {ca['p99_us']:.4f} us (ratio "
          f"{cell['p99_ratio']:.4f}); gates as recorded, not held here: "
          f"{fanin.check_gates(cell)}; stale served {ca['stale_served']}, "
          f"wrong reads {un['wrong_reads']} / {ca['wrong_reads']}, "
          f"unserved {un['unserved']} / {ca['unserved']}; cache "
          f"{ca['cache']}; events {ca['events']}; host seconds (uncached, "
          f"cached): load {tm['load'][0]:.3f} (shared), clone "
          f"{tm['clone'][0]:.3f}, rounds {secs('round')} (of them the "
          f"clients' reads {secs('reads')}), resync {secs('resync')}, join "
          f"copy {secs('join_copy')} + cutover {secs('join_cutover')}, "
          f"failover {secs('failover')}; whole cell {t_all:.1f} s; peak "
          f"device memory {peak:.3f} GiB [{card}]", flush=True)
    for name, p in (("uncached", un), ("cached", ca)):
        _check([e["event"] for e in p["events"]] == FANIN_EVENTS,
               f"the {name} pass fired the whole chaos schedule")
        _check(p["wrong_reads"] == 0, f"no wrong read in the {name} pass")
        ch = p["chaos"]
        _check(ch["stale_acks_detected"] == ch["stale_acks_injected"] > 0,
               f"every stale ack of the {name} pass detected")
        pe = {e["event"]: e for e in p["events"]}
        _check(pe["join"]["within_bound"], f"the {name} pass's join moved "
               f"<= 1/N + 5 %")
        _check(pe["failover"]["recovery_log_free"], f"the {name} pass's "
               f"failover recovered log-free")
    _check(ca["stale_served"] == 0, "the cache served no stale read")
    _check(cell["stream_check"]["ok"], "the request stream's self-check")
    _check(ev["resync"]["stale_acks_detected"]
           == ev["stale"]["acks_injected"], "resync detected every stale ack")
    return cell


def cache_phase(torch, card, twins) -> tuple:
    """Phase 3g, with every store-kernel call held in place against its
    plain version: (a)'s card runs in a second process on the card while
    this one drives (b) (both are host-bound; neither times a kernel).
    Returns (its kernels' launch counts, set to 0 before in both
    processes and summed; the in-place checks, merged)."""
    from repro_torch.kernels import mutate, probe, scan_walk
    probe.probe_segments.launches = 0
    mutate.mutate_segments.launches = 0
    scan_walk.scan_walk.launches = 0
    small = _Child(_cache_small_main, "phase 3g (a) on the card")
    try:
        _, checks = _in_situ_segments(torch, lambda: _cache_full(torch, card))
        runs, small_launches, small_checks = small.result()
    finally:
        small.stop()
    _cache_small(card, twins, runs)
    launches = {"probe_segments": probe.probe_segments.launches,
                "mutate_segments": mutate.mutate_segments.launches}
    for name, c in small_checks.items():
        launches[name] += small_launches[name]
        mine = checks[name]
        mine["calls"] += c["calls"]
        mine["batches"] |= c["batches"]
        mine["pairs"] |= c["pairs"]
        mine["max_abs_err"] = max(mine["max_abs_err"], c["max_abs_err"])
    for name, n in launches.items():
        _check(n > 0, f"the cache and chaos path launched {name}")
    for name, c in checks.items():
        _check(c["calls"] == launches[name] > 0, f"every {name} launch of "
               f"the cache and chaos path was held against its plain version")
        _check(c["max_abs_err"] == 0, f"{name} exact on the cache path")
        print(f"phase 3g: {name} held against its plain version at each of "
              f"its {c['calls']} launches on this path, batches "
              f"{min(c['batches'])}-{max(c['batches'])}, tables of "
              f"{sorted(c['pairs'])} pairs, max_abs_err {c['max_abs_err']} "
              f"[{card}]", flush=True)
    return launches, checks


# ---------------------------------------------------------------------------
# phase 4: the paged-attention kernel against its plain version
# ---------------------------------------------------------------------------

def _attn_case(torch, seed, B, H, KVH, D, PS, MAXP, NP=None, lens=None,
               dtype=None, q_scale=0.5):
    """Pool pages shuffled and mapped for each sequence's live length, the
    rest of the table unmapped (-1); on the card in ``dtype``.  Scores have
    std ``q_scale * 0.3``."""
    rng = np.random.RandomState(seed)
    NP = NP or B * MAXP + 2
    g = torch.Generator("cuda").manual_seed(seed)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device="cuda") * scale).to(
            dtype)
    q, kp, vp = randn(B, H, D, scale=q_scale), \
        randn(NP, KVH, PS, D, scale=0.3), \
        randn(NP, KVH, PS, D)
    lens = np.asarray(lens if lens is not None
                      else rng.randint(1, MAXP * PS, size=B), np.int32)
    pt = np.full((B, MAXP), -1, np.int32)
    live = -(-lens // PS)
    ids = rng.permutation(NP)[:int(live.sum())]
    for b in range(B):
        pt[b, :live[b]] = ids[live[:b].sum():live[:b + 1].sum()]
    return (q, kp, vp, torch.from_numpy(pt).cuda(),
            torch.from_numpy(lens).cuda())


def _attn_limit(want) -> float:
    """The bf16 limit at the serving shape: 6e-2, and at most ``ATTN_REL``
    of the largest plain output."""
    return min(ATTN_TOL["bfloat16"], ATTN_REL * float(want.abs().max()))


ATTN_ITEM = {"bf16": 2, "float32": 4, "int8": 1}   # bytes per K/V value


def _attn_bytes(mode, B, H, KVH, D, MAXP, last) -> int:
    """The bytes a decode attention step must move in ``mode`` (the K/V
    pools' dtype): each live token's K and V rows once, with their float32
    scales when int8; q and out (float32 in the float32 mode, else bf16);
    the page table and the lengths."""
    scales = 2 * 4 if mode == "int8" else 0
    q_item = 4 if mode == "float32" else 2
    return (B * last * KVH * (2 * D * ATTN_ITEM[mode] + scales)
            + 2 * B * H * D * q_item + B * MAXP * 4 + B * 4)


def _quantized(a):
    """An attention case ``(q, kpool, vpool, pt, lens)`` with its pools
    through ``quant_store``: (args, {"kscale", "vscale"})."""
    from repro_torch.serving import kvcache as KC
    q, kp, vp, pt, lens = a
    (kq, ks), (vq, vs) = KC.quant_store(kp), KC.quant_store(vp)
    return (q, kq, vq, pt, lens), {"kscale": ks, "vscale": vs}


def _dense(a):
    """An attention case's query and live tokens laid out as a dense (B,
    KVH, T, D) cache (every sequence of one length): the operands of
    ``scaled_dot_product_attention``."""
    q, kp, vp, pt, lens = a
    _, KVH, PS, D = kp.shape
    T_ = int(lens[0])
    idx = pt[:, :-(-T_ // PS)].long()
    return (q[:, :, None], *(x[idx].permute(0, 2, 1, 3, 4).reshape(
        len(q), KVH, -1, D)[:, :, :T_].contiguous() for x in (kp, vp)))


def attention_timing(torch, B, H, KVH, D, MAXP, NP, last, seed, card,
                     dtype=None):
    """The kernel at one decode shape (``B`` sequences of ``last`` tokens
    on a pool of ``NP`` pages, in ``dtype``: bf16 by default, or float32,
    the CUDA-core loop; scores of std 1.2): held within ``_attn_limit``
    (float32: 2e-5) of its plain version, a limit that an output one
    token or one page short is shown to break; timed on the device beside
    its bound, its plain version and ``scaled_dot_product_attention`` in
    the same dtype over the same tokens laid out densely.  Returns
    (max_abs_err, ms, plain_ms, bound_ms, library_ms)."""
    from repro_torch.kernels import _cuda, paged_attn
    from repro_torch.kernels.paged_attn_ref import paged_attention_ref
    kern, plain = paged_attn.paged_attention, paged_attention_ref
    PS = PAGE_SIZE
    dtype = dtype or torch.bfloat16
    f32 = dtype == torch.float32
    sdpa = torch.nn.functional.scaled_dot_product_attention
    batches = [_attn_case(torch, seed + i, B, H, KVH, D, PS, MAXP, NP=NP,
                          lens=[last] * B, dtype=dtype,
                          q_scale=4.0) for i in range(4)]
    full = batches[0]
    want = plain(*full).float()
    limit = ATTN_TOL["float32"] if f32 else _attn_limit(want)
    e_full = float((kern(*full).float() - want).abs().max())
    _check(e_full <= limit, f"B={B} H={H} D={D} {dtype} paged attention "
           f"within {limit:.3g} of its plain version ({e_full})")
    q, kp, vp, pt, lens = full
    for cut, what in ((1, "its last token"), (PS, "its last page")):
        moved = float((plain(q, kp, vp, pt, lens - cut).float() - want)
                      .abs().max())
        _check(moved > limit, f"the B={B} H={H} D={D} limit rejects an "
               f"output that drops {what} ({moved} vs {limit:.3g})")
    ms = _device_ms(torch, lambda a: kern(*a), batches, 100, KERNEL_SLEEP)
    plain_ms = _device_ms(torch, lambda a: plain(*a), batches, 10,
                          PLAIN_SLEEP)

    dense_b = [_dense(a) for a in batches]
    lib_ms = _device_ms(torch, lambda a: sdpa(*a, enable_gqa=True),
                        dense_b, 100, KERNEL_SLEEP)
    lib_out = sdpa(*dense_b[0], enable_gqa=True)[:, :, 0]
    _check(float((lib_out.float() - kern(*full).float()).abs().max())
           < ATTN_TOL["bfloat16"], "the library call computes the same")
    nbytes = _attn_bytes("float32" if f32 else "bf16", B, H, KVH, D, MAXP,
                         last)
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    splits = _cuda.paged_attn_splits(
        B * KVH, MAXP, _cuda.sm_count(0), _cuda.resident_blocks(
            0, _cuda.PAGED_ATTN_DTYPES[dtype], D, H // KVH))
    print(f"{'float32 ' if f32 else ''}paged_attention: {ms * 1e3:.2f} us "
          f"on the device per launch "
          f"at B={B} H={H} KVH={KVH} D={D} PS={PS} len={last}, {splits} "
          f"splits (bound {bound_ms * 1e3:.2f} us from "
          f"{nbytes / 1e6:.2f} MB; plain version {plain_ms * 1e3:.2f} us; "
          f"scaled_dot_product_attention on the dense cache, gather "
          f"excluded, {lib_ms * 1e3:.2f} us); max_abs_err {e_full:.3g}, "
          f"limit {limit:.3g} [{card}]", flush=True)
    del batches, dense_b, full, q, kp, vp
    torch.cuda.empty_cache()
    return e_full, ms, plain_ms, bound_ms, lib_ms


def attention_phase(torch, card) -> tuple:
    """Phase 4; returns the kernel's report row and the float32 mode's
    (launches filled later)."""
    from repro_torch.kernels import paged_attn
    from repro_torch.kernels.paged_attn_ref import paged_attention_ref
    kern, plain = paged_attn.paged_attention, paged_attention_ref
    errs = {"float32": 0.0, "bfloat16": 0.0}

    def compare(case, args):
        got, want = kern(*args), plain(*args)
        torch.cuda.synchronize()
        e = float((got.float() - want.float()).abs().max())
        name = str(args[0].dtype).replace("torch.", "")
        errs[name] = max(errs[name], e)
        _check(e < ATTN_TOL[name], f"paged attention within {ATTN_TOL[name]} "
               f"of its plain version ({case}, {name}: {e})")
        return got

    shapes = [(2, 4, 1, 16, 8, 3), (3, 8, 2, 32, 16, 4), (1, 16, 4, 64, 32, 2),
              (4, 4, 4, 16, 8, 5), (3, 16, 2, 128, 16, 6),
              (2, 8, 8, 128, 16, 4)]
    PS = PAGE_SIZE
    for dtype in (torch.float32, torch.bfloat16):
        for i, shp in enumerate(shapes):
            compare(f"B,H,KVH,D,PS,MAXP={shp}",
                    _attn_case(torch, i, *shp, dtype=dtype))
        compare("lengths on page boundaries and one past",
                _attn_case(torch, 9, 6, 32, 4, 128, PS, 4, dtype=dtype,
                           lens=[PS, PS + 1, 2 * PS, 2 * PS + 1, 1, 4 * PS]))
        q, kp, vp, pt, lens = _attn_case(torch, 10, 2, 16, 2, 64, PS, 4,
                                         NP=16, lens=[2 * PS + 3, PS],
                                         dtype=dtype)
        base = compare("poison baseline", (q, kp, vp, pt, lens))
        mapped = torch.zeros(16, dtype=torch.bool, device="cuda")
        mapped[pt[pt >= 0].long()] = True
        kp[~mapped], vp[~mapped] = 1e3, -1e3   # poison every unmapped page
        _check(torch.equal(kern(q, kp, vp, pt, lens), base),
               f"poisoned unmapped pages leave the output unchanged ({dtype})")
        _check(torch.equal(kern(q, kp, vp, pt, lens), base),
               f"two calls give bit-identical outputs ({dtype})")
        q, kp, vp, pt, lens = _attn_case(torch, 11, 4, 16, 2, 64, PS, 4,
                                         lens=[0, 1, 3 * PS, 4 * PS],
                                         dtype=dtype)
        got = kern(q, kp, vp, pt, lens)
        _check(not bool(got[0].any()), f"a length of 0 gives zeros ({dtype})")
        compare("lengths 0, 1, on a page boundary, full",
                (q[1:], kp, vp, pt[1:], lens[1:]))
        _check(torch.equal(got[1:], kern(q[1:], kp, vp, pt[1:], lens[1:])),
               f"a length-0 neighbour leaves the others unchanged ({dtype})")

    # Yi-6B's decode shape on a pool of phase 5's size, at its last step,
    # at the serving batch and the launcher's; scores of std 1.2, so a few
    # dozen tokens carry each output and one token less moves it by far
    # more than the limit
    H, KVH, D, MAXP = 32, 4, 128, -(-(PROMPT_LEN + GEN) // PS)
    timing = {B: attention_timing(torch, B, H, KVH, D, MAXP, SERVE_B * MAXP,
                                  PROMPT_LEN + GEN - 1, 20, card)
              for B in (SERVE_B, LAUNCHER_B)}
    e_full, ms, plain_ms, bound_ms, lib_ms = timing[SERVE_B]
    # the float32 mode (the CUDA-core loop) at the serving shape
    f32 = attention_timing(torch, SERVE_B, H, KVH, D, MAXP, SERVE_B * MAXP,
                           PROMPT_LEN + GEN - 1, 50, card,
                           dtype=torch.float32)
    print(f"phase 4: paged attention equals its plain version (max_abs_err "
          f"float32 {errs['float32']:.3g}, bfloat16 {errs['bfloat16']:.3g}; "
          f"Yi-6B shape {e_full:.3g}, float32 {f32[0]:.3g}); a length of 0 "
          f"gives zeros; poisoned unmapped pages ignored; two calls "
          f"bit-identical", flush=True)
    row = {"name": "paged_attention", "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/paged_attn.cu",
           "replaces": "src/repro/kernels/paged_attn.py:80",
           "max_abs_err": e_full, "ms": ms, "plain_ms": plain_ms,
           "bound_ms": bound_ms, "bound_by": "bytes", "library_ms": lib_ms}
    f32_row = dict(row, name="float32_attention", max_abs_err=f32[0],
                   ms=f32[1], plain_ms=f32[2], bound_ms=f32[3],
                   library_ms=f32[4])
    return row, f32_row


def _slices(torch, a, kw, m):
    """Each of ``m`` ranks' slice of every page of an attention case: [(its
    operands, its int8 scales, its first token)], the pools cut (copies)."""
    q, kp, vp, pt, lens = a
    n = kp.shape[2] // m

    def cut(t, r):
        return t[:, :, r * n:(r + 1) * n].contiguous()
    return [((q, cut(kp, r), cut(vp, r), pt, lens),
             {k: cut(v, r) for k, v in kw.items()}, r * n)
            for r in range(m)]


def _run_slices(torch, sl, attend, merge):
    """Every slice's partials (``attend``: the kernel's slice mode or its
    plain version), merged in slice order (``merge``): what the model
    group's ranks compute, the exchange between them aside."""
    PS = sl[0][0][1].shape[2] * len(sl)
    parts = [attend(*a, page_stride=PS, token_offset=off, **kw)
             for a, kw, off in sl]
    return merge(torch.cat([p[0] for p in parts], 2),
                 torch.cat([p[1] for p in parts], 2), sl[0][0][0].dtype)


def _slice_bytes(mode, B, H, KVH, D, MAXP, last, m, splits) -> tuple:
    """(bytes of one slice's launch, bytes of m launches and their merge,
    bytes of the merge alone): each slice's share of the live K/V rows
    (with their scales in int8), q, the page table and lengths per launch,
    the partials (acc and m, l per split) written once and read once by
    the merge, the output."""
    kv = B * last * KVH * (2 * D * ATTN_ITEM[mode]
                           + (2 * 4 if mode == "int8" else 0))
    item = 4 if mode == "float32" else 2
    fixed = B * H * D * item + B * MAXP * 4 + B * 4
    partials = B * H * splits * (D + 2) * 4
    one = kv / m + fixed + partials
    merge = m * partials + B * H * D * item
    return one, m * one + merge, merge


def _slice_rows(lens, PS, off, rows) -> "object":
    """The live rows of each sequence in the slice of ``rows`` rows from
    token ``off`` of each page of ``PS`` tokens (the kernel's
    ``slice_len``, unclipped)."""
    full = lens // PS
    return full * rows + (lens - full * PS - off).clamp(0, rows)


def _int8_equals_bf16(torch, a, kw, m) -> None:
    """The int8 slice route's partials against the bf16 slice route's on
    the plain version's dequantized pools, every slice of ``m``, at the
    int8 route's host split count: bit for bit."""
    from repro_torch.kernels import _cuda
    from repro_torch.kernels.paged_attn_ref import dequant
    q, kq, vq, pt, lens = a
    deq = {"k": dequant(kq, kw["kscale"], torch.bfloat16),
           "v": dequant(vq, kw["vscale"], torch.bfloat16)}
    scale = 1.0 / q.shape[-1] ** 0.5
    PS = kq.shape[2]
    for (sa, skw, off), (da, _, _) in zip(
            _slices(torch, a, kw, m),
            _slices(torch, (q, deq["k"], deq["v"], pt, lens), {}, m)):
        got = _cuda.launch_paged_attn_slice(*sa, scale, PS, off, **skw)
        want = _cuda.launch_paged_attn_slice(*da, scale, PS, off,
                                             splits=got[0].shape[2])
        live = got[1][..., 0] != float("-inf")   # an empty split writes no acc
        _check(torch.equal(got[1], want[1])
               and torch.equal(got[0][live], want[0][live]),
               f"int8, {m} slices: slice {off // (PS // m)}'s partials equal "
               f"the bf16 slice route's on the dequantized pools bit for "
               f"bit")


def slice_timing(torch, card) -> dict:
    """Phase 4's page-token slice mode at Yi-6B's B 32 decode shape (phase
    5's pool, 2,111 tokens, 132 pages of 16): each page's tokens cut into m
    slices on one card, m slice launches and the merge over every slice's
    partials.  For the bf16 and int8 routes at m = 2 and 4: held within
    ``_attn_limit`` of the whole-page kernel and of the plain version,
    bit-equal to the whole-page launch at m = 1, and timed (one slice's
    launch, the m launches with the merge, and the merge alone) beside
    their bounds, with SDPA over one slice's dense tokens (bf16); the int8
    route's partials equal to the bf16 route's on the dequantized pools
    bit for bit at m = 2 and 4; the float32 route held within 2e-5 of its
    plain version at m = 2; then the breakdown of one slice's launch by
    phase (``tools/attention_breakdown.py``).  Returns the report row
    (bf16 at m = 2, launches filled later)."""
    from repro_torch.kernels import _cuda, paged_attn
    from repro_torch.kernels.paged_attn_ref import (merge_partials_ref,
                                                    paged_attention_ref)
    kern, merge = paged_attn.paged_attention, paged_attn.merge_partials
    H, KVH, D, PS = 32, 4, 128, PAGE_SIZE
    B, MAXP = SERVE_B, -(-(PROMPT_LEN + GEN) // PS)
    last = PROMPT_LEN + GEN - 1
    bf16 = [_attn_case(torch, 60 + i, B, H, KVH, D, PS, MAXP, NP=B * MAXP,
                       lens=[last] * B, dtype=torch.bfloat16, q_scale=4.0)
            for i in range(4)]
    routes = {"bf16": [(a, {}) for a in bf16],
              "int8": [_quantized(a) for a in bf16]}
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_ms = _device_ms(torch, lambda d: sdpa(*d, enable_gqa=True),
                        [_dense(a) for a in bf16], 100, KERNEL_SLEEP)
    out, worst = {}, 0.0
    for mode, batches in routes.items():
        a, kw = batches[0]
        whole = kern(*a, **kw)
        want = paged_attention_ref(*a, **kw).float()
        limit = _attn_limit(want)
        _check(torch.equal(_run_slices(torch, _slices(torch, a, kw, 1),
                                       kern, merge), whole),
               f"{mode}: one slice of each page, merged, equals the "
               f"whole-page launch bit for bit")
        code = (_cuda.PAGED_ATTN_INT8 if kw else
                _cuda.PAGED_ATTN_DTYPES)[torch.bfloat16]
        splits = _cuda.paged_attn_splits(
            B * KVH, MAXP, _cuda.sm_count(0),
            _cuda.resident_blocks(0, code, D, H // KVH))
        for m in SLICES:
            sliced = [_slices(torch, b, k, m) for b, k in batches]
            if kw:
                _int8_equals_bf16(torch, a, kw, m)
            got = _run_slices(torch, sliced[0], kern, merge)
            e_whole = float((got.float() - whole.float()).abs().max())
            e_plain = float((got.float() - want).abs().max())
            _check(max(e_whole, e_plain) <= limit, f"{mode}, {m} slices: "
                   f"within {limit:.3g} of the whole-page kernel "
                   f"({e_whole}) and of the plain version ({e_plain})")
            worst = max(worst, e_plain)
            ms = _device_ms(torch, lambda sl: _run_slices(torch, sl, kern,
                                                          merge),
                            sliced, 50, KERNEL_SLEEP)
            one_ms = _device_ms(
                torch, lambda sl: kern(*sl[0][0], page_stride=PS,
                                       token_offset=0, **sl[0][1]),
                sliced, 50, KERNEL_SLEEP)
            plain_ms = _device_ms(
                torch, lambda sl: _run_slices(
                    torch, sl, lambda *x, **y: paged_attention_ref(
                        *x, partials=True, **y), merge_partials_ref),
                sliced, 10, PLAIN_SLEEP)
            parts = [[kern(*x, page_stride=PS, token_offset=off, **y)
                      for x, y, off in sl] for sl in sliced]
            cat = [(torch.cat([p[0] for p in ps], 2),
                    torch.cat([p[1] for p in ps], 2)) for ps in parts]
            merge_ms = _device_ms(torch, lambda c: merge(*c, torch.bfloat16),
                                  cat, 30, KERNEL_SLEEP)
            splits = cat[0][0].shape[2] // m
            one_b, all_b, merge_b = _slice_bytes(mode, B, H, KVH, D, MAXP,
                                                 last, m, splits)
            rec = {"ms": ms, "slice_ms": one_ms, "plain_ms": plain_ms,
                   "merge_ms": merge_ms,
                   "bound_ms": all_b / HBM_BYTES_PER_S * 1e3,
                   "slice_bound_ms": one_b / HBM_BYTES_PER_S * 1e3,
                   "merge_bound_ms": merge_b / HBM_BYTES_PER_S * 1e3,
                   "max_abs_err": e_plain, "splits": splits}
            lib_note = ""
            if not kw:               # SDPA over one slice's dense tokens
                q0, kp0, vp0, pt0, lens0 = sliced[0][0][0]
                n = _slice_rows(lens0, PS, 0, PS // m)
                rec["slice_library_ms"] = _device_ms(
                    torch, lambda d: sdpa(*d, enable_gqa=True),
                    [_dense((x[0][0][0], x[0][0][1], x[0][0][2], x[0][0][3],
                             n)) for x in sliced], 50, KERNEL_SLEEP)
                lib_note = (f"; SDPA over one slice's {int(n[0])} dense "
                            f"tokens {rec['slice_library_ms'] * 1e3:.2f} us")
            out[f"{mode}_m{m}"] = rec
            print(f"{mode} paged_attention slice mode, {m} slices of each "
                  f"page at B={B} H={H} KVH={KVH} D={D} PS={PS} len={last}: "
                  f"one slice's launch {one_ms * 1e3:.2f} us (bound "
                  f"{rec['slice_bound_ms'] * 1e3:.2f} us{lib_note}), {m} "
                  f"launches and the merge {ms * 1e3:.2f} us (bound "
                  f"{rec['bound_ms'] * 1e3:.2f} us; plain version "
                  f"{plain_ms * 1e3:.2f} us), the merge alone "
                  f"{merge_ms * 1e3:.2f} us over {m} x {splits} partials "
                  f"(bound {rec['merge_bound_ms'] * 1e3:.2f} us); {splits} "
                  f"splits per slice; max_abs_err vs the whole-page kernel "
                  f"{e_whole:.3g}, vs the plain version {e_plain:.3g}, "
                  f"limit {limit:.3g}{'; partials equal the bf16 route' if kw else ''}"
                  f" [{card}]", flush=True)
            del sliced, parts, cat
    f32 = _attn_case(torch, 70, B, H, KVH, D, PS, MAXP, NP=B * MAXP,
                     lens=[last] * B, dtype=torch.float32, q_scale=4.0)
    got = _run_slices(torch, _slices(torch, f32, {}, 2), kern, merge)
    e32 = float((got - paged_attention_ref(*f32)).abs().max())
    _check(e32 <= ATTN_TOL["float32"], f"float32, 2 slices: within "
           f"{ATTN_TOL['float32']} of the plain version ({e32})")
    print(f"float32 paged_attention slice mode, 2 slices: max_abs_err "
          f"{e32:.3g} vs the plain version; scaled_dot_product_attention "
          f"on the dense bf16 cache {lib_ms * 1e3:.2f} us [{card}]",
          flush=True)
    del bf16, routes, f32, got
    torch.cuda.empty_cache()
    sys.path.insert(0, str(ROOT / "tools"))
    import attention_breakdown
    breakdown = attention_breakdown.run(torch, sys.modules[__name__],
                                        iters=20)
    for line in attention_breakdown.headline(breakdown):
        print(f"{line} [{card}]", flush=True)
    r = out["bf16_m2"]
    return {"name": "paged_attention_slice", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/paged_attn.cu",
            "replaces": "src/repro/kernels/paged_attn.py:80",
            "max_abs_err": max(worst, e32), "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": "bytes", "library_ms": lib_ms, "slices": out,
            "float32_max_abs_err": e32, "breakdown": breakdown}


# ---------------------------------------------------------------------------
# phase 5: serving Yi-6B at full width
# ---------------------------------------------------------------------------

def _count(cache) -> int:
    return sum(int(t.count) for t in cache.table)


def _check_pages(geom, cache, npre, n_dec, lens, off, what) -> None:
    """The page table of a one-shard cache after a prompt of ``npre``
    pages per sequence and ``n_dec`` pages opened in decode holds exactly
    the bump allocator's ids (host-computed: prompt pages sequence-major,
    then each decode page for every sequence in slot order), and the
    small fields agree."""
    from repro_torch.serving import kvcache as KC
    B, MAXP, PS = geom.batch, geom.max_pages, geom.page_size
    b_ = np.arange(B)[:, None]
    want = np.full((B, MAXP), -1, np.int32)
    want[:, :npre] = b_ * npre + np.arange(npre)
    for k in range(n_dec):
        want[:, npre + k] = B * npre + k * B + b_[:, 0]
    pages = KC.lookup_pages(geom, cache.table, cache.seq_ids)[0]
    _check(_count(cache) == int((want >= 0).sum()),
           f"{what}: the page table holds {int((want >= 0).sum())} mappings")
    _check(np.array_equal(pages.cpu().numpy(), want),
           f"{what}: lookup_pages returns the bump allocator's pages")
    _check(int(cache.next_free[0]) == int((want >= 0).sum()),
           f"{what}: next_free")
    _check(bool((cache.seq_lens == lens).all()), f"{what}: seq_lens")
    _check(bool((cache.cur_off == off).all()), f"{what}: cur_off")
    last = want[np.arange(B), -(-lens // PS) - 1]
    _check(np.array_equal(cache.cur_page[0].cpu().numpy(), last),
           f"{what}: cur_page")


def _diff_stats(torch, a, b) -> str:
    """max / 99.9th percentile / mean abs difference of two (B, V) logit
    tensors, and the share of rows whose argmax agrees."""
    d = (a.float() - b.float()).abs()
    top = float((a.argmax(-1) == b.argmax(-1)).float().mean())
    q = float(torch.quantile(d.flatten()[:2 ** 24], 0.999))
    return (f"max_abs_err {float(d.max()):.4f}, p99.9 {q:.4f}, mean "
            f"{float(d.mean()):.5f}, argmax agreement {top:.3f}")


def _float32(torch, cfg, params):
    """The float32 twin of a model: its config and its weights upcast."""
    import dataclasses
    p32 = {k: v.float() for k, v in params.items() if k != "blocks"}
    p32["blocks"] = {k: v.float() for k, v in params["blocks"].items()}
    return dataclasses.replace(cfg, dtype="float32"), p32


def _uncounted(run):
    """``run()`` with the kernels' launch counts left as they were: the
    launches of a check are not the main path's."""
    from repro_torch.kernels import mutate, paged_attn, probe
    from repro_torch.kernels import scan_walk
    kerns = (probe.probe_segments, mutate.mutate_segments,
             paged_attn.paged_attention, scan_walk.scan_walk,
             paged_attn.merge_partials)
    pa = paged_attn.paged_attention
    saved = [k.launches for k in kerns]
    saved_modes = pa.int8_launches, pa.float32_launches, pa.slice_launches
    try:
        return run()
    finally:
        for k, n in zip(kerns, saved):
            k.launches = n
        pa.int8_launches, pa.float32_launches, pa.slice_launches = \
            saved_modes


def _swap_attention(attention, run):
    """``run()`` with ``ops.paged_attention`` replaced by
    ``attention(kernel_call, *args, **kw)``, where ``kernel_call`` is the
    ops function it replaces."""
    from repro_torch.kernels import ops as K
    kernel_call = K.paged_attention
    K.paged_attention = lambda *a, **kw: attention(kernel_call, *a, **kw)
    try:
        return run()
    finally:
        K.paged_attention = kernel_call


def _plain_attention(run):
    """``run()`` with every paged-attention call on the plain version."""
    return _swap_attention(lambda f, *a, **kw: f(*a, use_kernel=False, **kw),
                           run)


def _in_situ_attention(run) -> list:
    """Run ``run()`` with every paged-attention call also computed by the
    plain version on the same operands; returns each call's (max abs
    difference, limit) (the kernel's output goes on)."""
    errs = []

    def both(f, *args, **kw):
        out = f(*args, **kw)
        want = f(*args, use_kernel=False, **kw).float()
        errs.append((float((out.float() - want).abs().max()),
                     _attn_limit(want)))
        return out
    _swap_attention(both, run)
    return errs


def _device_profile(torch, fn):
    """One ``fn()`` under ``torch.profiler`` with CUDA activity: (host ms,
    device-busy ms: the union of every device op's interval, so ops that
    overlap (the attention merge launched early) count once, the five
    device ops that take the most time as (name, ms, count))."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, t = _timed(torch, fn)
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    ops = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    ops.sort(key=lambda e: -e.self_device_time_total)
    return (t * 1e3, busy / 1e3,
            [(e.key, e.self_device_time_total / 1e3, e.count)
             for e in ops[:5]])


# the float32-q attention loop's launches on each float32 twin's prefill
# and decode (phases 5 and 6b (a)), each counted from 0
F32_TWIN_LAUNCHES: dict = {}


def _float32_path(what, run):
    """``run()`` with the float32-q attention count set to 0 just before it
    and read just after, into ``F32_TWIN_LAUNCHES[what]``."""
    from repro_torch.kernels import paged_attn
    pa = paged_attn.paged_attention
    pa.float32_launches = 0
    out = run()
    F32_TWIN_LAUNCHES[what] = pa.float32_launches
    return out


def float32_twin(torch, cfg, params, prompts, what) -> float:
    """The serving path in float32 at full width, small batch, on the
    weights upcast: decode's last logits against the float32 dense forward
    over the same tokens, and one more step with the kernel against the
    same step with the plain attention.  Returns the first difference."""
    from repro_torch.launch import serve
    from repro_torch.models import transformer as T
    from repro_torch.serving import kvcache as KC
    cfg32, p32 = _float32(torch, cfg, params)
    B32, P32, G32 = CHECK_SEQS, 256, 8     # prompts cut for the time limit
    g32 = serve.make_geometry(cfg32, B32, P32, G32, page_size=PAGE_SIZE,
                              shards=1, device="cuda")

    def path():
        lg32, c32 = serve.run_prefill(cfg32, g32, p32, prompts[:B32, :P32],
                                      KC.create_cache(g32))
        return serve.run_decode(cfg32, g32, p32, lg32, c32, G32)
    t32, lg32, c32 = _float32_path(f"Yi-6B float32 twin, {what}", path)
    x, _ = T.forward(cfg32, p32, torch.cat(
        [prompts[:B32, :P32], t32[:, :G32 - 1]], 1))
    err32 = float((lg32 - T.logits_fn(cfg32, p32, x[:, -1])).abs().max())

    def step(attention):     # one more step on the same state, uncommitted
        c = KC.advance(g32, c32)
        pt = KC.lookup_pages(g32, c.table, c.seq_ids)
        x = attention(lambda: T.paged_layers(cfg32, p32, t32[:, -1], c, g32,
                                             pt))
        return T.logits_fn(cfg32, p32, T.final_norm(cfg32, p32, x))
    err_step = float((step(lambda run: run()) - step(_plain_attention))
                     .abs().max())
    print(f"float32 twin, {what} ({B32} sequences, {P32}-token prompts, "
          f"{G32} generated): decode vs dense forward max_abs_err "
          f"{err32:.3g} (tolerance {F32_FORWARD_TOL}); one step with the "
          f"kernel vs with the plain attention {err_step:.3g} (tolerance "
          f"{F32_STEP_TOL})", flush=True)
    _check(err32 <= F32_FORWARD_TOL, f"float32 paged decode equals the "
           f"float32 dense forward ({what})")
    _check(err_step <= F32_STEP_TOL, f"the float32 step's logits with the "
           f"kernel equal those with the plain attention ({what})")
    del p32, c32, x
    torch.cuda.empty_cache()
    return err32


def _scale_residuals(cfg, params) -> None:
    """Residual output projections scaled by 1/sqrt(2L) in place, as GPT-2
    and Megatron-LM initialise them: with the reference's unscaled init
    this random 32-layer model amplifies bf16 rounding until two bf16
    evaluations of one step differ by ~0.25 in logits of std 1.3, while
    the float32 twins (phase 5) agree with their forward to ~1e-5: the
    bf16 checks would measure that amplification, not the port."""
    for name in ("wo", "w_down"):
        params["blocks"][name].mul_((2 * cfg.n_layers) ** -0.5)


def _serving_weights(torch, cfg):
    """Phase 5's bf16 weights, drawn again from its seed."""
    from repro_torch.models import transformer as T
    params = T.init_params(cfg, torch.Generator("cuda").manual_seed(SEED))
    _scale_residuals(cfg, params)
    return params


class _FirstSteps:
    """While active, the launcher's decode steps (``launch.serve.stepper``)
    keep the logits of their first ``n`` steps and, after the n-th, a copy
    of the cache's page tables and sequence fields: what phase 7b (c)
    holds its sharded steps against."""

    def __init__(self, n):
        self.n, self.logits, self.state = n, [], None

    def __enter__(self):
        from repro_torch.launch import serve
        self._serve, self._stepper = serve, serve.stepper

        def stepper(*args, **kw):
            inner = self._stepper(*args, **kw)

            def step(tokens, cache):
                lg, cache = inner(tokens, cache)
                if len(self.logits) < self.n:
                    self.logits.append(lg)
                    if len(self.logits) == self.n:
                        self.state = _table_state(cache)
                return lg, cache
            return step
        serve.stepper = stepper
        return self

    def __exit__(self, *exc):
        self._serve.stepper = self._stepper


def _table_state(cache) -> dict:
    """Copies of a paged cache's page tables (every store-table field) and
    sequence fields."""
    out = {f: getattr(cache, f).clone() for f in
           ("next_free", "seq_ids", "seq_lens", "cur_page", "cur_off")}
    for s, t in enumerate(cache.table):
        out.update({f"table{s}.{f}": x.clone() for f, x in
                    zip(t._fields, t)})
    return out


def serving_phase(torch, card):
    """Phase 5; returns (cfg, params) for phases 5b and 6, the kernels'
    launches on the serving path, what phase 5b holds its int8 path
    against (the bf16 cache, its pools, and the generated tokens) and what
    phase 7b (c) holds the sharded serving step against (the prefill's and
    the first ``DIST_SERVE_STEPS`` steps' logits, the page tables and
    sequence fields after them, the tokens and the pools)."""
    from repro_torch.configs import get_arch
    from repro_torch.launch import serve
    from repro_torch.models import transformer as T
    from repro_torch.serving import engine as E
    from repro_torch.serving import kvcache as KC

    cfg = get_arch("yi-6b")
    params, t_init = _timed(torch, lambda: T.init_params(
        cfg, torch.Generator("cuda").manual_seed(SEED)))
    prompts = torch.from_numpy(np.random.RandomState(SEED).randint(
        0, cfg.vocab, (SERVE_B, PROMPT_LEN)).astype(np.int32)).cuda()
    # the port against its own forward at the init that launch.serve uses
    float32_twin(torch, cfg, params, prompts, "the launcher's init")
    _scale_residuals(cfg, params)
    geom = serve.make_geometry(cfg, SERVE_B, PROMPT_LEN, GEN,
                               page_size=PAGE_SIZE, shards=1, device="cuda")
    MAXP, PS = geom.max_pages, PAGE_SIZE
    cache = KC.create_cache(geom)
    print(f"phase 5: {cfg.name} {cfg.n_layers} layers d {cfg.d_model} heads "
          f"{cfg.n_heads}/{cfg.n_kv_heads} vocab {cfg.vocab}, "
          f"{cfg.param_count / 1e9:.2f} B parameters made in {t_init:.2f} s; "
          f"pool {geom.pool_pages} pages x {MAXP} per sequence, "
          f"{2 * cache.kpool.numel() * cache.kpool.element_size() / 1e9:.2f} "
          f"GB; device memory in use "
          f"{torch.cuda.memory_allocated() / 2 ** 30:.3f} GiB [{card}]",
          flush=True)
    npre = PROMPT_LEN // PS

    def check_table(cache, n_dec, lens, off, what):
        _check_pages(geom, cache, npre, n_dec, lens, off, what)

    # the serving path's launches: counted from 0 over prefill, the decode
    # steps and the releases; every check in between runs _uncounted
    torch.cuda.reset_peak_memory_stats()
    from repro_torch.kernels import mutate, paged_attn, probe
    for k in (probe.probe_segments, mutate.mutate_segments,
              paged_attn.paged_attention):
        k.launches = 0
    paged_attn.paged_attention.int8_launches = 0
    paged_attn.paged_attention.float32_launches = 0
    (lg, cache), t_pre = _timed(torch, lambda: serve.run_prefill(
        cfg, geom, params, prompts, cache))
    _check(lg.shape == (SERVE_B, cfg.vocab) and bool(lg.isfinite().all()),
           "prefill logits finite, (B, vocab)")
    _uncounted(lambda: check_table(cache, 0, PROMPT_LEN, 0, "after prefill"))
    prefill_logits = lg
    with _FirstSteps(DIST_SERVE_STEPS) as first:
        (toks, lg, cache), t_dec = _timed(torch, lambda: serve.run_decode(
            cfg, geom, params, lg, cache, GEN))
    n_steps = GEN - 1
    lens = PROMPT_LEN + n_steps
    n_dec = -(-lens // PS) - npre
    _uncounted(lambda: check_table(cache, n_dec, lens, (lens - 1) % PS,
                                   "after decode"))
    _check(bool(lg.isfinite().all()), "decode logits finite")
    print(f"prefill: {SERVE_B} x {PROMPT_LEN} tokens in {t_pre:.3f} s = "
          f"{SERVE_B * PROMPT_LEN / t_pre:.0f} tokens/s; decode: {n_steps} "
          f"steps x {SERVE_B} sequences in {t_dec:.3f} s = "
          f"{SERVE_B * n_steps / t_dec:.1f} tokens/s "
          f"({t_dec / n_steps * 1e3:.2f} ms per step); page table "
          f"{_count(cache)} mappings, lookup_pages exact [{card}]",
          flush=True)

    # (b) the last step's logits against the port's dense forward over the
    # same tokens; beside it, the same against the forward in float32 on
    # the same weights (the exact function both bf16 paths round)
    hist = torch.cat([prompts[:CHECK_SEQS], toks[:CHECK_SEQS, :n_steps]], 1)
    x, _ = T.forward(cfg, params, hist)
    ref = T.logits_fn(cfg, params, x[:, -1])
    err_fwd = float((lg[:CHECK_SEQS] - ref).abs().max())
    cfg32, params32 = _float32(torch, cfg, params)
    x, _ = T.forward(cfg32, params32, hist)
    ref32 = T.logits_fn(cfg32, params32, x[:, -1])
    del params32, x
    torch.cuda.empty_cache()
    print(f"decode vs dense forward over {hist.shape[1]} tokens, "
          f"{CHECK_SEQS} sequences: {_diff_stats(torch, lg[:CHECK_SEQS], ref)}"
          f" (tolerance {FORWARD_TOL} on the max; logits std "
          f"{float(ref.std()):.3f}); vs the float32 forward "
          f"{_diff_stats(torch, lg[:CHECK_SEQS], ref32)}", flush=True)
    _check(err_fwd <= FORWARD_TOL, "paged decode agrees with the dense "
           "forward")
    # the same path in float32 on these weights: decode equals the forward
    # up to float32 rounding, so the bf16 gap above is rounding
    _uncounted(lambda: float32_twin(torch, cfg, params, prompts,
                                    "the served weights"))

    # (a) one more step on the same state: the whole layer stack with the
    # plain attention, then with the kernel while every layer's kernel
    # output is held against the plain version on that layer's own q and
    # pool, then the kernel step again, timed part by part
    def check_step():
        tok = lg.argmax(-1).to(torch.int32)
        parts = {}
        c, parts["advance (inserts)"] = _timed(
            torch, lambda: KC.advance(geom, cache))
        pt, parts["lookup_pages (probe)"] = _timed(
            torch, lambda: KC.lookup_pages(geom, c.table, c.seq_ids))

        def layers():
            return T.paged_layers(cfg, params, tok, c, geom, pt)
        x_plain = _plain_attention(layers)
        lg_plain = T.logits_fn(cfg, params, T.final_norm(cfg, params, x_plain))
        layer_err = _in_situ_attention(layers)
        x, parts["layer stack (attention kernel + matmuls)"] = _timed(
            torch, layers)
        lg1, parts["final norm + logits"] = _timed(
            torch, lambda: T.logits_fn(cfg, params,
                                       T.final_norm(cfg, params, x)))

        def whole():         # the step again from the same state, no syncs
            c1 = KC.advance(geom, cache)
            pt1 = KC.lookup_pages(geom, c1.table, c1.seq_ids)
            x1 = T.paged_layers(cfg, params, tok, c1, geom, pt1)
            return T.logits_fn(cfg, params, T.final_norm(cfg, params, x1))
        t_whole = sorted(_timed(torch, whole)[1] * 1e3
                         for _ in range(STEP_REPS))
        prof = _device_profile(torch, whole)
        return (KC.commit_token(c), parts, layer_err, lg1, lg_plain,
                t_whole, prof)
    (cache, parts, layer_err, lg1, lg_plain, t_whole,
     (prof_ms, busy_ms, top)) = _uncounted(check_step)
    step_ms = t_whole[STEP_REPS // 2]
    worst = max(layer_err, key=lambda el: el[0] / el[1])
    _check(len(layer_err) == cfg.n_layers
           and all(e <= lim for e, lim in layer_err),
           f"in the decode step, every layer's kernel attention equals the "
           f"plain version on the same inputs (worst {worst[0]} against its "
           f"limit {worst[1]:.3g})")
    err_step = float((lg1 - lg_plain).abs().max())
    _check(err_step <= FORWARD_TOL, f"the step's logits with the kernel and "
           f"with the plain attention agree ({err_step})")
    print(f"one decode step, kernel vs plain attention on each layer's own "
          f"inputs: max_abs_err {max(e for e, _ in layer_err):.3g} over "
          f"{len(layer_err)} layers (each within {ATTN_REL} of its largest "
          f"plain output, at most {ATTN_TOL['bfloat16']}; tightest limit "
          f"{min(lim for _, lim in layer_err):.3g}); whole step with the "
          f"kernel vs whole step with the plain version: logits "
          f"{_diff_stats(torch, lg1, lg_plain)}", flush=True)
    print("the step by part (host clock, synchronized): "
          + ", ".join(f"{k} {v * 1e3:.3f} ms" for k, v in parts.items())
          + f"; sum {sum(parts.values()) * 1e3:.3f} ms; the whole step "
          f"without syncs between parts, {STEP_REPS} runs: median "
          f"{step_ms:.3f} ms, min {t_whole[0]:.3f}, max {t_whole[-1]:.3f} "
          f"[{card}]", flush=True)
    if busy_ms > 0:
        print(f"device-busy share of one step: {busy_ms:.3f} ms of device "
              f"ops in one profiled step ({prof_ms:.3f} ms of host clock "
              f"under the profiler) over the median unprofiled step "
              f"{step_ms:.3f} ms = {busy_ms / step_ms:.3f}; top device ops: "
              + "; ".join(f"{k} {v:.3f} ms x{n}" for k, v, n in top)
              + f" [{card}]", flush=True)
    else:
        print("device-busy share of one step: not measured (the profiler "
              "recorded no device op)", flush=True)

    # release every sequence: deletes through the mutation-plan kernel
    def release_all(c):
        for b in range(SERVE_B):
            c = E.release_sequence(geom, c, 0, b)
        return c
    cache, t_rel = _timed(torch, lambda: release_all(cache))
    _check(_count(cache) == 0 and not bool(cache.seq_lens.any()),
           "the page table is empty after release")
    launches = {"probe_segments": probe.probe_segments.launches,
                "mutate_segments": mutate.mutate_segments.launches,
                "paged_attention": paged_attn.paged_attention.launches}
    print(f"release: {SERVE_B} sequences in {t_rel:.3f} s, 0 mappings left; "
          f"serving path kernel launches {launches}; device memory in use "
          f"{torch.cuda.memory_allocated() / 2 ** 30:.3f} GiB, peak "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB [{card}]",
          flush=True)
    for name, n in launches.items():
        _check(n > 0, f"the serving path launched {name}")
    _check(paged_attn.paged_attention.int8_launches == 0
           and paged_attn.paged_attention.float32_launches == 0,
           "the bf16 serving path launches no int8 or float32-q attention")
    _check(launches["paged_attention"] == n_steps * cfg.n_layers,
           "one attention launch per layer per decode step")
    # what phase 7b (c) holds the sharded serving step against
    record = {"prefill_logits": prefill_logits, "logits": first.logits,
              "state": first.state, "toks": toks, "kpool": cache.kpool,
              "vpool": cache.vpool}
    return cfg, params, launches, {"cache": cache, "toks": toks}, record


# ---------------------------------------------------------------------------
# phase 5b: int8 KV pages at full width, and the merged decode path
# ---------------------------------------------------------------------------

INT8_GEN = 32                  # generated tokens: prefill's + 31 steps


def _prompts(torch, cfg):
    """Phase 5's prompts (the same seed)."""
    return torch.from_numpy(np.random.RandomState(SEED).randint(
        0, cfg.vocab, (SERVE_B, PROMPT_LEN)).astype(np.int32)).cuda()


def _int8_prompt_pages(torch, cache, bf16_cache, npages) -> None:
    """The int8 pools' and scales' prompt pages equal ``quant_store`` of the
    bf16 prefill's pages, byte for byte, layer by layer."""
    from repro_torch.serving import kvcache as KC
    for pools, scales, ref in ((cache.kpool, cache.kscale, bf16_cache.kpool),
                               (cache.vpool, cache.vscale, bf16_cache.vpool)):
        for layer in range(pools.shape[0]):
            q, sc = KC.quant_store(ref[layer, :, :npages])
            _check(torch.equal(pools[layer, :, :npages], q)
                   and torch.equal(scales[layer, :, :npages], sc),
                   f"layer {layer}: the int8 prompt pages are quant_store of "
                   f"the bf16 prefill's, byte for byte")


def int8_attention_timing(torch, B, H, KVH, D, MAXP, NP, last, seed, card):
    """The int8 mode at one decode shape: phase 4's bf16 case (scores of
    std 1.2) with its pools quantized by ``quant_store``, held within
    ``_attn_limit`` of the int8 plain version (a limit an output one token
    or one page short breaks), timed on the device beside its bound, its
    plain version and the bf16 kernel on the unquantized pools.  Returns
    (max_abs_err, ms, plain_ms, bound_ms, bf16_ms)."""
    from repro_torch.kernels import paged_attn
    from repro_torch.kernels.paged_attn_ref import paged_attention_ref
    kern, plain = paged_attn.paged_attention, paged_attention_ref
    PS = PAGE_SIZE
    bf16 = [_attn_case(torch, seed + i, B, H, KVH, D, PS, MAXP, NP=NP,
                       lens=[last] * B, dtype=torch.bfloat16, q_scale=4.0)
            for i in range(4)]
    batches = [_quantized(a) for a in bf16]
    full, sc = batches[0]
    want = plain(*full, **sc).float()
    limit = _attn_limit(want)
    err = float((kern(*full, **sc).float() - want).abs().max())
    _check(err <= limit, f"B={B} H={H} D={D} int8 paged attention within "
           f"{limit:.3g} of its plain version ({err})")
    q, kq, vq, pt, lens = full
    for cut, what in ((1, "its last token"), (PS, "its last page")):
        moved = float((plain(q, kq, vq, pt, lens - cut, **sc).float()
                       - want).abs().max())
        _check(moved > limit, f"the int8 limit rejects an output that "
               f"drops {what} ({moved} vs {limit:.3g})")
    # the route's output equals the bf16 mode's on the plain version's
    # dequantized pools, bit for bit, at the host's split count
    from repro_torch.kernels import _cuda
    from repro_torch.kernels.paged_attn_ref import dequant
    splits = _cuda.paged_attn_splits(
        B * KVH, MAXP, _cuda.sm_count(0), _cuda.resident_blocks(
            0, _cuda.PAGED_ATTN_INT8[q.dtype], D, H // KVH))
    scale = 1.0 / D ** 0.5
    same = torch.equal(
        _cuda.launch_paged_attn(*full, scale, splits=splits, **sc),
        _cuda.launch_paged_attn(q, dequant(kq, sc["kscale"], q.dtype),
                                dequant(vq, sc["vscale"], q.dtype), pt,
                                lens, scale, splits=splits))
    _check(same, f"the int8 route's output equals the bf16 mode's on the "
           f"dequantized pools bit for bit ({splits} splits)")
    ms = _device_ms(torch, lambda a: kern(*a[0], **a[1]), batches, 100,
                    KERNEL_SLEEP)
    plain_ms = _device_ms(torch, lambda a: plain(*a[0], **a[1]), batches, 10,
                          PLAIN_SLEEP)
    bf16_ms = _device_ms(torch, lambda a: kern(*a), bf16, 100, KERNEL_SLEEP)
    nbytes = _attn_bytes("int8", B, H, KVH, D, MAXP, last)
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    print(f"int8 paged_attention: {ms * 1e3:.2f} us on the device per "
          f"launch at B={B} H={H} KVH={KVH} D={D} PS={PS} len={last} (bound "
          f"{bound_ms * 1e3:.2f} us from {nbytes / 1e6:.2f} MB; plain "
          f"version {plain_ms * 1e3:.2f} us; the bf16 kernel on the same "
          f"tokens unquantized {bf16_ms * 1e3:.2f} us; no single library "
          f"call takes int8 K/V); max_abs_err {err:.3g}, limit {limit:.3g}; "
          f"at the host's {splits} splits equal to the bf16 mode's output "
          f"on the dequantized pools bit for bit [{card}]", flush=True)
    del batches, bf16, full, sc, q, kq, vq
    torch.cuda.empty_cache()
    return err, ms, plain_ms, bound_ms, bf16_ms, splits


def int8_phase(torch, cfg, params, served, card) -> dict:
    """Phase 5b; returns the int8 kernel's report row, its launches on the
    int8 path."""
    import dataclasses
    from repro_torch.kernels import paged_attn
    from repro_torch.launch import serve
    from repro_torch.models import transformer as T
    from repro_torch.serving import engine as E
    from repro_torch.serving import kvcache as KC
    geom = serve.make_geometry(cfg, SERVE_B, PROMPT_LEN, GEN,
                               page_size=PAGE_SIZE, shards=1,
                               kv_dtype="int8", device="cuda")
    MAXP, PS = geom.max_pages, PAGE_SIZE
    npre = PROMPT_LEN // PS
    cache = KC.create_cache(geom)
    prompts = _prompts(torch, cfg)
    pool_gb = sum(t.numel() * t.element_size() for t in (
        cache.kpool, cache.vpool, cache.kscale, cache.vscale)) / 1e9
    print(f"phase 5b: int8 KV pages, pool {geom.pool_pages} pages x {MAXP} "
          f"per sequence, {pool_gb:.2f} GB with the scales (phase 5's bf16 "
          f"pool: {2 * served['cache'].kpool.numel() * 2 / 1e9:.2f} GB) "
          f"[{card}]", flush=True)

    def check_table(c, n_dec, lens, off, what):
        _check_pages(geom, c, npre, n_dec, lens, off, f"int8 {what}")

    _reset_launches()
    (lg, cache), t_pre = _timed(torch, lambda: serve.run_prefill(
        cfg, geom, params, prompts, cache))
    _check(bool(lg.isfinite().all()), "int8 prefill logits finite")
    _uncounted(lambda: check_table(cache, 0, PROMPT_LEN, 0, "after prefill"))
    (toks, lg, cache), t_dec = _timed(torch, lambda: serve.run_decode(
        cfg, geom, params, lg, cache, INT8_GEN))
    n_steps = INT8_GEN - 1
    lens = PROMPT_LEN + n_steps
    _uncounted(lambda: check_table(cache, -(-lens // PS) - npre, lens,
                                   (lens - 1) % PS, "after decode"))
    _check(bool(lg.isfinite().all()), "int8 decode logits finite")
    _int8_prompt_pages(torch, cache, served["cache"], SERVE_B * npre)
    top1 = float((toks == served["toks"][:, :INT8_GEN]).float().mean())
    print(f"phase 5b: prefill {SERVE_B} x {PROMPT_LEN} tokens in "
          f"{t_pre:.3f} s = {SERVE_B * PROMPT_LEN / t_pre:.0f} tokens/s; "
          f"decode {n_steps} steps in {t_dec:.3f} s "
          f"({t_dec / n_steps * 1e3:.2f} ms per step); page tables exact; "
          f"prompt pages and scales equal quant_store of phase 5's bf16 "
          f"pages byte for byte; greedy tokens equal phase 5's bf16 ones at "
          f"{top1:.4f} of {toks.numel()} positions (recorded, not gated) "
          f"[{card}]", flush=True)

    # one more step on the same state (uncommitted): every layer's int8
    # kernel output held against the int8 plain version on that layer's
    # inputs; then the merged path, which must launch no attention kernel
    def check_step():
        tok = lg.argmax(-1).to(torch.int32)
        c = KC.advance(geom, cache)
        pt = KC.lookup_pages(geom, c.table, c.seq_ids)

        def logits(g):
            x = T.paged_layers(cfg, params, tok, c, g, pt)
            return T.logits_fn(cfg, params, T.final_norm(cfg, params, x))
        layer_err = _in_situ_attention(lambda: logits(geom))
        lg_k = logits(geom)
        merged = dataclasses.replace(geom, merged_attn=True)
        pa = paged_attn.paged_attention
        n0 = pa.launches + pa.int8_launches
        lg_m, t_m = _timed(torch, lambda: logits(merged))
        return (layer_err, pa.launches + pa.int8_launches - n0, lg_k,
                lg_m, t_m)
    layer_err, merged_launches, lg_k, lg_m, t_m = _uncounted(check_step)
    worst = max(layer_err, key=lambda el: el[0] / el[1])
    _check(len(layer_err) == cfg.n_layers
           and all(e <= lim for e, lim in layer_err),
           f"in the int8 decode step, every layer's kernel attention equals "
           f"the int8 plain version on the same inputs (worst {worst[0]} "
           f"against its limit {worst[1]:.3g})")
    _check(merged_launches == 0, f"the merged path launches no attention "
           f"kernel ({merged_launches})")
    err_m = float((lg_m - lg_k).abs().max())
    _check(err_m <= FORWARD_TOL, f"the merged path's logits agree with the "
           f"int8 kernel's ({err_m})")
    print(f"phase 5b: one int8 decode step, kernel vs plain int8 attention "
          f"on each layer's own inputs: max_abs_err "
          f"{max(e for e, _ in layer_err):.3g} over {len(layer_err)} layers "
          f"(tightest limit {min(lim for _, lim in layer_err):.3g}); the "
          f"merged path (merged_attn=True): {merged_launches} attention "
          f"launches, layer stack and logits {t_m * 1e3:.1f} ms, logits vs "
          f"the kernel's {_diff_stats(torch, lg_m, lg_k)} [{card}]",
          flush=True)

    def release_all(c):
        for b in range(SERVE_B):
            c = E.release_sequence(geom, c, 0, b)
        return c
    cache = release_all(cache)
    _check(_count(cache) == 0, "the int8 page table is empty after release")
    launches = _kernel_launches()
    _check(launches["int8_attention"] == launches["paged_attention"]
           == n_steps * cfg.n_layers,
           "one int8 attention launch per layer per decode step, and no "
           "attention launch of another mode")
    for name in ("probe_segments", "mutate_segments"):
        _check(launches[name] > 0, f"the int8 path launched {name}")
    print(f"phase 5b: int8 path kernel launches {launches}; device memory "
          f"in use {torch.cuda.memory_allocated() / 2 ** 30:.3f} GiB "
          f"[{card}]", flush=True)
    del cache, lg_k, lg_m
    served.clear()
    torch.cuda.empty_cache()
    MAXP = -(-(PROMPT_LEN + GEN) // PS)
    err, ms, plain_ms, bound_ms, bf16_ms, splits = int8_attention_timing(
        torch, SERVE_B, cfg.n_heads, cfg.n_kv_heads, cfg.hd, MAXP,
        SERVE_B * MAXP, PROMPT_LEN + GEN - 1, 30, card)
    return {"name": "int8_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/paged_attn.cu",
            "replaces": "src/repro/kernels/paged_attn.py:80",
            "launches": launches["int8_attention"],
            "max_abs_err": max(err, max(e for e, _ in layer_err)),
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "bytes", "library_ms": None, "bf16_kernel_ms": bf16_ms,
            "bit_equal_bf16_splits": splits,
            "merged_launches": merged_launches, "top1_vs_bf16": top1}


# ---------------------------------------------------------------------------
# phase 6: the continuous batcher answers requests
# ---------------------------------------------------------------------------

def batcher_phase(torch, cfg, params, card) -> None:
    from repro_torch.models.config import ShapeConfig
    from repro_torch.serving import kvcache as KC
    from repro_torch.serving.scheduler import ContinuousBatcher, Request
    geom = KC.make_geometry(cfg, ShapeConfig("serve", seq_len=512,
                                             global_batch=SERVE_B,
                                             kind="decode"),
                            shards=1, page_size=PAGE_SIZE, device="cuda")
    batcher = ContinuousBatcher(cfg, geom, params)
    rng = np.random.RandomState(SEED + 6)
    want = {}
    for rid in range(BATCH_REQUESTS):
        n = int(rng.randint(16, 33))
        want[rid] = n
        batcher.submit(Request(rid=rid, prompt=rng.randint(
            0, cfg.vocab, size=int(rng.randint(8, 65))).astype(np.int32),
            max_new_tokens=n))
    finished, t_run = _timed(torch, lambda: batcher.run(max_steps=2000))
    _check(sorted(finished) == list(range(BATCH_REQUESTS)),
           "every request finished")
    _check(all(len(finished[r]) == n for r, n in want.items()),
           "every request got exactly its token count")
    _check(all(0 <= t < cfg.vocab for out in finished.values() for t in out),
           "generated ids are in the vocabulary")
    _check(all(s is None for s in batcher.slots), "every slot is free")
    _check(_count(batcher.cache) == 0, "the page table ends empty")
    releases = int(batcher.cache.seq_ids.max()) - (SERVE_B - 1)
    _check(releases >= BATCH_REQUESTS,
           "slots were reused (a fresh sequence id per release)")
    n_tok = sum(want.values())
    print(f"phase 6: continuous batcher, {BATCH_REQUESTS} requests (prompts "
          f"8-64, 16-32 new tokens) through {SERVE_B} slots in {t_run:.3f} s: "
          f"{n_tok} tokens generated ({n_tok / t_run:.1f} tokens/s), "
          f"{releases} releases, page table empty [{card}]", flush=True)


# ---------------------------------------------------------------------------
# phase 6b: the other families at full width
# ---------------------------------------------------------------------------

MOE_ARCH = "granite-moe-3b-a800m"
SSM_ARCH = "mamba2-370m"
HYBRID_ARCH = "hymba-1.5b"
MOE_B, MOE_PROMPT = 16, 512          # served: 16 prompts of 512 tokens
FAMILY_GEN = 33                      # generated tokens: prefill's + 32 steps
MOE_TWIN_B, MOE_TWIN_GEN = 4, 9      # the float32 twin, as phase 5's
SSM_B, SSM_PROMPT = 8, 256           # 256 + 32 = 288 tokens
HYBRID_B, HYBRID_PROMPT = 2, 1_072   # 1,072 + 32 = 1,104 > 1,088 tokens
DECODE_TOL = (3e-3, 1e-3)            # decode vs forward (atol, rtol), as
                                     # tests/test_serving.py:131
TWIN_TOL = 2e-5                      # (d): card vs CPU, float32
EAGER_STEPS = 8                      # eager bf16 steps timed beside the graph
TWIN_B, TWIN_PROMPT, TWIN_RECURRENT, TWIN_STEPS = 4, 32, 72, 8


def _excess(torch, got, want) -> tuple:
    """(max |got - want|, max of |got - want| - rtol·|want|) under
    ``DECODE_TOL``: the second at most atol passes torch.testing's rule."""
    rtol = DECODE_TOL[1]
    d = (got.float() - want.float()).abs()
    return float(d.max()), float((d - rtol * want.float().abs()).max())


def _kernel_launches() -> dict:
    from repro_torch.kernels import mutate, paged_attn, probe, scan_walk
    pa = paged_attn.paged_attention
    return {"probe_segments": probe.probe_segments.launches,
            "mutate_segments": mutate.mutate_segments.launches,
            "paged_attention": pa.launches,
            "int8_attention": pa.int8_launches,
            "float32_attention": pa.float32_launches,
            "paged_attention_slice": pa.slice_launches,
            "attention_merge": paged_attn.merge_partials.launches,
            "scan_walk": scan_walk.scan_walk.launches}


def _reset_launches() -> None:
    from repro_torch.kernels import mutate, paged_attn, probe, scan_walk
    for k in (probe.probe_segments, mutate.mutate_segments,
              paged_attn.paged_attention, scan_walk.scan_walk,
              paged_attn.merge_partials):
        k.launches = 0
    paged_attn.paged_attention.int8_launches = 0
    paged_attn.paged_attention.float32_launches = 0
    paged_attn.paged_attention.slice_launches = 0


class _StepLog:
    """While active, every step of ``launch.serve.stepper`` (the launcher's
    ``run_prefill`` / ``run_decode`` step) keeps its logits (``keep``)
    and / or its host time between two device synchronizes (``timed``,
    seconds; a graphed step's first call includes its capture)."""

    def __init__(self, torch, keep=False, timed=False):
        self.torch, self.keep, self.timed = torch, keep, timed
        self.logits, self.times = [], []

    def __enter__(self):
        from repro_torch.launch import serve
        self._serve, self._stepper = serve, serve.stepper

        def stepper(*args, **kw):
            inner = self._stepper(*args, **kw)

            def step(tokens, cache):
                if self.timed:
                    self.torch.cuda.synchronize()
                    t0 = time.perf_counter()
                lg, cache = inner(tokens, cache)
                if self.timed:
                    self.torch.cuda.synchronize()
                    self.times.append(time.perf_counter() - t0)
                if self.keep:
                    self.logits.append(lg)
                return lg, cache
            return step
        serve.stepper = stepper
        return self

    def __exit__(self, *exc):
        self._serve.stepper = self._stepper


def _median_ms(times) -> float:
    return sorted(times)[len(times) // 2] * 1e3


def _params_gb(params) -> float:
    leaves = list(params["blocks"].values()) + [
        v for k, v in params.items() if k != "blocks"]
    return sum(v.numel() * v.element_size() for v in leaves) / 1e9


def moe_phase(torch, card) -> tuple:
    """6b (a): granite-moe-3b-a800m served at full width; returns (the
    path's launches, the attention kernel's timing at its decode shape)."""
    import dataclasses
    from repro_torch.configs import get_arch
    from repro_torch.launch import serve
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T
    from repro_torch.serving import engine as E
    from repro_torch.serving import kvcache as KC

    cfg = get_arch(MOE_ARCH)
    m, PS = cfg.moe, PAGE_SIZE
    params, t_init = _timed(torch, lambda: T.init_params(
        cfg, torch.Generator("cuda").manual_seed(SEED)))
    prompts = torch.from_numpy(np.random.RandomState(SEED).randint(
        0, cfg.vocab, (MOE_B, MOE_PROMPT)).astype(np.int32)).cuda()
    geom = serve.make_geometry(cfg, MOE_B, MOE_PROMPT, FAMILY_GEN,
                               page_size=PS, shards=1, device="cuda")
    cache = KC.create_cache(geom)
    print(f"phase 6b (a): {cfg.name} {cfg.n_layers} layers d {cfg.d_model} "
          f"heads {cfg.n_heads}/{cfg.n_kv_heads} of {cfg.hd}, {m.num_experts} "
          f"experts top-{m.top_k} of d_ff {m.expert_dff}, vocab {cfg.vocab}, "
          f"{cfg.param_count / 1e9:.2f} B parameters ({_params_gb(params):.2f}"
          f" GB) made in {t_init:.2f} s; pool {geom.pool_pages} pages x "
          f"{geom.max_pages} per sequence [{card}]", flush=True)

    # the path's launches: prefill, the decode steps and the releases
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    npre = MOE_PROMPT // PS
    (lg, cache), t_pre = _timed(torch, lambda: serve.run_prefill(
        cfg, geom, params, prompts, cache))
    _check(lg.shape == (MOE_B, cfg.vocab) and bool(lg.isfinite().all()),
           "granite prefill logits finite, (B, vocab)")
    _uncounted(lambda: _check_pages(geom, cache, npre, 0, MOE_PROMPT, 0,
                                    "granite after prefill"))
    (toks, lg, cache), t_dec = _timed(torch, lambda: serve.run_decode(
        cfg, geom, params, lg, cache, FAMILY_GEN))
    n_steps = FAMILY_GEN - 1
    lens = MOE_PROMPT + n_steps
    _uncounted(lambda: _check_pages(geom, cache, npre, -(-lens // PS) - npre,
                                    lens, (lens - 1) % PS,
                                    "granite after decode"))
    _check(bool(lg.isfinite().all()), "granite decode logits finite")

    # one more step (it opens a page: lens is a page multiple): each
    # layer's kernel attention held against the plain version on that
    # layer's inputs, the share of MoE assignments dropped at B 16; then
    # the whole step timed from the committed state (no page opens)
    def check_step():
        tok = lg.argmax(-1).to(torch.int32)
        c = KC.advance(geom, cache)
        pt = KC.lookup_pages(geom, c.table, c.seq_ids)

        def layers():
            return T.paged_layers(cfg, params, tok, c, geom, pt)
        layer_err = _in_situ_attention(layers)
        kept, dispatch = [], L.moe_dispatch

        def recording(*args, **kw):
            out = dispatch(*args, **kw)
            kept.append(out[4])
            return out
        L.moe_dispatch = recording
        try:
            layers()
        finally:
            L.moe_dispatch = dispatch
        c = KC.commit_token(c)

        def whole():
            c1 = KC.advance(geom, c)
            pt1 = KC.lookup_pages(geom, c1.table, c1.seq_ids)
            x = T.paged_layers(cfg, params, tok, c1, geom, pt1)
            return T.logits_fn(cfg, params, T.final_norm(cfg, params, x))
        times = [_timed(torch, whole)[1] for _ in range(STEP_REPS)]
        return c, layer_err, torch.cat(kept), times
    cache, layer_err, kept, times = _uncounted(check_step)
    worst = max(layer_err, key=lambda el: el[0] / el[1])
    _check(len(layer_err) == cfg.n_layers
           and all(e <= lim for e, lim in layer_err),
           f"granite: every layer's kernel attention (D {cfg.hd}, G "
           f"{cfg.n_heads // cfg.n_kv_heads}) equals the plain version on "
           f"the same inputs (worst {worst[0]} against {worst[1]:.3g})")
    _uncounted(lambda: _check_pages(geom, cache, npre,
                                    -(-(lens + 1) // PS) - npre, lens + 1,
                                    lens % PS, "granite after the check step"))
    cap = int(np.ceil(MOE_B * m.top_k / m.num_experts * m.capacity_factor))
    dropped = 1.0 - float(kept.float().mean())

    def release_all(c):
        for b in range(MOE_B):
            c = E.release_sequence(geom, c, 0, b)
        return c
    cache, t_rel = _timed(torch, lambda: release_all(cache))
    _check(_count(cache) == 0 and not bool(cache.seq_lens.any()),
           "granite: the page table is empty after release")
    launches = _kernel_launches()
    step_ms = _median_ms(times)
    print(f"phase 6b (a): prefill {MOE_B} x {MOE_PROMPT} tokens in "
          f"{t_pre:.3f} s = {MOE_B * MOE_PROMPT / t_pre:.0f} tokens/s; decode "
          f"{n_steps} steps in {t_dec:.3f} s ({t_dec / n_steps * 1e3:.2f} ms "
          f"per step), the whole step {STEP_REPS} times: median "
          f"{step_ms:.3f} ms (min {min(times) * 1e3:.3f}, max "
          f"{max(times) * 1e3:.3f}); page tables exact; in one step every "
          f"layer's kernel attention within its limit of the plain version "
          f"(max_abs_err {max(e for e, _ in layer_err):.3g}, tightest limit "
          f"{min(lim for _, lim in layer_err):.3g}); MoE assignments dropped "
          f"at B {MOE_B} (capacity {cap} per expert): {dropped:.4f} of "
          f"{kept.numel()}; release {t_rel:.3f} s; launches {launches}; peak "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB [{card}]",
          flush=True)
    for name in ("probe_segments", "mutate_segments", "paged_attention"):
        _check(launches[name] > 0, f"the moe path launched {name}")
    _check(launches["paged_attention"] == n_steps * cfg.n_layers,
           "one attention launch per layer per decode step")
    _check(launches["int8_attention"] == launches["float32_attention"] == 0,
           "the bf16 moe path launches no int8 or float32-q attention")

    # the sorted dispatch twice on one input: the same bits (its combine
    # adds each token's contributions in a fixed order, with no atomics)
    def moe_twice():
        lp = T.layer_params(params, 0)
        x = torch.randn(MOE_B, MOE_PROMPT, cfg.d_model, device="cuda",
                        generator=torch.Generator("cuda").manual_seed(SEED))
        x = x.to(lp["we_gate"].dtype)
        return [L.moe(cfg, lp, x) for _ in range(2)]
    (y0, aux0), (y1, aux1) = _uncounted(moe_twice)
    _check(torch.equal(y0, y1) and torch.equal(aux0, aux1),
           "granite's MoE layer (sorted dispatch) gives the same bits in two "
           "runs on one input")
    print(f"phase 6b (a): granite's MoE layer run twice on one input "
          f"({MOE_B} x {MOE_PROMPT} tokens, layer 0, {y0.dtype}): "
          f"bit-identical [{card}]", flush=True)
    del y0, y1

    # the float32 twin: decode against its own forward, nothing dropped
    def twin():
        cfg32, p32 = _float32(torch, cfg, params)
        cfg32 = dataclasses.replace(cfg32, moe=dataclasses.replace(
            m, capacity_factor=m.num_experts / m.top_k))
        g32 = serve.make_geometry(cfg32, MOE_TWIN_B, MOE_PROMPT, MOE_TWIN_GEN,
                                  page_size=PS, shards=1, device="cuda")

        def path():
            lg32, c32 = serve.run_prefill(cfg32, g32, p32,
                                          prompts[:MOE_TWIN_B],
                                          KC.create_cache(g32))
            return serve.run_decode(cfg32, g32, p32, lg32, c32, MOE_TWIN_GEN)
        t32, lg32, c32 = _float32_path("granite float32 twin", path)
        x, _ = T.forward(cfg32, p32, torch.cat(
            [prompts[:MOE_TWIN_B], t32[:, :MOE_TWIN_GEN - 1]], 1))
        return _excess(torch, lg32, T.logits_fn(cfg32, p32, x[:, -1]))
    err32, excess = _uncounted(twin)
    torch.cuda.empty_cache()
    print(f"phase 6b (a): float32 twin ({MOE_TWIN_B} sequences, "
          f"{MOE_PROMPT}-token prompts, {MOE_TWIN_GEN - 1} steps, capacity "
          f"factor {m.num_experts / m.top_k}): decode vs its forward "
          f"max_abs_err {err32:.3g} (atol {DECODE_TOL[0]}, rtol "
          f"{DECODE_TOL[1]}: excess {excess:.3g})", flush=True)
    _check(excess <= DECODE_TOL[0], "granite float32 paged decode equals "
           "its forward")
    del params, cache
    torch.cuda.empty_cache()
    timing = _uncounted(lambda: attention_timing(
        torch, MOE_B, cfg.n_heads, cfg.n_kv_heads, cfg.hd, geom.max_pages,
        geom.pool_pages, lens, 40, card))
    return launches, timing


def _recurrent_check(torch, cfg, params, prompts, what):
    """Recurrent prefill of ``prompts`` and ``FAMILY_GEN - 1`` greedy decode
    steps through the launcher on its float32 state cache, every step's
    logits held against the forward's at that position (``DECODE_TOL``);
    returns (max_abs_err of all steps, of the last, its excess, the
    forward's logits, the tokens fed, seconds of the run)."""
    from repro_torch.launch import serve
    from repro_torch.models import transformer as T
    B, P = prompts.shape
    with _StepLog(torch, keep=True) as log:
        def run():
            lg, c = serve.run_prefill(cfg, None, params, prompts,
                                      serve.make_state_cache(
                                          cfg, B, P, FAMILY_GEN,
                                          device="cuda"))
            return serve.run_decode(cfg, None, params, lg, c, FAMILY_GEN)
        (toks, _, _), t_run = _timed(torch, run)
    hist = torch.cat([prompts, toks[:, :FAMILY_GEN - 1]], 1)
    x, _ = T.forward(cfg, params, hist)
    want = T.logits_fn(cfg, params, x)
    got = torch.stack(log.logits, 1)
    err_all, excess_all = _excess(torch, got, want)
    err_last, excess_last = _excess(torch, got[:, -1], want[:, -1])
    print(f"{what}: {B} sequences x {hist.shape[1]} tokens recurrently in "
          f"{t_run:.3f} s ({t_run / hist.shape[1] * 1e3:.2f} ms per step); "
          f"every step's logits vs the forward's max_abs_err {err_all:.3g} "
          f"(excess {excess_all:.3g}), the last step's {err_last:.3g} "
          f"(excess {excess_last:.3g}); atol {DECODE_TOL[0]}, rtol "
          f"{DECODE_TOL[1]}; logits std {float(want.std()):.3f}", flush=True)
    _check(excess_all <= DECODE_TOL[0], f"{what}: recurrent decode equals "
           f"the forward at every step")
    return want, hist


def _bf16_steps(torch, cfg, params, B, max_seq, steps) -> str:
    """``steps`` greedy bf16 decode steps (``launch.serve.run_decode``, the
    graphed step) of ``B`` sequences from a fresh float32 state cache of
    room ``max_seq``, each timed, the logits finite; then ``EAGER_STEPS``
    eager ``engine.serve_step`` calls on another fresh cache, timed.
    Returns the report."""
    from repro_torch.launch import serve
    from repro_torch.serving import engine as E
    cache = serve.make_state_cache(cfg, B, max_seq, 0, device="cuda")
    first = torch.zeros((B, cfg.vocab), device="cuda")    # token 0 first
    with _StepLog(torch, timed=True) as log:
        toks, lg, _ = serve.run_decode(cfg, None, params, first, cache,
                                       steps + 1)
    _check(bool(lg.isfinite().all()), f"{cfg.name} bf16 logits finite")
    capture, times = log.times[0], log.times[1:]
    cache = serve.make_state_cache(cfg, B, max_seq, 0, device="cuda")
    eager = []
    for t in range(EAGER_STEPS):
        (_, cache), dt = _timed(torch, lambda: E.serve_step(
            cfg, None, params, toks[:, t], cache))
        eager.append(dt)
    return (f"bf16 decode, {steps} graphed steps of {B} sequences: the "
            f"first (its capture) {capture * 1e3:.3f} ms, then median "
            f"{_median_ms(times):.3f} ms per step (min {min(times) * 1e3:.3f}"
            f", max {max(times) * 1e3:.3f}); {EAGER_STEPS} eager steps: "
            f"median {_median_ms(eager):.3f} ms (min {min(eager) * 1e3:.3f}, "
            f"max {max(eager) * 1e3:.3f})")


def ssm_phase(torch, card) -> None:
    """6b (b): mamba2-370m at full width, launching no kernel."""
    from repro_torch.configs import get_arch
    from repro_torch.models import transformer as T
    cfg = get_arch(SSM_ARCH)
    params, t_init = _timed(torch, lambda: T.init_params(
        cfg, torch.Generator("cuda").manual_seed(SEED)))
    prompts = torch.from_numpy(np.random.RandomState(SEED + 1).randint(
        0, cfg.vocab, (SSM_B, SSM_PROMPT)).astype(np.int32)).cuda()
    s = cfg.ssm
    print(f"phase 6b (b): {cfg.name} {cfg.n_layers} layers d {cfg.d_model}, "
          f"d_state {s.d_state}, {s.expand * cfg.d_model // s.head_dim} "
          f"heads of {s.head_dim}, chunk {s.chunk}, no attention, vocab "
          f"{cfg.vocab}; {_params_gb(params):.2f} GB made in {t_init:.2f} s "
          f"[{card}]", flush=True)
    _reset_launches()
    cfg32, p32 = _float32(torch, cfg, params)
    _recurrent_check(torch, cfg32, p32, prompts, "phase 6b (b) float32")
    del p32
    torch.cuda.empty_cache()
    report = _bf16_steps(torch, cfg, params, SSM_B,
                         SSM_PROMPT + FAMILY_GEN, FAMILY_GEN - 1)
    launches = _kernel_launches()
    print(f"phase 6b (b): {report}; kernel launches {launches} "
          f"[{card}]", flush=True)
    _check(not any(launches.values()), "the ssm path launches no kernel")


def hybrid_phase(torch, card) -> None:
    """6b (c): hymba-1.5b at full width past its window, launching no
    kernel; the ring's negative control."""
    from repro_torch.configs import get_arch
    from repro_torch.models import transformer as T
    from repro_torch.serving import engine as E
    from repro_torch.serving import kvcache as KC
    cfg = get_arch(HYBRID_ARCH)
    params, t_init = _timed(torch, lambda: T.init_params(
        cfg, torch.Generator("cuda").manual_seed(SEED)))
    prompts = torch.from_numpy(np.random.RandomState(SEED + 2).randint(
        0, cfg.vocab, (HYBRID_B, HYBRID_PROMPT)).astype(np.int32)).cuda()
    glob = [i for i, w in enumerate(T.layer_windows(cfg)) if not w]
    print(f"phase 6b (c): {cfg.name} {cfg.n_layers} layers d {cfg.d_model} "
          f"heads {cfg.n_heads}/{cfg.n_kv_heads} of {cfg.hd}, window "
          f"{cfg.window}, global layers {glob}, d_state {cfg.ssm.d_state}, "
          f"vocab {cfg.vocab}; {_params_gb(params):.2f} GB made in "
          f"{t_init:.2f} s [{card}]", flush=True)
    _reset_launches()
    cfg32, p32 = _float32(torch, cfg, params)
    want, hist = _recurrent_check(torch, cfg32, p32, prompts,
                                  "phase 6b (c) float32, every ring wrapped")

    # negative control: the same tokens with each ring written one slot
    # off; it must leave the tolerance (checked step by step, stopped at
    # the first step that does)
    def shifted():
        slot = T.ring_slot
        T.ring_slot = lambda seq_lens, window: (seq_lens + 1) % window
        try:
            cache = KC.create_state_cache(cfg32, HYBRID_B, hist.shape[1],
                                          dtype=torch.float32, device="cuda")
            for t in range(hist.shape[1]):
                lg, cache = E.serve_step(cfg32, None, p32, hist[:, t], cache)
                err, excess = _excess(torch, lg, want[:, t])
                if excess > DECODE_TOL[0]:
                    return t, err
            return None, err
        finally:
            T.ring_slot = slot
    step, err = shifted()
    print(f"phase 6b (c): negative control, each ring slot shifted by one: "
          f"left the tolerance at position {step} (max_abs_err {err:.3g})",
          flush=True)
    _check(step is not None, "a ring written one slot off breaks the "
           "decode-vs-forward tolerance")
    del p32, want
    torch.cuda.empty_cache()
    report = _bf16_steps(torch, cfg, params, HYBRID_B, hist.shape[1],
                         FAMILY_GEN - 1)
    launches = _kernel_launches()
    print(f"phase 6b (c): {report}; kernel launches {launches} "
          f"[{card}]", flush=True)
    _check(not any(launches.values()), "the hybrid path launches no kernel")


def _family_twin(name, device) -> dict:
    """6b (d): one prefill (paged families; from (B, S, E) embeddings for
    the embed frontends) or recurrent pass (ssm, hybrid: past the twin's
    64-token window) of ``name``'s smoke twin plus ``TWIN_STEPS`` decode
    steps of seeded tokens on ``device``; a flat dict of numpy arrays:
    every step's logits, the cache's fields and the MoE's top-k ids."""
    import torch
    from repro_torch import convert
    from repro_torch.configs import smoke_config
    from repro_torch.launch import serve
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T
    from repro_torch.serving import engine as E
    from repro_torch.serving import kvcache as KC
    cfg = smoke_config(name)
    p = T.init_params(cfg, torch.Generator().manual_seed(SEED))
    p = {k: (v.to(device) if k != "blocks" else
             {n: w.to(device) for n, w in v.items()}) for k, v in p.items()}
    rng = np.random.RandomState(SEED + 9)
    recurrent = cfg.family in ("ssm", "hybrid")
    S_ = TWIN_RECURRENT if recurrent else TWIN_PROMPT
    prompt = torch.from_numpy(rng.randint(0, cfg.vocab, (TWIN_B, S_)).astype(
        np.int32)).to(device)
    fed = torch.from_numpy(rng.randint(0, cfg.vocab, (TWIN_B, TWIN_STEPS))
                           .astype(np.int32)).to(device)
    topk, route = [], L.moe_route

    def recording(*args, **kw):
        out = route(*args, **kw)
        topk.append(out[1].cpu().numpy())
        return out
    L.moe_route = recording
    try:
        if recurrent:
            geom = None
            cache = serve.make_state_cache(cfg, TWIN_B, S_, TWIN_STEPS,
                                           device=device)
            lg, cache = serve.run_prefill(cfg, None, p, prompt, cache)
        else:
            geom = serve.make_geometry(cfg, TWIN_B, S_, TWIN_STEPS,
                                       page_size=PAGE_SIZE, shards=2,
                                       device=device)
            if cfg.frontend == "embed":
                prompt = torch.from_numpy(rng.randn(
                    TWIN_B, S_, cfg.d_model).astype(np.float32)).to(device)
                lg, cache = E.prefill(cfg, geom, p, prompt,
                                      KC.create_cache(geom))
            else:
                lg, cache = serve.run_prefill(cfg, geom, p, prompt,
                                              KC.create_cache(geom))
        out = {"logits_0": lg.cpu().numpy()}
        for i in range(TWIN_STEPS):
            lg, cache = E.serve_step(cfg, geom, p, fed[:, i], cache)
            out[f"logits_{i + 1}"] = lg.cpu().numpy()
    finally:
        L.moe_route = route
    if recurrent:
        state = convert.state_cache_to_numpy(cache)
    else:
        state = {k: v for k, v in convert.cache_to_numpy(cache).items()
                 if v is not None}       # a float cache has no scales
        state.update({f"table.{k}": v for k, v in state.pop("table").items()})
    out.update(state)
    out.update({f"topk_{i}": a for i, a in enumerate(topk)})
    return out


def _same_twin(card_out, cpu_out, what) -> float:
    """Integer arrays equal, float ones within ``TWIN_TOL``; returns the
    largest float difference."""
    _check(sorted(card_out) == sorted(cpu_out), f"{what}: the same fields")
    worst = 0.0
    for k, a in cpu_out.items():
        b = card_out[k]
        if a.dtype.kind in "iub":
            _check(a.dtype == b.dtype and np.array_equal(a, b),
                   f"{what}: {k} equal")
        else:
            e = float(np.abs(b.astype(np.float64) - a).max()) if a.size else 0
            _check(e <= TWIN_TOL, f"{what}: {k} within {TWIN_TOL} ({e})")
            worst = max(worst, e)
    return worst


def families_phase(torch, card, twins) -> tuple:
    """Phase 6b; returns the moe path's launches and the attention
    kernel's timing at granite's decode shape."""
    from repro_torch.configs import ARCHS
    t0 = time.perf_counter()
    launches, timing = moe_phase(torch, card)
    t1 = time.perf_counter()
    ssm_phase(torch, card)
    torch.cuda.empty_cache()
    t2 = time.perf_counter()
    hybrid_phase(torch, card)
    torch.cuda.empty_cache()
    t3 = time.perf_counter()
    worst, t_card = {}, 0.0
    for name in ARCHS:
        out, t = _timed(torch, lambda: _uncounted(
            lambda: _family_twin(name, "cuda")))
        cpu, _ = twins.get("6b", name)
        worst[name] = _same_twin(out, cpu, f"the {name} twin, card vs CPU")
        t_card += t
    print(f"phase 6b (d): the ten twins on the card equal the CPU's runs "
          f"(integer state exact: page tables, seq_lens, top-k ids; floats "
          f"within {TWIN_TOL}: worst {max(worst.values()):.3g}) in "
          f"{t_card:.1f} s; (a) {t1 - t0:.1f} s, (b) {t2 - t1:.1f} s, (c) "
          f"{t3 - t2:.1f} s [{card}]", flush=True)
    return launches, timing


# ---------------------------------------------------------------------------
# phase 7: training at full width
# ---------------------------------------------------------------------------

TRAIN_LAYERS = 8               # of Yi-6B's 32: float32 masters, gradients
                               # and two moments take ~30.5 GB (all 32: ~97)
TRAIN_B, TRAIN_SEQ, TRAIN_MICRO = 2, 4_096, 2   # train_4k's sequence length
TRAIN_STEPS = 6
# lr 1e-5: at d 4096, lr 1e-3 (5e-4 in the first, sign-like Adam step)
# dropped the repeated batch's loss from 11.9 to 0.07 in one step, and
# the next steps oscillated (0.68, 4.72, 1.30, 0.62)
TRAIN_OPT = dict(lr=1e-5, warmup=2, decay_steps=100)
BF16_LOSS_REL, BF16_NORM_REL = 1e-2, 0.05      # bf16 against float32 compute
TRAIN_TWIN_STEPS, TRAIN_TWIN_B, TRAIN_TWIN_SEQ = 3, 2, 64
TRAIN_TWIN_REL = 1e-4          # (b): card vs CPU losses, relative
DRILL_STEPS, DRILL_SAVE = 6, 4  # (c): uninterrupted steps, the saved step


def _train_twin(name, device) -> dict:
    """7 (b): ``TRAIN_TWIN_STEPS`` AdamW steps of ``name``'s smoke twin on
    ``device`` from float32 masters drawn on the CPU from ``SEED``, on the
    train launcher's batches; {"loss_<i>": loss}."""
    import torch
    from repro_torch.configs import smoke_config
    from repro_torch.launch import train as launch_train
    from repro_torch.models import transformer as T
    from repro_torch.training import optimizer as O
    from repro_torch.training.train_step import make_train_step
    cfg = smoke_config(name)
    p = T.init_params(cfg, torch.Generator().manual_seed(SEED),
                      master_dtype=torch.float32)
    p = O.tree_map(lambda t: t.to(device), p)
    state = O.init(p)
    step = make_train_step(cfg, O.OptConfig(**TRAIN_OPT))
    out = {}
    for i in range(TRAIN_TWIN_STEPS):
        p, state, stats = step(p, state, launch_train.synthetic_batch(
            cfg, SEED, i, TRAIN_TWIN_B, TRAIN_TWIN_SEQ, device))
        out[f"loss_{i}"] = float(stats["loss"])
    return out


def _restart_drill(torch, card) -> str:
    """7 (c): ``smoke_config("yi-6b")`` on the card, ``DRILL_STEPS`` steps
    with an async save after step ``DRILL_SAVE``, a .tmp directory of an
    interrupted later save, a restore into a fresh init through a new
    manager and the remaining steps: their losses equal the uninterrupted
    run's exactly."""
    import os
    import tempfile
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import smoke_config
    from repro_torch.launch import train as launch_train
    from repro_torch.models import transformer as T
    from repro_torch.training import optimizer as O
    from repro_torch.training.train_step import make_train_step
    cfg = smoke_config("yi-6b")
    step = make_train_step(cfg, O.OptConfig(**TRAIN_OPT))
    batches = [launch_train.synthetic_batch(cfg, SEED, i, 4, 64, "cuda")
               for i in range(DRILL_STEPS)]

    def fresh():
        p = T.init_params(cfg, torch.Generator("cuda").manual_seed(SEED),
                          master_dtype=torch.float32)
        return p, O.init(p)
    with tempfile.TemporaryDirectory() as d:
        p, state = fresh()
        mgr = CheckpointManager(d, async_save=True)
        losses = []
        for i in range(DRILL_STEPS):
            p, state, stats = step(p, state, batches[i])
            losses.append(float(stats["loss"]))
            if i + 1 == DRILL_SAVE:
                mgr.save(DRILL_SAVE, {"p": p, "o": state})
        mgr.wait()
        tmp = os.path.join(d, f"step_{DRILL_STEPS:09d}.tmp")
        os.makedirs(tmp)                 # an interrupted save: no commit
        np.save(os.path.join(tmp, "p.embed.npy"), np.zeros(4, np.float32))
        mgr = CheckpointManager(d)
        _check(mgr.latest_step() == DRILL_SAVE, "an uncommitted .tmp save "
               "is invisible to restart")
        restored, at, _ = mgr.restore(dict(zip("po", fresh())))
        _check(at == DRILL_SAVE and int(restored["o"].step) == DRILL_SAVE,
               "the newest committed step is restored")
        p, state = restored["p"], restored["o"]
        again = []
        for i in range(DRILL_SAVE, DRILL_STEPS):
            p, state, stats = step(p, state, batches[i])
            again.append(float(stats["loss"]))
    _check(again == losses[DRILL_SAVE:], f"the restarted run's losses equal "
           f"the uninterrupted run's exactly ({again} vs "
           f"{losses[DRILL_SAVE:]})")
    return (f"losses {[round(x, 6) for x in losses]}, after the restart "
            f"{[round(x, 6) for x in again]} (equal)")


def training_phase(torch, card, twins) -> dict:
    """Phase 7; returns the kernels' launches on the training path (all 0,
    as in the reference: its training path reaches no Pallas kernel)."""
    import dataclasses
    from repro_torch.configs import ARCHS, get_arch
    from repro_torch.models import transformer as T
    from repro_torch.training import optimizer as O
    from repro_torch.training.train_step import (make_train_step,
                                                 microbatch_grads)
    import gc
    t0 = time.perf_counter()
    gc.collect()                  # the earlier phases' cycles (graphs, caches)
    torch.cuda.empty_cache()
    in_use = torch.cuda.memory_allocated() / 2 ** 30
    _reset_launches()
    cfg = dataclasses.replace(get_arch("yi-6b"), n_layers=TRAIN_LAYERS,
                              remat="full")
    params, t_init = _timed(torch, lambda: T.init_params(
        cfg, torch.Generator("cuda").manual_seed(SEED),
        master_dtype=torch.float32))
    n_params = sum(t.numel() for _, t in O.leaves(params))
    rng = np.random.RandomState(SEED + 7)
    toks = rng.randint(0, cfg.vocab, (TRAIN_B, TRAIN_SEQ)).astype(np.int32)
    batch = {"inputs": torch.from_numpy(toks).cuda(),
             "labels": torch.from_numpy(np.roll(toks, -1, 1)).cuda()}
    print(f"phase 7: {cfg.name} at its published widths, {TRAIN_LAYERS} of "
          f"32 layers, remat {cfg.remat}: {n_params / 1e9:.3f} B float32 "
          f"master parameters made in {t_init:.2f} s; {TRAIN_B} x "
          f"{TRAIN_SEQ} tokens in {TRAIN_MICRO} microbatches; device memory "
          f"in use before {in_use:.3f} GiB [{card}]", flush=True)

    # the bf16-compute gradients against float32-compute ones, same masters
    stats = {}
    for dtype in ("bfloat16", "float32"):
        c = dataclasses.replace(cfg, dtype=dtype)
        (loss, grads), t = _timed(torch, lambda: microbatch_grads(
            c, params, batch, TRAIN_MICRO, torch.float32))
        stats[dtype] = (float(loss), float(O.global_norm(grads)), t)
        del grads
        torch.cuda.empty_cache()
    (l16, n16, t16), (l32, n32, t32) = stats["bfloat16"], stats["float32"]
    print(f"phase 7 (a): bf16 compute loss {l16:.6f}, gradient norm "
          f"{n16:.6f} ({t16:.2f} s); float32 compute loss {l32:.6f}, norm "
          f"{n32:.6f} ({t32:.2f} s); relative {abs(l16 - l32) / l32:.3g} / "
          f"{abs(n16 - n32) / n32:.3g} (limits {BF16_LOSS_REL} / "
          f"{BF16_NORM_REL})", flush=True)
    _check(abs(l16 - l32) <= BF16_LOSS_REL * abs(l32), "the bf16-compute "
           "loss within 1e-2 of the float32-compute loss")
    _check(abs(n16 - n32) <= BF16_NORM_REL * n32, "the bf16-compute "
           "gradient norm within 5 % of the float32-compute one")

    state = O.init(params)
    step = make_train_step(cfg, O.OptConfig(**TRAIN_OPT),
                           num_micro=TRAIN_MICRO)
    torch.cuda.reset_peak_memory_stats()
    losses, times = [], []
    for _ in range(TRAIN_STEPS):
        (params, state, st), t = _timed(torch, lambda: step(params, state,
                                                            batch))
        losses.append(float(st["loss"]))
        times.append(t)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    s_step = sorted(times[1:])[len(times[1:]) // 2]
    print(f"phase 7 (a): {TRAIN_STEPS} steps on a repeated batch, losses "
          f"{[round(x, 4) for x in losses]}; {s_step:.3f} s per step "
          f"(median of steps 2-{TRAIN_STEPS}; the first {times[0]:.3f} s) "
          f"= {TRAIN_B * TRAIN_SEQ / s_step:.0f} tokens/s; peak device "
          f"memory {peak:.3f} GiB [{card}]", flush=True)
    _check(all(np.isfinite(losses)), "training losses finite")
    _check(losses[-1] < losses[0], "the loss falls over the steps")
    del params, state, batch
    torch.cuda.empty_cache()
    t1 = time.perf_counter()

    # (b) the ten smoke twins, card against the CPU twins' process
    worst = 0.0
    for name in ARCHS:
        got = _train_twin(name, "cuda")
        want, _ = twins.get("7", name)
        for k, w in want.items():
            rel = abs(got[k] - w) / abs(w)
            _check(rel <= TRAIN_TWIN_REL, f"the {name} twin's {k} on the "
                   f"card within {TRAIN_TWIN_REL} of the CPU's ({rel})")
            worst = max(worst, rel)
    t2 = time.perf_counter()
    print(f"phase 7 (b): the ten twins, {TRAIN_TWIN_STEPS} steps each, card "
          f"losses equal the CPU's within {TRAIN_TWIN_REL} relative (worst "
          f"{worst:.3g}) in {t2 - t1:.1f} s [{card}]", flush=True)

    # (c) the restart drill
    report = _restart_drill(torch, card)
    launches = _kernel_launches()
    print(f"phase 7 (c): restart drill on the yi-6b twin: {report}; the "
          f"training path's kernel launches {launches}; (a) {t1 - t0:.1f} "
          f"s, (b) {t2 - t1:.1f} s, (c) {time.perf_counter() - t2:.1f} s "
          f"[{card}]", flush=True)
    _check(not any(launches.values()), "the training path launches no "
           "kernel")
    return launches


# ---------------------------------------------------------------------------
# phase 7b: the multi-device layer at world 1
# ---------------------------------------------------------------------------

# the reference's service table (src/repro/launch/dryrun.py:415-420)
DIST_BUCKETS = 2 ** 22          # 2,097,152 pairs, 33,554,432 segment slots
DIST_RECORDS = int(0.3 * DIST_BUCKETS * 8)   # load factor 0.3 (cut from 0.6)
DIST_BATCH = 65_536             # write and read-back batch
DIST_CLIENT_B = 4_096           # the reference's batch per client
DIST_CLIENT_BATCHES = 256
DIST_MIX_B = 4_096              # the walk's mixed batch (card vs host copy)
DIST_TRAIN_STEPS = 2
DIST_SERVE_STEPS = 2            # 7b (c): decode steps after the prefill
DIST_LOSS_TOL, DIST_ATOL, DIST_RTOL = 1e-3, 2e-4, 2e-3   # test_distributed


def _free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def _mixed_entries(torch, keys, ok, fresh, gen):
    """DIST_MIX_B write requests over the loaded store: updates and deletes
    of acknowledged keys, inserts of fresh and of present keys, and 64
    keys each taking insert, update, delete, insert, update, update,
    delete, insert in one batch; (op, keys, vals) in batch order."""
    from repro_torch.core import distributed as D
    acked = torch.nonzero(ok).flatten()
    pick = acked[torch.randperm(acked.numel(), generator=gen,
                                device="cuda")[:2560]]
    rep = fresh[:64]
    cycle = [D.OP_INSERT, D.OP_UPDATE, D.OP_DELETE, D.OP_INSERT,
             D.OP_UPDATE, D.OP_UPDATE, D.OP_DELETE, D.OP_INSERT]
    k = torch.cat([keys[pick[:1024]], keys[pick[1024:2048]], fresh[64:1088],
                   keys[pick[2048:2560]],
                   rep.repeat(8, 1)])                 # copies spread out
    op = torch.tensor([D.OP_UPDATE] * 1024 + [D.OP_DELETE] * 1024
                      + [D.OP_INSERT] * 1536 + [c for c in cycle
                                                for _ in range(64)],
                      dtype=torch.int32, device="cuda")
    order = torch.randperm(DIST_MIX_B - 512, generator=gen, device="cuda")
    k = torch.cat([k[:-512][order], k[-512:]])
    op = torch.cat([op[:-512][order], op[-512:]])
    v = torch.randint(-2 ** 31, 2 ** 31, (DIST_MIX_B, 4), dtype=torch.int32,
                      generator=gen, device="cuda")
    return op, k.contiguous(), v


def _dist_store(torch, card) -> dict:
    """7b (a): the sharded store at the service size, world 1 on the card."""
    from repro_torch import api
    from repro_torch.core import continuity as ch
    from repro_torch.core import distributed as D
    from repro_torch.kernels import scan_walk as SW
    from repro_torch.launch.mesh import make_debug_mesh
    scfg = D.StoreConfig(table=ch.ContinuityConfig(num_buckets=DIST_BUCKETS,
                                                   ext_frac=0.0),
                         num_shards=1)
    mesh = make_debug_mesh((1,), ("data",), device_type="cuda")
    write, lookup = D.make_write(scfg, mesh), D.make_lookup(scfg, mesh)
    table = D.create_sharded(scfg, "cuda")
    gen = torch.Generator("cuda").manual_seed(SEED + 11)
    N = DIST_RECORDS
    keys = torch.randint(-2 ** 31, 2 ** 31, (N, 4), dtype=torch.int32,
                         generator=gen, device="cuda")
    vals = torch.randint(-2 ** 31, 2 ** 31, (N, 4), dtype=torch.int32,
                         generator=gen, device="cuda")
    fresh = torch.randint(-2 ** 31, 2 ** 31, (DIST_BATCH, 4),
                          dtype=torch.int32, generator=gen, device="cuda")
    ins = torch.full((DIST_BATCH,), D.OP_INSERT, dtype=torch.int32,
                     device="cuda")
    ok = torch.empty(N, dtype=torch.bool, device="cuda")
    routed = torch.empty(N, dtype=torch.bool, device="cuda")

    def load():
        for s in range(0, N, DIST_BATCH):
            e = min(s + DIST_BATCH, N)
            _, ok[s:e], routed[s:e] = write(table, ins[:e - s], keys[s:e],
                                            vals[s:e])
    _, t_load = _timed(torch, load)
    acked = int(ok.sum())
    # the walk's floor: one dependent trip to a random pair row of the
    # loaded table (its slot keys, 320 B apart; mostly beyond L2)
    rows = table.keys.view(torch.uint8).reshape(-1)
    floor_us = _chase_us(torch, rows, scfg.table.slots_per_pair * 16,
                         CHASE_COLD_STEPS, SEED + 40)
    _check(bool(routed.all()), "world 1 routes every write")
    found = torch.empty(N, dtype=torch.bool, device="cuda")
    got = torch.empty_like(vals)

    def read():
        for s in range(0, N, DIST_BATCH):
            r = lookup(table, keys[s:s + DIST_BATCH])
            found[s:s + DIST_BATCH], got[s:s + DIST_BATCH] = r.found, r.values
        return lookup(table, fresh)
    neg, t_read = _timed(torch, read)
    _check(torch.equal(found, ok), "every acknowledged record reads back and "
           "no refused one does")
    _check(torch.equal(got[ok], vals[ok]), "every acknowledged record's "
           "value reads back")
    _check(not bool(neg.found.any()), "no absent key is found")
    led = [int(x) for x in neg.ledger]
    _check(led[1] == DIST_BATCH and led[3] == DIST_BATCH,
           f"the read ledger counts one row read per key ({led})")

    # the unsharded store of the same geometry, loaded with what was acked
    # (a comparison: its probe launches are not the sharded path's)
    def unsharded():
        store = api.make_store("continuity", num_buckets=DIST_BUCKETS,
                               ext_frac=0.0, stash_frac=0.0, device="cuda")
        flat = store.create()
        ak, av = keys[ok], vals[ok]
        for s in range(0, acked, 2 ** 20):
            _, res = store.insert(flat, ak[s:s + 2 ** 20],
                                  av[s:s + 2 ** 20])
            _check(bool(res.ok.all()), "the unsharded store takes every "
                   "acknowledged record")
        del ak, av
        for s in range(0, N, 2 ** 20):
            res = store.lookup(flat, keys[s:s + 2 ** 20])
            _check(torch.equal(res.ok, found[s:s + 2 ** 20]), "the sharded "
                   "found set equals the unsharded store's")
            hit = res.ok
            _check(torch.equal(res.values[hit], got[s:s + 2 ** 20][hit]),
                   "the sharded values equal the unsharded store's")
        _check(not bool(store.lookup(flat, fresh).ok.any()), "the unsharded "
               "store finds no absent key either")
    _uncounted(unsharded)
    torch.cuda.empty_cache()

    # 256 client batches of 4,096 acknowledged keys, timed
    idx = torch.nonzero(ok).flatten()
    batches = [keys[idx[torch.randint(0, idx.numel(), (DIST_CLIENT_B,),
                                      generator=gen, device="cuda")]]
               for _ in range(8)]
    client_ms = _event_ms(torch, lambda b: lookup(table, b), batches,
                          DIST_CLIENT_BATCHES)

    # the walk's mixed batch on a clone, against its plain version on a
    # host copy of the table, byte for byte; then the kernel timed alone
    op, mk, mv = _mixed_entries(torch, keys, ok, fresh, gen)
    pair, parity = ch.locate(scfg.table, mk)
    ent = (pair.to(torch.int32), parity.to(torch.int32), op, mk, mv,
           torch.ones(DIST_MIX_B, dtype=torch.bool, device="cuda"))
    lcfg = scfg.local_cfg
    host = ch.ContinuityTable(*(t.cpu() for t in table))
    clone = ch.ContinuityTable(*(t.clone() for t in table))
    status = _uncounted(lambda: SW.routed_write(lcfg, clone, *ent))
    t0 = time.perf_counter()
    want = SW.routed_write(lcfg, host, *(t.cpu() for t in ent))
    plain_ms = (time.perf_counter() - t0) * 1e3
    _check(torch.equal(status.cpu(), want), "the routed walk's status equals "
           "its plain version's")
    for f in ch.ContinuityTable._fields:
        _check(torch.equal(getattr(clone, f).cpu(), getattr(host, f)),
               f"the routed walk's table field {f} equals its plain "
               f"version's byte for byte")
    n_ok = int(want.sum())
    _check(0 < n_ok < DIST_MIX_B, f"the mixed batch both applies and refuses "
           f"({n_ok} of {DIST_MIX_B})")
    del host
    # timed from a cold L2 (a pass over the table's slot keys first), as
    # the floor's chase, and warm (the batch's rows left by the last call)
    def cold():
        torch.count_nonzero(rows)
    walk_ms, warm_ms = (_uncounted(lambda: _device_ms(
        torch, lambda _: SW.routed_write(lcfg, clone, *ent), [None], 8,
        KERNEL_SLEEP, before)) for before in (cold, None))
    del clone
    torch.cuda.empty_cache()
    print(f"phase 7b (a): sharded store (world 1, NCCL) at the service size, "
          f"{DIST_BUCKETS} buckets: {acked} of {N} records acknowledged "
          f"(load factor {acked / (DIST_BUCKETS * 8):.6f} of the segment "
          f"slots) "
          f"in {t_load:.2f} s through make_write "
          f"({t_load / N * 1e6:.4f} µs per routed insert); read back with "
          f"{DIST_BATCH} absent keys in {t_read:.2f} s, found set and values "
          f"equal the unsharded ContinuityStore's; {DIST_CLIENT_BATCHES} "
          f"client batches of {DIST_CLIENT_B}: {client_ms:.4f} ms each; the "
          f"routed walk's mixed batch of {DIST_MIX_B} ({n_ok} applied) equals "
          f"its plain version byte for byte, {walk_ms:.4f} ms on the card "
          f"from a cold L2, {warm_ms:.4f} ms warm (plain {plain_ms:.1f} ms "
          f"on a host copy; latency floor "
          f"{DIST_MIX_B * floor_us / 1e3:.4f} ms: {floor_us:.4f} µs per "
          f"dependent row trip) [{card}]", flush=True)
    del table, keys, vals
    torch.cuda.empty_cache()
    return {"B": DIST_MIX_B, "replaces": "src/repro/core/distributed.py:228",
            "ms": walk_ms, "warm_ms": warm_ms,
            "plain_ms": plain_ms,
            "latency_floor_ms": DIST_MIX_B * floor_us / 1e3,
            "max_abs_err": 0, "load_s": t_load, "read_s": t_read,
            "acked": acked, "client_ms": client_ms}


def _dist_train(torch, card) -> str:
    """7b (b): phase 7's Yi-6B cut, 2 steps on a (1, 1) mesh against the
    same 2 steps unsharded."""
    import dataclasses
    from repro_torch.configs import get_arch
    from repro_torch.distribution import sharding as SH
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import transformer as T
    from repro_torch.training import optimizer as O
    from repro_torch.training.train_step import make_train_step, place_state
    cfg = dataclasses.replace(get_arch("yi-6b"), n_layers=TRAIN_LAYERS,
                              remat="full")
    opt = O.OptConfig(**TRAIN_OPT)
    step = make_train_step(cfg, opt, num_micro=TRAIN_MICRO)
    rng = np.random.RandomState(SEED + 7)
    toks = rng.randint(0, cfg.vocab, (TRAIN_B, TRAIN_SEQ)).astype(np.int32)
    batch = {"inputs": torch.from_numpy(toks).cuda(),
             "labels": torch.from_numpy(np.roll(toks, -1, 1)).cuda()}
    params = T.init_params(cfg, torch.Generator("cuda").manual_seed(SEED),
                           master_dtype=torch.float32)
    start = O.tree_map(lambda t: t.clone(), params)
    state = O.init(params)
    ref_loss, times = [], []
    for _ in range(DIST_TRAIN_STEPS):
        (params, state, st), t = _timed(torch, lambda: step(params, state,
                                                            batch))
        ref_loss.append(float(st["loss"]))
        times.append(t)
    del state
    torch.cuda.empty_cache()
    mesh = make_debug_mesh((1, 1), ("data", "model"), device_type="cuda")
    losses, dtimes = [], []
    with SH.use_mesh(mesh):
        p, s = place_state(cfg, opt, start, O.init(start))
        del start
        for _ in range(DIST_TRAIN_STEPS):
            (p, s, st), t = _timed(torch, lambda: step(p, s, batch))
            losses.append(float(st["loss"]))
            dtimes.append(t)
        placed = {k: tuple(v.placements) for k, v in O.leaves(p)}
        worst = 0.0
        for (k, a), (_, b) in zip(O.leaves(params), O.leaves(p)):
            d = (b.to_local() - a).abs()
            worst = max(worst, float((d - DIST_RTOL * a.abs()).max()))
    del p, s, params
    torch.cuda.empty_cache()
    for a, b in zip(ref_loss, losses):
        _check(abs(a - b) < DIST_LOSS_TOL, f"the sharded loss {b} within "
               f"{DIST_LOSS_TOL} of the unsharded {a}")
    _check(worst <= DIST_ATOL, f"every sharded leaf within atol {DIST_ATOL} "
           f"/ rtol {DIST_RTOL} of the unsharded run ({worst})")
    return (f"phase 7b (b): {cfg.name} {TRAIN_LAYERS} layers, "
            f"{TRAIN_B} x {TRAIN_SEQ} tokens, {DIST_TRAIN_STEPS} steps on a "
            f"(1, 1) ('data', 'model') mesh (DTensor, wq placed "
            f"{placed['blocks.wq']}): losses {losses} against the unsharded "
            f"{ref_loss}; worst leaf excess over rtol {worst:.3g} (atol "
            f"{DIST_ATOL}); {[round(t, 3) for t in dtimes]} s per step "
            f"against {[round(t, 3) for t in times]} [{card}]")


def dist_serve_record(torch) -> dict:
    """What phase 5 records for phase 7b (c), made alone (for
    ``tools/multidevice_phase.py``): phase 5's weights, prompts and
    geometry through the launcher's ``run_prefill`` and ``run_decode``,
    the prefill and ``DIST_SERVE_STEPS`` greedy decode steps."""
    from repro_torch.configs import get_arch
    from repro_torch.launch import serve
    from repro_torch.serving import kvcache as KC
    cfg = get_arch("yi-6b")
    params = _serving_weights(torch, cfg)
    geom = serve.make_geometry(cfg, SERVE_B, PROMPT_LEN, GEN,
                               page_size=PAGE_SIZE, shards=1, device="cuda")
    lg, cache = serve.run_prefill(cfg, geom, params, _prompts(torch, cfg),
                                  KC.create_cache(geom))
    with _FirstSteps(DIST_SERVE_STEPS) as first:
        toks, _, cache = serve.run_decode(cfg, geom, params, lg, cache,
                                          DIST_SERVE_STEPS + 1)
    return {"prefill_logits": lg, "logits": first.logits,
            "state": first.state, "toks": toks, "kpool": cache.kpool,
            "vpool": cache.vpool}


def _written_rows(torch, geom, cache):
    """(NP, PS) mask of the pool rows of a one-shard paged cache that its
    sequences have written, from its page table: the rows below each
    sequence's length on each of its mapped pages."""
    from repro_torch.serving import kvcache as KC
    PS = geom.page_size
    pt = KC.lookup_pages(geom, cache.table, cache.seq_ids)[0]  # (B, MAXP)
    lens = cache.seq_lens[0].long()
    rows = torch.arange(PS, device=pt.device)
    pages = torch.arange(pt.shape[1], device=pt.device)
    ok = (pt >= 0)[..., None] & (
        (pages[None, :, None] * PS + rows) < lens[:, None, None])
    mask = torch.zeros((geom.pool_pages, PS), dtype=torch.bool,
                       device=pt.device)
    mask[pt.clamp(min=0).long()[..., None].expand_as(ok)[ok],
         rows.expand_as(ok)[ok]] = True
    return mask


def _dist_serve(torch, card, record) -> str:
    """7b (c): phase 5's Yi-6B serving (its bf16 weights drawn again from
    its seed, its 32 prompts, page size 16) on a (1, 1) ``("data",
    "model")`` mesh: the prefill and ``DIST_SERVE_STEPS`` decode steps fed
    phase 5's greedy tokens, on this rank's shard of the cache
    (``kvcache.shard_cache``; at world 1 every placement is ``Replicate()``
    and the slice is the whole page), attention through the kernel's slice
    mode and the merge.  The logits, the page tables and sequence fields,
    and every pool row written equal phase 5's bit for bit."""
    from repro_torch.configs import get_arch
    from repro_torch.distribution import sharding as SH
    from repro_torch.launch import serve
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import transformer as T
    from repro_torch.serving import engine as E
    from repro_torch.serving import kvcache as KC
    cfg = get_arch("yi-6b")
    params = _serving_weights(torch, cfg)
    prompts = _prompts(torch, cfg)
    geom = serve.make_geometry(cfg, SERVE_B, PROMPT_LEN, GEN,
                               page_size=PAGE_SIZE, shards=1, device="cuda")
    mesh = make_debug_mesh((1, 1), ("data", "model"), device_type="cuda")
    with SH.use_mesh(mesh):
        p = SH.distribute(params, T.param_logical_axes(cfg, params))
        lgeom, cache = KC.shard_cache(geom, KC.create_cache(geom))
        torch.cuda.empty_cache()
        _reset_launches()
        (lg, cache), t_pre = _timed(torch, lambda: E.prefill(
            cfg, lgeom, p, prompts, cache))
        logits, times = [lg], []
        for i in range(DIST_SERVE_STEPS):
            (lg, cache), t = _timed(torch, lambda: E.serve_step(
                cfg, lgeom, p, record["toks"][:, i], cache))
            logits.append(lg)
            times.append(t)
        launches = _kernel_launches()
    _check(torch.equal(logits[0], record["prefill_logits"]),
           "7b (c): the sharded prefill's logits equal phase 5's bit for bit")
    for i, (a, b) in enumerate(zip(logits[1:], record["logits"])):
        _check(torch.equal(a, b), f"7b (c): decode step {i}'s logits equal "
               f"phase 5's bit for bit")
    state = _table_state(cache)
    for k, v in record["state"].items():
        _check(torch.equal(state[k], v), f"7b (c): {k} equals phase 5's")
    mask = _written_rows(torch, lgeom, cache)
    rows = int(mask.sum())
    for name in ("kpool", "vpool"):
        mine, ref = getattr(cache, name), record[name]
        for layer in range(cfg.n_layers):
            a = mine[layer, 0].permute(0, 2, 1, 3)[mask]
            b = ref[layer, 0].permute(0, 2, 1, 3)[mask]
            _check(torch.equal(a, b), f"7b (c): {name} layer {layer}'s "
                   f"written rows equal phase 5's bit for bit")
    n = DIST_SERVE_STEPS * cfg.n_layers
    _check(launches["paged_attention_slice"] == launches["paged_attention"]
           == launches["attention_merge"] == n, f"7b (c): one slice-mode "
           f"attention launch and one merge per layer per step ({launches})")
    _check(launches["probe_segments"] > 0, "7b (c): the sharded serving "
           "path's page-table lookups launched the probe kernel")
    del cache, p, params, logits
    torch.cuda.empty_cache()
    return (launches, f"phase 7b (c): {cfg.name} serving on a (1, 1) "
            f"('data', 'model') mesh: prefill {SERVE_B} x {PROMPT_LEN} "
            f"tokens in {t_pre:.3f} s, {DIST_SERVE_STEPS} decode steps "
            f"{[round(t * 1e3, 2) for t in times]} ms (slice "
            f"{lgeom.page_slice} of {lgeom.page_slices} per page); logits, "
            f"page tables, sequence fields and the {rows} written pool rows "
            f"per layer equal phase 5's bit for bit; launches {launches} "
            f"[{card}]")


def multidevice_phase(torch, card, record) -> tuple:
    """Phase 7b: a world-1 NCCL group in this process, the sharded store,
    the sharded training step and the sharded serving step (held against
    phase 5's ``record``) on the card, the group torn down at the end;
    returns (the walk's routed-mode record, the kernels' launches on (a)
    and (c), summed)."""
    import torch.distributed as dist
    t0 = time.perf_counter()
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{_free_port()}", rank=0, world_size=1)
    try:
        _reset_launches()
        routed = _dist_store(torch, card)
        launches = _kernel_launches()
        t1 = time.perf_counter()
        _reset_launches()
        line = _dist_train(torch, card)
        train_launches = _kernel_launches()
        t2 = time.perf_counter()
        serve_launches, serve_line = _dist_serve(torch, card, record)
    finally:
        dist.destroy_process_group()
    print(f"{line}; (a) {t1 - t0:.1f} s, (b) {t2 - t1:.1f} s; launches (a) "
          f"{launches}, (b) {train_launches}", flush=True)
    print(f"{serve_line}; (c) {time.perf_counter() - t2:.1f} s", flush=True)
    _check(launches["scan_walk"] > 0, "the sharded store's writes launched "
           "the serial walk")
    _check(not any(train_launches.values()), "the sharded training path "
           "launches no kernel")
    return routed, {k: launches[k] + serve_launches[k] for k in launches}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available; this script runs "
              "on the card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch  # noqa: F401  (fails here, alone, without the repo)
    # the CPU twins of phases 3e-3g run in their own process meanwhile
    twins = _Twins()
    try:
        return _smoke(torch, twins)
    finally:
        for child in _CHILDREN:
            child.stop()


def _smoke(torch, twins) -> int:
    from repro_torch import api
    from repro_torch.core import continuity as ch
    from repro_torch.data import ycsb
    from repro_torch.kernels import _cuda, mutate, probe
    from repro_torch.kernels import ops as K

    # float32 matmuls in full float32 (the float32 checks of phase 5)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # -- phase 1: header and build ---------------------------------------
    t_smoke = time.perf_counter()
    card = _smi()
    _, t_build = _timed(torch, lambda: _cuda.build_all(
        variants=(_cuda.ATTN_STAMPS,)))
    print(f"card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}; kernel build {t_build:.2f} s "
          f"({len(_cuda.SOURCES)} sources and the attention kernel's "
          f"stamped build in parallel)", flush=True)
    for source in _cuda.SOURCES:
        for line in _cuda.build_log.get(source, "").splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {source}: {line.strip()}", flush=True)
    keys, vals = _records(torch, ycsb)

    # -- phase 2: store kernels against their plain versions -------------
    rows = kernel_phase(torch, api, ch, ycsb, K, _cuda, probe, mutate, keys,
                        vals, card)

    # -- phase 3: the store's request path, its launches counted ---------
    torch.cuda.reset_peak_memory_stats()
    probe.probe_segments.launches = 0
    mutate.mutate_segments.launches = 0
    t0 = time.perf_counter()
    cont = main_path(torch, api, ch, ycsb, K, keys, vals, card)
    t_main = time.perf_counter() - t0
    launches = {"probe_segments": probe.probe_segments.launches,
                "mutate_segments": mutate.mutate_segments.launches}
    print(f"request path: {t_main:.1f} s, kernel launches {launches}, device "
          f"memory in use {torch.cuda.memory_allocated() / 2 ** 30:.3f} GiB, "
          f"peak {torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB "
          f"[{card}]", flush=True)
    for name, n in launches.items():
        _check(n > 0, f"the request path launched {name}")

    # -- phase 3b: the serial walk against its plain version -------------
    t0 = time.perf_counter()
    walk_err = _uncounted(lambda: walk_phase(torch, card))
    print(f"phase 3b: {time.perf_counter() - t0:.1f} s", flush=True)

    # -- phase 3c: the baselines at full size, their launches counted ----
    t0 = time.perf_counter()
    base, walk_launches, walk_timing = baselines_phase(torch, api, ycsb,
                                                       keys, vals, card)
    table1_report(cont, base, card)
    print(f"baselines path: {time.perf_counter() - t0:.1f} s, scan_walk "
          f"launches {walk_launches} [{card}]", flush=True)
    torch.cuda.empty_cache()

    # -- phase 3f (b): the full-size cluster, in its own process from here
    cluster_full = _Child(_cluster_full_main, "phase 3f (b) on the card")

    # -- phase 3d: the end-to-end simulator, its launches counted --------
    t0 = time.perf_counter()
    e2e_phase(torch, card)
    print(f"end-to-end path: {time.perf_counter() - t0:.1f} s", flush=True)

    # -- phase 3e: maintenance and crash consistency, launches counted ---
    t0 = time.perf_counter()
    m_launches, m_checks = maintenance_phase(torch, api, ch, ycsb, keys,
                                             vals, card, twins)
    del keys, vals
    torch.cuda.empty_cache()
    sim_batcher_check(torch, card)
    print(f"maintenance path: {time.perf_counter() - t0:.1f} s, kernel "
          f"launches {m_launches} [{card}]", flush=True)

    # -- phase 3f (a): the cluster at the reference's sizes, counted -----
    t0 = time.perf_counter()
    c_launches, c_checks = cluster_phase(torch, card, twins)
    torch.cuda.empty_cache()
    print(f"phase 3f (a): {time.perf_counter() - t0:.1f} s, kernel launches "
          f"{c_launches} [{card}]", flush=True)

    # -- phase 3g: the client cache and the chaos matrix, launches counted -
    t0 = time.perf_counter()
    g_launches, g_checks = cache_phase(torch, card, twins)
    torch.cuda.empty_cache()
    print(f"cache and chaos path: {time.perf_counter() - t0:.1f} s, kernel "
          f"launches {g_launches} [{card}]", flush=True)

    # -- phase 3f's end: (b) read from its process -----------------------
    t0 = time.perf_counter()
    cluster_finish(card, cluster_full, c_launches, c_checks)
    cluster_full.stop()
    print(f"cluster path: kernel launches {c_launches}; waited "
          f"{time.perf_counter() - t0:.1f} s for (b) [{card}]", flush=True)
    walk_err = max([walk_err] + [t[2] for t in walk_timing.values()])
    ins, floor = walk_timing["level"][0]["insert"], walk_timing["level"][1]
    # latency_floor_ms: WALK_B dependent trips at the warm token chase's
    # rate, the floor the byte bound cannot show for a serial walk
    walk_row = {"name": "scan_walk", "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/scan_walk.cu",
                "replaces": "src/repro/core/level.py:347",
                "max_abs_err": walk_err, "ms": ins["ms"],
                "plain_ms": ins["plain_ms"], "bound_ms": ins["bound_ms"],
                "bound_by": "bytes", "library_ms": None,
                "latency_floor_ms": floor["tok_warm_us"] * WALK_B / 1e3}

    # -- phase 4: paged attention against its plain version --------------
    t0 = time.perf_counter()
    attn_row, f32_row = attention_phase(torch, card)
    rows.append(attn_row)
    t1 = time.perf_counter()
    slice_row = slice_timing(torch, card)
    torch.cuda.empty_cache()
    print(f"attention phase: {time.perf_counter() - t0:.1f} s (the slice "
          f"mode {time.perf_counter() - t1:.1f} s)", flush=True)

    # -- phase 5: serving Yi-6B, its launches counted ---------------------
    t0 = time.perf_counter()
    cfg, params, launches, served, record = serving_phase(torch, card)
    torch.cuda.empty_cache()
    print(f"serving path: {time.perf_counter() - t0:.1f} s", flush=True)

    # -- phase 5b: int8 KV pages and the merged path, launches counted ---
    t0 = time.perf_counter()
    int8_row = int8_phase(torch, cfg, params, served, card)
    print(f"int8 path: {time.perf_counter() - t0:.1f} s", flush=True)

    # -- phase 6: the continuous batcher ---------------------------------
    batcher_phase(torch, cfg, params, card)
    del params
    torch.cuda.empty_cache()

    # -- phase 6b: the other families at full width, launches counted ----
    t0 = time.perf_counter()
    moe_launches, moe_attn = families_phase(torch, card, twins)
    print(f"families path: {time.perf_counter() - t0:.1f} s", flush=True)

    # -- phase 7: training at full width, launches counted ---------------
    t0 = time.perf_counter()
    train_launches = training_phase(torch, card, twins)
    print(f"training path: {time.perf_counter() - t0:.1f} s", flush=True)

    # -- phase 7b: the multi-device layer at world 1, launches counted ---
    t0 = time.perf_counter()
    routed, dist_launches = multidevice_phase(torch, card, record)
    del record
    print(f"multi-device path: {time.perf_counter() - t0:.1f} s", flush=True)

    # -- phase 8: report -------------------------------------------------
    walk_row["routed"] = {k: routed[k] for k in
                          ("B", "replaces", "ms", "warm_ms", "plain_ms",
                           "latency_floor_ms", "max_abs_err")}
    rows.append(walk_row)
    launches["scan_walk"] = walk_launches
    for r in rows:
        r["launches"] = launches[r["name"]]
        if r["name"] in m_checks:      # phases 3e-3g's in-place checks
            r["max_abs_err"] = max(r["max_abs_err"],
                                   m_checks[r["name"]]["max_abs_err"],
                                   c_checks[r["name"]]["max_abs_err"],
                                   g_checks[r["name"]]["max_abs_err"])
            r["cluster_launches"] = c_launches[r["name"]]
            r["cache_launches"] = g_launches[r["name"]]
        r["moe_launches"] = moe_launches[r["name"]]
        r["train_launches"] = train_launches[r["name"]]
        r["dist_launches"] = dist_launches[r["name"]]
        if r["name"] == "paged_attention":     # granite's decode shape
            e, ms, plain_ms, bound_ms, lib_ms = moe_attn
            r["moe_shape"] = {"B": MOE_B, "H": 24, "KVH": 8, "D": 64,
                              "len": MOE_PROMPT + FAMILY_GEN - 1,
                              "max_abs_err": e, "ms": ms,
                              "plain_ms": plain_ms, "bound_ms": bound_ms,
                              "library_ms": lib_ms}
            r["merged_launches"] = int8_row["merged_launches"]
    rows.append(dict(int8_row, moe_launches=moe_launches["int8_attention"],
                     train_launches=train_launches["int8_attention"],
                     dist_launches=dist_launches["int8_attention"]))
    # the float32-q loop: its launches on the float32 twins' paths
    rows.append(dict(f32_row, launches=sum(F32_TWIN_LAUNCHES.values()),
                     twin_launches=dict(F32_TWIN_LAUNCHES),
                     moe_launches=moe_launches["float32_attention"],
                     train_launches=train_launches["float32_attention"],
                     dist_launches=dist_launches["float32_attention"]))
    # the page-token slice mode: its launches on the multi-device serving
    # path, phase 7b (c), the only path that runs it
    rows.append(dict(slice_row, launches=dist_launches["paged_attention_slice"],
                     merge_launches=dist_launches["attention_merge"],
                     moe_launches=moe_launches["paged_attention_slice"],
                     train_launches=train_launches["paged_attention_slice"],
                     dist_launches=dist_launches["paged_attention_slice"]))
    _check(dist_launches["paged_attention_slice"] > 0, "the multi-device "
           "serving path launched the slice mode")
    _check(all(n > 0 for n in F32_TWIN_LAUNCHES.values())
           and len(F32_TWIN_LAUNCHES) == 3, f"every float32 twin launched "
           f"the float32-q loop ({F32_TWIN_LAUNCHES})")
    print(f"smoke: {time.perf_counter() - t_smoke:.1f} s from the build on "
          f"[{card}]", flush=True)
    order = ("name", "route", "source", "replaces", "launches", "max_abs_err",
             "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [
        {**{k: r[k] for k in order},
         **{k: v for k, v in r.items() if k not in order}} for r in rows]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
