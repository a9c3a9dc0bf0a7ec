"""PyTorch/CUDA port of the continuity hash store (reference: ``repro``).

The request path — hashing, the continuity table, lookup and the fused
insert/update/delete engine, verb plans and the store API — and
serving of every model family of the reference (dense, moe, audio and
vlm on the hash-paged KV cache; ssm and hybrid on recurrent state and
ring buffers: models, caches (int8 KV pages included), engine,
continuous batcher, ``launch.serve``) and training (``loss_fn``, AdamW,
microbatching, remat, checkpoints, ``launch.train``), with the
segment-probe,
mutation-plan and paged-attention kernels written in CUDA for Hopper
(``kernels/csrc``).  Entry points run on ``cuda`` unless the caller passes
``device="cpu"``; without a card, asking for CUDA raises.
"""
