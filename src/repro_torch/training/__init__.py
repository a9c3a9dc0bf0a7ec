"""Training substrate: AdamW, the train step with microbatching, schedules.

Port of ``repro.training``, ZeRO-1's ``opt_logical_axes`` and the sharded
step under ``distribution.sharding.use_mesh`` included.
"""
