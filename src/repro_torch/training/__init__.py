"""Training substrate: AdamW, the train step with microbatching, schedules.

Port of ``repro.training``; ZeRO-1 (``opt_logical_axes``) waits for the
multi-device layer (ROADMAP Queue 1 #7).
"""
