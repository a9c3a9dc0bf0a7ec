"""decode_step_ms (ms): host time of a group's decode steps
(``launch/serve.run_decode`` through ``serve.stepper``), ending in a
device synchronize, over the steps.  Layer: engine
(``serving/engine.serve_step``: page-table upkeep, the layer stack, the
output head).  Source: the benchmark's span around each window group's
decode.  Cells: yi6b.docqa.  Moves: tokens_s."""


def read(run):
    spans = run.spans.get("decode")
    steps = run.counters.get("decode_steps", 0)
    if not spans or not steps:
        return None
    return sum(spans) / steps * 1e3
