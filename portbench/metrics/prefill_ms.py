"""prefill_ms (ms): mean host time of one group's prefill
(``launch/serve.run_prefill``: the forward over the prompts and the page
fill), ending in a device synchronize.  Layer: engine (``launch/serve``,
``serving/engine.prefill``).  Source: the benchmark's span around each
window group's prefill.  Cells: yi6b.docqa.  Moves: tokens_s."""

from portbench import readers


def read(run):
    return readers.mean_span_ms(run, "prefill")
