"""Device milliseconds of the program's ``chain.replay`` span (the chain's
CUDA graph replayed, ``CapturedGraph.replay``) per request
(``generate_primx`` span), between the span's CUDA events."""

from portbench.program_spans import per_root_ms


def read(run, params):
    return per_root_ms(run, params["span"], params["per"])
