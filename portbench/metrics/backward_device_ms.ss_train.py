"""Device milliseconds of the program's ``train.backward`` spans
(``loss.backward()`` of each microbatch) per step (``train_step`` span),
between the spans' CUDA events."""

from portbench.program_spans import per_root_ms


def read(run, params):
    return per_root_ms(run, params["span"], params["per"])
