"""Device milliseconds of ``loss.backward()`` of each microbatch (the
program's span ``train.backward``) per step (``train_step`` span),
between the spans' CUDA events. None where the program records no such
span."""

from portbench.program_spans import per_root_ms


def read(run, params):
    return per_root_ms(run, params["span"], params["per"])
