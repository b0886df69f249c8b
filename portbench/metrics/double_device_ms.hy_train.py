"""Device milliseconds of the 16 double-stream blocks' forward (the
program's span ``mmdit.double``) per step (``train_step`` span), between
the spans' CUDA events. None where the program records no such span."""

from portbench.program_spans import per_root_ms


def read(run, params):
    return per_root_ms(run, params["span"], params["per"])
