"""Device milliseconds of the 32 single-stream blocks' forward (the
program's span ``mmdit.single``) per step (``train_step`` span), between
the spans' CUDA events. None where the program records no such span."""

from portbench.program_spans import per_root_ms


def read(run, params):
    return per_root_ms(run, params["span"], params["per"])
