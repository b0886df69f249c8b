"""Device milliseconds of the program's ``train.forward`` spans (the
microbatches' forward and loss) per step (``train_step`` span), between
the spans' CUDA events. None where the program records no such span."""

from portbench.program_spans import per_root_ms


def read(run, params):
    return per_root_ms(run, params["span"], params["per"])
