"""Device milliseconds of the program's ``train.optimizer`` span (clip,
AdamW and EMA, ``zero_grad``) per step (``train_step`` span), between the
span's CUDA events. None where the program records no such span."""

from portbench.program_spans import per_root_ms


def read(run, params):
    return per_root_ms(run, params["span"], params["per"])
