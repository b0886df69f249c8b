"""Device milliseconds of the mixture-of-experts FFNs' forward (the
program's span ``h21.moe``, one a MoE block: routing, dispatch, the
grouped expert products, the combine and the shared expert) per step
(``train_step`` span), between the spans' CUDA events. None where the
program records no such span."""

from portbench.program_spans import per_root_ms


def read(run, params):
    return per_root_ms(run, params["span"], params["per"])
