"""Device milliseconds of the program's ``encode`` span
(``DinoV2Wrapper.forward``) per request (``generate_primx`` span), between
the span's CUDA events: the encoder's stretch of the device's timeline,
idle time inside it included."""

from portbench.program_spans import per_root_ms


def read(run, params):
    return per_root_ms(run, params["span"], params["per"])
