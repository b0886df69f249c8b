"""Mean milliseconds of a request's DINOv2 encode: the benchmark's span
around the encoder's call, the device synchronised at both ends."""

from portbench.readers import span_ms


def read(run, params):
    return span_ms(run, "encode")
