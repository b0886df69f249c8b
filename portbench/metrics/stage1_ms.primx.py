"""Mean milliseconds of a request's ``generate_primx`` (the chain and the
VAE decode): the benchmark's span around the call, the device
synchronised at both ends."""

from portbench.readers import span_ms


def read(run, params):
    return span_ms(run, "stage1")
