"""Share of the traced window in which the device is idle (no operation
runs) while the host is inside a program span (``generate_primx``, ``encode`` and the
spans under them); the rest of the idle share (``device_idle``) falls
outside the program's spans, in the benchmark's own host work."""

from portbench.program_spans import program_idle_pct


def read(run, params):
    return program_idle_pct(run)
