"""Drivers: each drives one entry of the program under a traffic mix.

A driver module defines ``Driver(run)``, which reads ``run.config`` (the
configuration) and ``run.traffic`` (the mix's parameters) and has:

- ``setup()``: build the program from ``run.seed`` and warm every shape
  the mix uses; fill ``run.work`` with what one unit of work needs (its
  model FLOPs, its attention shapes), for the per-layer readers;
- ``request(i)``: request ``i`` of the window, to its end; returns the
  units of work it completed;
- ``finish()``: free the program's state once the window has closed;
- ``check()``: {name: (number, limit)} of the comparison with the
  reference, the limits from the cell's ``limits``.
"""
