"""Host milliseconds a step in the step's backward: the trace's
``surs.train.backward`` regions over the window's steps."""

from perfbench import regions


def read(run):
    return regions.ms_per_step(run, "surs.train.backward")
