"""Host milliseconds a step in the step's forward (the loss): the
trace's ``surs.train.forward`` regions over the window's steps."""

from perfbench import regions


def read(run):
    return regions.ms_per_step(run, "surs.train.forward")
