"""Host milliseconds a step waiting for the next batch from the loader:
the trace's ``surs.train.data_wait`` regions over the window's steps."""

from perfbench import regions


def read(run):
    return regions.ms_per_step(run, "surs.train.data_wait")
