"""Card-idle milliseconds a step in the optimizer: the milliseconds of
the trace's ``surs.train.optimizer`` regions in which no device
operation ran, over the window's steps."""

from perfbench import regions


def read(run):
    tr = run.out.get("trace")
    steps = run.out.get("steps", 0)
    if tr is None or not steps:
        return None
    idle, n = regions.idle_inside(tr, "surs.train.optimizer")
    return 1e3 * idle / steps if n else None
