"""Card-idle seconds a served subject's evaluation: the seconds of the
trace's ``surs.evaluate`` regions in which no device operation (kernel,
copy or set) ran, over the count of those regions."""

from perfbench import regions


def read(run):
    tr = run.out.get("trace")
    if tr is None:
        return None
    idle, n = regions.idle_inside(tr, "surs.evaluate")
    return idle / n if n else None
