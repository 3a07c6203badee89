"""Places a served subject's host waits on the card (the program's
``surs.sync`` spans, counted in ``stats["syncs"]``) over the window's
subjects."""


def read(run):
    st = run.out.get("stats") or {}
    n = run.out.get("subjects", 0)
    return st["syncs"] / n if n and "syncs" in st else None
