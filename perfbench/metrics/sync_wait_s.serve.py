"""Seconds a served subject's host waits on the card: the program's
``surs.sync`` spans (``stats["sync_wait_s"]``) over the window's
subjects."""


def read(run):
    st = run.out.get("stats") or {}
    n = run.out.get("subjects", 0)
    return st["sync_wait_s"] / n if n and "sync_wait_s" in st else None
