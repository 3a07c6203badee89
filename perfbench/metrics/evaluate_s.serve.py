"""Seconds a served subject spends in evaluation: the program's span
``surs.evaluate`` (``stats["evaluate_s"]``) over the window's
subjects."""


def read(run):
    st = run.out.get("stats") or {}
    n = run.out.get("subjects", 0)
    return st["evaluate_s"] / n if n and "evaluate_s" in st else None
