"""Points a served subject scores (the program's ``stats["queries"]``
over the window's subjects)."""


def read(run):
    st = run.out.get("stats") or {}
    n = run.out.get("subjects", 0)
    return st["queries"] / n if n and "queries" in st else None
