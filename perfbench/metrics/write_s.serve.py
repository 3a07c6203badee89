"""Seconds a served subject spends in the OBJ writer (the program's
``stats["write_s"]`` over the window's subjects)."""


def read(run):
    st = run.out.get("stats") or {}
    n = run.out.get("subjects", 0)
    return st["write_s"] / n if n and "write_s" in st else None
