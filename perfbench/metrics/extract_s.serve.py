"""Seconds a served subject spends extracting its two meshes (the
program's ``stats["extract_s"]`` over the window's subjects)."""


def read(run):
    st = run.out.get("stats") or {}
    n = run.out.get("subjects", 0)
    return st["extract_s"] / n if n and "extract_s" in st else None
