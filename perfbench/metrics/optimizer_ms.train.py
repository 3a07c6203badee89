"""Host milliseconds a step in the optimizer: the profiler's
``Optimizer.step`` operation over the traced window's steps."""


def read(run):
    tr = run.out.get("trace")
    steps = run.out.get("steps", 0)
    if tr is None or not steps:
        return None
    total = 0.0
    for name in {n for n, _, _ in tr.cpu_ops
                 if n.startswith("Optimizer.step#")}:
        total += tr.cpu_op_s(name)
    return 1e3 * total / steps if total > 0 else None
