"""The served window's share of the card's peak: the least time of its
model work (the trunk counted once a subject by FlopCounterMode, the
point MLPs for the points and columns run, each at the peak of its
stated arithmetic) over the window's wall time, in %."""

from perfbench import work, yardstick


def read(run):
    least = work.serve_least_s(run)
    if least is None:
        return None
    return yardstick.share_pct(least, run.out["window_s"])
