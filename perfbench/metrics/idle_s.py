"""idle_s.<capture|checkpoint|init>: device idle seconds of the solve
traced with the program's spans, inside its ``fit`` span, whose gap's
midpoint falls in that program span, the innermost ``fpv4d.*`` span
there: ``capture/<phase>`` (the graph captures), ``checkpoint`` (the
state written after each phase) or ``phase/init``."""
import numpy as np

from perfbench.metrics._spans import idle_gaps, innermost, solve

NAMES = {"capture": lambda n: n.startswith("fpv4d.capture/"),
         "checkpoint": lambda n: n == "fpv4d.checkpoint",
         "init": lambda n: n == "fpv4d.phase/init"}


def read(record, arg=None):
    got = solve(record, "span_solve")
    if got is None or arg not in NAMES:
        return None
    gaps = idle_gaps(got["events"])
    if gaps is None:
        return None
    names = innermost(got["events"], gaps.mean(axis=1))
    length = gaps[:, 1] - gaps[:, 0]
    hit = np.asarray([n is not None and NAMES[arg](n) for n in names],
                     dtype=bool)
    return float(length[hit].sum()) * 1e-9
