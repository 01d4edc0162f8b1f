"""step_ms.<phase>: wall ms per step of one phase of the solve, the
stage's seconds (``ClipSolver.phase_seconds``: its steps, refreshes and
graph captures, ending on a read that waits for the card) summed over
the window's solves, over their steps. The phase is the fit's stage
name, or ``local_<phase>`` where that is the name (``step_ms.skate``
reads ``local_skate``)."""


def read(record, arg=None):
    steps = (record.get("phase_steps") or {}).get(arg)
    solves = record.get("phase_seconds") or []
    if not steps or not solves:
        return None
    key = arg if arg in solves[0] else f"local_{arg}"
    if key not in solves[0]:
        return None
    return 1e3 * sum(s[key] for s in solves) / (steps * len(solves))
