"""replay_gap_us.<phase>: device idle us per replayed step of one phase
in the solve traced with the program's spans: the idle time inside the
span ``phase/<phase>`` outside the ``capture/*``, ``refresh/*`` and
``warmup/*`` spans within it (what is left is the replays and the
host's work between them), over the phase's replays (the counter
``replays/<phase>``)."""
from perfbench.metrics._spans import (activity, covered, host_spans, minus,
                                      solve, span, union)


def read(record, arg=None):
    got = solve(record, "span_solve")
    if got is None:
        return None
    ev = got["events"]
    replays = got.get("counts", {}).get(f"replays/{arg}")
    phase = span(ev, f"phase/{arg}")
    merged = union(activity(ev))
    if not replays or phase is None or len(merged) == 0:
        return None
    holes = [(s, e) for n, s, e in host_spans(ev)
             if n.startswith(("fpv4d.capture/", "fpv4d.refresh/",
                              "fpv4d.warmup/"))]
    rest = minus(phase[0], phase[1], holes)
    busy = covered(merged, rest[:, 0], rest[:, 1]).sum()
    idle = (rest[:, 1] - rest[:, 0]).sum() - busy
    return 1e-3 * float(idle) / replays
