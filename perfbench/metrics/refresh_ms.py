"""refresh_ms: device ms per contact refresh (the candidate tables'
rebuild, ``ClipSolver._refresh_cands``'s search and compaction) in the
solve traced with the program's device section marks: the device's
activity between the ``refresh`` markers over the refreshes."""
from perfbench.metrics._spans import section_seconds


def read(record, arg=None):
    got = section_seconds(record, "refresh")
    return None if got is None else 1e3 * got[0] / got[1]
