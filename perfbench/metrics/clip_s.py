"""clip_s: wall seconds per clip solved, the measured window (which ends
on a solve's completion) over the clips solved in it (host clock)."""


def read(record, arg=None):
    n = record.get("clips") or 0
    return record["window_s"] / n if n else None
