"""capture_s: host seconds of a solve's CUDA-graph captures
(``ClipSolver.capture_seconds`` summed), the mean over the window's
solves."""


def read(record, arg=None):
    caps = record.get("capture_seconds") or []
    return sum(caps) / len(caps) if caps else None
