"""peak_gib: the card's peak allocated memory from the measured window's
start through its first PEAK_SOLVES solves (``torch.cuda.max_memory_
allocated``, reset after warm-up, read after each solve), GiB. The
port's allocated memory grows by a fixed amount with each fit
(``held_mib``), so a peak over the whole window would depend on how many
solves the window holds; over a fixed count of them it does not."""

PEAK_SOLVES = 8


def read(record, arg=None):
    peaks = record.get("peaks") or []
    peak = peaks[min(PEAK_SOLVES, len(peaks)) - 1] if peaks else 0
    return peak / 2 ** 30 if peak else None
