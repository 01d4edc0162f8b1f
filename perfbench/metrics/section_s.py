"""section_s.<section>: device seconds of one section of the clip
solve's objective or phase loop (``vposer``, ``blend``, ``fk``,
``skin``, ``contact``, ``losses``, ``adam``), forward and backward, in
the solve traced with the program's device section marks
(``fpv4d_torch.utils.observability.mark``): the union of the device's
activity between each run of that section's markers, eager and
replayed, markers left out."""
from perfbench.metrics._spans import section_seconds


def read(record, arg=None):
    got = section_seconds(record, arg)
    return None if got is None else got[0]
