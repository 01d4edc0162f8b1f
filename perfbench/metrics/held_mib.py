"""held_mib: device memory that the port's fits leave allocated, MiB a
solve: the allocator's allocated bytes after the window's last solve
less those at its start, over the solves (None off the card)."""


def read(record, arg=None):
    start, end = record.get("held_start"), record.get("held_end")
    n = record.get("clips") or 0
    if start is None or end is None or not n:
        return None
    return (end - start) / n / 2 ** 20
