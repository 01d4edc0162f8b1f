"""A contact kernel's share of its roofline, from the traced solve."""


def roofline(record, key):
    """100 x the kernel's least time at its launch shape over its mean
    device time per launch in the profiled solve (None where the kernel
    did not run or the record has no bound for it)."""
    bound = (record.get("bound_ms") or {}).get(key)
    kern = (record.get("device_window") or {}).get("kernels") or {}
    sec = sum(v[0] for k, v in kern.items() if key in k)
    n = sum(v[1] for k, v in kern.items() if key in k)
    if bound is None or n == 0 or sec <= 0:
        return None
    return 100.0 * bound / (1e3 * sec / n)
