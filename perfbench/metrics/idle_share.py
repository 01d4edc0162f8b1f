"""idle_share: 100 x (1 - the union of the device's kernel, copy and
memset intervals over the wall of one solve profiled for device
activity alone), %."""


def read(record, arg=None):
    dw = record.get("device_window")
    if not dw or dw["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - dw["busy_s"] / dw["window_s"])
