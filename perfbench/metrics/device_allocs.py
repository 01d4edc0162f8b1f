"""device_allocs: the allocator's device allocations (``cudaMalloc``,
its ``num_device_alloc``) during one ``ClipSolver.fit``, the counter
``device_allocs`` of the solve traced with the program's spans."""
from perfbench.metrics._spans import solve


def read(record, arg=None):
    got = solve(record, "span_solve")
    if got is None:
        return None
    return got.get("counts", {}).get("device_allocs")
