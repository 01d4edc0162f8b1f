"""kernels_per_step.<phase>: device kernels per replayed step of one
phase in the solve traced with the program's spans: the kernels (not
copies or memsets) whose correlation is that of a host
``cudaGraphLaunch`` inside the span ``phase/<phase>`` and outside the
``refresh/*`` spans within it, over the phase's replays (the counter
``replays/<phase>``)."""
from perfbench.metrics._spans import MARK, host_spans, solve, span


def read(record, arg=None):
    got = solve(record, "span_solve")
    if got is None:
        return None
    ev = got["events"]
    replays = got.get("counts", {}).get(f"replays/{arg}")
    phase = span(ev, f"phase/{arg}")
    if not replays or phase is None:
        return None
    refresh = [(s, e) for n, s, e in host_spans(ev, "fpv4d.refresh/")]
    launches = {c for n, k, s, e, c in ev
                if k == "host" and n == "cudaGraphLaunch"
                and phase[0] <= s <= phase[1]
                and not any(a <= s <= b for a, b in refresh)}
    kernels = sum(1 for n, k, s, e, c in ev
                  if k == "device" and c in launches
                  and not n.startswith(("Memcpy", "Memset"))
                  and not MARK.search(n))
    return kernels / replays if launches else None
