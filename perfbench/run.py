"""The benchmark of the port (``fpv4d_torch``): one cell, one run.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Finds everything by name: the cell in ``perfbench/workloads/<cell>.json``
(its configuration; its traffic: the program entry, the solve's mode
and the clip stream; the limits of its check), the configuration in
``perfbench/configs/<config>.json``, the entry's driver in
``perfbench/drivers/<entry>.py`` and each metric's reader in
``perfbench/metrics/<name>.py``: a metric ``a.b`` is read by ``a.py``'s
``read(record, "b")``, a metric ``a`` by ``read(record, None)``; a
reader that finds nothing returns None and the metric is left out.
``BENCHMARK.json`` at the checkout's root says which metrics a cell
reports: with ``--trace 0`` its ``end_to_end`` metrics, with
``--trace 1`` its ``per_layer`` ones.

A run makes its inputs from the seed, builds the solver and warms up
(``setup_s`` is the process's start to the first timed solve), then
solves the stream's clips one after another until ``--seconds`` have
passed; the window ends when that solve completes. ``--trace 1`` then
profiles one more solve twice (device alone, then host and device).
The program's state is freed and the reference checks clips drawn from
the seed (``perfbench/reference/check.py``). The last line of standard
output is one JSON object: ``correct``, ``attempted`` (clips solved in
the window), ``failed`` (checked clips over the limit), ``metrics``,
``device`` (and with ``--trace 1``, ``breakdown``), and last ``checks``,
each compared number beside its limit, which also close standard error.

Exits non-zero, with no result line, without a CUDA device or with
fewer than the cell's chips, and if ``jax``, ``jaxlib``, ``flax``,
``optax`` or the JAX package ``fpv4d`` (compared by whole top-level
name) is loaded once the window has closed.
"""
from __future__ import annotations

import argparse
import gc
import importlib
import json
import os
import shutil
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
HERE = ROOT / "perfbench"
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "optax", "fpv4d"})
# build and kernel caches at fixed paths inside the checkout
CACHE = ROOT / ".perfbench_cache"


def _t_process() -> float:
    """This process's start, seconds since the epoch (Linux)."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            btime = next(int(line.split()[1]) for line in f
                         if line.startswith("btime"))
        return btime + start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, StopIteration, IndexError):
        return _T_IMPORT


_T_IMPORT = time.time()


def finite(obj):
    """obj with every infinite or NaN float replaced by None (null)."""
    if isinstance(obj, dict):
        return {k: finite(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [finite(v) for v in obj]
    if isinstance(obj, float) and obj != obj or obj in (float("inf"),
                                                         float("-inf")):
        return None
    return obj


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str):
    """(the cell's workload file, its configuration)."""
    workload = load_json(HERE / "workloads" / f"{name}.json")
    return workload, load_json(HERE / "configs" / f"{workload['config']}.json")


def forbidden_modules() -> list:
    """Top-level names of loaded modules that the port must not load."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)


def cell_metrics(bench: dict, cell: str, kind: str) -> list:
    """The `kind` ('end_to_end' or 'per_layer') metrics that `cell`
    reports: those without a workloads list, and those that list it."""
    return [m for m in bench.get(kind, [])
            if "workloads" not in m or cell in m["workloads"]]


def read_metric(name: str, record: dict):
    """A metric's value from its reader, or None."""
    base, _, arg = name.partition(".")
    mod = importlib.import_module(f"perfbench.metrics.{base}")
    v = mod.read(record, arg or None)
    return None if v is None else float(v)


def run_cell(bench: dict, workload: dict, cfg: dict, seed: int,
             seconds: float, traced: bool, device, chips: int = 1,
             work_root=None, err=sys.stderr):
    """One run of one cell -> (the result object, exit code). The result
    is None where the run must print none."""
    import torch
    from perfbench.counts.flops import phase_steps
    from perfbench.reference.prec import f32_products
    f32_products()
    on_card = torch.device(device).type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize()

    drv_mod = importlib.import_module(f"perfbench.drivers.{workload['entry']}")
    work = tempfile.mkdtemp(prefix="perfbench-", dir=work_root)
    driver = drv_mod.make(cfg, workload, seed, device, work)
    try:
        driver.warm()
        sync()
        # set-up's objects out of the collector's way: no full collection
        # of them lands inside the window
        gc.collect()
        gc.freeze()
        held_start = torch.cuda.memory_allocated() if on_card else None
        if on_card:
            torch.cuda.reset_peak_memory_stats()
        setup_s = time.time() - _t_process()
        t0 = time.perf_counter()
        n, per_solve, peaks = 0, [], []
        while True:
            a = time.perf_counter()
            driver.solve(n)
            sync()
            per_solve.append(time.perf_counter() - a)
            peaks.append(torch.cuda.max_memory_allocated() if on_card else 0)
            n += 1
            if time.perf_counter() - t0 >= seconds:
                break
        window_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() if on_card else 0
        held_end = torch.cuda.memory_allocated() if on_card else None
        bad = forbidden_modules()
        if bad:
            print(f"perfbench: loaded in the measuring process: {bad}",
                  file=err)
            return None, 3
        print(f"perfbench: set-up {setup_s:.3f} s; {n} clips in "
              f"{window_s:.3f} s; per solve "
              f"{[round(x, 4) for x in per_solve]}; peak after each "
              f"{[round(x / 2 ** 30, 4) for x in peaks]} GiB", file=err)
        for i, ph in enumerate(driver.phase_seconds):
            print(f"perfbench: solve {i} " + ", ".join(
                f"{k} {v:.4f}" for k, v in ph.items())
                + f", captures {driver.capture_seconds[i]:.4f}", file=err)
        record = {"setup_s": setup_s, "window_s": window_s, "clips": n,
                  "per_solve_s": per_solve, "peak_bytes": peak,
                  "peaks": peaks, "held_start": held_start,
                  "held_end": held_end,
                  "phase_seconds": driver.phase_seconds,
                  "capture_seconds": driver.capture_seconds,
                  "phase_steps": phase_steps(cfg, workload["mode"])}
        if traced:
            record.update(driver.trace(n))
        driver.free()
        problem = driver.problem()
        if traced:
            record["flops"] = driver.count_flops(problem)
        gaps = driver.check(problem, n)
    finally:
        gc.unfreeze()
        driver.close()
        shutil.rmtree(work, ignore_errors=True)

    limits = workload["limits"]
    worst = {k: max(g[k] for g in gaps.values()) for k in limits}
    failed = sum(1 for g in gaps.values()
                 if not all(g[k] <= lim for k, lim in limits.items()))
    for i, g in gaps.items():
        print(f"perfbench: clip {i} " + ", ".join(
            f"{k} {v:.3e}" for k, v in g.items()), file=err)

    kind = "per_layer" if traced else "end_to_end"
    metrics = {}
    for m in cell_metrics(bench, workload["name"], kind):
        v = read_metric(m["name"], record)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": (torch.cuda.get_device_name(0) if on_card
                    else "cpu"), "count": chips,
           "memory_peak_bytes": int(peak)}
    result = {"correct": failed == 0,
              "attempted": n, "failed": failed, "metrics": metrics,
              "device": dev}
    if traced:
        dw = record["device_window"]
        dev["busy_s"], dev["window_s"] = dw["busy_s"], dw["window_s"]
        result["breakdown"] = {k: record["breakdown"][k]
                               for k in ("device_ops", "idle_gaps")}
    result["checks"] = {k: {"value": worst[k], "limit": lim}
                        for k, lim in limits.items()}
    for k, lim in limits.items():
        print(f"check {k} {worst[k]!r} limit {lim!r}", file=err)
    return result, 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    bench = load_json(ROOT / "BENCHMARK.json")
    entry = next((w for w in bench["workloads"]
                  if w["name"] == args.workload), None)
    if entry is None:
        print(f"perfbench: no workload {args.workload!r}", file=sys.stderr)
        return 2
    workload, cfg = load_cell(args.workload)

    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(CACHE / sub)
    import torch
    torch.set_num_threads(4)
    chips = int(entry["chips"])
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < chips:
        print(f"perfbench: the cell needs {chips} CUDA device(s); {have} "
              "available", file=sys.stderr)
        return 1
    result, rc = run_cell(bench, workload, cfg, args.seed, args.seconds,
                          bool(args.trace), "cuda", chips)
    if result is None:
        return rc or 1
    sys.stdout.flush()
    print(json.dumps(finite(result), allow_nan=False), flush=True)
    return 0


if __name__ == "__main__":
    # run as a script: import the benchmark as a package from the root,
    # never its folders as top-level modules
    sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != HERE]
    sys.path.insert(0, str(ROOT))
    sys.exit(main())
