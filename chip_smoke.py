"""Chip smoke test of the PyTorch/H100 port (fpv4d_torch).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. device     the card's name and power limit (nvidia-smi);
  2. build      K1 (fpv4d_torch/csrc/cand_nn.cu) built with nvcc;
  3. K1         the kernel held bit-exactly against its plain PyTorch
                version on the standard problem's candidate tables
                ([900, N, 192] compacted, [900, N, 512] uncompacted),
                plus an all-invalid frame and duplicate candidates;
                kernel, plain and library (torch.cdist + min) times;
  4. main path  the full-size standard local-mode clip solve
                (T=900, V=10,475, 100,489 scene points, compact 192,
                skate 1024 body-only): finite, decreasing per-phase
                losses, and K1 launched once per local_a step;
  5. reference  a small solve on the card agrees with the same solve
                on the CPU (the plain versions).
The second-to-last lines are a JSON object of kernel results and the
nvidia-smi line; the last line is {"ok": true, "device": {...}}. Exits
non-zero, printing no result, when no CUDA device is available.
"""
import json
import subprocess
import sys
import time

import numpy as np
import torch


def _median_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median of per-call CUDA-event times after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s, f32 FLOP/s off the
# tensor cores
_HBM_BPS = 3.35e12
_F32_FLOPS = 67e12


def _k1_bound_ms(T: int, N: int, P: int):
    """Least time for K1's work: each input read once, each output
    written once, and 8 f32 operations per (query, candidate) pair."""
    nbytes = (T * N * 3 * 4 + T * P * 3 * 4 + T * P      # q, cand, valid
              + T * N * 4 + T * N * 4 + T * N * 3 * 4)   # dist, slot, near
    ops = 8.0 * T * N * P
    t_bytes, t_ops = nbytes / _HBM_BPS * 1e3, ops / _F32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def _check_k1(C, q, cand, valid, label):
    """Kernel vs plain version on the same inputs: dist, slot, nearest
    and the gradient must be exactly equal. Returns the max abs error."""
    d_k, s_k, n_k = C.cand_nn_cuda(q, cand, valid)
    d_p, s_p, n_p = C.cand_nn_plain(q, cand, valid)
    torch.cuda.synchronize()
    ok = (torch.equal(d_k, d_p) and torch.equal(s_k, s_p)
          and torch.equal(n_k, n_p))
    err = max(float((d_k - d_p).abs().max()),
              float((n_k - n_p).abs().max()))
    g = torch.randn(d_k.shape, device=q.device,
                    generator=torch.Generator(device=q.device).manual_seed(0))
    qk = q.detach().clone().requires_grad_(True)
    qp = q.detach().clone().requires_grad_(True)
    (C.nn_to_candidates(qk, cand, valid) * g).sum().backward()
    (C.nn_to_candidates_ref(qp, cand, valid) * g).sum().backward()
    ok = ok and torch.equal(qk.grad, qp.grad)
    print(f"[K1] {label}: q {tuple(q.shape)} cand {tuple(cand.shape)} "
          f"valid {float(valid.float().mean()):.3f} exact={ok} "
          f"max_abs_err={err}")
    if not ok:
        raise AssertionError(f"K1 disagrees with its plain version: {label}")
    return err


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    from fpv4d_torch.ops import cand_cuda as C
    from fpv4d_torch.ops import nn as NN
    from fpv4d_torch.utils.bench_problem import standard_problem

    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(f"[device] {name}; nvidia-smi: {smi}; torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)

    # 2. build
    secs = C.build()
    print(f"[build] K1 built in {secs:.2f} s", flush=True)
    for line in C.build_log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"[build] {line.strip()}")

    # the standard problem at full size
    t0 = time.perf_counter()
    prob = standard_problem(device=dev)
    solver = prob.solver
    print(f"[setup] standard problem in {time.perf_counter() - t0:.2f} s: "
          f"T={prob.body.shape[0]} V={prob.model.num_verts} "
          f"scene={len(prob.scene)} contact N={len(solver.contact_vids)} "
          f"skate vids={len(solver._skate_vids)}", flush=True)

    # 3. K1 against its plain version on the main path's tables
    state, _, _ = solver.init_state(prob.body, prob.cam)
    with torch.no_grad():
        from fpv4d_torch.solve.clip_solve import forward_world
        q, _, _ = forward_world(solver.ctx, state,
                                vertex_subset=solver.contact_vids,
                                prune=solver._contact_prune,
                                with_joints=False)
        fc512 = NN.frame_candidates(solver.grid, q,
                                    solver.config.contact_cell_budget)
        fc192 = NN.compact_candidates(q, fc512,
                                      solver.config.contact_compact)
    q = q.contiguous()
    err192 = _check_k1(C, q, fc192.cand, fc192.valid, "main [T,N,192]")
    _check_k1(C, q, fc512.cand, fc512.valid, "uncompacted [T,N,512]")
    valid_e = fc192.valid.clone()
    valid_e[3] = False
    _check_k1(C, q, fc192.cand, valid_e, "all-invalid frame 3")
    cand_d = fc192.cand.clone()
    cand_d[:, 1::2] = cand_d[:, 0::2]
    _check_k1(C, q, cand_d, torch.ones_like(fc192.valid),
              "duplicate candidates")
    d_e, _, n_e = C.cand_nn_cuda(q, fc192.cand, valid_e)
    if not (bool((d_e[3] == C.BIG).all()) and torch.equal(n_e[3], q[3])):
        raise AssertionError("all-invalid frame must give 1e4 and q")

    T, N, _ = q.shape
    timings = {}
    for P, fc in ((192, fc192), (512, fc512)):
        ms = _median_ms(lambda: C.cand_nn_cuda(q, fc.cand, fc.valid))
        plain_ms = _median_ms(lambda: C.cand_nn_plain(q, fc.cand, fc.valid))
        lib_ms = _median_ms(lambda: torch.cdist(q, fc.cand).min(-1))
        bound_ms, bound_by = _k1_bound_ms(T, N, P)
        timings[P] = (ms, plain_ms, lib_ms, bound_ms, bound_by)
        print(f"[K1] P={P}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"cdist+min {lib_ms:.4f} ms, bound {bound_ms:.4f} ms "
              f"({bound_by})", flush=True)
    del fc512, fc192, cand_d, valid_e
    torch.cuda.empty_cache()

    # 4. the main path, counted
    C.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    final, hist = solver.fit(prob.body, prob.cam, mode="local")
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = C.launches
    n_a = int(solver.config.num_iter * solver.config.stage_split)
    for k, v in hist.items():
        print(f"[main] {k}: {len(v)} steps, loss {v[0]:.6f} -> "
              f"{v[-1]:.6f}, {solver.phase_seconds[k]:.3f} s", flush=True)
        if not np.all(np.isfinite(v)):
            raise AssertionError(f"{k}: non-finite loss")
        if not v[-1] < v[0]:
            raise AssertionError(f"{k}: loss did not decrease")
    sec = solver.phase_seconds
    print(f"[main] init {sec['init']:.3f} s; detect_contact "
          f"{sec['detect_contact']:.3f} s; fit total {fit_s:.3f} s; K1 "
          f"launches {launches} (local_a steps {n_a})", flush=True)
    if launches != n_a:
        raise AssertionError(f"K1 launched {launches} times, expected {n_a}")
    body, scale, cam = solver.result_params(final)
    if body.shape != (T, 75) or cam.shape != (T, 4, 4) or not (
            np.all(np.isfinite(body)) and np.isfinite(scale)
            and np.all(np.isfinite(cam))):
        raise AssertionError("final parameters not finite / wrong shape")
    print(f"[main] final scale {scale:.6f}", flush=True)

    # 5. a small solve on the card agrees with the same solve on the CPU
    small = dict(T=24, num_verts=1024, scene_pts=2500, num_iter=20)
    h_gpu = standard_problem(device=dev, **small)
    h_cpu = standard_problem(device="cpu", **small)
    _, hg = h_gpu.solver.fit(h_gpu.body, h_gpu.cam)
    _, hc = h_cpu.solver.fit(h_cpu.body, h_cpu.cam)
    # the first loss is taken at the shared initial state: 1e-5 relative
    # (f32 summation order); later losses 2e-2, because the L1
    # smoothness terms turn last-bit differences of near-zero second
    # differences into +-lr Adam steps
    first = abs(hg["local_a"][0] - hc["local_a"][0]) / hc["local_a"][0]
    print(f"[reference] local_a first loss rel diff cuda vs cpu {first:.3e}")
    if not first <= 1e-5:
        raise AssertionError("cuda and cpu first losses disagree")
    for k in hc:
        rel = float(np.max(np.abs(hg[k] - hc[k]) / np.abs(hc[k])))
        print(f"[reference] {k}: max rel diff cuda vs cpu {rel:.3e}")
        if not (np.all(np.isfinite(hg[k])) and rel < 2e-2):
            raise AssertionError(f"{k}: cuda and cpu solves disagree")

    ms, plain_ms, lib_ms, bound_ms, bound_by = timings[192]
    print(json.dumps({"kernels": [{
        "name": "cand_nn", "route": "cuda",
        "source": "fpv4d_torch/csrc/cand_nn.cu",
        "replaces": "fpv4d/ops/cand_pallas.py:160",
        "launches": launches, "max_abs_err": err192, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": lib_ms}]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
