"""Chip smoke test of the PyTorch/H100 port (fpv4d_torch).

Run from the repository root on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. device     the card's name and power limit (nvidia-smi);
  2. build      K1 (csrc/cand_nn.cu) and K2 (csrc/chamfer_nn.cu), both
                with csrc/gram_nn.cuh, one nvcc each, started together;
                ptxas' register and spill lines;
  3. K1         the kernel held bit-exactly against its plain PyTorch
                version on the standard problem's candidate tables
                ([900, N, 192] compacted, [900, N, 512] uncompacted),
                plus an all-invalid frame, duplicate candidates,
                candidates on a sphere 1 ulp apart and every slot
                invalid but one; kernel, plain and library
                (torch.cdist + min) times, the share of the bound, and
                the exact re-checks per query;
  4. K2         the kernel held bit-exactly against its plain version
                (dist, idx, dx; dy within the bound of a reordered f32
                sum) at the global solve's shape, the standard problem's
                initial contact vertices [900, 813, 3] against the
                100,489-point scene, and on sizes that fill no tile,
                duplicated scene points, far queries, queries equal
                to scene points, points on a sphere 1 ulp apart and
                coordinates near +-1,000; kernel, plain, library
                (torch.cdist + min over 8,192-query chunks) times, the
                share of the bound, and the re-checks per query (main
                shape and far queries);
  5. local      the full-size standard local-mode clip solve (T=900,
                V=10,475, 100,489 scene points, compact 192, skate 1024
                body-only): finite, decreasing per-phase losses; K1
                launched once per local_a step, K2 never;
  6. global     the full-size global solve with brute-force contact NN
                (nn_impl='brute'): K2 launched once per global_a step,
                K1 never; then with the grid: K1 once per global_a step;
  7. dct        the full-size dct solve with the grid (9,500 dct_a
                steps + 500 dct_b): K1 once per dct_b step, K2 never;
  8. reference  small solves on the card agree with the same solves on
                the CPU (the plain versions): local/grid, global/brute
                and dct/grid;
  9. CLI        ``python -m fpv4d_torch.cli.globalopt`` in a subprocess,
                global mode with --nn-impl brute, on a fixture written
                from a seed: exits 0 and writes pkls with scale and
                camera_ext;
 10. keypoints  the keypoint fit on the standard model at T=900
                (``keypoint_problem``, 2 px noise): Adam 120, joint
                L-BFGS 60 and per-frame L-BFGS 40 steps per stage;
                frames/s, each stage's first and last loss, MPJPE (mm)
                against the ground truth; then one batched Adam fit of
                8 clips x 900 frames, and one fit at T=60 with hand and
                face keypoints (the landmark path); neither kernel runs;
 11. smoother   fit_independent at T=900, fit_sequential and
                fit_sequential_motion at T=300 (15,000 sequential Adam
                steps each); seconds;
 12. reference  a small Adam keypoint fit and a small fit_sequential on
                the card against the same on the CPU;
 13. pipeline   ``fit`` -> ``smooth`` -> ``globalopt local`` in
                subprocesses on seeded OpenPose JSONs with hands, each
                on the card by default: each exits 0 and writes its pkls;
 14. fleet NN   both kernels at the multi-clip fleet's shapes: K1
                bit-exact on the folded tables of an 8-clip first
                refresh [7200, 813, 192] and on 70,000 frames (more than
                a grid's y axis takes); K2 over a clip axis, the
                standard scene and that scene shifted by (0.5, 0, 0.25)
                m and cut to 80,000 points, padded by pad_scenes,
                queries [2, 900, 813]: bit-exact against the plain
                version and each clip against its own [M, 3] launch;
                ms per launch beside twice the single-cloud launch, the
                bound and cdist+min;
 15. fleet      MultiClipSolver.fit, local/grid, 8 clips x 900 frames
                (fleet_batch): seconds per stage (fenced), clips per
                hour, per-clip seconds over phase 5's single solve,
                peak memory; K1 launched once per local_a step; clip
                0's histories held to phase 5's as _card_vs_cpu holds
                them; each clip's losses finite and decreasing per
                phase; a second fit with skate_clip_chunk=0 (one grid
                cache hit), its skate time and histories beside the
                chunked run's;
 16. fleet      global with brute force, 2 clips: K2 once per global_a
                step (one launch over both clips' scenes);
 17. fleet      dct with the grid, 8 clips at full length: K1 once per
                dct_b step;
 18. reference  a small fleet (2 clips x 12 frames, local/grid and
                global/brute) on the card against the same on the CPU;
 19. multiopt   ``python -m fpv4d_torch.cli.multiopt`` in a subprocess on
                two clip directories, then again in a one-rank NCCL
                process group (FPV4D_DISTRIBUTED=1, RANK=0,
                WORLD_SIZE=1): both exit 0, the second's pkls equal to
                the first's;
 20. grid       the standard scene's voxel grid by the native builder
                (csrc/cand_grid.cpp, built with the host compiler) and
                by the NumPy loop: equal tables, both times; the single
                solve's grid (setup), the fleet's (phase 15) and every
                frames rank's were built natively;
 21. frames     MultiClipSolver.fit on a {clips: 1, frames: 2} mesh: two
                ranks spawned on the one card over gloo (NCCL takes one
                rank per card), each holding 450 of the standard
                problem's 900 frames: local/grid with the full schedule,
                held to phase 5's local solve, K1 400 times per rank in
                local_a; global/brute (40 + 10 steps) and dct/grid
                (W = 15 windows over 2 ranks: the gathered trajectory;
                30 + 30 steps), each held to the one-rank fold at the
                same depth, K2 and K1 counted per rank; the whole leaves
                equal on both ranks after every phase; fenced seconds
                per stage beside the one-rank solve's; then K1 and K2
                at a rank's shapes ([450, 813, 192]; 365,850 x 100,489)
                bit-exact against their plain versions, with times;
 22. multiopt   ``multiopt --mesh clips=1,frames=2`` in the same two
                ranks, on phase 19's clip directories: both exit 0, the
                pkls within the CLI tests' tolerances of phase 19's
                one-process run;
 23. render     the world and ego renders at full width on the card
                (fpv4d_torch/vis: a device rasterizer, no OpenCV or PIL):
                the standard model (V=10,475, 20,946 faces) and scene
                (100,489 points) at 1280x720, on a 900-frame clip of
                phase 5's solved body, scale and camera_ext with the
                camera 2.5 m from the body; world: 64 fixed-view frames,
                16 follow, 16 orbit; ego: 32 each with --source smoothed
                and local, no background. Every frame non-black (share >
                0.005) with a non-empty body mask; the first and last
                frame of each kind held against the port's CPU route
                (>= 99% of pixels exact and within 1 level, the random-
                mesh tolerance of tests/test_torch_vis.py); ms per frame
                for the chunked forward, points, mesh and the host PNG
                encode, frames per second, peak memory;
 24. viewer     the interactive viewer's server in a thread on an
                ephemeral port: /meta, /frame fixed, follow and orbit
                (each a 720x1280x3 PNG through decode_png), the same
                bytes again from the memo, 404 on an unknown path;
 25. ends       after phase 13's pipeline, ``vis world`` and ``vis ego
                --source local`` in subprocesses on the card (a PNG per
                frame), the ``prep`` subcommands that need neither ffmpeg
                nor cv2 on seeded fixtures (exit 0, outputs equal to what
                the script computes), and ``vis pack``, ``prep pack``,
                ``dump`` and ``recode``: exit 1 naming cv2 or ffmpeg where
                the tool is missing (asserted and printed), else exit 0
                with the file written;
 26. FK adjoint the hand-written level-sweep adjoint (models/fk.py
                rigid_transform) on the standard model's 55-joint tree at
                B = 900: forward bit-equal to _fwd_impl, gradients within
                2e-5 of autograd's over the largest magnitude; CUDA-event
                medians of fwd+bwd for both, and of the local_a model
                block (forward_world on the contact subset, fwd+bwd) with
                fk.rigid_transform_prod swapped each way, then the whole
                local solve on each in turns (autograd, adjoint, adjoint,
                autograd): seconds per phase, the histories held as
                phase 21's are (restored after);
 27. library    one CVAE Adam step at B = 900 on the card against the
                CPU (losses rtol 1e-5); ops/chamfer_ref.nn_distance_chunked
                at the global solve's shape (731,700 x 100,489) against
                K2: distances within the Gram form's bound 8 u (|x| +
                R)^2, and where the indices differ the oracle's pick
                within twice it of K2's; its time beside K2's;
                steps_until_converged of phase 5's histories;
 28. native io  the standard scene through a binary PLY and the native
                reader (csrc/native_io.cpp, equal arrays, nothing
                declined); voxel_downsample at 0.05 m; the KD-tree on the
                scene queried with the 731,700 contact vertices against
                K2 (distances rtol 1e-6, other indices only at ties);
                read, downsample, build and query seconds;
 29. observe    utils/observability.trace around 5 local_a steps (the
                Chrome trace names K1's cand_nn_kernel), StageTimer with
                sync_on, checked raising on a NaN output on the card;
 30. accuracy   utils/accuracy_report.run at 300 frames, V = 10,475, Adam
                and L-BFGS: tests/test_accuracy.py's thresholds (keypoint
                MPJPE < 60 mm, reprojection < 4x the pixel noise, MPJPE
                after < before, jitter < 0.3x the noisy init's), K1 once
                per local_a step of its clip solve, K2 never.
Every count is set to 0 just before its path runs and read just after.
The second-to-last lines are a JSON object of kernel results and the
nvidia-smi line; the last line is {"ok": true, "device": {...}}. Exits
non-zero, printing no result, when no CUDA device is available or when
the fpv4d_torch package is not beside the script.
"""
import json
import os
import pickle
import subprocess
import sys
import tempfile
import time
from dataclasses import replace
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent


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


# H100 SXM (NVIDIA data sheet): HBM bytes/s; CUDA-core lane
# instructions/s, 132 SMs x 128 lanes x 1.98 GHz boost clock
_HBM_BPS = 3.35e12
_LANE_OPS = 132 * 128 * 1.98e9


def _bound_ms(nbytes: float, ops: float):
    t_bytes, t_ops = nbytes / _HBM_BPS * 1e3, ops / _LANE_OPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


# The least work of a nearest-neighbour search, whatever unit does it:
# the Gram product can go to the tensor cores, but the running minimum
# needs at least one CUDA-core instruction per pair. (The 67 TFLOP/s f32
# peak counts an FMA as two operations, and no unit has to do the
# difference form's 8 f32 operations per pair.)


def _k1_bound_ms(T: int, N: int, P: int):
    """Least time for K1's work: each input read once, each output
    written once, and one CUDA-core instruction per (query, candidate)
    pair."""
    nbytes = (T * N * 3 * 4 + T * P * 3 * 4 + T * P      # q, cand, valid
              + T * N * 4 + T * N * 4 + T * N * 3 * 4)   # dist, slot, near
    return _bound_ms(nbytes, float(T * N * P))


def _k2_bound_ms(Q: int, M: int, clips: int = 1):
    """Least time for K2's work, counted as for K1: x and y read once,
    dist and idx written once, one instruction per (query, point); with
    a clip axis, each of `clips` clips has Q queries and an M-point
    cloud (padding included: the function searches it)."""
    return _bound_ms(clips * (Q * 3 * 4 + M * 3 * 4 + Q * 4 + Q * 4),
                     float(clips * Q * M))


def _rechecks(label, fn, shape, dev):
    """Run fn(rechecks) with a per-query count of exact re-evaluations
    and print its mean and maximum."""
    n = torch.zeros(shape, dtype=torch.int32, device=dev)
    fn(n)
    torch.cuda.synchronize()
    mean, mx = float(n.double().mean()), int(n.max())
    print(f"[rechecks] {label}: mean {mean:.4f} max {mx} per query",
          flush=True)
    return mean, mx


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


def _check_k2(K, x, y, label):
    """Kernel vs plain version on the same inputs: dist, idx and dx must
    be exactly equal. dy is an index_add_ whose f32 atomics add in a
    different order on every run, so it is held to the bound of a
    reordered sum: |dy_k - dy_p| <= 2 (n - 1) 2^-24 sum|terms| per row of
    n terms. Returns the max abs error of dist."""
    d_k, i_k = K.nn_distance_cuda(x, y)
    d_p, i_p = K.nn_distance_plain(x, y)
    torch.cuda.synchronize()
    ok = torch.equal(d_k, d_p) and torch.equal(i_k, i_p)
    err = float((d_k - d_p).abs().max())
    g = torch.randn(d_k.shape, device=x.device,
                    generator=torch.Generator(device=x.device).manual_seed(1))
    grads = []
    for fn in (K.nn_distance, K.nn_distance_ref):
        xg = x.detach().clone().requires_grad_(True)
        yg = y.detach().clone().requires_grad_(True)
        (fn(xg, yg)[0] * g).sum().backward()
        grads.append((xg.grad, yg.grad))
    (dx_k, dy_k), (dx_p, dy_p) = grads
    ok = ok and torch.equal(dx_k, dx_p)
    n = torch.bincount(K._flat_rows(y, i_p).reshape(-1),
                       minlength=y.numel() // 3).reshape(y.shape[:-1])
    abs_sum = K.scatter_to_cloud(y, i_p, dx_p.abs())
    bound = 2.0 * (n - 1).clamp(min=0)[..., None] * 2.0 ** -24 * abs_sum
    dy_err = float((dy_k - dy_p).abs().max())
    ok = ok and bool(((dy_k - dy_p).abs() <= bound).all())
    print(f"[K2] {label}: x {tuple(x.shape)} y {tuple(y.shape)} "
          f"exact={ok} max_abs_err={err} dy_max_abs_diff={dy_err}",
          flush=True)
    if not ok:
        raise AssertionError(f"K2 disagrees with its plain version: {label}")
    return err


def _sphere(centre, n, dev):
    """n points [T, n, 3] at distance ~0.2 around each centre [T, 1, 3]
    in f32, half of them moved by one ulp in z: near-ties of every
    order."""
    gen = torch.Generator(device=dev).manual_seed(3)
    u = torch.randn((centre.shape[0], n, 3), device=dev, generator=gen)
    y = centre + 0.2 * u / u.norm(dim=-1, keepdim=True)
    y[:, ::2, 2] = torch.nextafter(y[:, ::2, 2],
                                   torch.full_like(y[:, ::2, 2], 1e30))
    return y.contiguous()


def _reset_counts(C, K):
    torch.cuda.synchronize()
    C.launches = 0
    K.launches = 0


def _run_fit(solver, prob, mode, C, K, expect, label):
    """Drive fit(mode) with both counts at 0; check finite, decreasing
    per-phase losses and the launches of each kernel. Returns
    (K1 launches, K2 launches, fit seconds, loss histories, (body [T,
    75], scale, camera_ext [T, 4, 4]) as solved)."""
    _reset_counts(C, K)
    t0 = time.perf_counter()
    final, hist = solver.fit(prob.body, prob.cam, mode=mode)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    got = (C.launches, K.launches)
    for k, v in hist.items():
        print(f"[{label}] {k}: {len(v)} steps, loss {v[0]:.6f} -> "
              f"{v[-1]:.6f}, {solver.phase_seconds[k]:.3f} s", flush=True)
        if not np.all(np.isfinite(v)):
            raise AssertionError(f"{label} {k}: non-finite loss")
        if not v[-1] < v[0]:
            raise AssertionError(f"{label} {k}: loss did not decrease")
    others = {k: round(v, 3) for k, v in solver.phase_seconds.items()
              if k not in hist}
    print(f"[{label}] other stages (s): {others}; fit total {fit_s:.3f} s; "
          f"K1 launches {got[0]}, K2 launches {got[1]} (expected "
          f"{expect[0]}, {expect[1]})", flush=True)
    if got != expect:
        raise AssertionError(f"{label}: launches {got}, expected {expect}")
    T = prob.body.shape[0]
    body, scale, cam = solver.result_params(final)
    if body.shape != (T, 75) or cam.shape != (T, 4, 4) or not (
            np.all(np.isfinite(body)) and np.isfinite(scale)
            and np.all(np.isfinite(cam))):
        raise AssertionError(f"{label}: final parameters not finite / "
                             "wrong shape")
    return got[0], got[1], fit_s, hist, (body, scale, cam)


def _hold_histories(hg, hc, label, what="cuda vs cpu", watch=()):
    """Histories hg against hc (per clip where they are [steps, C]): the
    first loss is taken at the shared initial state, 1e-5 relative (f32
    summation order); later losses 2e-2, because the L1 smoothness terms
    turn last-bit differences of near-zero second differences into
    +-lr Adam steps. A phase in `watch` is held at 2e-2 on its mean and
    final relative difference, and a step past 2e-2 is printed as such
    (ROADMAP.md §3 logs it), not raised: where the two runs' model
    chains differ in their last bits for every frame (a frames split on
    the card), the skate phase's L1 terms carry them to single-step
    excursions that no split can remove."""
    if hg.keys() != hc.keys():
        raise AssertionError(f"{label}: phases {list(hg)} vs {list(hc)}")
    k0 = next(iter(hc))
    first = float(np.max(np.abs(hg[k0][0] - hc[k0][0]) / np.abs(hc[k0][0])))
    print(f"[reference] {label} {k0} first loss rel diff {what} "
          f"{first:.3e}")
    if not first <= 1e-5:
        raise AssertionError(f"{label}: first losses disagree ({what})")
    for k in hc:
        rel_steps = np.abs(hg[k] - hc[k]) / np.abs(hc[k])
        rel = float(np.max(rel_steps))
        print(f"[reference] {label} {k}: max rel diff {what} {rel:.3e}",
              flush=True)
        if not np.all(np.isfinite(hg[k])):
            raise AssertionError(f"{label} {k}: non-finite losses")
        if k not in watch:
            if not rel < 2e-2:
                raise AssertionError(f"{label} {k}: histories disagree "
                                     f"({what})")
            continue
        per_step = rel_steps.reshape(len(rel_steps), -1).max(-1)
        mean, final = float(per_step.mean()), float(per_step[-1])
        past = int((per_step >= 2e-2).sum())
        print(f"[reference] {label} {k} (watch): max at step "
              f"{int(per_step.argmax())} of {len(per_step)}, mean "
              f"{mean:.3e}, final {final:.3e}; {past} step(s) past 2e-2"
              + (" (logged in ROADMAP.md §3)" if past else ""), flush=True)
        if not (mean < 2e-2 and final < 2e-2):
            raise AssertionError(f"{label} {k}: histories disagree ({what})")


_SMALL = dict(num_verts=1024, scene_pts=2500, num_iter=20, num_iter_dct=40)


def _card_vs_cpu(standard_problem, dev, mode, nn_impl):
    """A small solve on the card against the same solve on the CPU."""
    small = dict(_SMALL, T=24, nn_impl=nn_impl)
    h_gpu = standard_problem(device=dev, **small)
    h_cpu = standard_problem(device="cpu", **small)
    _, hg = h_gpu.solver.fit(h_gpu.body, h_gpu.cam, mode=mode)
    _, hc = h_cpu.solver.fit(h_cpu.body, h_cpu.cam, mode=mode)
    _hold_histories(hg, hc, f"{mode}/{nn_impl}")


def _cli_on_card(tmp: Path):
    """The globalopt CLI in a subprocess on a seeded fixture: 6 frames
    of body pkls, a 2,500-point scene.ply and a camerapose.txt."""
    from fpv4d_torch.io import body_pkl
    from fpv4d_torch.io.ply import write_ply
    rng = np.random.RandomState(0)
    T = 6
    body_pkl.save_clip(str(tmp / "body_gen"),
                       (rng.randn(T, 75) * 0.1).astype(np.float32))
    g = np.linspace(-3, 3, 50)
    xs, zs = np.meshgrid(g, g)
    write_ply(str(tmp / "scene.ply"), np.stack(
        [xs.ravel(), -1.0 + 0.03 * rng.randn(xs.size), zs.ravel()],
        1).astype(np.float32))
    with open(tmp / "camerapose.txt", "w") as f:
        for t in range(T):
            f.write(f"{t:06d}.jpg 1 0 0 0 0.1 0.2 {0.3 + 0.1 * t}\n")
    cmd = [sys.executable, "-m", "fpv4d_torch.cli.globalopt",
           str(tmp / "body_gen"), str(tmp / "fit"), "global",
           "--scene", str(tmp / "scene.ply"),
           "--camera", str(tmp / "camerapose.txt"), "--iters", "10",
           "--model", "NONE", "--vposer", "NONE", "--nn-impl", "brute"]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT)] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    t0 = time.perf_counter()
    res = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=600)
    secs = time.perf_counter() - t0
    for line in (res.stdout + res.stderr).splitlines()[-8:]:
        print(f"[cli] | {line}")
    if res.returncode != 0:
        raise AssertionError(f"globalopt exited {res.returncode}")
    pkls = sorted((tmp / "fit").glob("*.pkl"))
    frames = [body_pkl.load_frame(str(p)) for p in pkls]
    if len(frames) != T or not all(
            "scale" in d and "camera_ext" in d
            and np.isfinite(d["scale"]) and np.all(np.isfinite(
                d["camera_ext"])) for d in frames):
        raise AssertionError("globalopt wrote no complete pkls")
    print(f"[cli] globalopt global --nn-impl brute exit 0 in {secs:.2f} s; "
          f"{len(pkls)} pkls with scale {float(frames[0]['scale']):.6f}",
          flush=True)


# -- the per-frame stages: keypoint fit and smoother -----------------------------

_STAGES = ("camera", "body", "all")


def _kp_truth(model, vp, T: int, dev, seed: int = 1):
    """Camera-space ground-truth joints [T, 55, 3] of keypoint_problem's
    target: its first draw is the VPoser latent, at zero betas and
    orientation, 3 m in front of the camera."""
    from fpv4d_torch.models import vposer as VP
    rng = np.random.RandomState(seed)
    lat = torch.as_tensor(rng.randn(T, 32).astype(np.float32) * 0.3,
                          device=dev)
    z = torch.zeros(T, 3, device=dev)
    with torch.no_grad():
        out = model(betas=torch.zeros(T, model.num_betas, device=dev),
                    global_orient=z, body_pose=VP.decode(vp, lat),
                    vertex_subset=np.zeros(1, np.int32))
    return out["joints"] + torch.tensor([0.0, 0.0, 3.0], device=dev)


def _mpjpe_mm(model, vp, params: np.ndarray, truth, dev) -> np.ndarray:
    """Per-frame mean distance (mm) of the fitted BODY_25-mapped joints,
    in camera space, from the ground truth: [T]."""
    from fpv4d_torch.models import vposer as VP
    from fpv4d_torch.solve.keypoint_fit import BODY25_FROM_SMPLX
    sel = np.unique(BODY25_FROM_SMPLX[BODY25_FROM_SMPLX >= 0])
    p = torch.as_tensor(params, device=dev)
    with torch.no_grad():
        out = model(betas=p[:, 6:16], global_orient=p[:, 3:6],
                    body_pose=VP.decode(vp, p[:, 16:48]),
                    left_hand_pose=p[:, 48:60],
                    right_hand_pose=p[:, 60:72],
                    vertex_subset=np.zeros(1, np.int32))
    j = out["joints"] + p[:, None, 72:75]
    err = (j[:, sel] - truth[:, sel]).norm(dim=-1).mean(-1)
    return err.cpu().numpy() * 1e3


def _run_keypoints(label, model, vp, kp, cfg, C, K, **kw):
    """One fit_keypoints with both counts at 0: finite losses, each
    stage's last below its first (every clip), no kernel launched.
    The per-frame L-BFGS's history is the mean over frames of each
    frame's value, and a frame whose 16 backtracking trials all fail
    still steps (the reference's bounded search), so a few frames can
    run away and that mean rises in either package
    (tests/test_torch_keypoint_fit.py): it is held by its median
    recovery instead (``_keypoint_phase``). Returns (params, hist,
    seconds)."""
    from fpv4d_torch.solve.keypoint_fit import fit_keypoints
    _reset_counts(C, K)
    t0 = time.perf_counter()
    params, hist = fit_keypoints(model, vp, kp, cfg, **kw)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    frames = int(np.prod(kp.shape[:-2]))
    got = (C.launches, K.launches)
    print(f"[{label}] {cfg.optimizer}, {cfg.num_iter} steps per stage, "
          f"{frames} frames: {secs:.3f} s, {frames / secs:.1f} frames/s; "
          f"K1 launches {got[0]}, K2 launches {got[1]} (expected 0, 0)",
          flush=True)
    for k in _STAGES:
        h = np.asarray(hist[k]).reshape(-1, cfg.num_iter)
        print(f"[{label}] {k}: loss {h[:, 0].mean():.6f} -> "
              f"{h[:, -1].mean():.6f}"
              + (f" (mean of {h.shape[0]} clips)" if h.shape[0] > 1
                 else ""), flush=True)
        if not np.all(np.isfinite(h)):
            raise AssertionError(f"{label} {k}: non-finite loss")
        if cfg.optimizer != "lbfgs_perframe" and not np.all(
                h[:, -1] < h[:, 0]):
            raise AssertionError(f"{label} {k}: loss did not decrease")
    if got != (0, 0):
        raise AssertionError(f"{label}: a kernel ran off its path {got}")
    if not np.all(np.isfinite(params)):
        raise AssertionError(f"{label}: non-finite parameters")
    return params, hist, secs


def _hands_face_fixture(model, vp, T: int, dev, seed: int = 5):
    """Body, hand and face keypoints [T, ...] projected (1 px noise) from a
    ground truth with hand poses, jaw pose and expression, as the
    reference's hand and face tests build them."""
    from fpv4d_torch.models import vposer as VP
    from fpv4d_torch.solve import keypoint_fit as KF
    rng = np.random.RandomState(seed)
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32),  # noqa: E731
                                  device=dev)
    lmk_vids, tri, bary = model.landmark_vertex_subset()
    with torch.no_grad():
        out = model(betas=t(np.zeros((T, 10))),
                    global_orient=t(rng.randn(T, 3) * 0.1),
                    body_pose=VP.decode(vp, t(rng.randn(T, 32) * 0.2)),
                    left_hand_pose=t(rng.randn(T, 12)),
                    right_hand_pose=t(rng.randn(T, 12)),
                    jaw_pose=t(rng.randn(T, 3) * 0.2),
                    expression=t(rng.randn(T, 10) * 2.0),
                    vertex_subset=lmk_vids)
    cam = t(np.stack([np.zeros(T), np.zeros(T), 2.5 + 0.2 * rng.rand(T)],
                     1))[:, None]
    center = t([640.0, 360.0])

    def proj(pts):
        p = KF.project(pts + cam, 694.0, center).cpu().numpy()
        return p + rng.randn(*p.shape).astype(np.float32)

    j = out["joints"]
    valid = KF.BODY25_FROM_SMPLX >= 0
    ids = np.where(valid, KF.BODY25_FROM_SMPLX, 0)
    kp = np.concatenate([proj(j[:, ids]), np.tile(
        valid.astype(np.float32)[None, :, None], (T, 1, 1))], -1)
    hands = []
    for hid in (KF.LHAND_SMPLX, KF.RHAND_SMPLX):
        h = np.zeros((T, 21, 3), np.float32)
        h[:, KF._HAND21_SLOTS, :2] = proj(j[:, hid])
        h[:, KF._HAND21_SLOTS, 2] = 1.0
        hands.append(h)
    lmk = torch.einsum("lk,tlkc->tlc", t(bary),
                       out["vertices"][:, torch.as_tensor(
                           tri.astype(np.int64), device=dev)])
    face = np.zeros((T, 70, 3), np.float32)
    face[:, 17:68, :2] = proj(lmk)
    face[:, 17:68, 2] = 1.0
    return kp.astype(np.float32), hands[0], hands[1], face


def _keypoint_phase(model, vp, dev, C, K):
    """Phase 10 on the standard problem's model and VPoser weights.
    Returns the Adam fit's [900, 75] parameters."""
    from fpv4d_torch.config import KeypointFitConfig
    from fpv4d_torch.utils.bench_problem import keypoint_problem
    T, clips = 900, 8
    kp, kcfg = keypoint_problem(model, vp, T, num_iter=120)
    truth = _kp_truth(model, vp, T, dev)
    adam_params = None
    for name, iters in (("adam", kcfg.num_iter), ("lbfgs", 60),
                        ("lbfgs_perframe", 40)):
        cfg = KeypointFitConfig(num_iter=iters, optimizer=name)
        params, _, _ = _run_keypoints("keypoints", model, vp, kp, cfg, C, K)
        err = _mpjpe_mm(model, vp, params, truth, dev)
        print(f"[keypoints] {name}: MPJPE {err.mean():.3f} mm (median "
              f"{np.median(err):.3f}, {int((err > 100).sum())} of {T} "
              f"frames beyond 100 mm)", flush=True)
        # every frame recovers with Adam and the joint L-BFGS; per frame,
        # the median (a few frames may run away, see _run_keypoints)
        held = np.median(err) if name == "lbfgs_perframe" else err.mean()
        if not held < 100.0:
            raise AssertionError(f"keypoints {name}: MPJPE {held:.1f} mm")
        if name == "adam":
            adam_params = params

    # the fleet shape: 8 clips x 900 frames in one batched fit, the clips
    # de-correlated by 1 px of noise each
    kp_b = np.broadcast_to(kp, (clips,) + kp.shape).copy()
    kp_b[..., :2] += np.random.RandomState(2).randn(
        *kp_b[..., :2].shape).astype(np.float32)
    params_b, _, _ = _run_keypoints("keypoints/batched", model, vp, kp_b,
                                    kcfg, C, K)
    if params_b.shape != (clips, T, 75):
        raise AssertionError("batched fit: wrong shape")

    # hands and face at T=60: the landmark path
    kp60, hl, hr, face = _hands_face_fixture(model, vp, 60, dev)
    _, hist, _ = _run_keypoints("keypoints/hands+face", model, vp, kp60,
                                KeypointFitConfig(num_iter=120), C, K,
                                hand_left=hl, hand_right=hr, face=face)
    jaw, expr = hist["jaw"], hist["expression"]
    print(f"[keypoints/hands+face] |jaw| {np.abs(jaw).mean():.4f}, "
          f"|expression| {np.abs(expr).mean():.4f}", flush=True)
    if not (np.all(np.isfinite(jaw)) and np.abs(expr).max() > 0):
        raise AssertionError("face fit: jaw/expression did not move")
    return adam_params


def _frame_diff(x: np.ndarray) -> float:
    """Mean frame-to-frame change of the betas + pose latent."""
    return float(np.mean(np.abs(np.diff(x[:, 6:48], axis=0))))


def _smoother_phase(body: np.ndarray, dev, C, K):
    """Phase 11 on the keypoint fit's [900, 75] result: the sequential
    variants on its first 300 frames, the reference's clip length."""
    from fpv4d_torch.models import motion_gru
    from fpv4d_torch.solve import frame_fit
    T_seq = 300
    gru = motion_gru.random_params(0, device=dev)
    runs = (("fit_independent", body, "50 Adam steps, all frames at once",
             lambda b: frame_fit.fit_independent(b, device=dev)),
            ("fit_sequential", body[:T_seq],
             f"{T_seq * 50} sequential Adam steps",
             lambda b: frame_fit.fit_sequential(b, device=dev)),
            ("fit_sequential_motion", body[:T_seq],
             f"{T_seq * 50} sequential Adam steps",
             lambda b: frame_fit.fit_sequential_motion(b, gru, device=dev)))
    for name, b, steps, fn in runs:
        _reset_counts(C, K)
        t0 = time.perf_counter()
        out = fn(b)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        got = (C.launches, K.launches)
        print(f"[smoother] {name}: T={len(b)}, {secs:.3f} s ({steps}), "
              f"frame diff "
              f"{_frame_diff(b):.5f} -> {_frame_diff(out):.5f}, max |out - "
              f"in| {np.abs(out - b).max():.4f}; K1 launches {got[0]}, K2 "
              f"launches {got[1]} (expected 0, 0)", flush=True)
        if out.shape != b.shape or not np.all(np.isfinite(out)):
            raise AssertionError(f"{name}: non-finite or wrong shape")
        if got != (0, 0):
            raise AssertionError(f"{name}: a kernel ran off its path {got}")
        if name == "fit_sequential" and not _frame_diff(out) < _frame_diff(b):
            raise AssertionError("fit_sequential did not smooth")


def _stages_card_vs_cpu(dev):
    """Phase 12. A small Adam keypoint fit, card against CPU: first loss
    within 1e-5 relative (the shared initial state), histories within
    1e-3 (after ~10 steps per stage Adam amplifies the two devices'
    rounding in near-zero latent gradients). fit_sequential returns no
    losses, so its results are held: 95% of entries within 1e-4, all
    within 1e-2, a tenth of lr (its L1 pull toward the previous frame
    meets zero residuals near its optimum, where last-bit differences
    choose the sign of a step)."""
    from fpv4d_torch.config import KeypointFitConfig
    from fpv4d_torch.models import smplx, vposer
    from fpv4d_torch.solve import frame_fit
    from fpv4d_torch.solve.keypoint_fit import fit_keypoints
    from fpv4d_torch.utils.bench_problem import keypoint_problem
    res = []
    for where, d in (("card", dev), ("cpu", torch.device("cpu"))):
        model = smplx.synthetic_model(num_verts=1024, seed=0,
                                      sparse_weights=True, device=d)
        vp = vposer.random_params(0, device=d)
        kp, cfg = keypoint_problem(model, vp, 24, num_iter=10)
        res.append(fit_keypoints(model, vp, kp, cfg))
    (pg, hg), (pc, hc) = res
    first = abs(hg["camera"][0] - hc["camera"][0]) / abs(hc["camera"][0])
    print(f"[reference] keypoints camera first loss rel diff cuda vs cpu "
          f"{first:.3e}", flush=True)
    if not first <= 1e-5:
        raise AssertionError("keypoints: cuda and cpu first losses disagree")
    for k in _STAGES:
        rel = float(np.max(np.abs(hg[k] - hc[k]) / np.abs(hc[k])))
        print(f"[reference] keypoints {k}: max rel diff cuda vs cpu "
              f"{rel:.3e}", flush=True)
        if not (np.all(np.isfinite(hg[k])) and rel < 1e-3):
            raise AssertionError(f"keypoints {k}: cuda and cpu disagree")
    body = pc + np.random.RandomState(3).randn(*pc.shape).astype(
        np.float32) * 0.05
    sg = frame_fit.fit_sequential(body, device=dev)
    sc = frame_fit.fit_sequential(body, device="cpu")
    err = np.abs(sg - sc)
    frac = float(np.mean(err <= 1e-4))
    print(f"[reference] fit_sequential T=24: max abs diff cuda vs cpu "
          f"{err.max():.3e}, {frac:.4f} of entries within 1e-4", flush=True)
    if not (np.all(np.isfinite(sg)) and frac >= 0.95 and err.max() <= 1e-2):
        raise AssertionError("fit_sequential: cuda and cpu disagree")


def _pipeline_on_card(tmp: Path):
    """Phase 13: fit -> smooth -> globalopt local, each a subprocess on
    the card by default, on 6 frames of seeded OpenPose JSONs with both
    hands, a 2,500-point scene.ply and a camerapose.txt."""
    from fpv4d_torch.io import body_pkl
    from fpv4d_torch.io.ply import write_ply
    rng = np.random.RandomState(4)
    T = 6
    kp_dir = tmp / "keypoints"
    kp_dir.mkdir()
    k, h = np.arange(25), np.arange(21)
    for t in range(T):
        body = np.stack([640 + 30 * np.cos(k) + 2 * t,
                         360 + 40 * np.sin(k) + t, np.ones(25)], 1)
        hl = np.stack([600 + 10 * np.cos(h) + t, 300 + 8 * np.sin(h),
                       np.full(21, 0.9)], 1)
        hr = np.stack([680 + 10 * np.sin(h), 300 + 8 * np.cos(h) + t,
                       np.full(21, 0.8)], 1)
        with open(kp_dir / f"{t:06d}_keypoints.json", "w") as f:
            json.dump({"people": [{
                "pose_keypoints_2d": body.ravel().tolist(),
                "hand_left_keypoints_2d": hl.ravel().tolist(),
                "hand_right_keypoints_2d": hr.ravel().tolist()}]}, f)
    g = np.linspace(-3, 3, 50)
    xs, zs = np.meshgrid(g, g)
    write_ply(str(tmp / "scene.ply"), np.stack(
        [xs.ravel(), -1.0 + 0.03 * rng.randn(xs.size), zs.ravel()],
        1).astype(np.float32))
    with open(tmp / "camerapose.txt", "w") as f:
        for t in range(T):
            f.write(f"{t:06d}.jpg 1 0 0 0 0.1 0.0 {0.5 + 0.1 * t}\n")
    assets = ["--model", "NONE", "--vposer", "NONE"]
    steps = (
        ("fit", [str(kp_dir), str(tmp / "body_gen"), "--iters", "30"]
         + assets, tmp / "body_gen"),
        ("smooth", [str(tmp / "body_gen"), str(tmp), "--iters", "10"],
         tmp / "smoothed_body"),
        ("globalopt", [str(tmp / "smoothed_body"), str(tmp / "fit_out"),
                       "local", "--scene", str(tmp / "scene.ply"),
                       "--camera", str(tmp / "camerapose.txt"),
                       "--iters", "10"] + assets, tmp / "fit_out"),
    )
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT)] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    for name, args, out_dir in steps:
        t0 = time.perf_counter()
        res = subprocess.run(
            [sys.executable, "-m", f"fpv4d_torch.cli.{name}"] + args,
            cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
        secs = time.perf_counter() - t0
        for line in (res.stdout + res.stderr).splitlines()[-6:]:
            print(f"[pipeline] {name} | {line}")
        if res.returncode != 0:
            raise AssertionError(f"{name} exited {res.returncode}")
        frames = [body_pkl.load_frame(str(p))
                  for p in sorted(out_dir.glob("*.pkl"))]
        if len(frames) != T or not all(
                np.all(np.isfinite(np.asarray(v, np.float32)))
                for d in frames for v in d.values()):
            raise AssertionError(f"{name} wrote no complete pkls")
        if name == "globalopt" and not all(
                "scale" in d and "camera_ext" in d for d in frames):
            raise AssertionError("globalopt pkls lack scale/camera_ext")
        print(f"[pipeline] {name} exit 0 in {secs:.2f} s; {len(frames)} "
              f"pkls in {out_dir.name}", flush=True)

# -- the multi-clip fleet ----------------------------------------------------------

def _fleet_kernels(C, K, solver, prob, dev):
    """Phase 14: both kernels at the fleet's shapes. Returns the kernel
    line's measurements of K1 on the folded C=8 tables and of K2 over a
    clip axis."""
    from fpv4d_torch.ops import nn as NN
    from fpv4d_torch.parallel import sharding as SH
    from fpv4d_torch.parallel.multi_clip import MultiClipSolver, pad_scenes
    from fpv4d_torch.solve.clip_solve import forward_world
    from fpv4d_torch.utils.bench_problem import fleet_batch
    clips = 8
    bodies, cams, _ = fleet_batch(prob, clips)
    state_b, _, _ = MultiClipSolver(solver=solver).init_batch(bodies, cams)
    # the fleet's scenes are the standard scene C times, whose batched
    # grid is the solver's own grid on each clip (build_voxel_grid_batch
    # of C equal scenes)
    g = solver.grid
    grid_b = NN.VoxelGrid(
        cand_pts=g.cand_pts.expand((clips,) + g.cand_pts.shape),
        cand_idx=g.cand_idx.expand((clips,) + g.cand_idx.shape),
        origin=g.origin.expand(clips, 3), dims=g.dims, h=g.h)
    fc = SH.refresh_cands(solver, state_b, grid_b)
    with torch.no_grad():
        q, _, _ = forward_world(solver.ctx, SH.flatten_state(state_b),
                                vertex_subset=solver.contact_vids,
                                prune=solver._contact_prune,
                                with_joints=False)
    del state_b
    k1_err = _check_k1(C, q, fc.cand, fc.valid,
                       f"fleet: {clips} clips folded, first refresh")
    T, N, P = fc.cand.shape[0], q.shape[1], fc.cand.shape[1]
    ms = _median_ms(lambda: C.cand_nn_cuda(q, fc.cand, fc.valid))
    plain_ms = _median_ms(lambda: C.cand_nn_plain(q, fc.cand, fc.valid),
                          reps=5, warmup=1)
    lib_ms = _median_ms(lambda: torch.cdist(q, fc.cand).min(-1), reps=5,
                        warmup=1)
    bound_ms, bound_by = _k1_bound_ms(T, N, P)
    print(f"[K1] fleet [{T}, {N}, {P}]: kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, cdist+min {lib_ms:.4f} ms, bound "
          f"{bound_ms:.4f} ms ({bound_by}), {bound_ms / ms:.1%} of the "
          "bound", flush=True)
    k1 = (k1_err, ms, plain_ms, lib_ms, bound_ms, bound_by)

    # more frames than a grid's y axis takes, at a small N
    F = 70_000
    rep = -(-F // T)
    q70 = q[:, :32].repeat(rep, 1, 1)[:F].contiguous()
    _check_k1(C, q70, fc.cand.repeat(rep, 1, 1)[:F].contiguous(),
              fc.valid.repeat(rep, 1)[:F].contiguous(),
              f"{F} frames (beyond 65,535)")
    del q70, fc
    torch.cuda.empty_cache()

    # K2 over a clip axis: the standard scene, and the scene shifted by
    # (0.5, 0, 0.25) m and cut to its first 80,000 points, padded
    scene = prob.scene
    shifted = scene[:80_000] + np.float32([0.5, 0.0, 0.25])
    y = torch.as_tensor(pad_scenes([scene, shifted]), device=dev)
    x = q[:prob.body.shape[0]]
    x = torch.stack([x, x + torch.tensor([0.5, 0.0, 0.25], device=dev)])
    del q
    k2_err = _check_k2(K, x, y, f"clip axis {tuple(x.shape)} x "
                       f"{tuple(y.shape)}, padded, shifted and cut")
    d_k, i_k = K.nn_distance_cuda(x, y)
    for c in range(2):
        d_c, i_c = K.nn_distance_cuda(x[c], y[c])
        if not (torch.equal(d_k[c], d_c) and torch.equal(i_k[c], i_c)):
            raise AssertionError(f"K2 clip {c} differs from its [M, 3] "
                                 "launch")
    if int(i_k[1].max()) >= len(shifted):
        raise AssertionError("K2: a padding point won")
    print("[K2] clip axis: each clip bit-identical to its own [M, 3] "
          "launch; no padding point won", flush=True)
    Q, M = x[0].numel() // 3, y.shape[1]
    ms = _median_ms(lambda: K.nn_distance_cuda(x, y), reps=10)
    single_ms = _median_ms(lambda: K.nn_distance_cuda(x[0], y[0]), reps=10)
    plain_ms = _median_ms(lambda: K.nn_distance_plain(x, y), reps=1,
                          warmup=1)
    xf = x.reshape(2, -1, 3)

    def cdist_min():
        for c in range(2):
            for s in range(0, Q, 8192):
                torch.cdist(xf[c, s:s + 8192], y[c]).min(-1)

    lib_ms = _median_ms(cdist_min, reps=2, warmup=1)
    bound_ms, bound_by = _k2_bound_ms(Q, M, clips=2)
    print(f"[K2] clip axis [2, {Q}] x [2, {M}]: kernel {ms:.4f} ms per "
          f"launch (2 x the single-cloud launch: {2 * single_ms:.4f} ms), "
          f"plain {plain_ms:.4f} ms, cdist+min {lib_ms:.4f} ms, bound "
          f"{bound_ms:.4f} ms ({bound_by}), {bound_ms / ms:.1%} of the "
          "bound", flush=True)
    del x, y, d_k, i_k
    torch.cuda.empty_cache()
    return k1, (k2_err, ms, plain_ms, lib_ms, bound_ms, bound_by)


def _run_fleet(mc, bodies, cams, scenes, mode, C, K, expect, label):
    """One MultiClipSolver.fit with both counts at 0 and every stage
    fenced: each clip's losses finite and each phase ending below where
    it began, the launches of each kernel. Returns (seconds, histories,
    final state, stage timings)."""
    _reset_counts(C, K)
    torch.cuda.reset_peak_memory_stats()
    tm = {}
    t0 = time.perf_counter()
    state_b, hist = mc.fit(bodies, cams, scenes, mode=mode, timings=tm)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    got = (C.launches, K.launches)
    clips = bodies.shape[0]
    fences = tm.pop("_fences")
    for k, v in hist.items():
        print(f"[{label}] {k}: {v.shape[0]} steps x {v.shape[1]} clips, "
              f"mean loss {v[0].mean():.6f} -> {v[-1].mean():.6f}",
              flush=True)
        if not np.all(np.isfinite(v)):
            raise AssertionError(f"{label} {k}: non-finite loss")
        if not np.all(v[-1] < v[0]):
            raise AssertionError(f"{label} {k}: a clip's loss did not "
                                 "decrease")
    stages = {k: round(v, 3) for k, v in tm.items()}
    print(f"[{label}] {clips} clips: {secs:.3f} s, "
          f"{clips / secs * 3600:.1f} clips per hour; stages (s) {stages}, "
          f"fences {fences}; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; K1 "
          f"launches {got[0]}, K2 launches {got[1]} (expected {expect[0]}, "
          f"{expect[1]})", flush=True)
    if got != expect:
        raise AssertionError(f"{label}: launches {got}, expected {expect}")
    for body, scale, cam in mc.result_params(state_b):
        if not (np.all(np.isfinite(body)) and np.isfinite(scale)
                and np.all(np.isfinite(cam))):
            raise AssertionError(f"{label}: final parameters not finite")
    return secs, hist, state_b, tm


def _fleet_phases(C, K, prob, dev, local_s, local_hist, n_a, n_dct_b):
    """Phases 15-18. Returns the K1 launches of the local fleet and the
    K2 launches of the global/brute fleet."""
    from fpv4d_torch.io import native
    from fpv4d_torch.parallel.multi_clip import MultiClipSolver
    from fpv4d_torch.utils.bench_problem import fleet_batch, standard_problem

    # 15. local/grid, 8 clips x 900 frames, skate in chunks of 2, then 0
    clips = 8
    bodies, cams, scenes = fleet_batch(prob, clips)
    mc = MultiClipSolver(solver=prob.solver)
    native.builds = 0
    secs, hist, state2, tm2 = _run_fleet(mc, bodies, cams, scenes, "local",
                                         C, K, (n_a, 0), "fleet/local")
    print(f"[fleet/local] grids: {native.builds} native builds for "
          f"{clips} clips in {tm2['grids']:.3f} s", flush=True)
    if native.builds != clips:
        raise AssertionError("fleet: the grids did not take the native "
                             "route")
    k1_launches = n_a
    print(f"[fleet/local] per clip {secs / clips:.3f} s = "
          f"{secs / clips / local_s:.3f} x the single local solve "
          f"({local_s:.3f} s, phase 5)", flush=True)
    _hold_histories({k: v[:, 0] for k, v in hist.items()}, local_hist,
                    "fleet/local clip 0", "fleet vs single solve")
    mc.skate_clip_chunk = 0
    _, hist0, state0, tm0 = _run_fleet(mc, bodies, cams, scenes, "local", C,
                                       K, (n_a, 0), "fleet/local, skate "
                                       "unchunked")
    print(f"[fleet/local] skate phase {tm2['skate']:.3f} s in chunks of 2, "
          f"{tm0['skate']:.3f} s unchunked; grid cache hits "
          f"{mc.grid_cache_hits}, misses {mc.grid_cache_misses}; max "
          f"|body_6d| difference "
          f"{float((state2.body_6d - state0.body_6d).abs().max()):.3e}",
          flush=True)
    if (mc.grid_cache_hits, mc.grid_cache_misses) != (1, 1):
        raise AssertionError("fleet: the second fit must hit the grid cache")
    _hold_histories(hist0, hist, "fleet/local skate unchunked",
                    "vs chunks of 2")
    del state2, state0
    torch.cuda.empty_cache()

    # 16. global with brute-force contact NN, 2 clips at full width
    prob_b = standard_problem(device=dev, nn_impl="brute")
    bodies2, cams2, scenes2 = fleet_batch(prob_b, 2)
    _run_fleet(MultiClipSolver(solver=prob_b.solver), bodies2, cams2,
               scenes2, "global", C, K, (0, n_a), "fleet/global/brute")
    k2_launches = n_a
    del prob_b
    torch.cuda.empty_cache()

    # 17. dct with the grid, 8 clips at full length
    _run_fleet(mc, bodies, cams, scenes, "dct", C, K, (n_dct_b, 0),
               "fleet/dct")

    # 18. a small fleet on the card and on the CPU
    for mode, nn_impl in (("local", "grid"), ("global", "brute")):
        hs = []
        for where, d in (("card", dev), ("cpu", torch.device("cpu"))):
            small = standard_problem(device=d, T=12, nn_impl=nn_impl,
                                     **_SMALL)
            b, c, sc = fleet_batch(small, 2)
            hs.append(MultiClipSolver(solver=small.solver).fit(
                b, c, sc, mode=mode)[1])
        _hold_histories(*hs, f"fleet C=2 T=12 {mode}/{nn_impl}")
    return k1_launches, k2_launches


def _write_clip(root: Path, T: int, seed: int):
    """A clip directory as _cli_on_card writes one: T frames of body
    pkls, a 2,500-point scene.ply and a camerapose.txt."""
    from fpv4d_torch.io import body_pkl
    from fpv4d_torch.io.ply import write_ply
    rng = np.random.RandomState(seed)
    body_pkl.save_clip(str(root / "body_gen"),
                       (rng.randn(T, 75) * 0.1).astype(np.float32))
    g = np.linspace(-3, 3, 50)
    xs, zs = np.meshgrid(g, g)
    write_ply(str(root / "scene.ply"), np.stack(
        [xs.ravel(), -1.0 + 0.03 * rng.randn(xs.size), zs.ravel()],
        1).astype(np.float32))
    with open(root / "camerapose.txt", "w") as f:
        for t in range(T):
            f.write(f"{t:06d}.jpg 1 0 0 0 0.1 0.2 {0.3 + 0.1 * t}\n")


def _multiopt_on_card(tmp: Path):
    """Phase 19: the multiopt CLI in a subprocess on two clip
    directories, alone and then in a one-rank NCCL process group
    (FPV4D_DISTRIBUTED=1, RANK=0, WORLD_SIZE=1, a free MASTER_PORT); the
    second run's pkls against the first's. Returns (the clip
    directories, the first run's frames per clip)."""
    import socket
    from fpv4d_torch.io import body_pkl
    T = 6
    dirs = []
    for i, name in enumerate(("clipA", "clipB")):
        (tmp / name).mkdir()
        _write_clip(tmp / name, T, seed=10 + i)
        dirs.append(str(tmp / name))
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    base = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT)] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    runs = (("alone", {}), ("one-rank NCCL group", dict(
        FPV4D_DISTRIBUTED="1", RANK="0", LOCAL_RANK="0", WORLD_SIZE="1",
        MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))))
    outs = []
    for i, (label, extra) in enumerate(runs):
        out = tmp / f"out{i}"
        cmd = [sys.executable, "-m", "fpv4d_torch.cli.multiopt", *dirs,
               "--out", str(out), "--mode", "global", "--iters", "10",
               "--scene-name", "scene.ply", "--model", "NONE", "--vposer",
               "NONE"]
        t0 = time.perf_counter()
        res = subprocess.run(cmd, cwd=ROOT, env=dict(base, **extra),
                             capture_output=True, text=True, timeout=600)
        secs = time.perf_counter() - t0
        for line in (res.stdout + res.stderr).splitlines()[-6:]:
            print(f"[multiopt] {label} | {line}")
        if res.returncode != 0:
            raise AssertionError(f"multiopt ({label}) exited "
                                 f"{res.returncode}")
        frames = [[body_pkl.load_frame(str(p)) for p in
                   sorted((out / name).glob("*.pkl"))]
                  for name in ("clipA", "clipB")]
        if not all(len(f) == T and all("scale" in d and "camera_ext" in d
                                       for d in f) for f in frames):
            raise AssertionError(f"multiopt ({label}) wrote no complete "
                                 "pkls")
        print(f"[multiopt] {label}: exit 0 in {secs:.2f} s, 2 x {T} pkls",
              flush=True)
        outs.append(frames)
    diff = max(float(np.max(np.abs(np.asarray(a[k], np.float64)
                                   - np.asarray(b[k], np.float64))))
               for fa, fb in zip(*outs) for a, b in zip(fa, fb) for k in a)
    print(f"[multiopt] the NCCL run's pkls against the first run's: max abs "
          f"difference {diff:.3e}", flush=True)
    if diff != 0.0:
        raise AssertionError("multiopt: the one-rank NCCL run's pkls differ")
    return dirs, outs[0]


# -- the native grid builder and the frames axis --------------------------------

def _native_grid_phase(prob):
    """Phase 20: the standard scene's grid by both routes; the tables must
    be equal (the origin, rounded once from f64 natively and computed in
    f32 by NumPy, within 1 ulp). Returns (native s, NumPy s)."""
    from fpv4d_torch.ops import nn as NN
    s = prob.solver
    t0 = time.perf_counter()
    gn = NN.build_voxel_grid(prob.scene, h=s.grid_h,
                             slots_per_cell=s.grid_slots)
    t_native = time.perf_counter() - t0
    t0 = time.perf_counter()
    gp = NN.build_voxel_grid(prob.scene, h=s.grid_h,
                             slots_per_cell=s.grid_slots, use_native=False)
    t_numpy = time.perf_counter() - t0
    same = (gn.dims == gp.dims and gn.h == gp.h
            and torch.equal(gn.cand_idx, gp.cand_idx)
            and torch.equal(gn.cand_pts, gp.cand_pts))
    ulps = np.abs(gn.origin.numpy().view(np.int32).astype(np.int64)
                  - gp.origin.numpy().view(np.int32))
    print(f"[grid] standard scene ({len(prob.scene)} points, h={s.grid_h}, "
          f"{s.grid_slots} slots, {int(np.prod(gn.dims))} cells): native "
          f"{t_native:.4f} s, NumPy {t_numpy:.4f} s; tables equal={same}, "
          f"origin {int(ulps.max())} ulp apart", flush=True)
    if not same or ulps.max() > 1:
        raise AssertionError("the native grid differs from the NumPy grid")
    return t_native, t_numpy


_FRAMES_MESH = {"clips": 1, "frames": 2}
# the depth of the frames axis's global/brute and dct/grid runs: 40
# global_a + 10 global_b steps; 30 dct_a + 30 dct_b steps
_FRAMES_DEPTH = {"global": dict(num_iter=50),
                 "dct": dict(num_iter_dct=60, dct_split=0.5)}


def _frames_config(cfg, mode):
    """The standard config at mode's frames-run depth."""
    return replace(cfg, **_FRAMES_DEPTH.get(mode, {}))


def _frames_problem(dev, mode):
    """The standard problem for mode's frames run, at that run's depth
    (brute force for global, the grid otherwise)."""
    from fpv4d_torch.utils.bench_problem import standard_problem
    prob = standard_problem(device=dev, nn_impl="brute" if mode == "global"
                            else "grid")
    prob.solver.config = _frames_config(prob.solver.config, mode)
    return prob


def _frames_rank(rank, init_file, out_dir, clip_dirs, device):
    """Phases 21-22 on one of the two gloo ranks sharing the card: each
    mode's fenced fit of the standard clip on the frames mesh, its
    launches and native grid builds, then multiopt on the same mesh.
    Writes out_dir/rank<r>.pkl."""
    from fpv4d_torch.cli.multiopt import main as multiopt
    from fpv4d_torch.io import native
    from fpv4d_torch.ops import cand_cuda as C
    from fpv4d_torch.ops import chamfer_cuda as K
    from fpv4d_torch.parallel import sharding as SH
    from fpv4d_torch.parallel.multi_clip import MultiClipSolver, pad_scenes
    dev = torch.device(device)
    SH.maybe_initialize_distributed(init_method=f"file://{init_file}",
                                    world_size=2, rank=rank, device=dev,
                                    backend="gloo")
    mesh = SH.make_mesh(_FRAMES_MESH)
    out = {}
    for mode in ("local", "global", "dct"):
        prob = _frames_problem(dev, mode)
        if prob.solver.device != dev:
            raise AssertionError(f"frames rank {rank} left the card")
        mc = MultiClipSolver(solver=prob.solver, mesh=mesh)
        native.builds = 0
        _reset_counts(C, K)
        tm = {}
        t0 = time.perf_counter()
        state_b, hist = mc.fit(prob.body[None], prob.cam[None],
                               pad_scenes([prob.scene]), mode=mode,
                               timings=tm)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        out[mode] = dict(
            seconds=time.perf_counter() - t0, hist=hist, timings=tm,
            launches=(C.launches, K.launches), native_builds=native.builds,
            spread=dict(mc.whole_leaf_spread),
            finite=all(bool(torch.isfinite(x).all()) for x in state_b),
            shapes=[tuple(x.shape) for x in state_b])
        del prob, mc, state_b
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    rc = multiopt(clip_dirs + [
        "--out", os.path.join(out_dir, "multiopt"), "--mode", "global",
        "--iters", "10", "--scene-name", "scene.ply", "--model", "NONE",
        "--vposer", "NONE", "--mesh", "clips=1,frames=2", "--device",
        device])
    out["multiopt"] = dict(rc=rc, seconds=time.perf_counter() - t0)
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    torch.distributed.destroy_process_group()


def _shard_kernels(C, K, prob, dev, L):
    """K1 and K2 at a frames rank's shapes: the standard problem's first
    L frames (their compacted candidate tables; their contact vertices
    against the whole scene), bit-exact against the plain versions, with
    kernel, plain, library and bound times."""
    from fpv4d_torch.ops import nn as NN
    from fpv4d_torch.solve.clip_solve import forward_world
    solver = prob.solver
    whole, _, _ = solver.init_state(prob.body, prob.cam)
    state = whole._replace(body_6d=whole.body_6d[:L],
                           camera_ext=whole.camera_ext[:L])
    kw = dict(vertex_subset=solver.contact_vids, prune=solver._contact_prune,
              with_joints=False)
    with torch.no_grad():
        q, _, _ = forward_world(solver.ctx, state, **kw)
        q_whole = forward_world(solver.ctx, whole, **kw)[0][:L]
        fc = NN.compact_candidates(q, NN.frame_candidates(
            solver.grid, q, solver.config.contact_cell_budget),
            solver.config.contact_compact)
    # the same frames through the model chain in a call of L frames and in
    # one of all T: the card's GEMMs round by the call's shape
    print(f"[frames] contact vertices of frames 0..{L - 1} from a {L}-frame "
          f"call and from the {len(prob.body)}-frame call: bit-identical="
          f"{torch.equal(q, q_whole)}, max abs difference "
          f"{float((q - q_whole).abs().max()):.3e}", flush=True)
    del q_whole
    q = q.contiguous()
    k1_err = _check_k1(C, q, fc.cand, fc.valid, f"frames shard [{L}, N, P]")
    T, N, P = q.shape[0], q.shape[1], fc.cand.shape[1]
    ms = _median_ms(lambda: C.cand_nn_cuda(q, fc.cand, fc.valid))
    plain_ms = _median_ms(lambda: C.cand_nn_plain(q, fc.cand, fc.valid))
    lib_ms = _median_ms(lambda: torch.cdist(q, fc.cand).min(-1))
    bound_ms, bound_by = _k1_bound_ms(T, N, P)
    print(f"[K1] frames shard [{T}, {N}, {P}]: kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, cdist+min {lib_ms:.4f} ms, bound "
          f"{bound_ms:.4f} ms ({bound_by}), {bound_ms / ms:.1%} of the "
          "bound", flush=True)
    k1 = (k1_err, ms, plain_ms, lib_ms, bound_ms, bound_by)
    scene = solver.scene
    k2_err = _check_k2(K, q, scene, f"frames shard [{L}, N] x scene")
    Q, M = q.numel() // 3, scene.shape[0]
    ms = _median_ms(lambda: K.nn_distance_cuda(q, scene), reps=10)
    plain_ms = _median_ms(lambda: K.nn_distance_plain(q, scene), reps=3,
                          warmup=1)
    qf = q.reshape(-1, 3)

    def cdist_min():
        for s in range(0, Q, 8192):
            torch.cdist(qf[s:s + 8192], scene).min(-1)

    lib_ms = _median_ms(cdist_min, reps=3, warmup=1)
    bound_ms, bound_by = _k2_bound_ms(Q, M)
    print(f"[K2] frames shard Q={Q} M={M}: kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, cdist+min {lib_ms:.4f} ms, bound "
          f"{bound_ms:.4f} ms ({bound_by}), {bound_ms / ms:.1%} of the "
          "bound", flush=True)
    del q, fc, qf
    torch.cuda.empty_cache()
    return k1, (k2_err, ms, plain_ms, lib_ms, bound_ms, bound_by)


def _hold_pkls(got, want, label):
    """multiopt pkls against another run's, at the CLI tests' tolerances:
    scale 1e-5, camera_ext 1e-6, body parameters 99% within 1e-4 and all
    within 2 lr (the L1 terms at exact zeros)."""
    body_err, worst = [], {}
    for fa, fb in zip(got, want):
        if len(fa) != len(fb):
            raise AssertionError(f"{label}: {len(fa)} pkls vs {len(fb)}")
        for a, b in zip(fa, fb):
            for k in a:
                d = np.abs(np.asarray(a[k], np.float64)
                           - np.asarray(b[k], np.float64))
                worst[k] = max(worst.get(k, 0.0), float(d.max()))
                if k not in ("scale", "camera_ext"):
                    body_err.append(d.ravel())
    err = np.concatenate(body_err)
    print(f"[{label}] max abs difference per key "
          f"{ {k: float(f'{v:.3e}') for k, v in worst.items()} }; body "
          f"within 1e-4: {np.mean(err <= 1e-4):.4f}", flush=True)
    if not (worst["scale"] <= 1e-5 and worst["camera_ext"] <= 1e-6
            and np.mean(err <= 1e-4) >= 0.99 and err.max() <= 2 * 0.005):
        raise AssertionError(f"{label}: pkls outside the tolerance")


def _frames_phase(C, K, prob, dev, local_hist, local_seconds, tmp,
                  clip_dirs, multiopt_alone):
    """Phases 21-22: two gloo ranks on the card (spawned; a rank that
    fails fails the phase) run the frames mesh; their results are held
    to phase 5's solve, to one-rank folds at the same depth and to phase
    19's multiopt pkls. Returns (K1 launches per rank in local_a, K2
    launches per rank in global_a, the kernels at a rank's shapes)."""
    import torch.multiprocessing as mp
    from fpv4d_torch.io import body_pkl
    from fpv4d_torch.parallel.multi_clip import MultiClipSolver, pad_scenes
    out_dir = tmp / "frames"
    out_dir.mkdir()
    T = prob.body.shape[0]
    L = T // _FRAMES_MESH["frames"]
    t0 = time.perf_counter()
    mp.spawn(_frames_rank, args=(str(out_dir / "pg"), str(out_dir),
                                 clip_dirs, str(dev)), nprocs=2, join=True)
    print(f"[frames] 2 gloo ranks on one card, {T} frames as 2 x {L}: "
          f"spawned and joined in {time.perf_counter() - t0:.2f} s",
          flush=True)
    ranks = []
    for r in range(2):
        with open(out_dir / f"rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))

    def depth(mode):
        cfg = _frames_config(prob.solver.config, mode)
        n_a = int(cfg.num_iter * cfg.stage_split)
        n = cfg.num_iter_dct
        return {"local": (n_a, 0), "global": (0, n_a),
                "dct": (n - int(n * cfg.dct_split), 0)}[mode]

    for r, res in enumerate(ranks):
        for mode in ("local", "global", "dct"):
            m = res[mode]
            stages = {k: round(v, 3) for k, v in m["timings"].items()
                      if k != "_fences"}
            print(f"[frames/{mode}] rank {r}: {m['seconds']:.3f} s, stages "
                  f"(s) {stages}; K1 launches {m['launches'][0]}, K2 "
                  f"launches {m['launches'][1]} (expected {depth(mode)}); "
                  f"native grid builds {m['native_builds']}; whole-leaf "
                  f"spread per phase {m['spread']}", flush=True)
            if tuple(m["launches"]) != depth(mode):
                raise AssertionError(f"frames/{mode} rank {r}: launches")
            if m["native_builds"] != (0 if mode == "global" else 1):
                raise AssertionError(f"frames/{mode} rank {r}: the grid did "
                                     "not take the native route")
            if any(v != 0.0 for v in m["spread"].values()):
                raise AssertionError(f"frames/{mode} rank {r}: the whole "
                                     "leaves' copies parted")
            if not m["finite"] or m["shapes"][0] != (1, T, 78):
                raise AssertionError(f"frames/{mode} rank {r}: the final "
                                     "state is not whole and finite")
            # the full schedule's phases end below where they began; the
            # shallow runs are held to the one-rank fold below
            for k, v in m["hist"].items():
                if not (np.all(np.isfinite(v)) and (
                        mode != "local" or np.all(v[-1] < v[0]))):
                    raise AssertionError(f"frames/{mode} rank {r} {k}: "
                                         "losses not finite and decreasing")
    print(f"[frames/local] one-rank solve (phase 5) stages (s) "
          f"{ {k: round(v, 3) for k, v in local_seconds.items()} }",
          flush=True)
    for r, res in enumerate(ranks):
        _hold_histories({k: v[:, 0] for k, v in res["local"]["hist"].items()},
                        local_hist, f"frames/local rank {r}",
                        "2 frames ranks vs single solve",
                        watch=("local_skate",))

    # the one-rank fold at the same depth
    for mode in ("global", "dct"):
        p1 = _frames_problem(dev, mode)
        _reset_counts(C, K)
        tm = {}
        t0 = time.perf_counter()
        _, h1 = MultiClipSolver(solver=p1.solver).fit(
            p1.body[None], p1.cam[None], pad_scenes([p1.scene]), mode=mode,
            timings=tm)
        torch.cuda.synchronize()
        if (C.launches, K.launches) != depth(mode):
            raise AssertionError(f"one-rank {mode}: launches")
        print(f"[frames/{mode}] one-rank fold: {time.perf_counter() - t0:.3f}"
              f" s, stages (s) "
              f"{ {k: round(v, 3) for k, v in tm.items() if k != '_fences'} }",
              flush=True)
        for r, res in enumerate(ranks):
            _hold_histories(res[mode]["hist"], h1, f"frames/{mode} rank {r}",
                            "2 frames ranks vs one rank")
        del p1
        torch.cuda.empty_cache()

    # 22. multiopt on the frames mesh against phase 19's one-process run
    for r, res in enumerate(ranks):
        print(f"[multiopt] --mesh clips=1,frames=2 rank {r}: exit "
              f"{res['multiopt']['rc']} in {res['multiopt']['seconds']:.2f} s",
              flush=True)
        if res["multiopt"]["rc"] != 0:
            raise AssertionError(f"multiopt on the frames mesh: rank {r} "
                                 f"exited {res['multiopt']['rc']}")
    got = [[body_pkl.load_frame(str(p)) for p in sorted(
        (out_dir / "multiopt" / Path(d).name).glob("*.pkl"))]
        for d in clip_dirs]
    _hold_pkls(got, multiopt_alone, "multiopt frames=2 vs one process")

    return depth("local")[0], depth("global")[1], _shard_kernels(
        C, K, prob, dev, L)


# -- the pipeline's two ends: rendering, the viewer, vis and prep ------------

def _frame_shares(png_bytes, want: torch.Tensor):
    """(share of pixels exact, share within 1 level) of a PNG written on
    the card against a float image [H, W, 3] of the CPU route,
    quantised as the PNG writer quantises."""
    from fpv4d_torch.vis.png import decode_png
    got = decode_png(png_bytes).astype(np.int64)
    ref = (torch.clamp(want, 0, 1) * 255).to(torch.uint8).numpy()
    d = np.abs(got - ref.astype(np.int64)).max(-1)
    return float(np.mean(d == 0)), float(np.mean(d <= 1))


def _render_phase(prob, dev, solved, tmp: Path):
    """Phase 23: the world and ego renders at full width on the card;
    returns the clip directory for phase 24."""
    from fpv4d_torch.io import body_pkl
    from fpv4d_torch.models import smplx
    from fpv4d_torch.vis import ego_overlay as E
    from fpv4d_torch.vis import world_view as W
    from fpv4d_torch.vis.png import decode_png
    body, scale, cam = solved
    # phase 5's solved clip, its camera moved 2.5 m from the body along
    # z (the reference's ego test puts it there): both views hold the
    # body, which sits on the camera at the solve's translation
    body = body.copy()
    body[:, 74] += 2.5
    clip = tmp / "render_clip"
    smoothed = clip / "smoothed_body"
    body_pkl.save_clip(str(smoothed), body, scale=scale, camera_ext=cam,
                       prefix="")
    params = [body_pkl.load_frame(str(p))
              for p in sorted(smoothed.glob("*.pkl"))]
    cpu_model = smplx.synthetic_model(num_verts=prob.model.num_verts,
                                      seed=0, sparse_weights=True)
    cpu_vp = {k: v.cpu() for k, v in prob.vp.items()}
    scene = prob.scene
    print(f"[render] clip of {len(params)} frames (scale {scale:.6f}); "
          f"model V={prob.model.num_verts}, {len(prob.model.faces)} faces; "
          f"scene {len(scene)} points; 1280x720", flush=True)

    def world(name, n, **kw):
        out = tmp / f"world_{name}"
        return (f"world {name}", n, out, "img_{:03d}.png",
                lambda st: W.render_dir(str(smoothed), prob.model, prob.vp,
                                        scene, str(out), limit=n,
                                        stats=st, **kw))

    def ego(source, n):
        out = clip / f"{source}_vis"
        return (f"ego {source}", n, out, "{:04d}.png",
                lambda st: E.render_dir(str(smoothed), prob.model, prob.vp,
                                        source=source, limit=n, stats=st))

    def cpu_frame(kind, i, n):
        p = params[i]
        if kind.startswith("ego"):
            local = kind == "ego local"
            return E.render_frame(cpu_model, cpu_vp, p, apply_scale=local,
                                  draw_joints=local)
        cams = torch.as_tensor(np.stack([q["camera_ext"]
                                         for q in params[:n]]))
        if kind == "world orbit":
            centers = torch.stack([W.body_to_world(q)[:3, 3]
                                   for q in params[:n]])
            center = centers.mean(0)
            radius = float(max(2.5, 1.8 * float(torch.linalg.vector_norm(
                centers - center, dim=1).max())))
            view = W.orbit_view(center, radius, 2.0 * np.pi * i / n)
        else:
            view = cams[i] if kind == "world follow" else cams[0]
        return W.render_frame(cpu_model, cpu_vp, p, scene, view,
                              cams[:i + 1, :3, 3])

    rows = []
    for kind, n, out, fmt, run in (world("fixed", 64),
                                   world("follow", 16, follow=True),
                                   world("orbit", 16, orbit=True),
                                   ego("smoothed", 32), ego("local", 32)):
        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        stats = {}
        t0 = time.perf_counter()
        got = run(stats)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - resident
        names = sorted(q.name for q in out.iterdir())
        if got != n or names != [fmt.format(i) for i in range(n)]:
            raise AssertionError(f"{kind}: {got} frames, files {names[:3]}")
        masks = stats["mask_pixels"]
        if len(masks) != n or min(masks) <= 0:
            raise AssertionError(f"{kind}: an empty body mask: {masks}")
        dark = []
        for i, name in enumerate(names):
            img = decode_png((out / name).read_bytes())
            if img.shape != (720, 1280, 3):
                raise AssertionError(f"{kind} {name}: shape {img.shape}")
            share = float((img.sum(-1) > 0).mean())
            if not share > 0.005:
                dark.append((name, share))
        if dark:
            raise AssertionError(f"{kind}: black frames {dark}")
        parts = {k: stats.get(k, 0.0) * 1e3 / n
                 for k in ("forward", "points", "mesh", "encode")}
        held = []
        for i in (0, n - 1):
            t1 = time.perf_counter()
            want = cpu_frame(kind, i, n)
            exact, within1 = _frame_shares((out / fmt.format(i)).read_bytes(),
                                           want)
            held.append((i, exact, within1, time.perf_counter() - t1))
            if not (exact >= 0.99 and within1 >= 0.99):
                raise AssertionError(f"{kind} frame {i}: card against the "
                                     f"CPU route exact {exact:.5f}, within "
                                     f"1 level {within1:.5f}")
        rows.append((kind, n, wall, parts, peak, masks))
        print(f"[render] {kind}: {n} frames in {wall:.3f} s, "
              f"{n / wall:.2f} frames/s; ms per frame: forward "
              f"{parts['forward']:.3f}, points {parts['points']:.3f}, "
              f"mesh {parts['mesh']:.3f}, encode {parts['encode']:.3f}; "
              f"peak {peak / 2**30:.3f} GiB above {resident / 2**30:.3f} "
              f"GiB resident; body mask {min(masks)}..{max(masks)} px",
              flush=True)
        for i, exact, within1, secs in held:
            print(f"[render] {kind} frame {i} against the CPU route: exact "
                  f"{exact:.5f}, within 1 level {within1:.5f} (CPU "
                  f"{secs:.2f} s)", flush=True)
    frames = sum(r[1] for r in rows)
    wall = sum(r[2] for r in rows)
    print(f"[render] all: {frames} frames in {wall:.3f} s, "
          f"{frames / wall:.2f} frames/s", flush=True)
    return clip


def _interactive_phase(prob, clip: Path):
    """Phase 24: the viewer's HTTP server in a thread on an ephemeral
    port: /meta, /frame in each mode, a memo hit, a 404."""
    import threading
    import urllib.error
    import urllib.request
    from fpv4d_torch.vis.interactive import InteractiveViewer, make_server
    from fpv4d_torch.vis.png import decode_png
    viewer = InteractiveViewer(str(clip / "smoothed_body"), prob.model,
                               prob.vp, prob.scene)
    srv = make_server(viewer, port=0)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"

    def get(path):
        t0 = time.perf_counter()
        with urllib.request.urlopen(base + path, timeout=120) as r:
            body = r.read()
            return r.status, body, time.perf_counter() - t0

    try:
        code, body, _ = get("/meta")
        if code != 200 or json.loads(body) != {"num_frames": len(
                viewer.params)}:
            raise AssertionError(f"/meta: {code} {body!r}")
        for mode, i in (("fixed", 10), ("follow", 300), ("orbit", 700)):
            q = f"/frame?i={i}&mode={mode}&azim=0.8&elev=0.35&zoom=1.0"
            code, png, secs = get(q)
            img = decode_png(png)
            if code != 200 or img.shape != (720, 1280, 3) or not (
                    (img.sum(-1) > 0).mean() > 0.005):
                raise AssertionError(f"/frame {mode}: {code} {img.shape}")
            cached = len(viewer._cache)
            code2, png2, secs2 = get(q)
            if code2 != 200 or png2 != png or len(viewer._cache) != cached:
                raise AssertionError(f"/frame {mode}: no memo hit")
            print(f"[interactive] {mode} frame {i}: {len(png)} bytes in "
                  f"{secs * 1e3:.1f} ms, memo hit {secs2 * 1e3:.1f} ms",
                  flush=True)
        try:
            get("/nope")
            raise AssertionError("an unknown path did not give 404")
        except urllib.error.HTTPError as e:
            if e.code != 404:
                raise AssertionError(f"unknown path: {e.code}") from e
        print(f"[interactive] /meta {len(viewer.params)} frames; 404 on an "
              "unknown path", flush=True)
    finally:
        srv.shutdown()
        srv.server_close()
        th.join(timeout=60)


def _prep_fixtures(root: Path):
    """Seeded prep inputs and the outputs the script expects of them:
    {subcommand: (argv, check(stdout) -> None)}."""
    from fpv4d_torch.vis.png import decode_png
    rng = np.random.RandomState(11)
    images = root / "images"
    images.mkdir(parents=True)
    for i in range(100):
        (images / f"{i:06d}.jpg").write_bytes(rng.bytes(32))
    kp = root / "kp"
    kp.mkdir()
    people = []
    for _ in range(2):
        pose = np.stack([rng.uniform(200, 1000, 25), rng.uniform(100, 600, 25),
                         rng.uniform(0, 1, 25)], 1)
        people.append({"pose_keypoints_2d": pose.ravel().tolist()})
    for name in ("b_keypoints.json", "a_keypoints.json"):
        (kp / name).write_text(json.dumps({"people": people}))
    lines = ["# header"] * 4
    poses = {}
    for i, name in enumerate(["000002.jpg", "000000.jpg", "000001.jpg"]):
        vals = [repr(float(v)) for v in rng.randn(7)]
        poses[name] = vals
        lines += [" ".join([str(i + 1)] + vals + ["1", name]),
                  "1.5 2.5 -1"]
    (root / "images.txt").write_text("\n".join(lines) + "\n")
    pts = rng.randn(20, 3)
    (root / "points3D.txt").write_text("# points\n" + "".join(
        f"{i} {x} {y} {z} 1 2 3 0.1 4 5\n" for i, (x, y, z) in enumerate(pts)))
    res = root / "sx" / "results"
    for i in range(3):
        (res / f"{i:03d}").mkdir(parents=True)
        (res / f"{i:03d}" / "000.pkl").write_bytes(rng.bytes(40))
    names = sorted(p.name for p in images.iterdir())
    out = root / "out"
    out.mkdir()

    def same_bytes(pairs):
        for got, want in pairs:
            if got.read_bytes() != want.read_bytes():
                raise AssertionError(f"{got} differs from {want}")

    def split(_):
        same_bytes((out / "split" / f"c-{c}" / "images" / f"{j:06d}.jpg",
                    images / names[33 * c + j])
                   for c in range(3) for j in range(33))

    def opcmd(stdout):
        want = ("op.bin --video v.mp4 --write_json js --face --hand "
                "--write_video o.avi")
        if stdout.strip() != want:
            raise AssertionError(f"openpose-cmd printed {stdout!r}")

    def rename(_):
        same_bytes([(out / "rename" / "000000_keypoints.json",
                     kp / "a_keypoints.json"),
                    (out / "rename" / "000001_keypoints.json",
                     kp / "b_keypoints.json")])

    def filt(_):
        best = max(people, key=lambda p: sum(p["pose_keypoints_2d"][2::3]))
        for name in ("a_keypoints.json", "b_keypoints.json"):
            got = json.loads((out / "filter" / name).read_text())
            if got["people"] != [best]:
                raise AssertionError(f"filter kept {got['people']}")

    def masks(_):
        pose = np.asarray(people[0]["pose_keypoints_2d"],
                          np.float32).reshape(25, 3)
        pts2 = pose[pose[:, 2] > 0, :2]
        x0, y0 = pts2.min(0)
        x1, y1 = pts2.max(0)
        want = np.full((720, 1280), 255, np.uint8)
        want[max(0, int(y0 * 0.8)):min(720, int(y1 * 1.2)),
             max(0, int(x0 * 0.95)):min(1280, int(x1 * 1.05))] = 0
        for name in ("a_keypoints.png", "b_keypoints.png"):
            got = decode_png((out / "masks" / name).read_bytes())
            if not np.array_equal(got, want):
                raise AssertionError(f"mask {name} differs")

    def pairs(_):
        want = "".join(f"{names[i]} {names[i + o]}\n" for i in range(100)
                       for o in (60, 61, 70, 71, 80, 81, 90, 91)
                       if i + o < 100)
        if (out / "pairs.txt").read_text() != want:
            raise AssertionError("pairs.txt differs")

    def campose(_):
        want = "".join(f"{n} {' '.join(poses[n])}\n" for n in sorted(poses))
        if (out / "camerapose.txt").read_text() != want:
            raise AssertionError("camerapose.txt differs")

    def cloud(_):
        p32 = pts.astype(np.float32)
        want = "".join(f"{p[0]} {p[1]} {p[2]}\n" for p in p32)
        if (out / "cloud.xyz").read_text() != want:
            raise AssertionError("cloud.xyz differs")

    def flatten(_):
        same_bytes((out / "flat" / f"body_gen_{i:06d}.pkl",
                    res / f"{i:03d}" / "000.pkl") for i in range(3))

    return {
        "split": ([str(images), "--out", str(out / "split"), "--name", "c",
                   "--clip-len", "33"], split),
        "openpose-cmd": (["v.mp4", "--binary", "op.bin", "--json-out", "js",
                          "--video-out", "o.avi"], opcmd),
        "rename": ([str(kp), "--out", str(out / "rename")], rename),
        "filter": ([str(kp), "--out", str(out / "filter")], filt),
        "masks": ([str(kp), "--out", str(out / "masks")], masks),
        "pairs": ([str(images), "--out", str(out / "pairs.txt")], pairs),
        "campose": ([str(root / "images.txt"), "--out",
                     str(out / "camerapose.txt")], campose),
        "cloud": ([str(root / "points3D.txt"), "--out",
                   str(out / "cloud.xyz")], cloud),
        "flatten": ([str(root / "sx"), "--out", str(out / "flat")], flatten),
    }


def _pipeline_ends(tmp: Path):
    """Phase 25: after phase 13's fit -> smooth -> globalopt, vis world
    and vis ego --source local on its output, then the prep subcommands
    on seeded fixtures, each a subprocess (vis on the card by default);
    vis pack and prep dump / pack / recode exit 1 naming ffmpeg or cv2
    where the tool is missing, else 0 with their file written. Runs that
    do not read each other's output run at the same time."""
    import importlib.util
    import shutil
    from concurrent.futures import ThreadPoolExecutor
    from fpv4d_torch.vis.png import decode_png
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT)] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    T = len(list((tmp / "fit_out").glob("*.pkl")))
    has_cv2 = importlib.util.find_spec("cv2") is not None
    has_ffmpeg = shutil.which("ffmpeg") is not None

    def run(cli, args, want_rc=0, names_tool=None):
        t0 = time.perf_counter()
        res = subprocess.run([sys.executable, "-m", f"fpv4d_torch.cli.{cli}"]
                             + args, cwd=ROOT, env=env, capture_output=True,
                             text=True, timeout=600)
        if res.returncode != want_rc or (
                names_tool and names_tool not in res.stderr):
            for line in (res.stdout + res.stderr).splitlines()[-8:]:
                print(f"[ends] {cli} {args[0]} | {line}")
            raise AssertionError(f"{cli} {args[0]} exited {res.returncode}, "
                                 f"expected {want_rc}"
                                 + (f" naming {names_tool}" if names_tool
                                    else ""))
        return res, time.perf_counter() - t0

    def run_all(jobs):
        """[(cli, args, want_rc, tool)] at once -> [(stdout, secs)]."""
        with ThreadPoolExecutor(max_workers=len(jobs)) as pool:
            futs = [pool.submit(run, *job) for job in jobs]
            return [(f.result()[0].stdout, f.result()[1]) for f in futs]

    prep = tmp / "prep"
    checks = _prep_fixtures(prep)
    video = prep / "clip.mp4"
    if has_ffmpeg:
        subprocess.run(["ffmpeg", "-y", "-f", "lavfi", "-i",
                        "testsrc=duration=1:size=320x240:rate=10",
                        str(video)], capture_output=True, check=True,
                       timeout=120)
    tool_rc, tool = (0, None) if has_ffmpeg else (1, "ffmpeg")
    assets = ["--model", "NONE", "--vposer", "NONE"]
    jobs = [("vis", ["world", str(tmp / "fit_out"), "--scene",
                     str(tmp / "scene.ply"), "--out", str(tmp / "render0")]
             + assets, 0, None),
            ("vis", ["ego", str(tmp / "fit_out"), "--source", "local"]
             + assets, 0, None),
            ("prep", ["dump", str(video), "--out", str(prep / "dump"),
                      "--width", "320", "--height", "240"], tool_rc, tool),
            ("prep", ["recode", str(video), "--out", str(prep / "r.mp4"),
                      "--fps", "5"], tool_rc, tool)]
    jobs += [("prep", [cmd] + args, 0, None)
             for cmd, (args, _) in checks.items()]
    t0 = time.perf_counter()
    results = run_all(jobs)
    wall = time.perf_counter() - t0

    world = sorted((tmp / "render0").glob("*.png"))
    ego = sorted((tmp / "local_vis").glob("*.png"))
    if [p.name for p in world] != [f"img_{i:03d}.png" for i in range(T)] \
            or [p.name for p in ego] != [f"{i:04d}.png" for i in range(T)]:
        raise AssertionError(f"vis wrote {len(world)} world and {len(ego)} "
                             f"ego PNGs, expected {T} each")
    for p in world + ego:
        if decode_png(p.read_bytes()).shape != (720, 1280, 3):
            raise AssertionError(f"{p.name}: not a 1280x720 RGB PNG")
    print(f"[ends] vis world exit 0 in {results[0][1]:.2f} s ({T} PNGs); "
          f"vis ego --source local exit 0 in {results[1][1]:.2f} s ({T} "
          "PNGs)", flush=True)
    for (cmd, (_, check)), (stdout, _) in zip(checks.items(), results[4:]):
        check(stdout)
    print(f"[ends] prep {', '.join(checks)}: exit 0, outputs as computed "
          f"here; {len(jobs)} subprocesses at once in {wall:.2f} s",
          flush=True)
    if has_ffmpeg:
        if not (list((prep / "dump" / "clip" / "images").glob("*.jpg"))
                and (prep / "r.mp4").is_file()):
            raise AssertionError("prep dump / recode wrote nothing")
        print("[ends] prep dump, recode: ffmpeg present, exit 0, frames "
              "and video written", flush=True)
    else:
        print("[ends] prep dump, recode: ffmpeg absent, exit 1 naming "
              "ffmpeg (asserted)", flush=True)

    outs = [tmp / "render0.avi", tmp / "pack.avi"]
    run_all([(cli, ["pack", str(tmp / "render0"), "--out", str(out)],
              0 if has_cv2 else 1, None if has_cv2 else "cv2")
             for cli, out in zip(("vis", "prep"), outs)])
    for cli, out in zip(("vis", "prep"), outs):
        if has_cv2 and not out.is_file():
            raise AssertionError(f"{cli} pack wrote no {out.name}")
        print(f"[ends] {cli} pack: " + (
            f"cv2 present, exit 0, {out.name} written" if has_cv2 else
            "cv2 absent, exit 1 naming cv2 (asserted)"), flush=True)


# -- the rest of the library and the ground-truth report -----------------------

def _grad_err(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a - b| over the largest |b| (tests/test_fk_vjp.py's rule)."""
    return float((a - b).abs().max() / (b.abs().max() + 1e-6))


def _fk_phase(prob, dev, state, C, K, n_a):
    """Phase 26: the hand-written FK adjoint against autograd on the
    standard model's 55-joint tree at B = 900, then both in the local_a
    model block (forward_world on the contact subset, fwd + bwd), then
    the whole local solve on each, in turns (autograd, adjoint, adjoint,
    autograd)."""
    from fpv4d_torch.core.rotations import aa_to_matrot
    from fpv4d_torch.models import fk
    from fpv4d_torch.models.smplx import PARENTS
    from fpv4d_torch.solve.clip_solve import forward_world
    B, J = prob.body.shape[0], len(PARENTS)
    rng = np.random.RandomState(26)
    rot = aa_to_matrot(torch.as_tensor(
        rng.randn(B, J, 3).astype(np.float32) * 0.3, device=dev))
    model = prob.model
    rest = (model.j_regressor @ model.v_template)[None].expand(B, J, 3)
    joints = (rest + torch.as_tensor(rng.randn(B, J, 3).astype(np.float32)
                                     * 0.01, device=dev)).contiguous()
    cp = torch.as_tensor(rng.randn(B, J, 3).astype(np.float32), device=dev)
    cr = torch.as_tensor(rng.randn(B, J, 4, 4).astype(np.float32),
                         device=dev)
    p_new, r_new = fk.rigid_transform(rot, joints, PARENTS)
    p_ref, r_ref = fk._fwd_impl(rot, joints, PARENTS)
    if not (torch.equal(p_new, p_ref) and torch.equal(r_new, r_ref)):
        raise AssertionError("FK adjoint: forward differs from _fwd_impl")

    def fwd_bwd(fn):
        a = rot.detach().requires_grad_(True)
        b = joints.detach().requires_grad_(True)
        p, r = fn(a, b, PARENTS)
        return torch.autograd.grad((p * cp).sum() + (r * cr).sum(), (a, b))

    g_new, g_ref = fwd_bwd(fk.rigid_transform), fwd_bwd(fk.rigid_transform_ref)
    errs = [_grad_err(x, y) for x, y in zip(g_new, g_ref)]
    print(f"[fk] B={B} J={J}: forward bit-equal; gradient error over the "
          f"largest magnitude: rot {errs[0]:.3e}, joints {errs[1]:.3e} "
          f"(limit 2e-5)", flush=True)
    if max(errs) > 2e-5:
        raise AssertionError(f"FK adjoint gradients off by {max(errs)}")
    ms = {name: _median_ms(lambda f=f: fwd_bwd(f))
          for name, f in (("adjoint", fk.rigid_transform),
                          ("autograd", fk.rigid_transform_ref))}

    solver = prob.solver
    body = state.body_6d.detach()

    def block():
        b = body.clone().requires_grad_(True)
        verts_w, joints_w, _ = forward_world(
            solver.ctx, state._replace(body_6d=b),
            vertex_subset=solver.contact_vids, prune=solver._contact_prune)
        loss = verts_w.sum() * 1e-6 + joints_w.sum() * 1e-6
        return torch.autograd.grad(loss, b)[0]

    saved = fk.rigid_transform_prod
    try:
        grads = {}
        for name, f in (("adjoint", fk.rigid_transform),
                        ("autograd", fk.rigid_transform_ref)):
            fk.rigid_transform_prod = f
            grads[name] = block()
            ms[f"block_{name}"] = _median_ms(block)
    finally:
        fk.rigid_transform_prod = saved
    berr = _grad_err(grads["adjoint"], grads["autograd"])
    print(f"[fk] fwd+bwd ms (CUDA-event medians): 55-joint FK at B={B}: "
          f"adjoint {ms['adjoint']:.4f}, autograd {ms['autograd']:.4f}; "
          f"local_a model block (forward_world, {len(solver.contact_vids)} "
          f"contact vertices, T={B}): adjoint {ms['block_adjoint']:.4f}, "
          f"autograd {ms['block_autograd']:.4f}; block gradient error "
          f"{berr:.3e}", flush=True)
    if berr > 2e-5:
        raise AssertionError(f"FK adjoint in the model block off by {berr}")

    fits = {"adjoint": [], "autograd": []}
    try:
        for name in ("autograd", "adjoint", "adjoint", "autograd"):
            fk.rigid_transform_prod = (fk.rigid_transform
                                       if name == "adjoint"
                                       else fk.rigid_transform_ref)
            _, _, fit_s, hist, _ = _run_fit(solver, prob, "local", C, K,
                                            (n_a, 0), f"local/FK {name}")
            fits[name].append((fit_s, dict(solver.phase_seconds), hist))
    finally:
        fk.rigid_transform_prod = saved
    _hold_histories(fits["adjoint"][0][2], fits["autograd"][0][2],
                    "local/FK adjoint", what="adjoint vs autograd",
                    watch=("local_skate",))
    for name, runs in fits.items():
        secs = {k: [round(r[1][k], 3) for r in runs]
                for k in ("local_a", "local_b", "local_skate")}
        print(f"[fk] local solve on {name} (two runs): fit "
              f"{[round(r[0], 3) for r in runs]} s, per phase {secs}",
              flush=True)
    return ms


def _contact_queries(solver, state):
    from fpv4d_torch.solve.clip_solve import forward_world
    with torch.no_grad():
        q, _, _ = forward_world(solver.ctx, state,
                                vertex_subset=solver.contact_vids,
                                prune=solver._contact_prune,
                                with_joints=False)
    return q.contiguous()


def _library_phase(prob, dev, K, q, k2_ms, local_hist):
    """Phase 27: a CVAE Adam step on the card against the CPU, the
    chunked Gram-form oracle against K2 at the global solve's shape, and
    steps_until_converged of phase 5's histories."""
    from fpv4d_torch.models import cvae
    from fpv4d_torch.ops import chamfer_ref
    from fpv4d_torch.utils.monitor import steps_until_converged
    B = prob.body.shape[0]
    rng = np.random.RandomState(27)
    data = [rng.randn(B, n).astype(np.float32) for n in
            (cvae.N_DIM_BODY, cvae.N_DIM_SCENE, cvae.LATENT_D)]
    losses = {}
    for where, d in (("card", dev), ("cpu", torch.device("cpu"))):
        params = {k: v.requires_grad_(True)
                  for k, v in cvae.random_params(seed=0, device=d).items()}
        x, zs, eps = (torch.as_tensor(a, device=d) for a in data)
        opt = torch.optim.Adam(params.values(), lr=1e-3)

        def loss_fn():
            rec, mu, ls = cvae.forward(params, x, eps, zs)
            return ((rec - x) ** 2).mean() + cvae.kl_loss(mu, ls)

        before = loss_fn()
        opt.zero_grad()
        before.backward()
        opt.step()
        with torch.no_grad():
            losses[where] = (float(before), float(loss_fn()))
    print(f"[cvae] B={B} Adam step, loss before -> after: card "
          f"{losses['card']}, cpu {losses['cpu']}", flush=True)
    if not np.allclose(losses["card"], losses["cpu"], rtol=1e-5, atol=0):
        raise AssertionError("CVAE step on the card differs from the CPU")

    scene = prob.solver.scene
    d_c, i_c = chamfer_ref.nn_distance_chunked(q, scene)
    d_k, i_k = K.nn_distance_cuda(q, scene)
    # the Gram form |x|^2 + |y|^2 - 2 x.y rounds each of its three terms
    # and two sums in f32: within 8 u (|x| + R)^2 of the exact value,
    # u = 2^-24, R the scene's largest |y|
    R = float(scene.norm(dim=-1).max())
    bound = 8 * 2.0 ** -24 * (q.norm(dim=-1) + R) ** 2
    dist_err = (d_c - d_k).abs()
    diff = i_c != i_k
    qd = q[diff]
    exact_c = ((qd - scene[i_c[diff].long()]) ** 2).sum(-1)
    pick_err = (exact_c - d_k[diff]).abs()
    ok = bool((dist_err <= bound).all()) and bool(
        (pick_err <= 2 * bound[diff]).all())
    ms = _median_ms(lambda: chamfer_ref.nn_distance_chunked(q, scene),
                    reps=3, warmup=1)
    print(f"[chamfer_ref] nn_distance_chunked Q={q.numel() // 3} M="
          f"{scene.shape[0]} (8192 x 8192 chunks): {ms:.4f} ms, K2 "
          f"{k2_ms:.4f} ms (phase 4); max |d - d_K2| "
          f"{float(dist_err.max()):.3e} within the Gram bound (max "
          f"{float(bound.max()):.3e}); indices differ at {int(diff.sum())} "
          f"queries, each pick within twice the bound of K2's "
          f"(max {float(pick_err.max()) if len(pick_err) else 0.0:.3e})",
          flush=True)
    if not ok:
        raise AssertionError("the chunked oracle disagrees with K2")
    conv = {k: (steps_until_converged(v), len(v))
            for k, v in local_hist.items()}
    print(f"[monitor] phase 5 histories, steps_until_converged (ftol 2e-9) "
          f"of steps: {conv}", flush=True)
    return ms


def _native_io_phase(prob, q, K, tmp: Path):
    """Phase 28: the standard scene through a binary PLY and the native
    reader, the voxel downsample, and the KD-tree against K2."""
    from fpv4d_torch.io import native
    from fpv4d_torch.io.ply import write_ply
    path = tmp / "scene.ply"
    write_ply(str(path), prob.scene, binary=True)
    native.ply_declines = 0
    t0 = time.perf_counter()
    got = native.read_ply_vertices(str(path))
    t_read = time.perf_counter() - t0
    if native.ply_declines or not np.array_equal(got, prob.scene):
        raise AssertionError("the scene read back natively differs")
    t0 = time.perf_counter()
    ds = native.voxel_downsample(prob.scene, 0.05)
    t_ds = time.perf_counter() - t0
    t0 = time.perf_counter()
    tree = native.KdTree(prob.scene)
    t_build = time.perf_counter() - t0
    qn = q.reshape(-1, 3).cpu().numpy()
    t0 = time.perf_counter()
    d_t, i_t = tree.query(qn)
    t_query = time.perf_counter() - t0
    tree.close()
    d_k, i_k = (a.reshape(-1).cpu().numpy() for a in K.nn_distance_cuda(
        q, prob.solver.scene))
    ok = np.allclose(d_t, d_k, rtol=1e-6, atol=0)
    diff = i_t != i_k
    # a different index only where the two points tie
    d_pick = ((qn[diff] - prob.scene[i_t[diff]]) ** 2).sum(-1)
    ok = ok and np.allclose(d_pick, d_k[diff], rtol=1e-6, atol=0)
    print(f"[native io] scene PLY ({len(got)} points, binary) read "
          f"natively in {t_read:.4f} s, equal; voxel_downsample 0.05 m: "
          f"{len(ds)} points in {t_ds:.4f} s; KdTree build {t_build:.4f} s, "
          f"{len(qn)} queries {t_query:.4f} s; max rel |d - d_K2| "
          f"{float((np.abs(d_t - d_k) / np.maximum(d_k, 1e-30)).max()):.3e}"
          f", indices differ at {int(diff.sum())} (tied)", flush=True)
    if not ok:
        raise AssertionError("the KD-tree disagrees with K2")
    return t_build, t_query


def _observability_phase(prob, dev, C, tmp: Path):
    """Phase 29: torch.profiler around 5 local_a steps (the trace names
    K1's kernel), StageTimer with sync_on, checked on a NaN output."""
    from fpv4d_torch.utils import observability as obs
    s = prob.solver
    state, target, fw = s.init_state(prob.body, prob.cam)
    state, opt = s.make_optimizer(state)
    timer = obs.StageTimer(verbose=False)
    with timer.stage("refresh", sync_on=state.body_6d):
        cands = s._refresh_cands(state)
    s._run_phase(state, opt, target, fw, 1, "local_a", cands)   # warm-up
    with obs.trace(str(tmp / "trace")) as path:
        with timer.stage("local_a x5", sync_on=state.body_6d):
            s._run_phase(state, opt, target, fw, 5, "local_a", cands)
    size = os.path.getsize(path)
    with open(path) as f:
        text = f.read()
    n_k1 = text.count("cand_nn_kernel")
    print(f"[observability] trace {size} bytes, cand_nn_kernel named "
          f"{n_k1} times; StageTimer {timer.summary()}", flush=True)
    if n_k1 == 0:
        raise AssertionError("the trace does not name K1's kernel")
    if sorted(timer.records) != ["local_a x5", "refresh"] or min(
            timer.summary().values()) <= 0:
        raise AssertionError("StageTimer did not record both stages")
    x = -torch.ones(8, device=dev)
    try:
        obs.checked(torch.log, x)
    except FloatingPointError as e:
        print(f"[observability] checked raised on the card: {e}", flush=True)
    else:
        raise AssertionError("checked did not raise on a NaN output")
    obs.checked(torch.exp, x)


def _accuracy_phase(C, K):
    """Phase 30: the ground-truth recovery report at the paper's 300
    frames and the standard model's width, both keypoint optimizers;
    tests/test_accuracy.py's thresholds; K1 launched once per local_a
    step of its clip solve."""
    from fpv4d_torch.config import ClipConfig
    from fpv4d_torch.utils import accuracy_report
    _reset_counts(C, K)
    t0 = time.perf_counter()
    r = accuracy_report.run(frames=300, num_verts=10475, optimizer="both",
                            device="cuda")
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    got = (C.launches, K.launches)
    cfg = ClipConfig(num_iter=r["clip_iters"])
    want = (int(cfg.num_iter * cfg.stage_split), 0)
    print(f"[accuracy] T={r['frames']} V=10475 in {secs:.2f} s: "
          f"{json.dumps(r)}; "
          f"K1 launches {got[0]}, K2 launches {got[1]} (expected {want})",
          flush=True)
    checks = {
        "keypoint MPJPE < 60 mm": r["keypoint_fit_mpjpe_mm"] < 60,
        "reprojection < 4x pixel noise":
            r["keypoint_fit_reproj_px"] < 4 * r["obs_noise_px"],
        "L-BFGS keypoint MPJPE < 60 mm":
            r["keypoint_fit"]["lbfgs"]["mpjpe_mm"] < 60,
        "MPJPE after < before": r["clip_solve_mpjpe_mm_after"]
            < r["clip_solve_mpjpe_mm_before"],
        "jitter solved < 0.3x noisy": r["jitter_mm_solved"]
            < 0.3 * r["jitter_mm_noisy"]}
    failed = [k for k, v in checks.items() if not v]
    if failed or got != want:
        raise AssertionError(f"accuracy report: failed {failed}, launches "
                             f"{got} (expected {want})")
    return r, got[0]


def main() -> int:
    if not (ROOT / "fpv4d_torch" / "__init__.py").is_file():
        print(f"chip_smoke: the fpv4d_torch package is missing beside "
              f"{Path(__file__).name} (run it from the repository's root)")
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    from fpv4d_torch.io import native
    from fpv4d_torch.ops import cand_cuda as C
    from fpv4d_torch.ops import chamfer_cuda as K
    from fpv4d_torch.ops import cuda_build
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

    # 2. build: one compiler per source (nvcc for K1 and K2, the host
    # compiler for the grid builder), started together
    t0 = time.perf_counter()
    logs = cuda_build.compile_sources([C.SRC, K.SRC, native.SRC,
                                       native.IO_SRC])
    C.build()
    K.build()
    print(f"[build] K1, K2, the grid builder and the native io built in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    for src, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {src}: {line.strip()}")

    # the standard problem at full size
    t0 = time.perf_counter()
    native.builds = 0
    prob = standard_problem(device=dev)
    solver = prob.solver
    print(f"[setup] standard problem in {time.perf_counter() - t0:.2f} s: "
          f"T={prob.body.shape[0]} V={prob.model.num_verts} "
          f"scene={len(prob.scene)} contact N={len(solver.contact_vids)} "
          f"skate vids={len(solver._skate_vids)}; native grid builds "
          f"{native.builds}", flush=True)
    if native.builds != 1:
        raise AssertionError("the solver's grid did not take the native "
                             "route")

    # 3. K1 against its plain version on the main path's tables
    state, _, _ = solver.init_state(prob.body, prob.cam)
    q = _contact_queries(solver, state)
    with torch.no_grad():
        fc512 = NN.frame_candidates(solver.grid, q,
                                    solver.config.contact_cell_budget)
        fc192 = NN.compact_candidates(q, fc512,
                                      solver.config.contact_compact)
    err192 = _check_k1(C, q, fc192.cand, fc192.valid, "main [T,N,192]")
    _check_k1(C, q, fc512.cand, fc512.valid, "uncompacted [T,N,512]")
    valid_e = fc192.valid.clone()
    valid_e[3] = False
    _check_k1(C, q, fc192.cand, valid_e, "all-invalid frame 3")
    cand_d = fc192.cand.clone()
    cand_d[:, 1::2] = cand_d[:, 0::2]
    _check_k1(C, q, cand_d, torch.ones_like(fc192.valid),
              "duplicate candidates")
    sph_c = _sphere(q[:5, :1], 192, dev)
    _check_k1(C, q[:5].contiguous(), sph_c,
              torch.ones_like(fc192.valid[:5]),
              "candidates on a sphere around query 0, 1 ulp apart")
    valid_1 = torch.zeros_like(fc192.valid)
    valid_1[:, 100] = True
    _check_k1(C, q, fc192.cand, valid_1, "every slot invalid but one")
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
              f"({bound_by}), {bound_ms / ms:.1%} of the bound",
              flush=True)
        _rechecks(f"K1 [{T}, {N}, {P}]", lambda n: C.cand_nn_cuda(
            q, fc.cand, fc.valid, rechecks=n), (T, N), dev)
    del fc512, fc192, cand_d, valid_e, valid_1, sph_c
    torch.cuda.empty_cache()

    # 4. K2 against its plain version at the global solve's shape
    scene = solver.scene
    k2_err = _check_k2(K, q, scene, "global [900,813] x scene")
    gen = torch.Generator(device=dev).manual_seed(2)
    x_odd = q[:7, :111].contiguous()                       # 777 queries
    _check_k2(K, x_odd, scene[:100_001].contiguous(),
              "unaligned Q=777, M=100001")
    dup = torch.cat([scene[:30_000], scene[:30_000], scene[:5_001]])
    _check_k2(K, x_odd, dup, "duplicated scene points")
    _check_k2(K, x_odd * 40.0 + 100.0, scene, "far queries")
    _rechecks("K2 far queries [7, 111] x scene", lambda n:
                       K.nn_distance_cuda(x_odd * 40.0 + 100.0, scene,
                                          rechecks=n), (7, 111), dev)
    x_eq = x_odd.clone()
    x_eq[0, :50] = scene[1000:1050]
    _check_k2(K, x_eq, scene, "queries equal to scene points")
    d_eq, i_eq = K.nn_distance_cuda(x_eq, scene)
    if not (bool((d_eq[0, :50] == 0).all()) and torch.equal(
            i_eq[0, :50].long(), torch.arange(1000, 1050, device=dev))):
        raise AssertionError("a query equal to a scene point must find it")
    x_rand = torch.rand((3, 1000, 3), device=dev, generator=gen) * 10 - 5
    _check_k2(K, x_rand, scene, "random queries over the scene box")
    sph = _sphere(x_odd[:1, :1], 100_000, dev)
    _check_k2(K, x_odd, sph[0], "100,000 points on a sphere around query "
              "0, 1 ulp apart")
    _check_k2(K, x_odd + 1000.0, torch.cat([scene + 1000.0, scene - 1000.0]),
              "coordinates near +-1,000")

    Q, M = q.numel() // 3, scene.shape[0]
    k2_ms = _median_ms(lambda: K.nn_distance_cuda(q, scene), reps=10)
    k2_plain_ms = _median_ms(lambda: K.nn_distance_plain(q, scene), reps=3,
                             warmup=1)
    qf = q.reshape(-1, 3)

    def cdist_min():
        for s in range(0, Q, 8192):
            torch.cdist(qf[s:s + 8192], scene).min(-1)

    k2_lib_ms = _median_ms(cdist_min, reps=3, warmup=1)
    k2_bound, k2_bound_by = _k2_bound_ms(Q, M)
    print(f"[K2] Q={Q} M={M}: kernel {k2_ms:.4f} ms, plain "
          f"{k2_plain_ms:.4f} ms, cdist+min (8192-query chunks) "
          f"{k2_lib_ms:.4f} ms, bound {k2_bound:.4f} ms ({k2_bound_by}), "
          f"{k2_bound / k2_ms:.1%} of the bound", flush=True)
    _rechecks(f"K2 {tuple(q.shape[:2])} x {M}", lambda n:
              K.nn_distance_cuda(q, scene, rechecks=n), q.shape[:2], dev)
    del q, x_odd, dup, x_eq, x_rand, sph
    torch.cuda.empty_cache()

    cfg = solver.config
    n_a = int(cfg.num_iter * cfg.stage_split)
    n_dct_b = cfg.num_iter_dct - int(cfg.num_iter_dct * cfg.dct_split)

    # 5. the local path (the main path of the first slice)
    k1_launches, _, local_s, local_hist, local_solved = _run_fit(
        solver, prob, "local", C, K, (n_a, 0), "local")
    local_seconds = dict(solver.phase_seconds)

    # 6. global: brute-force contact NN (K2), then the grid (K1)
    t0 = time.perf_counter()
    prob_b = standard_problem(device=dev, nn_impl="brute")
    print(f"[setup] brute-force standard problem in "
          f"{time.perf_counter() - t0:.2f} s (no voxel grid: "
          f"{prob_b.solver.grid is None})", flush=True)
    _, k2_launches, _, _, _ = _run_fit(prob_b.solver, prob_b, "global", C,
                                       K, (0, n_a), "global/brute")
    del prob_b
    torch.cuda.empty_cache()
    _run_fit(solver, prob, "global", C, K, (n_a, 0), "global/grid")

    # 7. dct with the grid, at full length
    _run_fit(solver, prob, "dct", C, K, (n_dct_b, 0), "dct/grid")

    # 8. small solves on the card agree with the same solves on the CPU
    for mode, nn_impl in (("local", "grid"), ("global", "brute"),
                          ("dct", "grid")):
        _card_vs_cpu(standard_problem, dev, mode, nn_impl)

    # 9. the CLI on the card
    with tempfile.TemporaryDirectory() as tmp:
        _cli_on_card(Path(tmp))

    # 10-11. the keypoint fit and the smoother at full width
    body_fit = _keypoint_phase(prob.model, prob.vp, dev, C, K)
    _smoother_phase(body_fit, dev, C, K)

    # 12. the same small stages on the card and on the CPU
    _stages_card_vs_cpu(dev)

    # 13. fit -> smooth -> globalopt on the card (its directory stays for
    # phase 25)
    pipe = tempfile.TemporaryDirectory()
    _pipeline_on_card(Path(pipe.name))

    # 14. both kernels at the fleet's shapes
    k1_fleet, k2_fleet = _fleet_kernels(C, K, solver, prob, dev)

    # 15-18. the fleet: local/grid (8 x 900), global/brute (2 x 900),
    # dct/grid (8 x 900), and a small fleet on the card and on the CPU
    k1_fleet_launches, k2_fleet_launches = _fleet_phases(
        C, K, prob, dev, local_s, local_hist, n_a, n_dct_b)

    # 19. multiopt on the card, alone and in a one-rank NCCL group; 20.
    # the native grid; 21-22. the frames axis: two gloo ranks on the card,
    # then multiopt on their frames mesh against 19's pkls
    with tempfile.TemporaryDirectory() as tmp:
        clip_dirs, multiopt_alone = _multiopt_on_card(Path(tmp))
        _native_grid_phase(prob)
        k1_frames_launches, k2_frames_launches, (k1_frames, k2_frames) = \
            _frames_phase(C, K, prob, dev, local_hist, local_seconds,
                          Path(tmp), clip_dirs, multiopt_alone)

    # 23-24. the world and ego renders at full width, the viewer; 25. vis
    # and prep in subprocesses after phase 13's pipeline
    t_ends = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        clip = _render_phase(prob, dev, local_solved, Path(tmp))
        _interactive_phase(prob, clip)
    _pipeline_ends(Path(pipe.name))
    pipe.cleanup()
    print(f"[ends] phases 23-25 in {time.perf_counter() - t_ends:.2f} s",
          flush=True)

    # 26. the FK adjoint; 27. the library; 28. the native io; 29.
    # observability; 30. the ground-truth accuracy report
    t_lib = time.perf_counter()
    _fk_phase(prob, dev, state, C, K, n_a)
    q = _contact_queries(solver, state)
    _library_phase(prob, dev, K, q, k2_ms, local_hist)
    with tempfile.TemporaryDirectory() as tmp:
        _native_io_phase(prob, q, K, Path(tmp))
        del q
        torch.cuda.empty_cache()
        _observability_phase(prob, dev, C, Path(tmp))
    _accuracy_phase(C, K)
    print(f"[library] phases 26-30 in {time.perf_counter() - t_lib:.2f} s",
          flush=True)

    k1_src = ("fpv4d_torch/csrc/cand_nn.cu", "fpv4d/ops/cand_pallas.py:160")
    k2_src = ("fpv4d_torch/csrc/chamfer_nn.cu",
              "fpv4d/ops/chamfer_pallas.py:55")

    def entry(name, src, launches, m):
        err, ms, plain_ms, lib_ms, bound_ms, bound_by = m
        return {"name": name, "route": "cuda", "source": src[0],
                "replaces": src[1], "launches": launches,
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound_ms, "bound_by": bound_by,
                "library_ms": lib_ms}

    ms, plain_ms, lib_ms, bound_ms, bound_by = timings[192]
    print(json.dumps({"kernels": [
        entry("cand_nn", k1_src, k1_launches,
              (err192, ms, plain_ms, lib_ms, bound_ms, bound_by)),
        entry("chamfer_nn", k2_src, k2_launches,
              (k2_err, k2_ms, k2_plain_ms, k2_lib_ms, k2_bound,
               k2_bound_by)),
        entry("cand_nn (fleet, 8 clips folded)", k1_src, k1_fleet_launches,
              k1_fleet),
        entry("chamfer_nn (clip axis, 2 clips)", k2_src, k2_fleet_launches,
              k2_fleet),
        entry("cand_nn (frames shard, 450 of 900 frames, per rank)", k1_src,
              k1_frames_launches, k1_frames),
        entry("chamfer_nn (frames shard, 450 of 900 frames, per rank)",
              k2_src, k2_frames_launches, k2_frames)]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
