"""The port's clips axis over torch.distributed (fpv4d_torch/parallel/
sharding.py): the mesh and process-group helpers, the contract of the
reference's tests/test_sharding.py where it carries over (make_mesh
raising, maybe_initialize_distributed a strict no-op without the flag),
and one 2-process gloo run (tests/torch_fleet_worker.py) that must
reproduce the one-process fleet and the unsplit batched keypoint fit.

The 2-process run splits C=4 clips into two ranks of 2, each rank folds
its own; a clip's arithmetic is then that of a 2-clip fold instead of a
4-clip fold, which on the CPU changes no bit (tests/test_torch_multi_
clip.py measures the fold against single-clip solves); held at the
fleet's parity tolerances all the same: histories rtol 1e-4 (skate
1e-3), body_6d 99% within 1e-4 and all within 2 lr; the keypoint fit at
tests/test_torch_keypoint_fit.py's batched-vs-per-clip tolerance."""
import numpy as np
import pytest
import torch
import torch.distributed as dist

from fpv4d_torch.config import KeypointFitConfig
from fpv4d_torch.parallel import sharding as SH
from fpv4d_torch.parallel.multi_clip import MultiClipSolver
from fpv4d_torch.solve.clip_solve import ClipState
from fpv4d_torch.solve.keypoint_fit import fit_keypoints

import torch_fleet_worker as W


def test_make_mesh_without_a_process_group():
    assert not dist.is_initialized()
    mesh = SH.make_mesh({"clips": 1})
    assert mesh.axes == {"clips": 1} and mesh.size == 1
    assert mesh.rank == 0 and SH.clip_range(mesh, 5) == (0, 5)
    assert SH.make_mesh({"clips": 1, "frames": 1}).size == 1
    with pytest.raises(ValueError, match="needs 2 ranks"):
        SH.make_mesh({"clips": 2})
    with pytest.raises(ValueError, match="needs 4 ranks"):
        SH.make_mesh({"clips": 1, "frames": 4})
    with pytest.raises(ValueError):
        SH.make_mesh({"clips": 0})
    with pytest.raises(ValueError, match="do not split"):
        SH.clip_range(SH.Mesh({"clips": 2}, rank=1), 3)
    assert SH.clip_range(SH.Mesh({"clips": 2}, rank=1), 4) == (2, 4)
    x = torch.arange(6.0).reshape(3, 2)
    assert SH.all_gather_clips(x, mesh) is x


def test_mesh_coordinates_frame_and_window_ranges():
    """Ranks lie row-major in the order the axes are given (rank = c F +
    f), as the reference reshapes its devices; a frames axis splits T
    into contiguous blocks of >= 2 frames; c_dct splits on windows
    exactly when the window count divides over the frames axis (the
    reference's clip_batch_shardings rule, tests/test_sharding.py)."""
    axes = {"clips": 2, "frames": 2}
    coords = [(SH.Mesh(axes, rank=r).coord("clips"),
               SH.Mesh(axes, rank=r).coord("frames")) for r in range(4)]
    assert coords == [(0, 0), (0, 1), (1, 0), (1, 1)]
    m = SH.Mesh(axes, rank=3)
    assert m.member and not SH.Mesh(axes, rank=4).member
    assert SH.clip_range(m, 4) == (2, 4) and SH.frame_range(m, 8) == (4, 8)
    assert SH.Mesh(axes, rank=3).coord("other") == 0
    with pytest.raises(ValueError, match="do not split"):
        SH.frame_range(m, 7)
    with pytest.raises(ValueError, match="needs >= 2"):
        SH.frame_range(SH.Mesh({"frames": 4}, rank=0), 4)
    assert SH.frame_range(SH.Mesh({"clips": 2}, rank=1), 5) == (0, 5)
    f4 = SH.Mesh({"clips": 2, "frames": 4}, rank=6)
    assert SH.window_range(f4, 8) == (4, 6)
    assert SH.window_range(f4, 6) is None
    assert SH.window_range(SH.Mesh({"clips": 2}, rank=1), 3) == (0, 3)
    sh = SH.FrameShard.of(SH.Mesh({"clips": 1}), 12, 4)
    assert (sh.F, sh.lo, sh.hi, sh.dct_split) == (1, 0, 12, False)
    assert sh.frac(0) == sh.frac(1) == sh.frac(2) == 1.0


def test_maybe_initialize_distributed_noop(monkeypatch):
    """Without FPV4D_DISTRIBUTED=1 and an init_method nothing happens;
    with the flag the call goes to init_process_group with torchrun's
    environment (env://) and the backend of the device."""
    calls = []
    monkeypatch.delenv("FPV4D_DISTRIBUTED", raising=False)
    monkeypatch.setattr(dist, "init_process_group",
                        lambda *a, **kw: calls.append((a, kw)))
    assert SH.maybe_initialize_distributed() is False
    assert SH.maybe_initialize_distributed(device="cpu") is False
    assert calls == []
    monkeypatch.setenv("FPV4D_DISTRIBUTED", "1")
    assert SH.maybe_initialize_distributed(device="cpu") is True
    assert calls == [(("gloo",), {"init_method": "env://"})]
    monkeypatch.delenv("FPV4D_DISTRIBUTED")
    assert SH.maybe_initialize_distributed(
        init_method="tcp://localhost:1", world_size=2, rank=1,
        device="cpu") is True
    assert calls[-1] == (("gloo",), {"init_method": "tcp://localhost:1",
                                     "world_size": 2, "rank": 1})
    # an initialized group short-circuits
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    n = len(calls)
    assert SH.maybe_initialize_distributed(init_method="x") is True
    assert len(calls) == n


def test_flatten_state_folds_clips_into_frames():
    C, T = 3, 4
    st = ClipState(body_6d=torch.randn(C, T, 78), scale=torch.rand(C),
                   camera_ext=torch.randn(C, T, 4, 4),
                   c_dct=torch.randn(C, 1, 23, 3, 2))
    f = SH.flatten_state(st)
    assert f.body_6d.shape == (C * T, 78)
    assert torch.equal(f.body_6d[T:2 * T], st.body_6d[1])
    assert torch.equal(f.scale, st.scale.repeat_interleave(T))
    assert torch.equal(f.camera_ext[-1], st.camera_ext[-1, -1])


def test_two_gloo_ranks_reproduce_one_process(tmp_path):
    """C=4 clips over a clips axis of 2 gloo ranks, then the batched
    keypoint fit of 2 clips over the same mesh: rank 0's gathered
    results against the one-process fleet and the unsplit fit."""
    out = tmp_path / "rank0.npz"
    torch.multiprocessing.spawn(W.run, args=(str(tmp_path / "pg"),
                                             str(out)), nprocs=2, join=True)
    got = np.load(out)
    solver, bodies, cams, scenes, model, vp, kp_b = W.problem()
    state_b, hist = MultiClipSolver(solver=solver).fit(bodies, cams, scenes,
                                                       mode="local")
    assert set(hist) == {"local_a", "local_b", "local_skate"}
    for k, v in hist.items():
        assert got[f"hist_{k}"].shape == v.shape == (v.shape[0], W.C)
        np.testing.assert_allclose(got[f"hist_{k}"], v, rtol=1e-3
                                   if k == "local_skate" else 1e-4,
                                   err_msg=k)
    err = np.abs(got["body_6d"] - state_b.body_6d.numpy())
    assert np.mean(err <= 1e-4) >= 0.99 and err.max() <= 2 * 0.005
    np.testing.assert_allclose(got["scale"], state_b.scale.numpy(),
                               atol=1e-5)
    params, kp_hist = fit_keypoints(model, vp, kp_b,
                                    KeypointFitConfig(num_iter=5),
                                    device="cpu")
    np.testing.assert_allclose(got["kp_params"], params, atol=2e-5,
                               rtol=1e-4)
    np.testing.assert_allclose(got["kp_all"], kp_hist["all"], rtol=1e-4,
                               atol=1e-6)
