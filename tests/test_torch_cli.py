"""The port's globalopt CLI and the io/params/transforms/contact helpers
it reads through, against the JAX package's, on the fixture of
tests/test_cli.py (3 frames, the 10,475-vertex synthetic stand-in, a
300-point random scene, a camerapose.txt).

The port's CLI runs with ``--device cpu --nn-impl brute`` (K2's plain
version) and the reference's with ``--nn-impl xla`` (its exact brute
force off the TPU). The fit and smooth CLIs run on the verify recipe's
keypoint fixture (4 frames of OpenPose JSON, here with both hands),
fit at 10 steps per stage (tests/test_torch_keypoint_fit.py says why
longer Adam runs part ways): body parameters within 1e-4 (measured
1.6e-5), smoothed pkls within 1e-5 (measured 3.6e-6). Tolerances: the written body parameters within
2*lr (the L1 reconstruction and smoothness terms start at exact zeros,
where last-bit differences steer single Adam steps by +-lr) with 99%
of entries within 1e-4; scale within 1e-5 and camera_ext within 1e-6
(f32 summation order). File formats and integer logic are exact. The
vis CLI (world, ego --source local, pack) runs on 2 frames of the
10,475-vertex stand-in at 1280x720 against the reference's: the same
exit codes and file lists, images within the random-mesh tolerance of
tests/test_torch_vis.py."""
import json
import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from fpv4d.core import transforms as JT
from fpv4d.io import body_pkl as JBP
from fpv4d.io import colmap as JCOL
from fpv4d.io import ply as JPLY
from fpv4d.models import params as JP
from fpv4d.ops import contact as JC
from fpv4d_torch.core import transforms as TT
from fpv4d_torch.io import body_pkl as TBP
from fpv4d_torch.io import colmap as TCOL
from fpv4d_torch.io import ply as TPLY
from fpv4d_torch.models import params as TP
from fpv4d_torch.ops import contact as TC

LR = 0.005


@pytest.fixture(scope="module")
def clip_dir(tmp_path_factory):
    """body_gen pkls + scene.ply + camerapose.txt, as tests/test_cli.py
    makes them."""
    rng = np.random.RandomState(0)
    root = tmp_path_factory.mktemp("clip")
    T = 3
    body = (rng.randn(T, 75) * 0.1).astype(np.float32)
    JBP.save_clip(str(root / "body_gen"), body)
    scene = rng.randn(300, 3).astype(np.float32)
    JPLY.write_ply(str(root / "scene.ply"), scene)
    with open(root / "camerapose.txt", "w") as f:
        for t in range(T):
            f.write(f"{t:06d}.jpg 1 0 0 0 0.1 0.2 {0.3 + t}\n")
    return root


def _args(clip_dir, out, mode="global"):
    return [str(clip_dir / "body_gen"), str(out), mode,
            "--scene", str(clip_dir / "scene.ply"),
            "--camera", str(clip_dir / "camerapose.txt"),
            "--iters", "4", "--model", "NONE", "--vposer", "NONE"]


def _frames(path):
    return [JBP.load_frame(str(p)) for p in sorted(path.glob("*.pkl"))]


def test_globalopt_matches_reference(clip_dir, tmp_path):
    from fpv4d.cli.globalopt import main as jmain
    from fpv4d_torch.cli.globalopt import main as tmain
    assert jmain(_args(clip_dir, tmp_path / "j") + ["--nn-impl",
                                                    "xla"]) == 0
    assert tmain(_args(clip_dir, tmp_path / "t") + [
        "--nn-impl", "brute", "--device", "cpu"]) == 0
    jf, tf = _frames(tmp_path / "j"), _frames(tmp_path / "t")
    assert len(tf) == len(jf) == 3
    assert [p.name for p in sorted((tmp_path / "t").glob("*.pkl"))] == \
        [p.name for p in sorted((tmp_path / "j").glob("*.pkl"))]
    body_err = []
    for a, b in zip(tf, jf):
        assert a.keys() == b.keys()
        assert "scale" in a and "camera_ext" in a
        np.testing.assert_allclose(a["scale"], b["scale"], atol=1e-5)
        np.testing.assert_allclose(a["camera_ext"], b["camera_ext"],
                                   atol=1e-6)
        for k in TP.SLICES:
            assert a[k].shape == b[k].shape, k
            body_err.append(np.abs(a[k] - b[k]).ravel())
    err = np.concatenate(body_err)
    assert np.mean(err <= 1e-4) >= 0.99 and err.max() <= 2 * LR


def test_globalopt_sdf_and_checkpoints(clip_dir, tmp_path):
    """The collision term and per-phase checkpoints through the CLI
    (dct mode, grid contact)."""
    from fpv4d_torch.cli.globalopt import main as tmain
    d = 8
    lin = np.linspace(-4, 4, d, dtype=np.float32)
    vals = np.broadcast_to(lin[None, :, None] + 1.0, (d, d, d))
    np.save(tmp_path / "sdf.npy", np.ascontiguousarray(vals).ravel())
    with open(tmp_path / "sdf.json", "w") as f:
        json.dump({"min": [-4, -4, -4], "max": [4, 4, 4], "dim": d}, f)
    rc = tmain(_args(clip_dir, tmp_path / "fit", "dct") + [
        "--device", "cpu", "--sdf-json", str(tmp_path / "sdf.json"),
        "--sdf-npy", str(tmp_path / "sdf.npy"),
        "--checkpoint-dir", str(tmp_path / "ckpt")])
    assert rc == 0
    assert sorted(os.listdir(tmp_path / "ckpt")) == ["dct_a.pt", "dct_b.pt"]
    frames = _frames(tmp_path / "fit")
    assert len(frames) == 3 and all(np.isfinite(f["scale"]) for f in frames)


@pytest.fixture(scope="module")
def kp_dir(tmp_path_factory):
    """The verify recipe's OpenPose JSONs (4 frames), with both hands."""
    d = tmp_path_factory.mktemp("kp") / "keypoints"
    d.mkdir()
    for t in range(4):
        k = np.arange(25)
        body = np.stack([640 + 30 * np.cos(k) + 2 * t,
                         360 + 40 * np.sin(k) + t, np.ones(25)], 1)
        h = np.arange(21)
        hl = np.stack([600 + 10 * np.cos(h) + t, 300 + 8 * np.sin(h),
                       np.full(21, 0.9)], 1)
        hr = np.stack([680 + 10 * np.sin(h), 300 + 8 * np.cos(h) + t,
                       np.full(21, 0.8)], 1)
        person = {"pose_keypoints_2d": body.ravel().tolist(),
                  "hand_left_keypoints_2d": hl.ravel().tolist(),
                  "hand_right_keypoints_2d": hr.ravel().tolist()}
        with open(d / f"{t:06d}_keypoints.json", "w") as f:
            json.dump({"people": [person]}, f)
    return d


def _assert_same_pkls(t_dir, j_dir, atol):
    tf, jf = _frames(t_dir), _frames(j_dir)
    assert len(tf) == len(jf) == 4
    assert [p.name for p in sorted(t_dir.glob("*.pkl"))] == \
        [p.name for p in sorted(j_dir.glob("*.pkl"))]
    for a, b in zip(tf, jf):
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].shape == b[k].shape, k
            np.testing.assert_allclose(a[k], b[k], atol=atol, rtol=0,
                                       err_msg=k)


def test_fit_and_smooth_match_reference(kp_dir, tmp_path):
    from fpv4d.cli.fit import main as jfit
    from fpv4d.cli.smooth import main as jsmooth
    from fpv4d_torch.cli.fit import main as tfit
    from fpv4d_torch.cli.smooth import main as tsmooth
    assets = ["--model", "NONE", "--vposer", "NONE"]
    assert jfit([str(kp_dir), str(tmp_path / "j_gen"), "--iters", "10"]
                + assets) == 0
    assert tfit([str(kp_dir), str(tmp_path / "t_gen"), "--iters", "10",
                 "--device", "cpu"] + assets) == 0
    _assert_same_pkls(tmp_path / "t_gen", tmp_path / "j_gen", 1e-4)
    for mode in ("sequential", "independent", "motion"):
        gen = str(tmp_path / "j_gen")
        assert jsmooth([gen, str(tmp_path / f"j_{mode}"), "--iters", "10",
                        "--mode", mode]) == 0
        assert tsmooth([gen, str(tmp_path / f"t_{mode}"), "--iters", "10",
                        "--mode", mode, "--device", "cpu"]) == 0
        _assert_same_pkls(tmp_path / f"t_{mode}" / "smoothed_body",
                          tmp_path / f"j_{mode}" / "smoothed_body", 1e-5)


def test_smooth_motion_unreadable_checkpoint(tmp_path, capsys):
    """A motion checkpoint of garbage bytes: the CLI prints that the load
    failed and smooths with the stand-in weights, exactly as without a
    checkpoint (the reference's fpv4d/cli/smooth.py falls back alike;
    test_fit_and_smooth_match_reference holds the stand-in run to it)."""
    from fpv4d_torch.cli.smooth import main as tsmooth
    gen = str(tmp_path / "gen")
    JBP.save_clip(gen, (np.random.RandomState(1).randn(4, 75)
                        * 0.1).astype(np.float32))
    bad = tmp_path / "garbage.ckp"
    bad.write_bytes(np.random.RandomState(0).bytes(257))
    args = ["--iters", "3", "--mode", "motion", "--device", "cpu"]
    capsys.readouterr()
    assert tsmooth([gen, str(tmp_path / "t"), "--motion-ckpt", str(bad)]
                   + args) == 0
    assert "GRU ckpt load failed" in capsys.readouterr().err
    assert tsmooth([gen, str(tmp_path / "n"), "--motion-ckpt",
                    str(tmp_path / "missing.ckp")] + args) == 0
    assert "GRU ckpt load failed" not in capsys.readouterr().err
    _assert_same_pkls(tmp_path / "t" / "smoothed_body",
                      tmp_path / "n" / "smoothed_body", 0.0)


@pytest.mark.parametrize("cli", ["fit", "smooth"])
def test_fit_and_smooth_default_device_needs_a_card(kp_dir, tmp_path, cli,
                                                    capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device would run")
    from fpv4d_torch.cli import fit, smooth
    main = fit.main if cli == "fit" else smooth.main
    assert main([str(kp_dir), str(tmp_path / "x")]) == 1
    assert "no CUDA device" in capsys.readouterr().err
    assert not (tmp_path / "x").exists()


def test_fit_and_smooth_empty_inputs(tmp_path):
    """No keypoint JSONs: fit exits 1; no body pkls: smooth raises."""
    from fpv4d_torch.cli import fit, smooth
    (tmp_path / "empty").mkdir()
    assert fit.main([str(tmp_path / "empty"), str(tmp_path / "o"),
                     "--device", "cpu"]) == 1
    with pytest.raises(FileNotFoundError):
        smooth.main([str(tmp_path / "empty"), str(tmp_path / "o"),
                     "--device", "cpu"])


def test_bad_mode_exits_2(clip_dir, tmp_path):
    from fpv4d_torch.cli.globalopt import main as tmain
    with pytest.raises(SystemExit) as e:
        tmain(_args(clip_dir, tmp_path / "x", "bogus") + ["--device", "cpu"])
    assert e.value.code == 2
    with pytest.raises(SystemExit) as e:
        tmain(_args(clip_dir, tmp_path / "x") + ["--nn-impl", "xla"])
    assert e.value.code == 2


def test_default_device_needs_a_card(clip_dir, tmp_path, capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device would run")
    from fpv4d_torch.cli.globalopt import main as tmain
    assert tmain(_args(clip_dir, tmp_path / "x")) == 1
    assert "no CUDA device" in capsys.readouterr().err
    assert not (tmp_path / "x").exists()


@pytest.mark.parametrize("binary", [True, False])
def test_ply_round_trip_matches_reference(tmp_path, binary):
    rng = np.random.RandomState(1)
    v = rng.randn(50, 3).astype(np.float32)
    f = rng.randint(0, 50, (20, 3)).astype(np.int32)
    TPLY.write_ply(str(tmp_path / "t.ply"), v, f, binary=binary)
    JPLY.write_ply(str(tmp_path / "j.ply"), v, f, binary=binary)
    assert (tmp_path / "t.ply").read_bytes() == \
        (tmp_path / "j.ply").read_bytes()
    tv, tf = TPLY.read_ply(str(tmp_path / "j.ply"))
    np.testing.assert_allclose(tv, v, rtol=1e-6)
    np.testing.assert_array_equal(tf, f)


def test_body_pkl_and_params_match_reference(tmp_path):
    rng = np.random.RandomState(2)
    body = rng.randn(4, 75).astype(np.float32)
    cam = rng.randn(4, 4, 4).astype(np.float32)
    tp = TBP.save_clip(str(tmp_path / "t"), body, 1.7, cam)
    jp = JBP.save_clip(str(tmp_path / "j"), body, 1.7, cam)
    assert [os.path.basename(p) for p in tp] == \
        [os.path.basename(p) for p in jp]
    for a, b in zip(tp, jp):
        da, db = TBP.load_frame(a), JBP.load_frame(b)
        assert da.keys() == db.keys()
        for k in da:
            np.testing.assert_array_equal(da[k], db[k])
    np.testing.assert_array_equal(TBP.load_clip(str(tmp_path / "t")), body)
    np.testing.assert_array_equal(TBP.load_clip(str(tmp_path / "j")),
                                  JBP.load_clip(str(tmp_path / "t")))
    frame = TBP.load_frame(tp[0])
    np.testing.assert_array_equal(TP.from_pkl_dict(frame, False),
                                  JP.from_pkl_dict(frame, False))
    with pytest.raises(FileNotFoundError):
        TBP.load_clip(str(tmp_path / "empty"))


def test_camera_and_transforms_match_reference(clip_dir):
    path = str(clip_dir / "camerapose.txt")
    q, t = TCOL.read_camerapose(path)
    jq, jt = JCOL.read_camerapose(path)
    np.testing.assert_array_equal(q, jq)
    np.testing.assert_array_equal(t, jt)
    np.testing.assert_allclose(TCOL.camera_ext_from_file(path),
                               np.asarray(JCOL.camera_ext_from_file(path)),
                               atol=1e-6)
    rng = np.random.RandomState(3)
    qv = rng.randn(5, 4).astype(np.float32)
    qv /= np.linalg.norm(qv, axis=1, keepdims=True)
    tv = rng.randn(5, 3).astype(np.float32)
    w = TT.colmap_pose_to_world_from_cam(torch.as_tensor(qv),
                                         torch.as_tensor(tv))
    np.testing.assert_allclose(
        w.numpy(), np.asarray(JT.colmap_pose_to_world_from_cam(
            jnp.asarray(qv), jnp.asarray(tv))), atol=1e-6)
    inv = TT.invert_rigid(w)
    np.testing.assert_allclose(inv.numpy(), np.asarray(JT.invert_rigid(
        jnp.asarray(w.numpy()))), atol=1e-6)
    np.testing.assert_allclose(torch.matmul(w, inv).numpy(),
                               np.broadcast_to(np.eye(4), (5, 4, 4)),
                               atol=1e-5)
    xyz = clip_dir / "pts.xyz"
    np.savetxt(xyz, rng.randn(7, 3))
    np.testing.assert_array_equal(TCOL.read_xyz(str(xyz)),
                                  JCOL.read_xyz(str(xyz)))


def test_contact_ids_match_reference(tmp_path):
    np.testing.assert_array_equal(
        TC.contact_ids(str(tmp_path / "missing"), ("L_Leg", "R_Leg"), 2000),
        JC.contact_ids(str(tmp_path / "missing"), ("L_Leg", "R_Leg"), 2000))
    JC.write_synthetic_segments(str(tmp_path / "segs"), 2000, seed=3)
    np.testing.assert_array_equal(
        TC.contact_ids(str(tmp_path / "segs"), ("L_Leg",), 2000),
        JC.contact_ids(str(tmp_path / "segs"), ("L_Leg",), 2000))


def _two_clips(clip_dir, root):
    """tests/test_cli.py's test_cli_multiopt layout: two clip directories
    sharing the fixture's body_gen, scene and camerapose.txt."""
    import shutil
    dirs = []
    for name in ("clipA", "clipB"):
        c = root / name
        shutil.copytree(clip_dir / "body_gen", c / "body_gen")
        shutil.copyfile(clip_dir / "scene.ply", c / "scene.ply")
        shutil.copyfile(clip_dir / "camerapose.txt", c / "camerapose.txt")
        dirs.append(str(c))
    return dirs + ["--mode", "global", "--iters", "4", "--scene-name",
                   "scene.ply", "--model", "NONE", "--vposer", "NONE"]


def test_multiopt_matches_reference(clip_dir, tmp_path):
    """The reference's CLI on its own test's arguments (--mesh clips=2,
    exact brute force off the TPU) against the port's on one rank with
    --nn-impl brute, at the globalopt test's tolerances."""
    from fpv4d.cli.multiopt import main as jmain
    from fpv4d_torch.cli.multiopt import main as tmain
    args = _two_clips(clip_dir, tmp_path)
    assert jmain(args + ["--out", str(tmp_path / "j"), "--mesh",
                         "clips=2"]) == 0
    assert tmain(args + ["--out", str(tmp_path / "t"), "--nn-impl", "brute",
                         "--device", "cpu"]) == 0
    body_err = []
    for name in ("clipA", "clipB"):
        jf, tf = _frames(tmp_path / "j" / name), _frames(tmp_path / "t" / name)
        assert len(tf) == len(jf) == 3
        for a, b in zip(tf, jf):
            assert a.keys() == b.keys()
            np.testing.assert_allclose(a["scale"], b["scale"], atol=1e-5)
            np.testing.assert_allclose(a["camera_ext"], b["camera_ext"],
                                       atol=1e-6)
            body_err += [np.abs(a[k] - b[k]).ravel() for k in TP.SLICES]
    err = np.concatenate(body_err)
    assert np.mean(err <= 1e-4) >= 0.99 and err.max() <= 2 * LR


def test_multiopt_needs_a_card_and_one_rank(clip_dir, tmp_path, capsys):
    from fpv4d_torch.cli.multiopt import main as tmain
    args = _two_clips(clip_dir, tmp_path)
    if not torch.cuda.is_available():
        assert tmain(args + ["--out", str(tmp_path / "x")]) == 1
        assert "no CUDA device" in capsys.readouterr().err
        assert not (tmp_path / "x").exists()
    with pytest.raises(ValueError, match="needs 2 ranks"):
        tmain(args + ["--out", str(tmp_path / "y"), "--mesh", "clips=2",
                      "--device", "cpu"])


# -- the vis CLI ------------------------------------------------------------------

@pytest.fixture(scope="module")
def vis_clip(clip_dir, tmp_path_factory):
    """A 2-frame smoothed_body/ with scale and camera_ext, beside the
    globalopt fixture's scene.ply."""
    rng = np.random.RandomState(9)
    T = 2
    body = (rng.randn(T, 75) * 0.1).astype(np.float32)
    body[:, 74] = 2.5
    cam_ext = np.tile(np.eye(4, dtype=np.float32), (T, 1, 1))
    cam_ext[:, 2, 3] = -3.0
    root = tmp_path_factory.mktemp("vis")
    JBP.save_clip(str(root / "smoothed_body"), body, scale=1.1,
                  camera_ext=cam_ext, prefix="")
    return root, str(clip_dir / "scene.ply")


def _same_pngs(a, b, names):
    from PIL import Image
    assert sorted(os.listdir(a)) == sorted(os.listdir(b)) == names
    for n in names:
        ia = np.asarray(Image.open(os.path.join(a, n))).astype(int)
        ib = np.asarray(Image.open(os.path.join(b, n))).astype(int)
        d = np.abs(ia - ib).max(-1)
        assert np.mean(d <= 1) >= 0.99 and (ib.sum(-1) > 0).mean() > 0.005


def test_vis_cli_matches_reference(vis_clip, tmp_path):
    """vis world and vis ego --source local on the synthetic 10,475-vertex
    stand-in at 1280x720 (2 frames), then vis pack: the reference's exit
    codes and file lists, images within the random-mesh tolerance of
    tests/test_torch_vis.py."""
    from fpv4d.cli.vis import main as jmain
    from fpv4d_torch.cli.vis import main as tmain
    root, scene = vis_clip
    assets = ["--model", "NONE", "--vposer", "NONE"]
    smoothed = str(root / "smoothed_body")
    for name, main, extra in (("j", jmain, []),
                              ("t", tmain, ["--device", "cpu"])):
        assert main(["world", smoothed, "--scene", scene, "--out",
                     str(tmp_path / f"world_{name}")] + assets + extra) == 0
        assert main(["ego", smoothed, "--source", "local"] + assets
                    + extra) == 0
        os.rename(root / "local_vis", tmp_path / f"ego_{name}")
    _same_pngs(tmp_path / "world_j", tmp_path / "world_t",
               ["img_000.png", "img_001.png"])
    _same_pngs(tmp_path / "ego_j", tmp_path / "ego_t",
               ["0000.png", "0001.png"])
    (tmp_path / "empty").mkdir()
    for main in (jmain, tmain):
        assert main(["pack", str(tmp_path / "world_t")]) == 0
        assert main(["pack", str(tmp_path / "empty")]) == 1
    assert (tmp_path / "world_t.mp4").stat().st_size > 0


def test_vis_cli_needs_a_card_and_cv2(vis_clip, tmp_path, capsys,
                                      monkeypatch):
    from fpv4d_torch.cli.vis import main as tmain
    root, scene = vis_clip
    smoothed = str(root / "smoothed_body")
    with pytest.raises(SystemExit) as e:
        tmain(["bogus", smoothed])
    assert e.value.code == 2
    if not torch.cuda.is_available():
        for argv in (["world", smoothed, "--scene", scene, "--out",
                      str(tmp_path / "w")],
                     ["ego", smoothed, "--source", "local"],
                     ["interactive", smoothed, "--scene", scene]):
            assert tmain(argv + ["--model", "NONE", "--vposer", "NONE"]) == 1
            assert "no CUDA device" in capsys.readouterr().err
        assert not (tmp_path / "w").exists()
        assert not (root / "local_vis").exists()
    frames = tmp_path / "frames"
    frames.mkdir()
    from fpv4d_torch.vis.frames import save_png
    save_png(str(frames / "0000.png"), torch.ones(8, 8, 3) * 0.5)
    monkeypatch.setitem(__import__("sys").modules, "cv2", None)
    assert tmain(["pack", str(frames)]) == 1
    assert "cv2" in capsys.readouterr().err
