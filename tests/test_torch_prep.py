"""The port's prep CLI and io/video against the JAX package's on the
same seeded fixtures, on the CPU: every subcommand that needs no ffmpeg
writes what the reference writes (text files and pkls byte for byte,
mask PNGs pixel for pixel through cv2); the ffmpeg wrappers pass the
same argv (subprocess.run recorded, since ffmpeg is absent here); and
the tools' absence exits 1 with a message naming them."""
import json
import os
import pickle
import subprocess
import sys
import threading
import time

import cv2
import numpy as np
import pytest

from fpv4d.cli import prep as JPREP
from fpv4d.io import video as JVID
from fpv4d_torch.cli import prep as TPREP
from fpv4d_torch.io import video as TVID


def _tree(root):
    """{relative path: bytes} of every file under root."""
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


def _both(tmp_path, args, capsys=None):
    """Run the reference's and the port's prep with args (where '{out}'
    stands for each one's output path); returns ((rc, out, err) ...)."""
    res = []
    for name, main in (("ref", JPREP.main), ("port", TPREP.main)):
        out = str(tmp_path / name)
        rc = main([a.replace("{out}", out) for a in args])
        text = capsys.readouterr() if capsys else None
        res.append((rc, out, text))
    return res


@pytest.fixture(scope="module")
def fixtures(tmp_path_factory):
    rng = np.random.RandomState(0)
    root = tmp_path_factory.mktemp("prep")
    images = root / "images"
    images.mkdir()
    for i in range(100):
        (images / f"{i:06d}.jpg").write_bytes(rng.bytes(64))
    kp = root / "keypoints"
    kp.mkdir()
    for i in range(6):
        people = []
        for _ in range(i % 3):          # 0, 1 or 2 people
            flat = np.stack([rng.uniform(100, 1100, 25),
                             rng.uniform(50, 650, 25),
                             rng.uniform(0, 1, 25)], 1)
            flat[rng.rand(25) < 0.2, 2] = 0.0
            people.append({"pose_keypoints_2d": flat.ravel().tolist()})
        name = (f"video_{5 - i:012d}_keypoints.json" if i % 2
                else f"video_{5 - i:012d}.json")
        (kp / name).write_text(json.dumps({"version": 1.3,
                                           "people": people}))
    lines = ["# Image list with two lines of data per image:",
             "#   IMAGE_ID, QW, QX, QY, QZ, TX, TY, TZ, CAMERA_ID, NAME",
             "#   POINTS2D[] as (X, Y, POINT3D_ID)",
             "# Number of images: 4, mean observations per image: 2"]
    for i, name in enumerate(["000003.jpg", "000001.jpg", "000002.jpg",
                              "000000.jpg"]):
        q = rng.randn(4)
        q /= np.linalg.norm(q)
        t = rng.randn(3)
        lines.append(" ".join([str(i + 1)] + [repr(float(v)) for v in q]
                              + [repr(float(v)) for v in t] + ["1", name]))
        lines.append("12.5 30.25 7 100.0 8.0 -1")
    (root / "images.txt").write_text("\n".join(lines) + "\n")
    pts = ["# 3D point list with one line of data per point:",
           "#   POINT3D_ID, X, Y, Z, R, G, B, ERROR, TRACK[]"]
    for i in range(50):
        x, y, z = rng.randn(3)
        pts.append(f"{i} {x} {y} {z} 10 20 30 0.5 1 2 3 4")
    (root / "points3D.txt").write_text("\n".join(pts) + "\n")
    res = root / "smplifyx" / "results"
    for i in range(4):
        d = res / f"{i:04d}"
        d.mkdir(parents=True)
        with open(d / "000.pkl", "wb") as f:
            pickle.dump({"transl": rng.randn(1, 3).astype(np.float32)}, f)
    return root


def test_split(fixtures, tmp_path, capsys):
    (rj, oj, _), (rt, ot, _) = _both(
        tmp_path, ["split", str(fixtures / "images"), "--out", "{out}",
                   "--name", "clip", "--clip-len", "30"])
    assert rj == rt == 0
    assert _tree(oj) == _tree(ot) and len(_tree(ot)) == 90


def test_openpose_cmd(tmp_path, capsys):
    for extra in ([], ["--video-out", "o.avi", "--binary", "op.bin"]):
        (rj, _, cj), (rt, _, ct) = _both(
            tmp_path, ["openpose-cmd", "in.mp4", "--json-out", "js"] + extra,
            capsys)
        assert rj == rt == 0 and cj.out == ct.out and "--hand" in ct.out


def test_rename_and_filter(fixtures, tmp_path):
    (rj, oj, _), (rt, ot, _) = _both(
        tmp_path, ["rename", str(fixtures / "keypoints"), "--out", "{out}"])
    assert rj == rt == 0
    assert _tree(oj) == _tree(ot) and len(_tree(ot)) == 3
    for first in ([], ["--first"]):
        sub = tmp_path / f"filter{len(first)}"
        (rj, oj, _), (rt, ot, _) = _both(
            sub, ["filter", str(fixtures / "keypoints"), "--out", "{out}"]
            + first)
        assert rj == rt == 0
        assert _tree(oj) == _tree(ot) and len(_tree(ot)) == 6


def test_masks_equal_pixel_for_pixel(fixtures, tmp_path):
    (rj, oj, _), (rt, ot, _) = _both(
        tmp_path, ["masks", str(fixtures / "keypoints"), "--out", "{out}",
                   "--width", "320", "--height", "180"])
    assert rj == rt == 0
    names = sorted(os.listdir(oj))
    assert names == sorted(os.listdir(ot)) and len(names) == 6
    for n in names:
        want = cv2.imread(os.path.join(oj, n), cv2.IMREAD_UNCHANGED)
        got = cv2.imread(os.path.join(ot, n), cv2.IMREAD_UNCHANGED)
        assert got.shape == (180, 320) and got.dtype == np.uint8
        np.testing.assert_array_equal(got, want)
    assert any((cv2.imread(os.path.join(ot, n), 0) == 0).any()
               for n in names)


@pytest.mark.parametrize("cmd,src", [("pairs", "images"),
                                     ("campose", "images.txt"),
                                     ("cloud", "points3D.txt")])
def test_text_outputs_byte_for_byte(fixtures, tmp_path, cmd, src):
    (rj, oj, _), (rt, ot, _) = _both(
        tmp_path, [cmd, str(fixtures / src), "--out", "{out}"])
    assert rj == rt == 0
    with open(oj, "rb") as a, open(ot, "rb") as b:
        want, got = a.read(), b.read()
    assert got == want and len(got.splitlines()) > 3


def test_flatten(fixtures, tmp_path):
    (rj, oj, _), (rt, ot, _) = _both(
        tmp_path, ["flatten", str(fixtures / "smplifyx"), "--out", "{out}"])
    assert rj == rt == 0
    assert _tree(oj) == _tree(ot) and len(_tree(ot)) == 4


class _Recorder:
    """Stands in for subprocess.run: records each argv and answers with
    the returncode (and stdout) a callback picks."""

    def __init__(self, rc=lambda argv: 0, stdout=""):
        self.calls, self.rc, self.stdout = [], rc, stdout
        self.lock = threading.Lock()

    def __call__(self, argv, capture_output=False, text=False):
        with self.lock:
            self.calls.append(list(argv))
        return subprocess.CompletedProcess(argv, self.rc(argv),
                                           stdout=self.stdout, stderr="e")


def _record(monkeypatch, fn_ref, fn_port, rec_kw=None):
    """Call both with subprocess.run recorded; returns both results and
    argv lists."""
    out = []
    for fn in (fn_ref, fn_port):
        rec = _Recorder(**(rec_kw or {}))
        monkeypatch.setattr(subprocess, "run", rec)
        out.append((fn(), rec.calls))
        monkeypatch.undo()
    return out


def test_ffmpeg_wrappers_pass_the_same_argv(monkeypatch, tmp_path):
    out = str(tmp_path / "f")
    for name, args in (
            ("extract_frames", ("v.mp4", out)),
            ("extract_frames", ("v.mp4", out, 15, (640, 360), 3)),
            ("recode_fps", ("v.mp4", "o.mp4", 10)),
            ("probe_size", ("v.mp4",))):
        (rj, cj), (rt, ct) = _record(
            monkeypatch, lambda: getattr(JVID, name)(*args),
            lambda: getattr(TVID, name)(*args),
            {"stdout": "1280,720\n"})
        assert ct == cj and len(ct) >= 1 and rt == rj, name
    (rj, _), (rt, _) = _record(monkeypatch, lambda: JVID.probe_size("v"),
                               lambda: TVID.probe_size("v"),
                               {"rc": lambda a: int(a[1] != "-version")})
    assert rj is None and rt is None
    assert TVID.openpose_command("b", "v", "j", "o", face=False) == \
        JVID.openpose_command("b", "v", "j", "o", face=False)


def test_dump_cli_and_parallel_order(monkeypatch, tmp_path, capsys):
    """The port's dump runs the argv the reference's extract_frames
    builds for each video (the reference's joblib workers run in other
    processes, out of the recorder's reach), exits 1 when one fails and
    0 when none does; results keep the input order."""
    vids = [f"/data/clip{i}.mp4" for i in range(5)]
    out = tmp_path / "d"
    rec = _Recorder()
    monkeypatch.setattr(subprocess, "run", rec)
    for v in vids:
        JVID.extract_frames(v, str(out / v[6:11] / "images"), fps=25)
    want = sorted(map(tuple, rec.calls))
    args = ["dump"] + vids + ["--out", str(out), "--fps", "25", "--jobs",
                              "3"]
    for fails, rc in (("clip3", 1), ("none", 0)):
        rec = _Recorder(rc=lambda argv: int(fails in argv[3]))
        monkeypatch.setattr(subprocess, "run", rec)
        assert TPREP.main(args) == rc
        assert sorted(map(tuple, rec.calls)) == want
    assert "ffmpeg failed: e" in capsys.readouterr().err

    def slow(argv):             # later videos finish first
        time.sleep(0.02 * (5 - int(argv[3][-5])))
        return int(argv[3][-5]) % 2

    rec = _Recorder(rc=slow)
    monkeypatch.setattr(subprocess, "run", rec)
    res = TVID.extract_frames_parallel(vids, str(tmp_path / "p"), n_jobs=5)
    assert [ok for ok, _ in res] == [True, False, True, False, True]
    res = TVID.extract_frames_parallel(vids, str(tmp_path / "p"), n_jobs=-1)
    assert [ok for ok, _ in res] == [True, False, True, False, True]


def test_missing_ffmpeg_and_cv2_exit_1(fixtures, tmp_path, capsys,
                                       monkeypatch):
    """Here ffmpeg is absent: dump and recode exit 1 naming it. pack
    runs with cv2 (exit 0, a video written) and, with cv2 blocked,
    exits 1 naming it."""
    assert TPREP.main(["dump", "v.mp4", "--out", str(tmp_path / "d")]) == 1
    assert "ffmpeg" in capsys.readouterr().err
    assert TPREP.main(["recode", "v.mp4", "--out", "o.mp4"]) == 1
    assert "ffmpeg" in capsys.readouterr().err
    assert JPREP.main(["recode", "v.mp4", "--out", "o.mp4"]) == 1
    frames = tmp_path / "frames"
    frames.mkdir()
    for i in range(3):
        cv2.imwrite(str(frames / f"{i:04d}.png"),
                    np.full((24, 32, 3), 40 * i, np.uint8))
    for name, main in (("ref", JPREP.main), ("port", TPREP.main)):
        out = tmp_path / f"{name}.avi"
        assert main(["pack", str(frames), "--out", str(out)]) == 0
        assert out.stat().st_size > 0
    monkeypatch.setitem(sys.modules, "cv2", None)
    assert TPREP.main(["pack", str(frames), "--out",
                       str(tmp_path / "x.avi")]) == 1
    assert "cv2" in capsys.readouterr().err
    assert not (tmp_path / "x.avi").exists()
    with pytest.raises(ImportError, match="cv2"):
        TVID.pack_frames_to_video(str(frames), str(tmp_path / "y.avi"))


def test_bad_subcommand_exits_2():
    for main in (JPREP.main, TPREP.main):
        with pytest.raises(SystemExit) as e:
            main(["nope"])
        assert e.value.code == 2
