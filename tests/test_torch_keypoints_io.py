"""The port's copy of the OpenPose keypoint I/O (fpv4d_torch/io/keypoints.py)
and the keypoint-fit / smoother pkl writers (save_clip(extra=),
save_smoothed) against the JAX package's, on JSON fixtures written here:
every result equal, every pkl equal key by key."""
import json
import os

import numpy as np
import pytest

from fpv4d.io import body_pkl as JBP
from fpv4d.io import keypoints as JK
from fpv4d_torch.io import body_pkl as TBP
from fpv4d_torch.io import keypoints as TK


def _person(rng, hands=True, face=True, scale=1.0):
    p = {"pose_keypoints_2d": (rng.rand(25, 3) * scale).ravel().tolist()}
    if hands:
        p["hand_left_keypoints_2d"] = rng.rand(21, 3).ravel().tolist()
        p["hand_right_keypoints_2d"] = rng.rand(21, 3).ravel().tolist()
    if face:
        p["face_keypoints_2d"] = rng.rand(70, 3).ravel().tolist()
    return p


@pytest.fixture()
def folder(tmp_path):
    """OpenPose-named JSONs: two people (the second more confident), one
    person without hands or face, an empty detection, an empty hand
    list."""
    rng = np.random.RandomState(0)
    d = tmp_path / "op"
    d.mkdir()
    frames = [
        {"people": [_person(rng), _person(rng, scale=3.0)]},
        {"people": [_person(rng, hands=False, face=False)]},
        {"people": []},
        {"people": [dict(_person(rng), hand_left_keypoints_2d=[])]},
    ]
    for i, data in enumerate(frames):
        with open(d / f"clip_{i:012d}_keypoints.json", "w") as f:
            json.dump(data, f)
    return d


def _equal_dicts(a, b):
    assert (a is None) == (b is None)
    if a is None:
        return
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_read_and_select_match_reference(folder):
    for path in sorted(folder.glob("*.json")):
        _equal_dicts(TK.read_keypoints(str(path)),
                     JK.read_keypoints(str(path)))
        assert TK.most_confident_person(str(path)) == \
            JK.most_confident_person(str(path))
    rng = np.random.RandomState(1)
    person = _person(rng, face=False)
    _equal_dicts(TK.parse_person(person), JK.parse_person(person))


@pytest.mark.parametrize("best", [True, False])
def test_filter_single_person_matches_reference(folder, tmp_path, best):
    src = str(sorted(folder.glob("*.json"))[0])
    TK.filter_single_person(src, str(tmp_path / "t.json"), best=best)
    JK.filter_single_person(src, str(tmp_path / "j.json"), best=best)
    assert (tmp_path / "t.json").read_bytes() == \
        (tmp_path / "j.json").read_bytes()


def test_rename_and_load_clip_match_reference(folder, tmp_path):
    t = TK.rename_for_smplifyx(str(folder), str(tmp_path / "t"))
    j = JK.rename_for_smplifyx(str(folder), str(tmp_path / "j"))
    assert [os.path.basename(p) for p in t] == \
        [os.path.basename(p) for p in j] == \
        [f"{i:06d}_keypoints.json" for i in range(4)]
    for a, b in zip(t, j):
        assert open(a, "rb").read() == open(b, "rb").read()
    kp_t = TK.load_clip_keypoints(str(tmp_path / "t"))
    np.testing.assert_array_equal(kp_t, JK.load_clip_keypoints(
        str(tmp_path / "j")))
    assert kp_t.shape == (4, 25, 3) and kp_t[2].max() == 0.0
    _equal_dicts(TK.load_clip_keypoints_full(str(tmp_path / "t")),
                 JK.load_clip_keypoints_full(str(tmp_path / "j")))
    (tmp_path / "none").mkdir()
    np.testing.assert_array_equal(
        TK.load_clip_keypoints(str(tmp_path / "none")),
        JK.load_clip_keypoints(str(tmp_path / "none")))
    _equal_dicts(TK.load_clip_keypoints_full(str(tmp_path / "none")),
                 JK.load_clip_keypoints_full(str(tmp_path / "none")))


def test_human_bbox_mask_matches_reference(folder):
    kp = TK.read_keypoints(str(sorted(folder.glob("*.json"))[0]))["pose"]
    kp = kp * np.array([700.0, 400.0, 1.0], np.float32)
    for k, margins in ((kp, (0.95, 0.8, 1.05, 1.2)), (kp, (1, 1, 1, 1)),
                       (kp * np.array([1, 1, 0], np.float32), None)):
        args = (k, 360, 640) if margins is None else (k, 360, 640, margins)
        np.testing.assert_array_equal(TK.human_bbox_mask(*args),
                                      JK.human_bbox_mask(*args))


def test_save_clip_extra_and_save_smoothed_match_reference(tmp_path):
    rng = np.random.RandomState(2)
    body = rng.randn(3, 75).astype(np.float32)
    extra = {"jaw_pose": rng.randn(3, 3).astype(np.float32),
             "expression": rng.randn(3, 10).astype(np.float32)}
    pairs = [
        (TBP.save_clip(str(tmp_path / "t" / "new"), body, extra=extra),
         JBP.save_clip(str(tmp_path / "j" / "new"), body, extra=extra)),
        (TBP.save_smoothed(str(tmp_path / "ts"), body),
         JBP.save_smoothed(str(tmp_path / "js"), body)),
    ]
    for tp, jp in pairs:
        assert [os.path.basename(p) for p in tp] == \
            [os.path.basename(p) for p in jp]
        for a, b in zip(tp, jp):
            da, db = TBP.load_frame(a), JBP.load_frame(b)
            assert da.keys() == db.keys()
            for k in da:
                assert np.asarray(da[k]).dtype == np.asarray(db[k]).dtype
                np.testing.assert_array_equal(da[k], db[k], err_msg=k)
    assert sorted(os.listdir(tmp_path / "ts")) == ["smoothed_body"]
    assert sorted(os.listdir(tmp_path / "ts" / "smoothed_body")) == [
        "000000.pkl", "000001.pkl", "000002.pkl"]
    np.testing.assert_array_equal(
        TBP.load_clip(str(tmp_path / "ts" / "smoothed_body")), body)
