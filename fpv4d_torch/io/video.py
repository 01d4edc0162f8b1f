"""Host-side video and frame helpers (port of fpv4d/io/video.py).

ffmpeg/ffprobe subprocess wrappers for frame extraction and recode,
clip segmentation into fixed-length "subatom" folders, and
frames -> video packing with OpenCV. These are data-prep utilities on
the host; ffmpeg failures, a missing binary included, return status
tuples. Packing imports cv2 when it runs and raises ImportError, naming
it, where OpenCV is not installed.
"""
from __future__ import annotations

import glob
import os
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Sequence, Tuple

DEFAULT_FPS = 30
DEFAULT_SIZE = (1280, 720)
CLIP_LEN = 300    # frames per subatom clip


def _run(cmd: Sequence[str]) -> Tuple[bool, str]:
    try:
        res = subprocess.run(list(cmd), capture_output=True, text=True)
        return res.returncode == 0, res.stderr[-2000:]
    except FileNotFoundError as e:
        return False, str(e)


def probe_size(video: str) -> Optional[Tuple[int, int]]:
    """ffprobe width,height of the first video stream."""
    ok, _ = _run(["ffprobe", "-version"])
    if not ok:
        return None
    res = subprocess.run(
        ["ffprobe", "-v", "error", "-select_streams", "v:0",
         "-show_entries", "stream=width,height", "-of", "csv=p=0", video],
        capture_output=True, text=True)
    if res.returncode != 0:
        return None
    try:
        w, h = res.stdout.strip().split(",")[:2]
        return int(w), int(h)
    except ValueError:
        return None


def extract_frames(video: str, out_dir: str, fps: int = DEFAULT_FPS,
                   size: Tuple[int, int] = DEFAULT_SIZE,
                   quality: int = 1) -> Tuple[bool, str]:
    """ffmpeg frame dump: -r fps -q:v quality -s WxH out/%06d.jpg
    (defaults: 1280x720 @ 30 fps)."""
    os.makedirs(out_dir, exist_ok=True)
    return _run(["ffmpeg", "-y", "-i", video, "-r", str(fps),
                 "-q:v", str(quality), "-s", f"{size[0]}x{size[1]}",
                 os.path.join(out_dir, "%06d.jpg")])


def extract_frames_parallel(videos: Sequence[str], out_root: str,
                            n_jobs: int = 4, **kw) -> List[Tuple[bool, str]]:
    """Frame dumps of several videos on n_jobs threads (each waits on
    its ffmpeg process), results in input order. n_jobs < 0 counts
    from the number of CPUs, as joblib does (-1: all of them)."""
    def one(v):
        name = os.path.splitext(os.path.basename(v))[0]
        return extract_frames(v, os.path.join(out_root, name, "images"),
                              **kw)
    if n_jobs < 0:
        n_jobs = max(1, (os.cpu_count() or 1) + 1 + n_jobs)
    with ThreadPoolExecutor(max_workers=max(1, n_jobs)) as pool:
        return list(pool.map(one, videos))


def recode_fps(video: str, out_path: str, fps: int = DEFAULT_FPS
               ) -> Tuple[bool, str]:
    """fps recode with ffmpeg."""
    return _run(["ffmpeg", "-y", "-i", video, "-r", str(fps), out_path])


def split_frames(images_dir: str, out_root: str, clip_name: str,
                 clip_len: int = CLIP_LEN) -> List[str]:
    """Segment a frame folder into floor(N/clip_len) clips named
    <clip_name>-<i>, dropping (N mod clip_len)/2 frames from each end
    (centered). Returns clip dirs."""
    frames = sorted(glob.glob(os.path.join(images_dir, "*.jpg"))) or \
        sorted(glob.glob(os.path.join(images_dir, "*.png")))
    n = len(frames)
    num_clips = n // clip_len
    out = []
    if num_clips == 0:
        return out
    start = (n - num_clips * clip_len) // 2
    for c in range(num_clips):
        clip_dir = os.path.join(out_root, f"{clip_name}-{c}", "images")
        os.makedirs(clip_dir, exist_ok=True)
        for j in range(clip_len):
            src = frames[start + c * clip_len + j]
            dst = os.path.join(clip_dir, f"{j:06d}" +
                               os.path.splitext(src)[1])
            shutil.copyfile(src, dst)
        out.append(os.path.dirname(clip_dir))
    return out


def pack_frames_to_video(images_dir: str, out_path: str,
                         fps: int = DEFAULT_FPS,
                         pattern: str = "*.png") -> Tuple[bool, str]:
    """Frames -> .mp4/.avi via OpenCV at `fps` (30 by default). Raises
    ImportError, naming cv2, where OpenCV is not installed."""
    try:
        import cv2
    except ImportError as e:
        raise ImportError("packing frames into a video needs OpenCV "
                          "(cv2), which is not installed") from e
    frames = sorted(glob.glob(os.path.join(images_dir, pattern)))
    if not frames:
        frames = sorted(glob.glob(os.path.join(images_dir, "*.jpg")))
    if not frames:
        return False, f"no frames in {images_dir}"
    first = cv2.imread(frames[0])
    h, w = first.shape[:2]
    fourcc = cv2.VideoWriter_fourcc(*("DIVX" if out_path.endswith(".avi")
                                      else "mp4v"))
    vw = cv2.VideoWriter(out_path, fourcc, fps, (w, h))
    for fpath in frames:
        img = cv2.imread(fpath)
        if img is not None:
            vw.write(img)
    vw.release()
    return True, ""


def openpose_command(binary: str, video: str, out_json_dir: str,
                     out_video: Optional[str] = None,
                     face: bool = True, hand: bool = True) -> List[str]:
    """Build the OpenPose binary command line the pipeline invokes
    out-of-band (flags --video --face --hand --write_json
    --write_video)."""
    cmd = [binary, "--video", video, "--write_json", out_json_dir]
    if face:
        cmd.append("--face")
    if hand:
        cmd.append("--hand")
    if out_video:
        cmd += ["--write_video", out_video]
    return cmd
