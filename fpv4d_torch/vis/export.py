"""Rendered-frame -> video export (port of fpv4d/vis/export.py: the
30 fps repack of the vis PNG folders)."""
from __future__ import annotations

from typing import Optional, Tuple

from fpv4d_torch.io.video import pack_frames_to_video


def pack_vis_outputs(vis_dir: str, out_path: Optional[str] = None,
                     fps: int = 30) -> Tuple[bool, str]:
    """Pack a rendered-frames folder into a video (mp4 by extension,
    avi for DIVX). Needs OpenCV: raises ImportError without cv2."""
    out_path = out_path or (vis_dir.rstrip("/") + ".mp4")
    return pack_frames_to_video(vis_dir, out_path, fps=fps)
