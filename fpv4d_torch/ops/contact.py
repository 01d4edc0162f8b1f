"""Contact-vertex registry (port of fpv4d/ops/contact.py): PROX
body-segment JSONs, or a synthetic registry for tests and benchmarks,
which ``write_synthetic_segments`` writes out in the segment-file
format."""
from __future__ import annotations

import json
import os
from typing import Dict, List, Sequence, Tuple

import numpy as np

from fpv4d_torch.models.smplx import synthetic_vertex_bones

CLIP_SOLVE_PARTS = ("L_Leg", "R_Leg")
ALL_PARTS = ("back", "butt", "gluteus", "L_Hand", "R_Hand", "L_Leg",
             "R_Leg", "thighs")

# PROX part name -> generating-bone joints of the synthetic model
_PART_BONES = {
    "L_Leg": (4, 7, 10), "R_Leg": (5, 8, 11),
    "thighs": (1, 2), "butt": (1, 2), "gluteus": (1, 2),
    "back": (3, 6, 9),
    "L_Hand": tuple(range(25, 40)), "R_Hand": tuple(range(40, 55)),
}


def load_contact_ids(segments_folder: str,
                     parts: Sequence[str] = ("L_Hand", "R_Hand")
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Read {part}.json files -> (vert_ids, face_ids), each a
    concatenation of the per-part deduplicated index sets."""
    verts, faces = [], []
    for part in parts:
        with open(os.path.join(segments_folder, part + ".json")) as f:
            data = json.load(f)
        verts.append(np.asarray(sorted(set(data["verts_ind"])), np.int32))
        faces.append(np.asarray(sorted(set(data["faces_ind"])), np.int32))
    return np.concatenate(verts), np.concatenate(faces)


def synthetic_segments(num_verts: int, seed: int = 0,
                       parts: Sequence[str] = ALL_PARTS,
                       coherent: bool = False, model_seed: int = 0
                       ) -> Dict[str, List[int]]:
    """Deterministic fake segment map (the same draws as the reference).

    coherent=True: ids are the synthetic model's vertices generated
    around each part's bones, so with sparse-weight models the solver's
    static FK pruning engages as on the real artifact. model_seed must
    equal the synthetic_model seed."""
    if coherent:
        bones = synthetic_vertex_bones(num_verts, seed=model_seed)
        rng = np.random.RandomState(seed)
        out = {}
        for part in parts:
            ids = np.where(np.isin(bones, _PART_BONES[part]))[0]
            keep = max(8, int(0.7 * len(ids)))
            if len(ids) > keep:
                ids = rng.choice(ids, size=keep, replace=False)
            out[part] = sorted(int(v) for v in ids)
        # dedup parts that share a bone set, in `parts` order, after
        # sampling (keeps the rng stream unchanged)
        taken: Dict[tuple, set] = {}
        for part in parts:
            seen = taken.setdefault(_PART_BONES[part], set())
            uniq = [v for v in out[part] if v not in seen]
            out[part] = uniq if uniq else out[part][:8]
            seen.update(out[part])
        return out
    rng = np.random.RandomState(seed)
    per_part = max(8, num_verts // (len(parts) * 3))
    out = {}
    for part in parts:
        ids = rng.choice(num_verts, size=per_part, replace=False)
        out[part] = sorted(int(v) for v in ids)
    return out


def write_synthetic_segments(folder: str, num_verts: int,
                             seed: int = 0) -> None:
    """Write the synthetic registry as {part}.json files in the
    reference's segment-file format (verts_ind and faces_ind)."""
    os.makedirs(folder, exist_ok=True)
    for part, ids in synthetic_segments(num_verts, seed).items():
        with open(os.path.join(folder, part + ".json"), "w") as f:
            json.dump({"verts_ind": ids, "faces_ind": ids}, f)


def contact_ids(segments_folder: str, parts: Sequence[str],
                num_verts: int, seed: int = 0) -> np.ndarray:
    """Vertex ids of the given parts; the synthetic registry when the
    folder (or a part file) is missing."""
    try:
        vids, _ = load_contact_ids(segments_folder, parts)
        return vids
    except (FileNotFoundError, TypeError):
        segs = synthetic_segments(num_verts, seed)
        return np.concatenate([np.asarray(segs[p], np.int32)
                               for p in parts])
