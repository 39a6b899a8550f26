"""3D molecular coordinate helpers (numpy, host side).

A copy of `graphgpt_tpu/data/mol3d.py`: the PCQM4M-v2 percentile ranges
(`DICT_RANGE` :20), the canonical anchor rotation (node 0 at the origin,
node 1 on +z, node 2 in the y-z plane), the random translation and
rotation, uniform discretisation (`discrete_pos`), percentile boundaries
and the binning over them (`discrete_pos_v2`), their npz cache beside a
store (`build_dict_bounds` :103-127, which the graph-level readers'
`pos_percentile_bounds` policy calls), and the position type of a
sequence slot (`pos_type_from_node_index` :139).
"""

from __future__ import annotations

import numpy as np

# PCQM4M-v2 coordinate percentile ranges after the anchor rotation
RANGE_MIN_P1P = np.asarray([-8.12, -6.57, -5.3], np.float32)
RANGE_MAX_P1P = np.asarray([7.19, 10.24, 11.93], np.float32)
RANGE_MIN_1P = np.asarray([-5.63, -4.12, -2.99], np.float32)
RANGE_MAX_1P = np.asarray([4.95, 8.24, 9.73], np.float32)
DICT_RANGE = {
    "p1p": (RANGE_MIN_P1P, RANGE_MAX_P1P),
    "1p": (RANGE_MIN_1P, RANGE_MAX_1P),
}

_EPS = 1e-12


def anchor_rotation_matrix(pos: np.ndarray) -> np.ndarray:
    """Rotation bringing node 1 onto +z and node 2 into the y-z plane;
    pos[0] must already be the origin."""
    b = pos[1, :]
    norm = max(np.sqrt(b[1] ** 2 + b[2] ** 2), _EPS)
    cos_g, sin_g = b[2] / norm, b[1] / norm
    roll = np.asarray([[1, 0, 0], [0, cos_g, -sin_g], [0, sin_g, cos_g]])
    norm = max(np.sqrt(b[0] ** 2 + b[1] ** 2 + b[2] ** 2), _EPS)
    cos_b = np.sqrt(b[1] ** 2 + b[2] ** 2) / norm
    sin_b = -b[0] / norm
    pitch = np.asarray([[cos_b, 0, sin_b], [0, 1, 0], [-sin_b, 0, cos_b]])
    rot = pitch @ roll
    if pos.shape[0] > 2:
        c = rot @ pos[2, :]
        norm = max(np.sqrt(c[0] ** 2 + c[1] ** 2), _EPS)
        cos_a, sin_a = c[1] / norm, c[0] / norm
        yaw = np.asarray([[cos_a, -sin_a, 0], [sin_a, cos_a, 0], [0, 0, 1]])
        rot = yaw @ rot
    return rot


def anchor_rotate(pos: np.ndarray) -> np.ndarray:
    """Translate node 0 to the origin, then the canonical rotation."""
    pos = pos - pos[0:1, :]
    if pos.shape[0] == 1:
        return pos.astype(np.float32)
    rot = anchor_rotation_matrix(pos)
    return (rot @ pos.T).T.astype(np.float32)


def trans_rotate_random(pos: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """Centre, then a uniformly random rotation (QR of a Gaussian matrix)."""
    pos = pos - pos.mean(axis=0, keepdims=True)
    a = rng.normal(size=(3, 3))
    q, r = np.linalg.qr(a)
    q = q * np.sign(np.diag(r))
    if np.linalg.det(q) < 0:
        q[:, 0] = -q[:, 0]
    return (q @ pos.T).T.astype(np.float32)


ROTATIONS = {
    "anchor_rotate": lambda pos, rng: anchor_rotate(pos),
    "trans_rotate": trans_rotate_random,
}


def discrete_pos(pos, num_bins: int, range_min=None, range_max=None):
    """Uniform binning into [0, num_bins)."""
    range_min = RANGE_MIN_P1P if range_min is None else np.asarray(range_min, np.float32)
    range_max = RANGE_MAX_P1P if range_max is None else np.asarray(range_max, np.float32)
    span = range_max - range_min
    bins = (np.asarray(pos, np.float32) - range_min) * ((num_bins - 1) / span)
    return np.clip(bins.astype(np.int64), 0, num_bins - 1)


def pos_percentile_boundaries(all_pos: np.ndarray, num_bins: int, eps: float = 1e-4) -> np.ndarray:
    """Percentile bin boundaries over the coordinate values with |pos| > eps,
    the outermost edges widened to +-100."""
    flat = np.asarray(all_pos, np.float32).reshape(-1)
    filtered = flat[np.abs(flat) > eps]
    if filtered.size == 0:
        filtered = np.asarray([-1.0, 1.0], np.float32)
    q = 100.0 * np.arange(num_bins + 1) / num_bins
    b = np.percentile(filtered, q).astype(np.float32)
    b[0], b[-1] = -100.0, 100.0
    return b


def build_dict_bounds(
    all_pos: np.ndarray,
    cache_dir: "str | None" = None,
    nums=(128, 256, 512, 1024),
    eps: float = 1e-4,
):
    """{num_bins: boundaries} for the reference's four bin counts, cached
    as npz next to the dataset (pcqm4mv2.py:262-266 file protocol)."""
    import os

    out = {}
    for num in nums:
        fn = (
            os.path.join(cache_dir, f"pos_{num}percentile_eps{eps}_boundaries.npz")
            if cache_dir
            else None
        )
        if fn and os.path.exists(fn):
            out[num] = np.load(fn)["boundaries"].astype(np.float32)
            continue
        b = pos_percentile_boundaries(all_pos, num, eps)
        if fn:
            np.savez(fn, boundaries=b)
        out[num] = b
    return out


def discrete_pos_v2(pos, num_bins: int, dict_bounds) -> np.ndarray:
    """Non-uniform binning by the boundaries `dict_bounds[num_bins]`: clip
    to [-99, 99], then bucketize (searchsorted, side left) minus one."""
    pos_clipped = np.clip(np.asarray(pos, np.float32), -99.0, 99.0)
    boundaries = np.asarray(dict_bounds[num_bins], np.float32)
    return np.searchsorted(boundaries, pos_clipped, side="left").astype(np.int64) - 1


def pos_type_from_node_index(raw_node_idx: np.ndarray) -> np.ndarray:
    """Position type of a sequence slot from its raw node index: 0 pad (-1),
    1 (0,0,0), 2 (0,0,z), 3 (0,y,z), 4 (x,y,z): clip(idx + 1, 0, 4)."""
    return np.clip(np.asarray(raw_node_idx) + 1, 0, 4)
