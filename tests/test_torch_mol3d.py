"""The port's numpy copy of the 3D-molecule helpers (`graphgpt_torch/data/
mol3d.py`) against `graphgpt_tpu/data/mol3d.py`, bit for bit, and the 3D
batch that the tests and `chip_smoke.py` build (`synthetic.mol3d_batch`)."""

import numpy as np
import pytest

from graphgpt_tpu.data import mol3d as jmol3d
from graphgpt_torch.data import mol3d as tmol3d
from graphgpt_torch.synthetic import mol3d_batch, mol3d_tokenizer


def _pos(seed, n=9, scale=3.0):
    return (np.random.default_rng(seed).normal(size=(n, 3)) * scale).astype(np.float32)


def test_ranges_are_the_same():
    assert set(tmol3d.DICT_RANGE) == set(jmol3d.DICT_RANGE)
    for k, (lo, hi) in tmol3d.DICT_RANGE.items():
        np.testing.assert_array_equal(lo, jmol3d.DICT_RANGE[k][0])
        np.testing.assert_array_equal(hi, jmol3d.DICT_RANGE[k][1])


@pytest.mark.parametrize("n", [1, 2, 3, 9])
def test_anchor_rotation_bit_for_bit(n):
    pos = _pos(n, n)
    np.testing.assert_array_equal(tmol3d.anchor_rotate(pos), jmol3d.anchor_rotate(pos))
    if n > 1:
        np.testing.assert_array_equal(tmol3d.anchor_rotation_matrix(pos - pos[:1]),
                                      jmol3d.anchor_rotation_matrix(pos - pos[:1]))


def test_random_rotation_bit_for_bit():
    pos = _pos(1)
    got = tmol3d.trans_rotate_random(pos, np.random.default_rng(5))
    want = jmol3d.trans_rotate_random(pos, np.random.default_rng(5))
    np.testing.assert_array_equal(got, want)
    for name in ("anchor_rotate", "trans_rotate"):
        np.testing.assert_array_equal(tmol3d.ROTATIONS[name](pos, np.random.default_rng(2)),
                                      jmol3d.ROTATIONS[name](pos, np.random.default_rng(2)))


@pytest.mark.parametrize("num_bins", [16, 256])
@pytest.mark.parametrize("rng_name", ["p1p", "1p"])
def test_discretisers_bit_for_bit(num_bins, rng_name):
    pos = _pos(3, 40, 6.0)
    lo, hi = tmol3d.DICT_RANGE[rng_name]
    np.testing.assert_array_equal(tmol3d.discrete_pos(pos, num_bins, lo, hi),
                                  jmol3d.discrete_pos(pos, num_bins, lo, hi))
    np.testing.assert_array_equal(tmol3d.discrete_pos(pos, num_bins),
                                  jmol3d.discrete_pos(pos, num_bins))
    b = tmol3d.pos_percentile_boundaries(pos, num_bins)
    np.testing.assert_array_equal(b, jmol3d.pos_percentile_boundaries(pos, num_bins))
    np.testing.assert_array_equal(tmol3d.discrete_pos_v2(pos, num_bins, {num_bins: b}),
                                  jmol3d.discrete_pos_v2(pos, num_bins, {num_bins: b}))


def test_pos_type_bit_for_bit():
    idx = np.arange(-3, 8)
    np.testing.assert_array_equal(tmol3d.pos_type_from_node_index(idx),
                                  jmol3d.pos_type_from_node_index(idx))
    assert tmol3d.pos_type_from_node_index(np.asarray([-1, 0, 1, 2, 3, 9])).tolist() == [
        0, 1, 2, 3, 4, 4]


@pytest.mark.parametrize("bi_split", [0, 16])
def test_mol3d_batch_layout(bi_split):
    tok = mol3d_tokenizer()
    assert (tok.vocab_size, tok.stacked_feat) == (755, 13)
    b, p = 6, 88 if bi_split else 72
    nb = mol3d_batch(b, p, seed=3, bi_split=bi_split, tokenizer=tok)
    assert nb["input_ids"].shape == (b, p, 13) and nb["pos"].shape == (b, p, 3)
    assert nb["graph_labels"].shape == (b, 1)
    lo, hi = tmol3d.DICT_RANGE["p1p"]
    assert np.all(nb["pos"] >= lo) and np.all(nb["pos"] <= hi)
    room = p - bi_split
    for r in range(b):
        seg = nb["segment_ids"][r]
        n = int(seg[:room].sum())
        assert np.all(seg[:n] == 1) and np.all(seg[n:room] == 0)  # molecule, then padding
        # node decoration: raw index + 1, pos_type from the raw index
        raw = nb["node_idx"][r, :n] - 1
        np.testing.assert_array_equal(nb["pos_type"][r, :n],
                                      tmol3d.pos_type_from_node_index(raw))
        assert (raw == 0).any() and np.all(nb["pos"][r, :n][raw == 0] == 0)  # node 0: origin
        assert np.all(nb["pos"][r, :n][raw < 0] == 0)  # the eos row has none
        assert np.all(nb["node_idx"][r, n:] == 0) and np.all(nb["pos_type"][r, n:] == 0)
        if bi_split:
            assert np.all(seg[room:] == 1)
            assert np.all(nb["input_ids"][r, room:] == tok.mask_id)
            np.testing.assert_array_equal(nb["position_ids"][r, room:], np.arange(n, n + 16))
        else:
            assert np.all(nb["input_ids"][r, n:] == 0)
