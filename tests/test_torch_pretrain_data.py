"""The port's host-side pretraining data path against the JAX package's, on
the CPU: the tokenizer's pretrain-mlm and clean pretrain rows, the
per-row SMTP masking, packing (greedy and block-aligned), the loader's
packed batches with and without its worker pool, the tokens-per-sample
estimate, the tokenization inspection, the throughput columns, and the two
repairs of the dataset and tokenizer a pretrain config builds. These are
numpy code on both sides, so the results must be equal bit for bit.

Both packages walk in C++ by default; here both are held to the numpy
walk (`euler._NATIVE_CHECKED = True`, `_NATIVE = None` in each package's
`data/euler.py`; the port's loader passes that on to its spawned workers).
`tests/test_torch_readers.py` holds the two default (C++) walks against
each other.
"""

import numpy as np
import pytest

from graphgpt_tpu import config as jconfig
from graphgpt_tpu.data import collator as jcollator
from graphgpt_tpu.data import datasets as jdatasets
from graphgpt_tpu.data import euler as jeuler
from graphgpt_tpu.data import loader as jloader
from graphgpt_tpu.data import tokenizer as jtok
from graphgpt_tpu.data import vocab as jvocab
from graphgpt_tpu.training import pipeline as jpipeline
from graphgpt_tpu.utils import inspection as jinspection
from graphgpt_tpu.utils import logging as jlogging
from graphgpt_torch import config as tconfig
from graphgpt_torch.data import collator as tcollator
from graphgpt_torch.data import datasets as tdatasets
from graphgpt_torch.data import euler as teuler
from graphgpt_torch.data import loader as tloader
from graphgpt_torch.data import tokenizer as ttok
from graphgpt_torch.data import vocab as tvocab
from graphgpt_torch.training import pipeline as tpipeline
from graphgpt_torch.utils import inspection as tinspection
from graphgpt_torch.utils import logging as tlogging

# (name, fixed_ratio, power, mtp, dlm_wgt): the default schedule, a fixed
# ratio with random replacement, a cosine one without the dLM weight
SCHEDULES = {
    "polynomial": ("polynomial", 0.7, 1.0, (1.0, 0.0, 0.0), True),
    "fixed-random": ("fixed", 0.3, 1.0, (0.8, 0.1, 0.1), True),
    "cosine": ("cosine", 0.7, 2.0, (1.0, 0.0, 0.0), False),
}


@pytest.fixture(autouse=True)
def numpy_walk(monkeypatch):
    monkeypatch.setattr(jeuler, "_NATIVE_CHECKED", True)
    monkeypatch.setattr(jeuler, "_NATIVE", None)
    monkeypatch.setattr(teuler, "_NATIVE_CHECKED", True)
    monkeypatch.setattr(teuler, "_NATIVE", None)


def _tok_cfgs():
    cfgs = []
    for mod in (tconfig, jconfig):
        cfg = mod.TokenizationConfig()
        cfg.semantics.node.discrete, cfg.semantics.node.dim = "node_attr", 9
        cfg.semantics.edge.discrete, cfg.semantics.edge.dim = "edge_attr", 3
        cfgs.append(cfg)
    node = [np.arange(c) for c in tdatasets.MOL_NODE_CARD]
    edge = [np.arange(c) for c in tdatasets.MOL_EDGE_CARD]
    vocab = tvocab.build_vocab(cfgs[0], node, edge)
    assert vocab == jvocab.build_vocab(cfgs[1], node, edge)
    return cfgs[0], cfgs[1], tvocab.vocab_map_from_list(vocab)


def _schedules(name):
    kind, ratio, power, mtp, wgt = SCHEDULES[name]
    return tuple(mod.MlmScheduleConfig(name=kind, fixed_ratio=ratio, power=power, mtp=mtp,
                                       dlm_wgt=wgt) for mod in (tconfig, jconfig))


def _tokenizers(task, schedule="polynomial"):
    cfg, jcfg, vm = _tok_cfgs()
    tm, jm = _schedules(schedule)
    return (ttok.StackedGSTTokenizer(cfg, vm, task_type=task, mlm_cfg=tm),
            jtok.StackedGSTTokenizer(jcfg, vm, task_type=task, mlm_cfg=jm))


def _assert_same_sample(got, want):
    for key in ("input_ids", "labels", "position_ids", "attention_mask"):
        a, b = getattr(got, key), getattr(want, key)
        assert a.dtype == b.dtype, key
        np.testing.assert_array_equal(a, b, err_msg=key)
    assert got.wgt == want.wgt
    assert list(got.segment_lengths) == list(want.segment_lengths)


@pytest.mark.parametrize("schedule", sorted(SCHEDULES))
@pytest.mark.parametrize("task", ["pretrain-mlm", "pretrain"])
def test_pretrain_rows_equal_jax_bit_for_bit(task, schedule):
    """The rows of 24 molecules, each tokenized with the same seeded rng on
    both sides: the walk, the ranks, the mask ratio, the chosen cells and
    the random replacements are drawn in the same order."""
    port, ref = _tokenizers(task, schedule)
    ds = tdatasets.SyntheticMolDataset(64, seed=3)
    for i in range(24):
        got = port(ds[i], np.random.default_rng((7, i)))
        want = ref(ds[i], np.random.default_rng((7, i)))
        _assert_same_sample(got, want)
        # pretrain rows keep the eos row (masked or not)
        assert got.input_ids[-1, 0] in (port.eos_id, port.mask_id)
        assert not got.extras and not want.extras


@pytest.mark.parametrize("schedule", sorted(SCHEDULES))
def test_mask_packed_row_equals_jax(schedule):
    """One mask-ratio draw per packed row of clean ids; padding gets no label."""
    port, ref = _tokenizers("pretrain")
    ds = tdatasets.SyntheticMolDataset(64, seed=4)
    samples = [port(ds[i], np.random.default_rng(i)) for i in range(12)]
    row = next(tcollator.pack_samples(iter(samples), 256, block=64))
    jrow = next(jcollator.pack_samples(iter(samples), 256, block=64))
    tm, jm = _schedules(schedule)
    got = ttok.mask_packed_row(row, port.mask_id, tm, np.random.default_rng(1), port.vocab_size)
    want = jtok.mask_packed_row(jrow, ref.mask_id, jm, np.random.default_rng(1), ref.vocab_size)
    _assert_same_sample(got, want)
    pad = row.input_ids[:, 0] == ttok.PAD_ID
    assert pad.any() and np.all(got.labels[pad] == -100)


@pytest.mark.parametrize("block", [0, 64], ids=["greedy", "block64"])
def test_pack_samples_equal_jax_bit_for_bit(block):
    """Rows of exactly 256 tokens: ids, labels, positions, segment lengths
    (negative entries are padding gaps of the block-aligned packing) and the
    mean dLM weight; then the collated segment ids."""
    port, _ = _tokenizers("pretrain-mlm")
    ds = tdatasets.SyntheticMolDataset(200, seed=5)
    samples = [port(ds[i], np.random.default_rng(i)) for i in range(120)]
    got = list(tcollator.pack_samples(iter(samples), 256, block=block))
    want = list(jcollator.pack_samples(iter(samples), 256, block=block))
    assert len(got) == len(want) > 5
    for g, w in zip(got, want):
        _assert_same_sample(g, w)
    if block:
        assert any(n < 0 for g in got for n in g.segment_lengths)  # padding gaps
    tb = tcollator.collate(got[:4], mpe=256, fixed_length=256)
    jb = jcollator.collate(want[:4], mpe=256, fixed_length=256)
    for key in jb.keys():
        np.testing.assert_array_equal(tb[key], jb[key], err_msg=key)


def test_a_sample_longer_than_a_block_is_truncated_with_a_warning():
    """As in the JAX package: the head of the sample, one block long."""
    port, _ = _tokenizers("pretrain")
    ds = tdatasets.SyntheticMolDataset(64, seed=6, min_nodes=30, max_nodes=32)
    samples = [port(ds[i], np.random.default_rng(i)) for i in range(4)]
    assert max(s.seq_len for s in samples) > 32
    with pytest.warns(UserWarning, match="head-truncated"):
        rows = list(tcollator.pack_samples(iter(samples), 64, block=32))
    with pytest.warns(UserWarning, match="head-truncated"):
        want = list(jcollator.pack_samples(iter(samples), 64, block=32))
    for g, w in zip(rows, want):
        _assert_same_sample(g, w)
    assert all(0 < abs(n) <= 32 for g in rows for n in g.segment_lengths)


def _loaders(num_workers, block=0, after_pack=False):
    task = "pretrain" if after_pack else "pretrain-mlm"
    port_tok, ref_tok = _tokenizers(task)
    tm, jm = _schedules("polynomial")
    kw = dict(batch_size=3, mpe=128, pack=True, bucket=8, seed=5, pack_block=block)

    def post(mod, mlm):
        return lambda s, rng: mod.mask_packed_row(s, port_tok.mask_id, mlm, rng,
                                                  port_tok.vocab_size)

    port = tloader.GraphTokenLoader(
        tdatasets.SyntheticMolDataset(400, seed=11), port_tok, num_workers=num_workers,
        post_pack_fn=post(ttok, tm) if after_pack else None, **kw)
    ref = jloader.GraphTokenLoader(
        jdatasets.SyntheticMolDataset(400, seed=11), ref_tok, num_workers=0,
        post_pack_fn=post(jtok, jm) if after_pack else None, **kw)
    return port, ref


@pytest.mark.parametrize("num_workers", [0, 2])
@pytest.mark.parametrize("block,after_pack", [(0, False), (64, False), (0, True)],
                         ids=["greedy", "block64", "mask-after-pack"])
def test_loader_packed_batches_equal_jax_bit_for_bit(num_workers, block, after_pack):
    """Packed batches of 3 rows of 128 over a permutation of 200 graphs (7
    chunks of 32 for the workers, a ragged end), the last partial batch kept
    and dropped, and through the prefetch thread."""
    port, ref = _loaders(num_workers, block, after_pack)
    try:
        idx = np.random.default_rng(0).permutation(400)[:200]
        for drop_last in (True, False):
            got = list(port.epoch_batches(idx, epoch=1, drop_last=drop_last))
            want = list(ref.epoch_batches(idx, epoch=1, drop_last=drop_last))
            assert len(got) == len(want) > 5
            for g, w in zip(got, want):
                assert sorted(g.keys()) == sorted(w.keys())
                for key in w.keys():
                    assert g[key].dtype == w[key].dtype, key
                    np.testing.assert_array_equal(g[key], w[key], err_msg=key)
                assert g["input_ids"].shape[1] == 128
        fetched = list(port.prefetched(idx, epoch=1))
        assert len(fetched) == len(list(ref.epoch_batches(idx, epoch=1)))
        for g, w in zip(fetched, ref.epoch_batches(idx, epoch=1)):
            np.testing.assert_array_equal(g["input_ids"], w["input_ids"])
    finally:
        port.close()


def test_a_prefetch_left_early_stops_its_thread():
    """The pipeline leaves an epoch at its last step: the producer thread
    must end and the pool serve the next pass."""
    import threading
    import time

    port, ref = _loaders(2)
    try:
        port.start()
        before = threading.active_count()
        it = port.prefetched(np.arange(400), epoch=0)
        next(it)
        assert threading.active_count() == before + 1
        it.close()  # the producer put its end marker; wait for it to return
        deadline = time.monotonic() + 10
        while threading.active_count() > before and time.monotonic() < deadline:
            time.sleep(0.01)
        assert threading.active_count() == before
        idx = np.arange(40)
        got = list(port.epoch_batches(idx, epoch=0, drop_last=False))
        want = list(ref.epoch_batches(idx, epoch=0, drop_last=False))
        np.testing.assert_array_equal(got[-1]["input_ids"], want[-1]["input_ids"])
    finally:
        port.close()


def test_estimate_tokens_per_sample_equals_jax():
    port, ref = _tokenizers("pretrain-mlm")
    ds = tdatasets.SyntheticMolDataset(300, seed=2)
    got = tloader.estimate_tokens_per_sample(ds, port, n=64)
    assert got == jloader.estimate_tokens_per_sample(ds, ref, n=64)
    assert got == jloader.estimate_tokens_per_sample_global(ds, ref, n=64)


def test_inspection_equals_jax(capsys):
    port, ref = _tokenizers("pretrain-mlm")
    ds = tdatasets.SyntheticMolDataset(100, seed=2)
    assert tinspection.inspect_tokenization(ds, port, n_stats=16) == \
        jinspection.inspect_tokenization(ds, ref, n_stats=16)
    assert "token length over 16 samples" in capsys.readouterr().out


def test_throughput_columns_follow_jax():
    args = (86_000_000, 4096, 12, 12, 64)
    for causal in (False, True):
        assert tlogging.train_flops_per_token(*args, causal=causal) == \
            jlogging.train_flops_per_token(*args, causal=causal)
    assert tlogging.peak_flops_per_chip("NVIDIA H100 80GB HBM3") == 989e12
    assert tlogging.peak_flops_per_chip("NVIDIA H100 PCIe") == 756e12
    assert tlogging.peak_flops_per_chip("Some Other Card") == 0.0
    thr = tlogging.Throughput()
    thr.update(1000, 2)
    rates = thr.rates()
    assert set(rates) == {"tokens_per_s", "samples_per_s"} and rates["tokens_per_s"] > 0


def _pipeline_cfgs(task, **mlm):
    cfgs = []
    for mod in (tconfig, jconfig):
        cfg = mod.Config()
        cfg.tokenization.semantics.node.discrete, cfg.tokenization.semantics.node.dim = \
            "node_attr", 9
        cfg.tokenization.semantics.edge.discrete, cfg.tokenization.semantics.edge.dim = \
            "edge_attr", 3
        cfg.training.task_type = task
        for k, v in mlm.items():
            setattr(cfg.training.pretrain_mlm, k, v)
        cfgs.append(cfg)
    return cfgs


def test_build_dataset_gives_coord_tasks_positions():
    """Repair: the port built the molecules without positions for every
    task; the JAX package gives a coord task 3D positions."""
    tcfg, jcfg = _pipeline_cfgs("pretrain-coord")
    got, want = tpipeline.build_dataset(tcfg), jpipeline.build_dataset(jcfg)
    assert got.with_pos and want.with_pos
    for i in range(5):
        np.testing.assert_array_equal(got[i].pos, want[i].pos)
        np.testing.assert_array_equal(got[i].node_attr, want[i].node_attr)
    tcfg, _ = _pipeline_cfgs("pretrain-mlm")
    assert tpipeline.build_dataset(tcfg)[0].pos is None


def test_build_tokenizer_takes_the_configs_mask_schedule(tmp_path):
    """Repair: the port's tokenizer took the default SMTP schedule; the JAX
    package's takes `training.pretrain_mlm`. A fixed ratio of 0.2 with
    random replacement gives JAX's rows, and not the default's."""
    tcfg, jcfg = _pipeline_cfgs("pretrain-mlm", name="fixed", fixed_ratio=0.2,
                                mtp=(0.8, 0.1, 0.1))
    tcfg.training.output_dir = str(tmp_path / "port")
    jcfg.training.output_dir = str(tmp_path / "jax")
    ds = tpipeline.build_dataset(tcfg)
    port, ref = tpipeline.build_tokenizer(tcfg, ds), jpipeline.build_tokenizer(jcfg, ds)
    default, _ = _tokenizers("pretrain-mlm")
    differs = False
    for i in range(8):
        got = port(ds[i], np.random.default_rng(i))
        _assert_same_sample(got, ref(ds[i], np.random.default_rng(i)))
        other = default(ds[i], np.random.default_rng(i))
        differs |= not np.array_equal(got.input_ids, other.input_ids)
        cells = got.input_ids.size
        assert (got.labels != -100).sum() == int(np.ceil(cells * 0.2))
    assert differs


def test_a_token_budget_in_yaml_loads_as_a_float():
    """Repair: YAML 1.1 reads `total_tokens: 2.0e11` as a string; the JAX
    loader keeps it, and its PretrainPipeline then fails in
    compute_total_steps on every pretrain config of the repository. The
    port's loader makes it the float the field holds."""
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "configs", "pcqm4m_v2_pretrain_long.yaml")
    want, got = jconfig.load_config(path), tconfig.load_config(path)
    assert want.training.schedule.total_tokens == "2.0e11"
    with pytest.raises(TypeError):
        jpipeline.opt_lib.compute_total_steps(want.training.schedule.total_tokens,
                                              want.training.schedule.warmup_tokens, 2048.0, 128)
    assert got.training.schedule.total_tokens == 2.0e11
    assert got.training.schedule.warmup_tokens == 1.0e9
    assert tpipeline.opt_lib.compute_total_steps(
        got.training.schedule.total_tokens, got.training.schedule.warmup_tokens, 2048.0,
        128) == (762939, 3814)
