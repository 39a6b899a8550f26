"""How the kernel wrappers hand fp32 tensors to the fp32 forms of every
kernel (#1-#13), on the CPU.

The card is stood in for: `use_kernel` says yes, and `_build.entry`,
`_build.ptr` and `_build.stream_ptr` record which C entry was asked for and
which tensors it was given, launching nothing. Each wrapper must send fp32
to its `_f32` entry (counting a launch of the fp32 form, none of the bf16
one) with fp32 RoPE tables equal to the caller's (a bf16 rounding costs
~1e-3, far past the fp32 forms' 2e-5), bf16 to the entry it always took,
and refuse any other dtype, and a mix, before it launches. The numbers
themselves are held on the card (`tests/test_torch_gpu.py`, the fp32 tests
at its end, and `chip_smoke.py`'s phases L, N, O and P). Small fp32 models,
one with LayerScale and DropPath, a bi-causal denoiser, one past 2,048
positions and under GGT_FLASH_MODE=skip (the streamed route), and one under
GGT_FLASH_MODE=band and GGT_ATTN_NORM_FUSE=1 (the band kernels and the
norm-fused q/k/v), train a step under the stand-in card and ask for the
fp32 entries only.
"""

import ctypes

import numpy as np
import pytest
import torch

from graphgpt_torch.models.rope import rope_cos_sin
from graphgpt_torch.ops import _build
from graphgpt_torch.ops import flash_attention as tfa
from graphgpt_torch.ops import mlp as tmlp


class FakeCard:
    """The entries asked for, with the tensors each call handed over (and,
    in `args`, every argument of each call)."""

    def __init__(self, monkeypatch):
        self.calls = []
        self.args = []
        self._args = []
        for mod in (tfa, tmlp):
            monkeypatch.setattr(mod, "use_kernel", lambda *t: True)
        monkeypatch.setattr(tmlp, "_sm_count", lambda device: 132)

        def entry(source, symbol, argtypes):
            def fn(*args):
                self.calls.append((source, symbol, list(self._args)))
                self.args.append(args)
                self._args.clear()
                return 0

            return fn

        def ptr(t):
            self._args.append(t)
            return ctypes.c_void_p(0)

        monkeypatch.setattr(_build, "entry", entry)
        monkeypatch.setattr(_build, "ptr", ptr)
        monkeypatch.setattr(_build, "stream_ptr", lambda device: ctypes.c_void_p(0))


def _flash(dtype, b=2, p=128, h=2, dh=64, seed=0):
    rng = np.random.default_rng(seed)
    qs, k, v, do = (torch.from_numpy((rng.normal(size=(b, p, h * dh)) * 0.5).astype(np.float32))
                    .to(dtype) for _ in range(4))
    seg = torch.ones(b, p, dtype=torch.int32)
    cos, sin = rope_cos_sin(torch.arange(p).expand(b, p), dh)
    return qs, k, v, do, seg, cos, sin


@pytest.mark.parametrize("dtype,symbol,source", [
    (torch.float32, "ggt_flash_fwd_f32", "flash_bwd_split_f32"),
    (torch.bfloat16, "ggt_flash_fwd", "flash_fwd")], ids=["fp32", "bf16"])
def test_flash_fwd_sends_each_dtype_to_its_entry(monkeypatch, dtype, symbol, source):
    """fp32 reaches #1f, the split body's forward role; bf16 #1."""
    card = FakeCard(monkeypatch)
    qs, k, v, _, seg, cos, sin = _flash(dtype)
    before = (tfa.flash_fwd.launches, tfa.flash_fwd_f32.launches)
    out, lse = tfa.flash_fwd(qs, k, v, seg, cos, sin, False, 64)
    (got_source, got, tensors), = card.calls
    assert got == symbol and got_source == source
    assert out.dtype == dtype and lse.dtype == torch.float32
    fp32 = dtype == torch.float32
    assert (tfa.flash_fwd.launches - before[0], tfa.flash_fwd_f32.launches - before[1]) == (
        (0, 1) if fp32 else (1, 0))
    gcos, gsin = tensors[4], tensors[5]  # q, k, v, seg, cos, sin, out, lse
    assert gcos.dtype == gsin.dtype == dtype
    if fp32:
        assert torch.equal(gcos, cos) and torch.equal(gsin, sin)


@pytest.mark.parametrize("dtype,symbol", [(torch.float32, "ggt_flash_bwd_f32"),
                                          (torch.bfloat16, "ggt_flash_bwd")], ids=["fp32", "bf16"])
def test_flash_bwd_sends_each_dtype_to_its_entry(monkeypatch, dtype, symbol):
    card = FakeCard(monkeypatch)
    qs, k, v, do, seg, cos, sin = _flash(dtype)
    lse = torch.zeros(2, 2, 128)
    before = (tfa.flash_bwd.launches, tfa.flash_bwd_f32.launches)
    dq, dk, dv = tfa.flash_bwd(qs, k, v, seg, cos, sin, qs, lse, do, None, False, 64)
    (_, got, tensors), = card.calls
    assert got == symbol and dq.dtype == dk.dtype == dv.dtype == dtype
    fp32 = dtype == torch.float32
    assert (tfa.flash_bwd.launches - before[0], tfa.flash_bwd_f32.launches - before[1]) == (
        (0, 1) if fp32 else (1, 0))
    if fp32:
        assert torch.equal(tensors[4], cos) and torch.equal(tensors[5], sin)


def test_the_model_path_keeps_fp32_rope_tables(monkeypatch):
    """flash_attention on fp32 q, k, v (a float32 model's attention) reaches
    #1's fp32 entry with the RoPE tables as computed, unrounded."""
    card = FakeCard(monkeypatch)
    qs, k, v, _, seg, cos, sin = _flash(torch.float32)
    q4, k4, v4 = (t.view(2, 128, 2, 64) for t in (qs, k, v))
    tfa.flash_attention(q4, k4, v4, seg, rope=(cos, sin))
    (_, got, tensors), = card.calls
    assert got == "ggt_flash_fwd_f32"
    assert torch.equal(tensors[4], cos) and torch.equal(tensors[5], sin)


def test_the_flash_wrappers_refuse_other_dtypes(monkeypatch):
    card = FakeCard(monkeypatch)
    qs, k, v, do, seg, cos, sin = _flash(torch.float16)
    with pytest.raises(NotImplementedError):
        tfa.flash_fwd(qs, k, v, seg, cos, sin, False, 64)
    with pytest.raises(NotImplementedError):
        tfa.flash_bwd(qs, k, v, seg, cos, sin, qs, torch.zeros(2, 2, 128), do, None, False, 64)
    with pytest.raises(NotImplementedError):  # fp32 q beside bf16 k and v
        tfa.flash_fwd(qs.float(), k.bfloat16(), v.bfloat16(), seg, cos, sin, False, 64)
    lse = torch.zeros(2, 2, 128)
    with pytest.raises(NotImplementedError):  # the split pair: fp16, then fp32 beside bf16
        tfa.flash_bwd(qs, k, v, seg, cos, sin, qs, lse, do, None, False, 64, 16)
    with pytest.raises(NotImplementedError):
        tfa.flash_dq(qs.float(), k.bfloat16(), v.float(), seg, cos, sin, qs.float(), lse,
                     do.float(), None, False, 64, 16)
    with pytest.raises(NotImplementedError):
        tfa.flash_dkv(qs.float(), k.float(), v.float(), seg, cos, sin, lse, lse,
                      do.bfloat16(), False, 64, 16)
    with pytest.raises(NotImplementedError):  # the fp32 pair keeps the pair's P <= MAX_P
        big = torch.zeros(1, tfa.MAX_P + 64, 128)
        tfa.flash_dq(big, big, big, torch.ones(1, tfa.MAX_P + 64, dtype=torch.int32), None,
                     None, big, torch.zeros(1, 2, tfa.MAX_P + 64), big, None, False, 64, 16)
    assert card.calls == []


@pytest.mark.parametrize("dtype,source", [(torch.float32, "flash_bwd_split_f32"),
                                          (torch.bfloat16, "flash_bwd_split")],
                         ids=["fp32", "bf16"])
def test_the_split_pair_sends_each_dtype_to_its_entries(monkeypatch, dtype, source):
    """flash_bwd with a bi-causal split reaches flash_dq then flash_dkv; fp32
    goes to #4's and #5's fp32 entries (one launch of each fp32 form, none
    of the bf16 pair), which take the RoPE tables unrounded, and flash_dkv
    reads the delta that flash_dq wrote."""
    card = FakeCard(monkeypatch)
    qs, k, v, do, seg, cos, sin = _flash(dtype)
    lse = torch.zeros(2, 2, 128)
    counts = (tfa.flash_dq, tfa.flash_dkv, tfa.flash_dq_f32, tfa.flash_dkv_f32, tfa.flash_bwd,
              tfa.flash_bwd_f32)
    before = [c.launches for c in counts]
    dq, dk, dv = tfa.flash_bwd(qs, k, v, seg, cos, sin, qs, lse, do, None, False, 64, 16)
    (src_dq, sym_dq, t_dq), (src_dkv, sym_dkv, t_dkv) = card.calls
    fp32 = dtype == torch.float32
    suffix = "_f32" if fp32 else ""
    assert (src_dq, sym_dq) == (source, f"ggt_flash_dq{suffix}")
    assert (src_dkv, sym_dkv) == (source, f"ggt_flash_dkv{suffix}")
    assert dq.dtype == dk.dtype == dv.dtype == dtype
    assert [c.launches - n for c, n in zip(counts, before)] == (
        [0, 0, 1, 1, 0, 0] if fp32 else [1, 1, 0, 0, 0, 0])
    # q, k, v, seg, cos, sin, out, lse, do, delta, dq (dlse None: no pointer)
    assert t_dq[4].dtype == t_dq[5].dtype == dtype
    # q, k, v, seg, cos, sin, lse, delta, do, dk, dv
    assert t_dkv[7] is t_dq[9] and t_dkv[7].dtype == torch.float32
    if fp32:
        for t in (t_dq, t_dkv):
            assert torch.equal(t[4], cos) and torch.equal(t[5], sin)


def _mlp(dtype, n=200, d=128, f=512):
    rng = np.random.default_rng(1)

    def t(*shape):
        return torch.from_numpy((rng.normal(size=shape) * 0.05).astype(np.float32)).to(dtype)

    return t(n, d), torch.ones(d), t(f, d), t(f, d), t(d, f)


@pytest.mark.parametrize("dtype,d", [(torch.float32, 128), (torch.bfloat16, 128),
                                     (torch.float32, 1600)], ids=["fp32", "bf16", "fp32-d1600"])
def test_norm_mlp_sends_each_dtype_to_its_entry(monkeypatch, dtype, d):
    """fp32 reaches #2's fp32 entry, in one source with #11's and #12's
    fp32 forms, with the scratch of the three weights' TF32 hi and lo
    planes before g and the down stage's tile width (f32_block_n: 128, and
    64 at xxlarge's D 1600, which 128 does not divide); bf16 the entry it
    always took."""
    card = FakeCard(monkeypatch)
    x, wn, wg, wu, wd = _mlp(dtype, d=d)
    before = (tmlp.norm_mlp.launches, tmlp.norm_mlp_f32.launches)
    out = tmlp.norm_mlp(x, wn, wg, wu, wd, 1e-6, "gelu")
    (source, got, tensors), = card.calls
    fp32 = dtype == torch.float32
    assert (source, got) == (("mlp_qkv_f32", "ggt_norm_mlp_f32") if fp32
                             else ("norm_mlp", "ggt_norm_mlp"))
    assert out.dtype == dtype and out.shape == (200, d)
    g = tensors[6] if fp32 else tensors[5]  # fp32: x, wn, wg, wu, wd, planes, g, out, rrms
    assert g.dtype == dtype and g.shape == (200, 512)  # the g scratch
    if fp32:
        assert tensors[5].dtype == dtype and tensors[5].shape == (2, 3 * 512 * d)
        assert len(tensors) == 9 and len(tmlp._F32_ARGTYPES) == 16
        assert card.args[-1][12] == (128 if d == 128 else 64)  # bn, after N, D, F
    assert (tmlp.norm_mlp.launches - before[0], tmlp.norm_mlp_f32.launches - before[1]) == (
        (0, 1) if fp32 else (1, 0))


def test_norm_mlp_f32_refuses_d_past_its_norm_row(monkeypatch):
    """#2's fp32 form keeps wn's row in shared memory beside its stages, as
    #12f does: D past 4096 raises before a launch (bf16 takes up to 8192)."""
    card = FakeCard(monkeypatch)
    x, wn, wg, wu, wd = _mlp(torch.float32, n=8, d=4160, f=64)
    with pytest.raises(NotImplementedError):
        tmlp.norm_mlp(x, wn, wg, wu, wd, 1e-6, "gelu")
    assert card.calls == []
    tmlp.norm_mlp(*(t.bfloat16() if t.dim() == 2 else t for t in (x, wn, wg, wu, wd)), 1e-6,
                  "gelu")
    assert [sym for _, sym, _ in card.calls] == ["ggt_norm_mlp"]


@pytest.mark.parametrize("dtype,source", [(torch.float32, "mlp_qkv_f32"),
                                          (torch.bfloat16, "mlp")], ids=["fp32", "bf16"])
def test_mlp_sends_each_dtype_to_its_entry(monkeypatch, dtype, source):
    """fp32 reaches #11's fp32 entry, one source with #12's fp32 form, with
    the scratch of the three weights' TF32 hi and lo planes before g."""
    card = FakeCard(monkeypatch)
    x, _, wg, wu, wd = _mlp(dtype)
    before = (tmlp.mlp.launches, tmlp.mlp_f32.launches)
    out = tmlp.mlp(x, wg, wu, wd, "gelu")
    (got_source, got, tensors), = card.calls
    fp32 = dtype == torch.float32
    assert (got_source, got) == (source, "ggt_mlp_f32" if fp32 else "ggt_mlp")
    assert out.dtype == dtype and out.shape == (200, 128)
    g = tensors[5] if fp32 else tensors[4]  # fp32: x, wg, wu, wd, planes, g, out
    assert g.dtype == dtype and g.shape == (200, 512)  # the g scratch
    if fp32:
        assert tensors[4].dtype == dtype and tensors[4].shape == (2, 3 * 512 * 128)
    assert len(tmlp._MLP_F32_ARGTYPES if fp32 else tmlp._MLP_ARGTYPES) == 13
    assert (tmlp.mlp.launches - before[0], tmlp.mlp_f32.launches - before[1]) == (
        (0, 1) if fp32 else (1, 0))


def test_the_mlp_wrappers_refuse_other_dtypes(monkeypatch):
    card = FakeCard(monkeypatch)
    x, wn, wg, wu, wd = _mlp(torch.float16)
    with pytest.raises(NotImplementedError):
        tmlp.norm_mlp(x, wn, wg, wu, wd, 1e-6, "gelu")
    with pytest.raises(NotImplementedError):  # fp32 x beside bf16 weights
        tmlp.norm_mlp(x.float(), wn, wg.bfloat16(), wu.bfloat16(), wd.bfloat16(), 1e-6, "gelu")
    with pytest.raises(NotImplementedError):
        tmlp.mlp(x, wg, wu, wd, "gelu")
    with pytest.raises(NotImplementedError):  # fp32 x beside bf16 weights, and the reverse
        tmlp.mlp(x.float(), wg.bfloat16(), wu.bfloat16(), wd.bfloat16(), "gelu")
    with pytest.raises(NotImplementedError):
        tmlp.mlp(x.bfloat16(), wg.float(), wu.float(), wd.float(), "gelu")
    with pytest.raises(NotImplementedError):
        tmlp.rmsnorm_bwd(x, x, wn, 1e-6)
    with pytest.raises(NotImplementedError):  # fp32 x beside a bf16 cotangent
        tmlp.rmsnorm_bwd(x.float(), x.bfloat16(), wn, 1e-6)
    assert card.calls == []


@pytest.mark.parametrize("dtype,symbol", [(torch.float32, "ggt_rmsnorm_bwd_f32"),
                                          (torch.bfloat16, "ggt_rmsnorm_bwd")], ids=["fp32", "bf16"])
@pytest.mark.parametrize("d", [128, 768, 1600])
def test_rmsnorm_bwd_sends_each_dtype_to_its_entry(monkeypatch, dtype, symbol, d):
    """Both dtypes take the one templated source, at every hidden size the
    configs name (D 128 is toy_pretrain's)."""
    card = FakeCard(monkeypatch)
    x, _, _, _, _ = _mlp(dtype, n=64, d=d, f=64)
    before = (tmlp.rmsnorm_bwd.launches, tmlp.rmsnorm_bwd_f32.launches)
    dx, dw = tmlp.rmsnorm_bwd(x, x, torch.ones(d), 1e-6)
    (source, got, _), = card.calls
    assert (source, got) == ("rmsnorm_bwd", symbol)
    assert dx.dtype == dtype and dw.dtype == torch.float32
    fp32 = dtype == torch.float32
    assert (tmlp.rmsnorm_bwd.launches - before[0], tmlp.rmsnorm_bwd_f32.launches - before[1]) == (
        (0, 1) if fp32 else (1, 0))


_BF16_ENTRIES = {"ggt_flash_fwd", "ggt_flash_bwd", "ggt_flash_dq", "ggt_flash_dkv", "ggt_mlp",
                 "ggt_norm_mlp", "ggt_rmsnorm_bwd"}


def _symbols(card):
    return [sym for _, sym, _ in card.calls]


def test_an_fp32_layer_scale_model_asks_for_the_fp32_mlp(monkeypatch):
    """A two-layer fp32 model with LayerScale, DropPath and attention
    dropout (the fine-tune regularisers) under pairs remat: its training
    forward and backward reach mlp_f32 (each layer's forward and its
    recompute), flash_fwd_f32, flash_bwd_f32 and rmsnorm_bwd_f32 and no bf16
    entry, and raise nowhere."""
    from graphgpt_torch.config import ModelConfig
    from graphgpt_torch.models.heads import GraphGPTPretrain
    from graphgpt_torch.synthetic import fake_batch, to_torch

    card = FakeCard(monkeypatch)
    cfg = ModelConfig(vocab_size=50, hidden_size=128, num_hidden_layers=2, stacked_feat=3,
                      next_n_token=3, mask_token_id=1, dtype="float32",
                      layer_scale_init_value=1.0, path_dropout=0.1, attention_dropout=0.1,
                      remat=True, remat_policy="pairs").finalize()
    model = GraphGPTPretrain(cfg, device="cpu", seed=0)
    batch = to_torch(fake_batch(2, 128, 3, 50, np.random.default_rng(0)), "cpu")
    before = tmlp.mlp_f32.launches
    out = model(batch, generator=torch.Generator().manual_seed(0), train=True)
    out["loss"].backward()
    syms = _symbols(card)
    assert syms.count("ggt_mlp_f32") == 4 and tmlp.mlp_f32.launches - before == 4
    assert {"ggt_flash_fwd_f32", "ggt_flash_bwd_f32", "ggt_rmsnorm_bwd_f32"} <= set(syms)
    assert not set(syms) & _BF16_ENTRIES and "ggt_norm_mlp_f32" not in syms


def test_an_fp32_bi_causal_denoiser_asks_for_the_fp32_split_pair(monkeypatch):
    """A two-layer fp32 denoiser with a 16-slot bi-causal split: its training
    backward takes the split pair in its fp32 form, flash_dq_f32 then
    flash_dkv_f32 once a layer, never the fused backward, and no bf16
    entry."""
    from graphgpt_torch.config import ModelConfig
    from graphgpt_torch.models.denoise import GraphGPTDenoise, denoise_draws
    from graphgpt_torch.synthetic import mol3d_batch, mol3d_tokenizer, to_torch

    card = FakeCard(monkeypatch)
    tok = mol3d_tokenizer()
    cfg = ModelConfig(vocab_size=tok.vocab_size, hidden_size=128, num_hidden_layers=2,
                      stacked_feat=tok.stacked_feat, mask_token_id=tok.mask_id,
                      dtype="float32", stacked_feat_agg_method="gated", task_type="graph",
                      problem_type="regression", loss_type="l1", num_labels=1,
                      bi_causal_split=16).finalize()
    model = GraphGPTDenoise(cfg, device="cpu", seed=0)
    batch = to_torch(mol3d_batch(2, 88, seed=0, bi_split=16, tokenizer=tok), "cpu")
    draws = denoise_draws(2, 88, torch.Generator().manual_seed(1), "cpu")
    before = (tfa.flash_dq_f32.launches, tfa.flash_dkv_f32.launches)
    out = model(batch, train=True, draws=draws)
    out["loss"].backward()
    syms = _symbols(card)
    assert syms.count("ggt_flash_dq_f32") == syms.count("ggt_flash_dkv_f32") == 2
    assert (tfa.flash_dq_f32.launches - before[0], tfa.flash_dkv_f32.launches - before[1]) == (
        2, 2)
    assert all(syms[syms.index("ggt_flash_dq_f32", i) + 1] == "ggt_flash_dkv_f32"
               for i, s in enumerate(syms) if s == "ggt_flash_dq_f32")
    assert "ggt_flash_bwd_f32" not in syms and not set(syms) & _BF16_ENTRIES


# the streamed route: above P 2048 (the smallest such P of whole 64-row
# tiles), or under skip at the toy's P 128
STREAM_ROUTES = {"p2112": ("legacy", 2112), "skip": ("skip", 128)}


def _stream_route(monkeypatch, route):
    mode, p = STREAM_ROUTES[route]
    monkeypatch.setattr(tfa, "_MODE", mode)
    return p


_STREAM_COUNTS = ("flash_fwd_stream", "flash_dq_stream", "flash_dkv_stream",
                  "flash_fwd_stream_f32", "flash_dq_stream_f32", "flash_dkv_stream_f32",
                  "flash_fwd", "flash_fwd_f32", "flash_bwd", "flash_bwd_f32", "flash_dq_f32",
                  "flash_dkv_f32")


@pytest.mark.parametrize("route", list(STREAM_ROUTES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_the_streamed_route_sends_each_dtype_to_its_entries(monkeypatch, dtype, route):
    """flash_fwd and flash_bwd above P 2048, or under skip, reach #6, then #7
    and #8: fp32 the three fp32 stream entries (one launch of each fp32
    form, none of the bf16 ones or of #1f, #3f-#5f) with the RoPE tables
    unrounded, #6f, #7f and #8f in the split body's source with their
    tile-table scratch; bf16 the entries it always took, with their
    scratch. #8 reads the delta #7 wrote."""
    card = FakeCard(monkeypatch)
    p = _stream_route(monkeypatch, route)
    qs, k, v, do, seg, cos, sin = _flash(dtype, b=1, p=p)
    before = {n: getattr(tfa, n).launches for n in _STREAM_COUNTS}
    out, lse = tfa.flash_fwd(qs, k, v, seg, cos, sin, False, 64)
    dq, dk, dv = tfa.flash_bwd(qs, k, v, seg, cos, sin, out, lse, do, None, False, 64)
    fp32 = dtype == torch.float32
    suffix, fwd_src, bwd_src = (("_f32", "flash_bwd_split_f32", "flash_bwd_split_f32") if fp32
                                else ("", "flash_fwd", "flash_bwd_split"))
    (s_fwd, y_fwd, t_fwd), (s_dq, y_dq, t_dq), (s_dkv, y_dkv, t_dkv) = card.calls
    assert (s_fwd, y_fwd) == (fwd_src, f"ggt_flash_fwd_stream{suffix}")
    assert (s_dq, y_dq) == (bwd_src, f"ggt_flash_dq_stream{suffix}")
    assert (s_dkv, y_dkv) == (bwd_src, f"ggt_flash_dkv_stream{suffix}")
    assert out.dtype == dq.dtype == dk.dtype == dv.dtype == dtype
    got = {n: getattr(tfa, n).launches - before[n] for n in _STREAM_COUNTS}
    forms = [f"{n}{suffix}" for n in ("flash_fwd_stream", "flash_dq_stream", "flash_dkv_stream")]
    assert got == {n: int(n in forms) for n in _STREAM_COUNTS}
    # fwd: q, k, v, seg_q, seg_k, cos, sin, out, lse, tab; dq: q, k, v,
    # seg_q, seg_k, cos, sin, out, lse, do, delta, dq, tab (dlse None);
    # dkv: q, k, v, seg_q, seg_k, cos, sin, lse, delta, do, dk, dv, tab
    assert [len(t_fwd), len(t_dq), len(t_dkv)] == [10, 13, 13]
    nt = -(-p // 64)
    for t in (t_fwd[9], t_dq[12], t_dkv[12]):
        assert t.dtype == torch.int32 and t.shape == (4 * nt,)
    assert t_dkv[8] is t_dq[10] and t_dkv[8].dtype == torch.float32
    for t in (t_fwd, t_dq, t_dkv):
        assert t[5].dtype == t[6].dtype == dtype
        assert t[3].dtype == t[4].dtype == torch.int32 and torch.equal(t[4], seg.int())
        if fp32:
            assert torch.equal(t[5], cos) and torch.equal(t[6], sin)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_the_stream_wrappers_hand_over_the_keys_own_ids(monkeypatch, dtype):
    """With key ids of another array (a ring chunk's), #6-#8's entries of
    either dtype get both arrays as given; with one array twice, the same
    tensor twice."""
    card = FakeCard(monkeypatch)
    qs, k, v, do, seg, cos, sin = _flash(dtype, b=1, p=2112)
    seg_k = seg.roll(1, dims=1).int() * 2
    lse = torch.zeros(1, 2, 2112)
    tfa.flash_fwd_stream(qs, k, v, seg, seg_k, cos, sin, False, 64)
    _, delta = tfa.flash_dq_stream(qs, k, v, seg, seg_k, cos, sin, qs, lse, do, None, False, 64)
    tfa.flash_dkv_stream(qs, k, v, seg, seg_k, cos, sin, lse, delta, do, False, 64)
    tfa.flash_fwd_stream(qs, k, v, seg, seg, cos, sin, False, 64)
    suffix = "_f32" if dtype == torch.float32 else ""
    assert [sym for _, sym, _ in card.calls] == [
        f"ggt_flash_{n}_stream{suffix}" for n in ("fwd", "dq", "dkv", "fwd")]
    for _, _, t in card.calls[:3]:
        assert torch.equal(t[3], seg) and torch.equal(t[4], seg_k) and t[3] is not t[4]
    assert card.calls[3][2][3] is card.calls[3][2][4]


def test_the_stream_wrappers_refuse_other_dtypes(monkeypatch):
    """fp16, and fp32 beside bf16 either way, raise in #6-#8 before any
    launch, at P > 2048 and under skip."""
    card = FakeCard(monkeypatch)
    for route in STREAM_ROUTES:
        p = _stream_route(monkeypatch, route)
        qs, k, v, do, seg, cos, sin = _flash(torch.float16, b=1, p=p)
        lse = torch.zeros(1, 2, p)
        with pytest.raises(NotImplementedError):
            tfa.flash_fwd(qs, k, v, seg, cos, sin, False, 64)
        with pytest.raises(NotImplementedError):
            tfa.flash_bwd(qs, k, v, seg, cos, sin, qs, lse, do, None, False, 64)
        f, h = qs.float(), qs.bfloat16()
        with pytest.raises(NotImplementedError):  # fp32 q beside bf16 k and v
            tfa.flash_fwd_stream(f, h, h, seg, seg, cos, sin, False, 64)
        with pytest.raises(NotImplementedError):  # bf16 q beside fp32 k and v
            tfa.flash_fwd_stream(h, f, f, seg, seg, cos, sin, False, 64)
        with pytest.raises(NotImplementedError):  # an fp32 pair with a bf16 do
            tfa.flash_dq_stream(f, f, f, seg, seg, cos, sin, f, lse, h, None, False, 64)
        with pytest.raises(NotImplementedError):
            tfa.flash_dkv_stream(f, f, h, seg, seg, cos, sin, lse, lse, f, False, 64)
    assert card.calls == []


@pytest.mark.parametrize("route", list(STREAM_ROUTES))
def test_an_fp32_model_on_the_streamed_route_asks_for_the_fp32_stream_entries(monkeypatch,
                                                                               route):
    """A two-layer fp32 model (heads of 64, save_attn, as the long-context
    config trains) past 2,048 positions, or under skip at P 128: its
    training forward and backward reach #6f once a layer (save_attn keeps
    its output for the recompute), #7f then #8f once a layer, #2f and #13f,
    and no bf16 entry, none of #1f, #3f, #4f or #5f."""
    from graphgpt_torch.config import ModelConfig
    from graphgpt_torch.models.heads import GraphGPTPretrain
    from graphgpt_torch.synthetic import fake_batch, to_torch

    card = FakeCard(monkeypatch)
    p = _stream_route(monkeypatch, route)
    cfg = ModelConfig(vocab_size=50, hidden_size=128, num_hidden_layers=2, stacked_feat=3,
                      next_n_token=3, mask_token_id=1, dtype="float32", remat=True,
                      remat_policy="save_attn", max_position_embeddings=max(p, 1024)).finalize()
    model = GraphGPTPretrain(cfg, device="cpu", seed=0)
    batch = to_torch(fake_batch(1, p, 3, 50, np.random.default_rng(0)), "cpu")
    out = model(batch, generator=torch.Generator().manual_seed(0), train=True)
    out["loss"].backward()
    syms = _symbols(card)
    for sym in ("ggt_flash_fwd_stream_f32", "ggt_flash_dq_stream_f32",
                "ggt_flash_dkv_stream_f32"):
        assert syms.count(sym) == 2, (sym, syms)
    assert all(syms[syms.index("ggt_flash_dq_stream_f32", i) + 1] == "ggt_flash_dkv_stream_f32"
               for i, s in enumerate(syms) if s == "ggt_flash_dq_stream_f32")
    assert {"ggt_norm_mlp_f32", "ggt_rmsnorm_bwd_f32"} <= set(syms)
    assert set(syms) <= {"ggt_flash_fwd_stream_f32", "ggt_flash_dq_stream_f32",
                         "ggt_flash_dkv_stream_f32", "ggt_norm_mlp_f32", "ggt_rmsnorm_bwd_f32"}


# ---- the knobs' kernels: #9, #10 (GGT_FLASH_MODE=band) and #12
# (GGT_ATTN_NORM_FUSE=1)

_BAND_COUNTS = ("flash_fwd_band", "flash_bwd_band", "flash_fwd_band_f32", "flash_bwd_band_f32",
                "flash_fwd", "flash_fwd_f32", "flash_bwd", "flash_bwd_f32", "flash_dq_f32",
                "flash_dkv_f32", "flash_fwd_stream_f32", "flash_dq_stream_f32",
                "flash_dkv_stream_f32")


@pytest.mark.parametrize("split", [0, 16], ids=["bidirectional", "bicausal"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_the_band_route_sends_each_dtype_to_its_entries(monkeypatch, dtype, split):
    """flash_fwd and flash_bwd under band (q and k rotated: no cos, sin)
    reach #9 and #10 whatever the split: fp32 the band forms' fp32 entries
    (one launch of each, none of the bf16 band forms or of any other fp32
    form), bf16 the entries it always took; each with the query ids as key
    ids (one tensor twice) and its band-table scratch. #10 writes a delta
    of its own."""
    card = FakeCard(monkeypatch)
    monkeypatch.setattr(tfa, "_MODE", "band")
    qs, k, v, do, seg, _, _ = _flash(dtype)
    before = {n: getattr(tfa, n).launches for n in _BAND_COUNTS}
    out, lse = tfa.flash_fwd(qs, k, v, seg, None, None, False, 64, split)
    dq, dk, dv = tfa.flash_bwd(qs, k, v, seg, None, None, out, lse, do, None, False, 64, split)
    fp32 = dtype == torch.float32
    suffix = "_f32" if fp32 else ""
    (s_fwd, y_fwd, t_fwd), (s_bwd, y_bwd, t_bwd) = card.calls
    assert (s_fwd, y_fwd) == (f"flash_fwd{suffix}", f"ggt_flash_fwd_band{suffix}")
    assert (s_bwd, y_bwd) == (f"flash_bwd{suffix}", f"ggt_flash_bwd_band{suffix}")
    assert out.dtype == dq.dtype == dk.dtype == dv.dtype == dtype and lse.dtype == torch.float32
    got = {n: getattr(tfa, n).launches - before[n] for n in _BAND_COUNTS}
    forms = (f"flash_fwd_band{suffix}", f"flash_bwd_band{suffix}")
    assert got == {n: int(n in forms) for n in _BAND_COUNTS}
    # fwd: q, k, v, seg_q, seg_k, out, lse, tab; bwd: q, k, v, seg_q, seg_k,
    # out, lse, do, delta, dq, dk, dv, tab (dlse None: no pointer)
    assert [len(t_fwd), len(t_bwd)] == [8, 13]
    for t in (t_fwd, t_bwd):
        assert t[3] is t[4] and t[3].dtype == torch.int32 and torch.equal(t[3], seg)
        assert t[-1].dtype == torch.int32 and t[-1].numel() == 4 * 2 * 2  # 4 x B x ceil(P/64)
    assert t_bwd[8].dtype == torch.float32 and t_bwd[8].shape == lse.shape


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_the_band_wrappers_hand_over_the_keys_own_ids(monkeypatch, dtype):
    """With key ids of another array, #9's and #10's entries of either dtype
    get both arrays as given, and #10 reads its key tiles' table from the
    second half of the scratch; with one array twice, the same tensor
    twice and one table."""
    card = FakeCard(monkeypatch)
    qs, k, v, do, seg, _, _ = _flash(dtype)
    seg_k = seg.roll(1, dims=1).int() * 2
    lse = torch.zeros(2, 2, 128)
    faux, baux, same = {}, {}, {}
    tfa.flash_fwd_band(qs, k, v, seg, seg_k, True, 64, aux=faux)
    tfa.flash_bwd_band(qs, k, v, seg, seg_k, qs, lse, do, None, True, 64, aux=baux)
    tfa.flash_bwd_band(qs, k, v, seg, seg, qs, lse, do, None, True, 64, aux=same)
    suffix = "_f32" if dtype == torch.float32 else ""
    assert [sym for _, sym, _ in card.calls] == [f"ggt_flash_{n}_band{suffix}"
                                                 for n in ("fwd", "bwd", "bwd")]
    (_, _, t_fwd), (_, _, t_bwd), (_, _, t_same) = card.calls
    for t in (t_fwd, t_bwd):
        assert torch.equal(t[3], seg) and torch.equal(t[4], seg_k) and t[3] is not t[4]
    assert t_same[3] is t_same[4]
    tab = t_bwd[-1]
    assert faux["table"].shape == (2, 2, 2) and faux["table"].dtype == torch.int32
    assert baux["table_k"].data_ptr() == tab.data_ptr() + 2 * 2 * 2 * 4  # the second table
    assert same["table_k"].data_ptr() == t_same[-1].data_ptr()  # one table for one array
    assert baux["delta"] is t_bwd[8]


def _qkv(dtype, n=200, d=128, widths=(128, 64, 64)):
    rng = np.random.default_rng(2)

    def t(*shape):
        return torch.from_numpy((rng.normal(size=shape) * 0.05).astype(np.float32)).to(dtype)

    return t(n, d), torch.ones(d), [t(w, d) for w in widths]


@pytest.mark.parametrize("widths", [(128, 128, 128), (128, 64, 64)], ids=["mha", "gqa"])
@pytest.mark.parametrize("dtype,source,symbol", [
    (torch.float32, "mlp_qkv_f32", "ggt_norm_qkv_f32"),
    (torch.bfloat16, "norm_qkv", "ggt_norm_qkv")], ids=["fp32", "bf16"])
def test_norm_qkv_sends_each_dtype_to_its_entry(monkeypatch, dtype, source, symbol, widths):
    """fp32 x and weights reach #12's fp32 entry (one source with #11f) with
    wn in fp32, the scratch of the weights' TF32 hi and lo planes, the three
    widths and the tile width; bf16 the entry it always took. One launch of
    the form, none of the other."""
    card = FakeCard(monkeypatch)
    x, wn, ws = _qkv(dtype, widths=widths)
    before = (tmlp.norm_qkv.launches, tmlp.norm_qkv_f32.launches)
    q, k, v = tmlp.norm_qkv(x, wn, *ws, 1e-6)
    (got_source, got, tensors), = card.calls
    assert (got_source, got) == (source, symbol)
    assert [tuple(o.shape) for o in (q, k, v)] == [(200, w) for w in widths]
    assert all(o.dtype == dtype for o in (q, k, v))
    fp32 = dtype == torch.float32
    # x, wn, wq, wk, wv, (fp32: planes,) q, k, v, rrms
    assert tensors[1].dtype == torch.float32 and torch.equal(tensors[1], wn)
    assert all(t.dtype == dtype for t in tensors[2:5])
    assert tensors[-1].dtype == torch.float32 and tensors[-1].shape == (200,)
    if fp32:
        assert tensors[5].shape == (2, sum(widths) * 128) and len(tensors) == 10
    assert (tmlp.norm_qkv.launches - before[0], tmlp.norm_qkv_f32.launches - before[1]) == (
        (0, 1) if fp32 else (1, 0))
    argtypes = tmlp._QKV_F32_ARGTYPES if fp32 else tmlp._QKV_ARGTYPES
    assert len(argtypes) == (18 if fp32 else 17)


@pytest.mark.parametrize("widths,bn", [((768, 768, 768), 128), ((768, 256, 256), 128),
                                       ((128, 64, 64), 64), ((1600, 1600, 1600), 64),
                                       ((3072,), 128), ((96,), 0)])
def test_f32_block_n_is_the_widest_tile_of_the_3xtf32_body_dividing_every_width(widths, bn):
    """#12f's and #11f's down tile width: 128 or 64, the widest dividing
    every output width (the body takes no wider: two sets of sums a
    thread); 0 where neither divides, which the wrappers refuse."""
    assert tmlp.f32_block_n(widths) == bn


def test_the_band_and_qkv_wrappers_refuse_other_dtypes(monkeypatch):
    """fp16, and fp32 beside bf16 either way, raise in #9, #10 and #12
    before any launch; #12f keeps the bf16 kernel's contract (D and the
    widths multiples of 64)."""
    card = FakeCard(monkeypatch)
    monkeypatch.setattr(tfa, "_MODE", "band")
    qs, k, v, do, seg, _, _ = _flash(torch.float16)
    lse = torch.zeros(2, 2, 128)
    with pytest.raises(NotImplementedError):
        tfa.flash_fwd(qs, k, v, seg, None, None, False, 64)
    with pytest.raises(NotImplementedError):
        tfa.flash_bwd(qs, k, v, seg, None, None, qs, lse, do, None, False, 64)
    f, h = qs.float(), qs.bfloat16()
    with pytest.raises(NotImplementedError):  # fp32 q beside bf16 k and v
        tfa.flash_fwd_band(f, h, h, seg, seg, False, 64)
    with pytest.raises(NotImplementedError):  # bf16 q beside fp32 k and v
        tfa.flash_fwd_band(h, f, f, seg, seg, False, 64)
    with pytest.raises(NotImplementedError):  # an fp32 backward with a bf16 do
        tfa.flash_bwd_band(f, f, f, seg, seg, f, lse, h, None, False, 64)
    with pytest.raises(NotImplementedError):  # a bf16 backward with an fp32 out
        tfa.flash_bwd_band(h, h, h, seg, seg, f, lse, h, None, False, 64)
    x, wn, ws = _qkv(torch.float16)
    with pytest.raises(NotImplementedError):
        tmlp.norm_qkv(x, wn, *ws, 1e-6)
    with pytest.raises(NotImplementedError):  # fp32 x beside bf16 weights
        tmlp.norm_qkv(x.float(), wn, *(w.bfloat16() for w in ws), 1e-6)
    with pytest.raises(NotImplementedError):  # bf16 x beside fp32 weights
        tmlp.norm_qkv(x.bfloat16(), wn, *(w.float() for w in ws), 1e-6)
    with pytest.raises(NotImplementedError):  # fp32 x beside one bf16 weight
        tmlp.norm_qkv(x.float(), wn, ws[0].float(), ws[1].float(), ws[2].bfloat16(), 1e-6)
    xf, wnf, wsf = _qkv(torch.float32, d=96, widths=(96, 64, 64))
    with pytest.raises(NotImplementedError):  # D % 64 != 0
        tmlp.norm_qkv(xf, wnf, *wsf, 1e-6)
    xf, wnf, wsf = _qkv(torch.float32, widths=(128, 64, 32))
    with pytest.raises(NotImplementedError):  # a width % 64 != 0
        tmlp.norm_qkv(xf, wnf, *wsf, 1e-6)
    assert card.calls == []


def test_an_fp32_model_under_both_knobs_asks_for_the_band_and_qkv_entries(monkeypatch):
    """A two-layer fp32 model (heads of 64, save_attn) under
    GGT_FLASH_MODE=band and GGT_ATTN_NORM_FUSE=1: its training forward and
    backward reach #9f once a layer (save_attn keeps its output for the
    recompute), #10f once a layer, #12f twice a layer (the forward and the
    recompute), #2f once a layer and #13f once a layer and for the final
    norm (#12's adjoint), and nothing else: no bf16 entry, no other form."""
    from graphgpt_torch.config import ModelConfig
    from graphgpt_torch.models.heads import GraphGPTPretrain
    from graphgpt_torch.synthetic import fake_batch, to_torch

    card = FakeCard(monkeypatch)
    monkeypatch.setattr(tfa, "_MODE", "band")
    monkeypatch.setenv("GGT_ATTN_NORM_FUSE", "1")
    cfg = ModelConfig(vocab_size=50, hidden_size=128, num_hidden_layers=2, stacked_feat=3,
                      next_n_token=3, mask_token_id=1, dtype="float32", remat=True,
                      remat_policy="save_attn").finalize()
    assert cfg.head_dim == 64
    model = GraphGPTPretrain(cfg, device="cpu", seed=0)
    batch = to_torch(fake_batch(2, 128, 3, 50, np.random.default_rng(0)), "cpu")
    counts = (tfa.flash_fwd_band_f32, tfa.flash_bwd_band_f32, tmlp.norm_qkv_f32,
              tmlp.norm_mlp_f32, tmlp.rmsnorm_bwd_f32)
    before = [c.launches for c in counts]
    out = model(batch, generator=torch.Generator().manual_seed(0), train=True)
    out["loss"].backward()
    syms = _symbols(card)
    want = {"ggt_flash_fwd_band_f32": 2, "ggt_flash_bwd_band_f32": 2, "ggt_norm_qkv_f32": 4,
            "ggt_norm_mlp_f32": 2, "ggt_rmsnorm_bwd_f32": 3}
    assert {s: syms.count(s) for s in set(syms)} == want, syms
    assert [c.launches - n for c, n in zip(counts, before)] == [2, 2, 4, 2, 3]
