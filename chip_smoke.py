"""Drive the PyTorch port (graphgpt_torch) on one CUDA card.

    python3 chip_smoke.py

1. Fails unless a CUDA card is present; prints its name and power limit.
2. Builds every kernel of the inference path from graphgpt_torch/csrc with
   nvcc (one process per source, all at once) and prints the build time.
3. Kernel phase: at GraphGPT-base shapes, each kernel against its plain
   PyTorch version in bf16 (max error beside its tolerance), timed with CUDA
   events beside the plain version, one PyTorch library call where one
   computes the same function, and the card's bound for the same work.
4. Eval phase: GraphGPT-base at full width (seeded random weights), the
   SMTP eval loss of a packed 8 x 1024 batch, against the same model run
   with the plain versions; each kernel launches once per layer.
5. Generation phase: dLLM unmasking of a 30-40% masked band with the
   default GenerationConfig (64 steps, entropy confidence).
6. Prints one JSON line listing every kernel, then the device line last.

Any failed check raises, so the script exits non-zero. The launch counts
are set to 0 just before the eval phase and read after the generation
phase: that window is the main path.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12

# bf16 out, fp32 lse. out is held twice: elementwise, and by the relative
# Frobenius error over the valid rows. A typical |out| is ~0.07 here, so
# the elementwise 3e-2 alone could let a fault on the P.V side through (a
# wrong V row, a dropped key tile, a misrounded P).
FLASH_TOL = dict(out_atol=3e-2, out_rel=4e-3, lse_atol=1e-3)
MLP_TOL = dict(atol=1e-2, rtol=1e-2)  # about 2.5 bf16 ulps of the output
LOSS_ATOL = 5e-3
HIDDEN_REL = 3e-2  # Frobenius norm of the difference over that of the plain run


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0].strip()


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of fn() over `iters` back-to-back calls (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes: float, flops: float):
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / PEAK_BF16_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def flash_phase(dev, fa, ops, synthetic, rope_cos_sin):
    b, p, h, dh = 8, 1024, 12, 64
    rng = np.random.default_rng(0)
    seg_np = synthetic.packed_segments(b, p, rng)
    seg_np[-1, p - 40 :] = 0  # a padded tail
    seg = torch.from_numpy(seg_np).to(dev)
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape):
        return (torch.randn(*shape, generator=gen, device=dev) * 0.5).to(torch.bfloat16)

    # q pre-scaled as the dispatcher hands it over
    qs = (randn(b, p, h * dh) * torch.tensor(dh**-0.5, dtype=torch.bfloat16)).contiguous()
    k, v = randn(b, p, h * dh), randn(b, p, h * dh)
    pos = torch.arange(p, device=dev).expand(b, p)
    cos, sin = (t.to(torch.bfloat16) for t in rope_cos_sin(pos, dh))

    res = {}
    for causal in (False, True):
        args = (qs, k, v, seg, cos, sin, causal, dh)
        out, lse = fa.flash_fwd(*args)
        torch.cuda.synchronize()
        with ops.reference_mode():
            rout, rlse = fa.flash_fwd(*args)
        valid = seg > 0
        err_out = (out.float() - rout.float()).abs().max().item()
        rel_out = ((out.float() - rout.float())[valid].norm() / rout.float()[valid].norm()).item()
        err_lse = (lse - rlse).abs().amax(dim=1)[valid].max().item()
        pad_ok = bool((out[~valid] == 0).all()) and bool((lse.transpose(1, 2)[~valid] == -1e30).all())
        tag = "causal" if causal else "bidirectional"
        print(
            f"flash_fwd[{tag}] max|out-plain| {err_out:.3e} (tol {FLASH_TOL['out_atol']}) "
            f"|out-plain|/|plain| {rel_out:.3e} (tol {FLASH_TOL['out_rel']}) "
            f"max|lse-plain| {err_lse:.3e} (tol {FLASH_TOL['lse_atol']}) padded rows ok {pad_ok}",
            flush=True,
        )
        if not (err_out <= FLASH_TOL["out_atol"] and rel_out <= FLASH_TOL["out_rel"]
                and err_lse <= FLASH_TOL["lse_atol"] and pad_ok):
            fail(f"flash_fwd[{tag}] disagrees with its plain version")

        ms = cuda_ms(lambda: fa.flash_fwd(*args))
        with ops.reference_mode():
            plain_ms = cuda_ms(lambda: fa.flash_fwd(*args), iters=5)
        # library yardstick: SDPA with a boolean block-diagonal mask on the
        # rotated q, k (the rotation itself is not timed)
        rq = fa.rotate_tokens(qs, cos, sin, dh).view(b, p, h, dh).transpose(1, 2)
        rk = fa.rotate_tokens(k, cos, sin, dh).view(b, p, h, dh).transpose(1, 2)
        v4 = v.view(b, p, h, dh).transpose(1, 2)
        mask = fa._valid_mask(seg, causal)
        lib_ms = cuda_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                rq, rk, v4, attn_mask=mask, scale=1.0
            ),
            iters=5,
        )
        # work these inputs need: each (query, valid key) pair costs a
        # q.k and a p.v product of Dh multiply-adds per head
        pairs = int(mask.sum().item())
        flops = 4.0 * dh * h * pairs
        nbytes = 4 * b * p * h * dh * 2 + b * p * 4 + 2 * b * p * dh * 2 + b * h * p * 4
        bms, by = bound(nbytes, flops)
        print(
            f"flash_fwd[{tag}] B={b} P={p} H={h} Dh={dh}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"SDPA {lib_ms:.4f} ms, bound {bms * 1e3:.2f} us ({by}: {nbytes / 1e6:.1f} MB, "
            f"{flops / 1e9:.3f} GFLOP)",
            flush=True,
        )
        res[tag] = dict(err=max(err_out, err_lse), ms=ms, plain_ms=plain_ms, lib_ms=lib_ms,
                        bound_ms=bms, bound_by=by)
    return res


def mlp_phase(dev, mlp, ops):
    n, d, f = 8192, 768, 3072
    gen = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn(n, d, generator=gen, device=dev).to(torch.bfloat16)
    wn = 1.0 + 0.1 * torch.randn(d, generator=gen, device=dev)
    wg, wu = (
        (torch.randn(f, d, generator=gen, device=dev) * 0.02).to(torch.bfloat16) for _ in range(2)
    )
    wd = (torch.randn(d, f, generator=gen, device=dev) * 0.02).to(torch.bfloat16)
    args = (x, wn, wg, wu, wd, 1e-6, "gelu")
    out = mlp.norm_mlp(*args)
    torch.cuda.synchronize()
    with ops.reference_mode():
        ref = mlp.norm_mlp(*args)
    diff = (out.float() - ref.float()).abs()
    err = diff.max().item()
    excess = (diff - MLP_TOL["atol"] - MLP_TOL["rtol"] * ref.float().abs()).max().item()
    print(
        f"norm_mlp max|out-plain| {err:.3e} (tol atol {MLP_TOL['atol']} + rtol {MLP_TOL['rtol']}"
        f" * |plain|, worst excess {excess:.3e})",
        flush=True,
    )
    if not (excess <= 0 and torch.isfinite(out.float()).all()):
        fail("norm_mlp disagrees with its plain version")
    ms = cuda_ms(lambda: mlp.norm_mlp(*args))
    with ops.reference_mode():
        plain_ms = cuda_ms(lambda: mlp.norm_mlp(*args), iters=5)
    flops = 2.0 * n * d * f * 3
    nbytes = 2 * n * d * 2 + d * 4 + 3 * d * f * 2
    bms, by = bound(nbytes, flops)
    print(
        f"norm_mlp N={n} D={d} F={f} gelu: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"library none, bound {bms * 1e3:.2f} us ({by}: {nbytes / 1e6:.1f} MB, "
        f"{flops / 1e9:.1f} GFLOP)",
        flush=True,
    )
    return dict(err=err, ms=ms, plain_ms=plain_ms, lib_ms=None, bound_ms=bms, bound_by=by)


def sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize()


def eval_phase(model, nb) -> float:
    """The SMTP eval loss of one packed batch; must be finite."""
    from graphgpt_torch import synthetic

    cfg, dev = model.cfg, model.device
    b, p, f = nb["input_ids"].shape
    batch = synthetic.to_torch(nb, dev)
    sync(dev)
    t0 = time.perf_counter()
    loss = model.loss(batch).item()
    ms = (time.perf_counter() - t0) * 1e3
    print(
        f"eval: hidden {cfg.hidden_size}, {cfg.num_hidden_layers} layers, "
        f"{cfg.num_attention_heads} heads, FFN {cfg.intermediate_size}, vocab {cfg.vocab_size}, "
        f"F {f}, next_n {cfg.next_n_token}, B={b} P={p}: loss {loss:.6f} in {ms:.1f} ms "
        f"(first call)",
        flush=True,
    )
    if not np.isfinite(loss):
        fail(f"eval loss is not finite: {loss}")
    return loss


def generation_phase(model, nb) -> int:
    """dLLM unmasking of a 30-40% band of the real cells with the default
    GenerationConfig; every masked cell must be filled. Returns the number
    of model forwards (steps) taken."""
    from graphgpt_torch import synthetic
    from graphgpt_torch.config import GenerationConfig
    from graphgpt_torch.generation import dllm

    cfg, dev = model.cfg, model.device
    mask_id = cfg.mask_token_id
    gcfg = GenerationConfig()
    ids = nb["input_ids"]
    b, p, f = ids.shape
    masked, mask = dllm.mask_at_ratio(ids, mask_id, (0.3, 0.4), np.random.default_rng(3))
    real = int((ids != cfg.pad_token_id).sum())
    n_masked = int(mask.sum())
    batch = synthetic.to_torch(nb, dev)
    # the sampler may not emit the special tokens (pad 0, mask 1): a random
    # model would otherwise predict the mask id for some cells
    special = torch.tensor([cfg.pad_token_id, mask_id], device=dev)

    def logits_fn(x_flat, position_ids, segment_ids):
        lg = model.logits(
            {"input_ids": x_flat.view(b, p, f), "position_ids": position_ids,
             "segment_ids": segment_ids}
        ).view(b, p * f, -1)
        lg[..., special] = float("-inf")
        return lg

    sampler = dllm.make_unmask_sampler(logits_fn, gcfg, mask_id, device=dev)
    x0 = torch.from_numpy(masked.reshape(b, p * f)).to(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    sync(dev)
    t0 = time.perf_counter()
    xg = sampler(x0, gen, batch["position_ids"], batch["segment_ids"])
    sync(dev)
    gen_s = time.perf_counter() - t0
    steps = sampler.forwards
    peak = torch.cuda.max_memory_allocated() / 2**20 if dev.type == "cuda" else float("nan")
    left = int((xg == mask_id).sum())
    mask_t = torch.from_numpy(mask.reshape(b, p * f)).to(dev)
    truth = torch.from_numpy(ids.reshape(b, p * f)).to(dev)
    acc = dllm.generation_accuracy(xg, truth, mask_t)
    print(
        f"generation: {n_masked} of {real} real cells masked ({n_masked / real:.3f}), "
        f"{gcfg.alg}, {gcfg.steps} steps: {steps} steps taken, "
        f"{gen_s * 1e3 / max(steps, 1):.2f} ms/step, {n_masked / gen_s:.0f} generated cells/s, "
        f"{left} masked cells left, accuracy {float(acc['acc']):.4f} over "
        f"{int(acc['n_masked'])} cells (random weights), max_memory_allocated {peak:.0f} MiB",
        flush=True,
    )
    if left != 0 or bool((xg[~mask_t] != x0[~mask_t]).any()):
        fail("generation left masked cells or changed unmasked ones")
    return steps


def compare_plain(model, nb, ops) -> None:
    """The eval forward with the kernels against the same forward with the
    plain versions: loss and final hidden states."""
    from graphgpt_torch import synthetic

    dev = model.device
    batch = synthetic.to_torch(nb, dev)
    sync(dev)
    t0 = time.perf_counter()
    out_k = model(batch)
    sync(dev)
    kernel_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    with ops.reference_mode():
        out_p = model(batch)
    sync(dev)
    plain_ms = (time.perf_counter() - t0) * 1e3
    loss_k, loss_p = out_k["loss"].item(), out_p["loss"].item()
    hk, hp = out_k["hidden_states"].float(), out_p["hidden_states"].float()
    rel = ((hk - hp).norm() / hp.norm()).item()
    print(
        f"eval vs plain: loss {loss_k:.6f} vs {loss_p:.6f} (|diff| {abs(loss_k - loss_p):.3e}, "
        f"tol {LOSS_ATOL}); hidden-state relative error {rel:.3e} (tol {HIDDEN_REL}); "
        f"forward {kernel_ms:.1f} ms with kernels, {plain_ms:.1f} ms plain",
        flush=True,
    )
    if not (abs(loss_k - loss_p) <= LOSS_ATOL and rel <= HIDDEN_REL):
        fail("the eval forward with kernels disagrees with the plain run")


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this script runs on a CUDA card")
    sys.path.insert(0, HERE)
    import graphgpt_torch

    if not os.path.abspath(graphgpt_torch.__file__).startswith(os.path.join(HERE, "graphgpt_torch")):
        fail(f"graphgpt_torch was imported from {graphgpt_torch.__file__}, not from this checkout")
    from graphgpt_torch import ops, synthetic
    from graphgpt_torch.config import flagship_config
    from graphgpt_torch.models.heads import GraphGPTPretrain
    from graphgpt_torch.models.rope import rope_cos_sin
    from graphgpt_torch.ops import _build
    from graphgpt_torch.ops import flash_attention as fa
    from graphgpt_torch.ops import mlp

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    print(card_line(), flush=True)  # name, power limit
    print(
        f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}",
        flush=True,
    )

    t0 = time.perf_counter()
    logs = _build.build_all()
    print(f"build: {sorted(logs)} with nvcc for sm_90a in {time.perf_counter() - t0:.1f} s", flush=True)
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}", flush=True)

    # ---- kernel phase
    fres = flash_phase(dev, fa, ops, synthetic, rope_cos_sin)
    mres = mlp_phase(dev, mlp, ops)

    # ---- eval and generation phases: the main path, counted from 0
    cfg = flagship_config()
    model = GraphGPTPretrain(cfg, device=dev, seed=0)
    nb = synthetic.fake_batch(8, cfg.max_position_embeddings, cfg.stacked_feat, cfg.vocab_size,
                              np.random.default_rng(2))
    L = cfg.num_hidden_layers
    fa.flash_fwd.launches = 0
    mlp.norm_mlp.launches = 0
    eval_phase(model, nb)
    counts = (fa.flash_fwd.launches, mlp.norm_mlp.launches)
    print(f"eval launches: flash_fwd {counts[0]} norm_mlp {counts[1]} (want {L} each)", flush=True)
    if counts != (L, L):
        fail(f"expected {L} launches of each kernel per forward, got {counts}")
    steps = generation_phase(model, nb)
    counts = (fa.flash_fwd.launches, mlp.norm_mlp.launches)
    want = L * (1 + steps)
    print(f"main path launches: flash_fwd {counts[0]} norm_mlp {counts[1]} (want {want} each)",
          flush=True)
    if counts != (want, want):
        fail(f"expected {want} launches of each kernel, got {counts}")
    launches = {"flash_fwd": counts[0], "norm_mlp": counts[1]}
    compare_plain(model, nb, ops)

    base = "graphgpt_tpu/ops/"
    kernels = [
        dict(
            name="flash_fwd", route="cuda", source="graphgpt_torch/csrc/flash_fwd.cu",
            replaces=base + "flash_attention.py:124", launches=launches["flash_fwd"],
            max_abs_err=max(r["err"] for r in fres.values()),
            ms=fres["bidirectional"]["ms"], plain_ms=fres["bidirectional"]["plain_ms"],
            bound_ms=fres["bidirectional"]["bound_ms"], bound_by=fres["bidirectional"]["bound_by"],
            library_ms=fres["bidirectional"]["lib_ms"], causal_ms=fres["causal"]["ms"],
            tol=FLASH_TOL, status="ok",
        ),
        dict(
            name="norm_mlp", route="cuda", source="graphgpt_torch/csrc/norm_mlp.cu",
            replaces=base + "mlp.py:203", launches=launches["norm_mlp"],
            max_abs_err=mres["err"], ms=mres["ms"], plain_ms=mres["plain_ms"],
            bound_ms=mres["bound_ms"], bound_by=mres["bound_by"], library_ms=None,
            tol=MLP_TOL, status="ok",
        ),
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(
        json.dumps(
            {"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                    "count": torch.cuda.device_count()}}
        ),
        flush=True,
    )


if __name__ == "__main__":
    main()
