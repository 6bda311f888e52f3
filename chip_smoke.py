#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (``vit_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Runs, in order, and exits non-zero at the first failure:
  1. the card's name and power limit; the build of ``vit_tpu_torch/csrc``;
  2. each Hopper kernel against its plain PyTorch twin, on the card, at the
     ViT-L/16 shapes (bf16 stream, and fp32 stream with bf16 weights), and at
     small shapes with masked keys;
  3. the serving path at the full width of ViT-L/16 @224 (random weights from
     a seed): ``BatchingServer`` -> ``InferencePipeline`` -> ``ViT``, 32
     pre-decoded requests from several threads, in the bf16 and the mixed
     config, with the kernels' launch counts read around the run;
  4. the kernel path's logits against the port's plain fp32 path;
  5. times: img/s and p50 latency, kernels against the plain path, and each
     kernel against its twin.
Then one JSON line describes each kernel, and the last line is
``{"ok": true, "device": {...}}``. Needs one card; imports no JAX.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent

# ViT-L/16 @224, the configuration bench.py measures.
VIT_L = dict(image_size=224, patch_size=16, num_classes=1000, dim=1024, depth=24, heads=16,
             dim_head=64, mlp_dim=4096)
N_TOKENS = (224 // 16) ** 2 + 1
SEED = 0
N_REQUESTS = 32

# End-to-end tolerances on max |logit| (logits here are ~N(0, 1) scale).
# Kernel path against the port's plain fp32 path: the JAX package's own bf16
# ViT-L at random init was 0.040 from its fp32 reference (BENCH_r05.json,
# measured on its TPU); 0.1 is 2.5x that for bf16, 0.05 for the mixed config,
# whose stream stays fp32. Server rows against direct pipeline calls: the
# kernels are batch-invariant, but the patch-embed and head GEMMs
# (torch.matmul) may sum in another order at another batch size, which can
# round a bf16 activation to its neighbour; 5% of the largest logit.
E2E_TOL = {"bf16": 0.1, "mixed": 0.05}
SERVER_TOL = 0.05


class SmokeFailure(RuntimeError):
    pass


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def kernel_tol(ref: torch.Tensor, base, dtype) -> float:
    """2% of the largest change the op makes (``ref - base``: a wrong kernel
    is off by that change), plus one bf16 ulp of the largest output when the
    output is bf16 (its last rounding may land on the neighbouring value)."""
    ref = ref.float()
    delta = ref - base.float() if base is not None else ref
    tol = 0.02 * delta.abs().max().item()
    if dtype == torch.bfloat16:
        tol += 2.0**-7 * ref.abs().max().item()
    return tol


def cuda_ms(fn, iters=20, warmup=3) -> float:
    """Mean device time of ``fn`` in ms (CUDA events around ``iters`` calls)."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# -- inputs -------------------------------------------------------------------


def attn_inputs(gen, b, n, dim, heads, d, x_dtype, dev):
    r = lambda *s: torch.randn(*s, generator=gen, device=dev)
    return dict(
        x=r(b, n, dim).to(x_dtype),
        ln_scale=1.0 + 0.1 * r(dim), ln_bias=0.1 * r(dim),
        wqkv=(r(dim, 3 * heads * d) / dim**0.5).bfloat16(),
        wout=(r(heads * d, dim) / (heads * d) ** 0.5).bfloat16(),
        bout=0.1 * r(dim),
    )


def mlp_inputs(gen, t, dim, f, x_dtype, dev, ln=True):
    r = lambda *s: torch.randn(*s, generator=gen, device=dev)
    inp = dict(
        x=r(8, t, dim).to(x_dtype),
        w1=(r(dim, f) / dim**0.5).bfloat16(), b1=0.1 * r(f),
        w2=(r(f, dim) / f**0.5).bfloat16(), b2=0.1 * r(dim),
    )
    if ln:
        inp.update(ln_scale=1.0 + 0.1 * r(dim), ln_bias=0.1 * r(dim))
    return inp


def _trunc_normal(rng, shape, std):
    """Normal(0, std) truncated at two standard deviations (flax's)."""
    z = rng.standard_normal(shape, dtype=np.float32)
    bad = np.abs(z) > 2
    while bad.any():
        z[bad] = rng.standard_normal(int(bad.sum()), dtype=np.float32)
        bad = np.abs(z) > 2
    return z * np.float32(std)


def vit_l_tree(seed: int) -> dict:
    """A ViT-L variables tree in ``vit_tpu``'s layout, drawn with numpy as
    ``ViT.init`` draws it: truncated normal(0.02) for cls / pos_embedding,
    lecun-normal kernels, zero biases, LayerNorm ones and zeros."""
    rng = np.random.default_rng(seed)
    c = VIT_L
    dim, depth, inner, mlp = c["dim"], c["depth"], c["heads"] * c["dim_head"], c["mlp_dim"]
    patch_dim = c["patch_size"] ** 2 * 3
    lecun = lambda *shape, fan_in: _trunc_normal(rng, shape, fan_in**-0.5 / 0.87962566103423978)
    zeros = lambda *shape: np.zeros(shape, np.float32)
    ones = lambda *shape: np.ones(shape, np.float32)
    return {"params": {
        "cls": _trunc_normal(rng, (1, 1, dim), 0.02),
        "pos_embedding": _trunc_normal(rng, (1, N_TOKENS, dim), 0.02),
        "patch_embed": {"proj": {"kernel": lecun(patch_dim, dim, fan_in=patch_dim),
                                 "bias": zeros(dim)}},
        "encoder": {"blocks": {
            "attn": {"norm_scale": ones(depth, dim), "norm_bias": zeros(depth, dim),
                     "qkv_kernel": lecun(depth, dim, 3 * inner, fan_in=dim),
                     "out_kernel": lecun(depth, inner, dim, fan_in=inner),
                     "out_bias": zeros(depth, dim)},
            "ff": {"ln_scale": ones(depth, dim), "ln_bias": zeros(depth, dim),
                   "w1": lecun(depth, dim, mlp, fan_in=dim), "b1": zeros(depth, mlp),
                   "w2": lecun(depth, mlp, dim, fan_in=mlp), "b2": zeros(depth, dim)},
        }},
        "head_norm": {"scale": ones(dim), "bias": zeros(dim)},
        "head": {"kernel": lecun(dim, c["num_classes"], fan_in=dim),
                 "bias": zeros(c["num_classes"])},
    }}


# -- phases -------------------------------------------------------------------


def phase_kernels(dev):
    """Each kernel against its twin on the card; returns max |err| per kernel
    at the ViT-L shapes."""
    from vit_tpu_torch.ops import block_attention as ba
    from vit_tpu_torch.ops.fused_mlp import fused_mlp, reference_mlp

    gen = torch.Generator(device=dev).manual_seed(SEED)
    worst = {"attention_block": 0.0, "fused_mlp": 0.0}
    args = ("x", "ln_scale", "ln_bias", "wqkv", "wout", "bout")
    attn_cases = [
        ("ViT-L bf16", dict(b=8, n=N_TOKENS, dim=1024, heads=16, d=64, x_dtype=torch.bfloat16), {}),
        ("ViT-L mixed", dict(b=8, n=N_TOKENS, dim=1024, heads=16, d=64, x_dtype=torch.float32), {}),
        ("padded true_n", dict(b=4, n=48, dim=256, heads=4, d=64, x_dtype=torch.bfloat16),
         dict(true_n=37)),
        ("packed block_tokens", dict(b=4, n=80, dim=256, heads=4, d=64, x_dtype=torch.bfloat16),
         dict(true_n=37, block_tokens=40)),
    ]
    for name, shape, masks in attn_cases:
        inp = attn_inputs(gen, dev=dev, **shape)
        a = [inp[k] for k in args]
        out = ba.fused_attention_block(*a, shape["heads"], **masks)
        ref = ba.xla_attention_block(*a, shape["heads"], shape["d"] ** -0.5, **masks)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        tol = kernel_tol(ref, inp["x"], out.dtype)
        rel = err / ref.float().abs().max().item()
        print(f"attention_block {name}: max_abs_err {err:.6g} (rel {rel:.3g}) tol {tol:.6g}")
        require(torch.isfinite(out.float()).all().item(), f"attention_block {name}: non-finite output")
        require(err <= tol, f"attention_block {name}: error {err} > {tol}")
        if name.startswith("ViT-L"):
            worst["attention_block"] = max(worst["attention_block"], err)

    mlp_cases = [
        ("ViT-L bf16 ln+gelu", dict(t=N_TOKENS, dim=1024, f=4096, x_dtype=torch.bfloat16),
         dict(activation="gelu", residual=False)),
        ("ViT-L mixed ln+gelu", dict(t=N_TOKENS, dim=1024, f=4096, x_dtype=torch.float32),
         dict(activation="gelu", residual=False)),
        ("small residual gelu_exact", dict(t=33, dim=256, f=512, x_dtype=torch.bfloat16, ln=False),
         dict(activation="gelu_exact", residual=True)),
        ("small mixed ln+res hard_swish", dict(t=33, dim=256, f=512, x_dtype=torch.float32),
         dict(activation="hard_swish", residual=True)),
    ]
    for name, shape, kw in mlp_cases:
        inp = mlp_inputs(gen, dev=dev, **shape)
        out = fused_mlp(**inp, **kw)
        ref = reference_mlp(**inp, **kw)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        tol = kernel_tol(ref, inp["x"] if kw["residual"] else None, out.dtype)
        rel = err / ref.float().abs().max().item()
        print(f"fused_mlp {name}: max_abs_err {err:.6g} (rel {rel:.3g}) tol {tol:.6g}")
        require(torch.isfinite(out.float()).all().item(), f"fused_mlp {name}: non-finite output")
        require(err <= tol, f"fused_mlp {name}: error {err} > {tol}")
        if name.startswith("ViT-L"):
            worst["fused_mlp"] = max(worst["fused_mlp"], err)
    return worst


def build_model(state, dev, config):
    from vit_tpu_torch.models import ViT

    dtypes = {"bf16": (torch.bfloat16, None), "mixed": (torch.bfloat16, torch.float32),
              "fp32": (None, None)}[config]
    model = ViT(**VIT_L, dtype=dtypes[0], residual_dtype=dtypes[1], device=dev)
    model.load_state_dict(state, strict=True)
    return model.eval()


def serve_slice(model, requests, config):
    """BatchingServer -> InferencePipeline -> ViT on the card; returns the
    number of forwards it ran."""
    from vit_tpu_torch import ops
    from vit_tpu_torch.pipeline import InferencePipeline
    from vit_tpu_torch.serving import BatchingServer

    forwards = []
    hook = model.register_forward_hook(lambda m, a, o: forwards.append(a[0].shape[0]))
    before = ops.launch_counts()
    pipe = InferencePipeline(model, image_size=224, batch_size=64)
    require(pipe.batch_buckets == [1, 4, 16, 64], f"buckets {pipe.batch_buckets}")
    t0 = time.perf_counter()
    with BatchingServer(pipe, max_wait_ms=5) as server:  # warms every bucket
        t_warm = time.perf_counter() - t0
        futures = [None] * len(requests)

        def client(idx):
            for i in idx:
                futures[i] = server.submit(requests[i])

        t1 = time.perf_counter()
        threads = [threading.Thread(target=client, args=(range(k, len(requests), 4),))
                   for k in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            require(not t.is_alive(), "client thread hung")
        rows = [f.result(timeout=300) for f in futures]
        t_serve = time.perf_counter() - t1
    served_batches = forwards[len(pipe.batch_buckets):]
    direct = np.concatenate([pipe(r[None]) for r in requests])
    hook.remove()
    after = ops.launch_counts()

    rows = np.stack(rows)
    require(rows.shape == (len(requests), 1000), f"rows {rows.shape}")
    require(np.isfinite(rows).all(), "non-finite logits from the server")
    err = float(np.abs(rows - direct).max())
    tol = SERVER_TOL * float(np.abs(direct).max())
    print(f"slice {config}: {len(requests)} requests in {t_serve * 1e3:.1f} ms as batches "
          f"{served_batches} (warm {t_warm:.2f} s); server vs direct max|dlogit| {err:.6g} "
          f"tol {tol:.6g}; bitwise equal {bool(err == 0.0)}")
    require(err <= tol, f"slice {config}: server rows differ from direct calls by {err}")
    depth = VIT_L["depth"]
    for k in ("attention_block", "fused_mlp"):
        grew = after[k] - before[k]
        print(f"slice {config}: {k} launches {grew} over {len(forwards)} forwards")
        require(grew == depth * len(forwards) and grew >= depth * (len(pipe.batch_buckets) + 1),
                f"slice {config}: {k} launched {grew} times for {len(forwards)} forwards")
    return len(forwards)


def phase_e2e(models, dev, requests):
    """Kernel-path logits against the port's plain fp32 path (twins, no TF32)."""
    from vit_tpu_torch import ops
    from vit_tpu_torch.pipeline import preprocess

    raw = torch.from_numpy(np.stack(requests[:2])).to(dev)
    with torch.inference_mode():
        with ops.force_backend("torch"):
            ref = models["fp32"](preprocess(raw, image_size=224, dtype=torch.float32))
        errs = {}
        for config in ("bf16", "mixed"):
            out = models[config](preprocess(raw, image_size=224, dtype=torch.bfloat16))
            errs[config] = (out - ref).abs().max().item()
            print(f"e2e {config} kernels vs plain fp32: max|dlogit| {errs[config]:.6g} "
                  f"(max|logit| {ref.abs().max().item():.4g}) tol {E2E_TOL[config]}")
    for config, err in errs.items():
        require(err <= E2E_TOL[config], f"e2e {config}: {err} > {E2E_TOL[config]}")


def p50_ms(fn, reps) -> float:
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def phase_times(models, dev, smi):
    """img/s at batch 128 and p50 latency at batch 1, 8, 128: kernel path
    against the plain path on this card, in turns (kernel, plain, plain,
    kernel)."""
    from vit_tpu_torch import ops

    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    for config in ("bf16", "mixed"):
        model = models[config]
        for b in (1, 8, 128):
            x = torch.randn(b, 224, 224, 3, generator=gen, device=dev).bfloat16()
            with torch.inference_mode():
                kernel = lambda: model(x)

                def plain():
                    with ops.force_backend("torch"):
                        model(x)

                reps = 3 if b == 128 else 5
                for f in (kernel, plain):
                    p50_ms(f, 2)  # warm-up
                turns = [(kernel, "k"), (plain, "p"), (plain, "p"), (kernel, "k")]
                runs = {"k": [], "p": []}
                for f, side in turns:
                    runs[side].append(p50_ms(f, reps))
                kern, pl = statistics.mean(runs["k"]), statistics.mean(runs["p"])
            line = f"times {config} batch {b}: p50 kernels {kern:.3f} ms, plain {pl:.3f} ms"
            if b == 128:
                line += f"; img/s kernels {b / kern * 1e3:.1f}, plain {b / pl * 1e3:.1f}"
            print(f"{line} [{smi}]")


def phase_op_times(dev, smi):
    """Each kernel against its twin at the ViT-L shape, batch 128, bf16."""
    from vit_tpu_torch.ops import block_attention as ba
    from vit_tpu_torch.ops.fused_mlp import fused_mlp, reference_mlp

    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    a_in = attn_inputs(gen, 128, N_TOKENS, 1024, 16, 64, torch.bfloat16, dev)
    a = [a_in[k] for k in ("x", "ln_scale", "ln_bias", "wqkv", "wout", "bout")]
    m_in = mlp_inputs(gen, 16 * N_TOKENS, 1024, 4096, torch.bfloat16, dev)  # 8 x 16 = 128 images
    mkw = dict(activation="gelu", residual=False)
    with torch.inference_mode():
        ms = {
            "attention_block": (cuda_ms(lambda: ba.fused_attention_block(*a, 16)),
                                cuda_ms(lambda: ba.xla_attention_block(*a, 16, 0.125), iters=5)),
            "fused_mlp": (cuda_ms(lambda: fused_mlp(**m_in, **mkw)),
                          cuda_ms(lambda: reference_mlp(**m_in, **mkw), iters=5)),
        }
    for k, (kern, plain) in ms.items():
        print(f"op {k} ViT-L batch 128 bf16: kernel {kern:.3f} ms, twin {plain:.3f} ms [{smi}]")
    return ms


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this needs an NVIDIA card",
              file=sys.stderr)
        return 1
    if not (REPO / "vit_tpu_torch" / "csrc").is_dir():
        print(f"chip_smoke: no vit_tpu_torch/csrc beside {__file__}", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    from vit_tpu_torch import ops
    from vit_tpu_torch.ops import _build
    from vit_tpu_torch.utils import from_jax_params

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")
    smi = nvidia_smi()
    print(f"device: {torch.cuda.get_device_name(0)} (count {torch.cuda.device_count()}); "
          f"torch {torch.__version__} cuda {torch.version.cuda}")
    print(smi)

    # 1. build
    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.load_library()
    print(f"build: {lib_path.relative_to(REPO)} in {time.perf_counter() - t0:.1f} s")

    # 2. kernels against twins
    worst = phase_kernels(dev)

    # 3. the slice, bf16 then mixed
    t0 = time.perf_counter()
    state = from_jax_params(vit_l_tree(SEED))
    models = {c: build_model(state, dev, c) for c in ("bf16", "mixed", "fp32")}
    del state
    print(f"ViT-L weights drawn and loaded in {time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(SEED)
    requests = [rng.integers(0, 256, (256, 256, 3), dtype=np.uint8) for _ in range(N_REQUESTS)]
    ops.reset_launch_counts()
    for config in ("bf16", "mixed"):
        serve_slice(models[config], requests, config)
    launches = ops.launch_counts()
    print(f"main path launches: {launches}")
    for k, n in launches.items():
        require(n > 0, f"{k} was not launched on the main path")

    # 4. against the plain path
    phase_e2e(models, dev, requests)

    # 5. times
    phase_times(models, dev, smi)
    op_ms = phase_op_times(dev, smi)

    sources = {"attention_block": ("vit_tpu_torch/csrc/attention_block.cu",
                                   "vit_tpu/ops/block_attention.py:45"),
               "fused_mlp": ("vit_tpu_torch/csrc/fused_mlp.cu", "vit_tpu/ops/fused_mlp.py:53")}
    kernels = [
        {"name": k, "route": "cuda", "source": src, "replaces": rep, "launches": launches[k],
         "max_abs_err": worst[k], "ms": op_ms[k][0], "plain_ms": op_ms[k][1]}
        for k, (src, rep) in sources.items()
    ]
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
