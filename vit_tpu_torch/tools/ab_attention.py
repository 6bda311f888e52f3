"""Two trees of the repo on one card, in turns: parent, change, change, parent.

    python3 -m vit_tpu_torch.tools.ab_attention PARENT_DIR CHANGE_DIR [--e2e]
        [--p50-pairs N] [--log FILE]
    python3 -m vit_tpu_torch.tools.ab_attention PARENT_DIR CHANGE_DIR --serve PAIRS

Each turn is a child process that imports the tree's own ``vit_tpu_torch``
and ``chip_smoke`` (so each side builds and runs its own kernels) and
measures, at batch 128 unless named:
- kernel 1 (``fused_attention_block``) at ViT-L (dim 1024, 197 tokens, 16
  heads of 64) at batch 1, 8 and 128, in the bf16 and the mixed stream:
  its device time from ``torch.profiler``, split into its four launches
  (LayerNorm, qkv GEMM, attention, out GEMM; ``launch_ms``);
- kernel 3 (``fused_qkv_attention``) at ViT-L (197 tokens, 16 heads of 64)
  at batch 1, 4 and 128, and kernel 4 (``flash_attention``) at the four GSA
  shapes of the Twins-SVT preset (3136 x 64, 784 x 16, 196 x 4, 49 x 1
  keys, 8 heads of 64), each as the mean of CUDA events around 20 wrapper
  calls (what chip_smoke's op lines take) and as device time from
  ``torch.profiler``;
- kernel 2 (``fused_mlp``) at ViT-L (1024 / 4096) at batch 1, 8 and 128 in
  the bf16 stream, split into its three launches (LayerNorm, fc1, fc2), and
  kernel 5 (``flash_attention_kv_blocked``) at both T2T tokenizer stages
  (3136 tokens of width 147, 784 of 1323; one head) at batch 128 on the
  ``split_heads`` views of fused qkv rows, kernel 6
  (``fused_window_attention_block``) at Twins' three LSA stages (7 x 7
  windows, C 64, 128, 256, 8 heads of 64), kernel 7
  (``fused_talking_heads_block``) at the CaiT preset (64 tokens, dim 1024,
  16 heads of 64), kernel 8 (``fused_reattention_block``) at the DeepViT
  preset (65 tokens, dim 1024, 16 heads of 64) and kernel 9
  (``fused_quant_attention_block``) at ViT-L int8 (197 tokens), at batch
  128, and kernel 10 (``fused_quant_mlp``) at ViT-L int8 at batch 1, 8 and
  128, each split into its launches in device time (``call_ms``: a tree
  launches as many kernels as its design has);
- every kernel's time at the shape of PERF.md's table, through the tree's
  own ``chip_smoke.phase_op_times`` and ``phase_t2t_op_times``;
- with ``--e2e``: ViT-L/16 bf16 img/s at batch 128 and p50 at batch 1,
  Twins-SVT, T2T-ViT, CaiT, DeepViT and CrossFormer img/s at batch 128
  (bf16) and the
  int8 ``auto`` p50 at batch 1, 8 and 128 and img/s at batch 128 (ViT-L),
  random weights from chip_smoke's seeds (CaiT's and DeepViT's drawn on the
  card);
- with ``--serve PAIRS``, instead of all the above, in PAIRS pairs of
  fresh processes, the pair's order alternating: the p50 of one
  bf16 forward at batch 1, 8 and 128 of ViT-L/16, the HF ViT-B/16, CaiT
  and CrossFormer, weights drawn on the card (the time does not depend on
  them), and at batch 1 the CPU time of the process a forward over 200
  forwards back to back: the serving paths' host time, which a change of
  dispatch moves, and whose wall clock moves by milliseconds from one
  process to the next;
- with ``--p50-pairs N``, after the four turns: ViT-L/16 bf16 p50 at batch
  1 (100 forwards, weights drawn on the card) in N pairs of fresh
  processes, the pair's order alternating (parent first in even pairs).
  That forward is host-bound and its p50 moves by milliseconds from one
  process to the next, so two turns a side cannot settle it; every
  reading is printed, with each side's median and the pairs the change
  won.

The parent process prints each side's mean over its two turns, the change
against the parent, and the card's name and power limit. The children's own
output goes to ``--log`` (default ``vit_tpu_torch/_build/ab_attention.log``,
which git ignores).
Needs one card; imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

TAG = "AB_RESULT "
GSA = ((3136, 64), (784, 16), (196, 4), (49, 1))
LSA = ((64, 64), (16, 128), (4, 256))  # Twins' LSA stages: 7 x 7 windows an image, C
K1_LAUNCHES = ("ln", "qkv gemm", "attention", "out gemm")
FILLER_LAUNCHES = 128  # marker kernels that open each profiled window
MARKER_CYCLES = 1000  # the marker kernel's spin, about a microsecond


def _device_ms(fn, iters=10) -> float:
    """Device time of ``fn`` in ms: the sum of its kernels' CUDA time in a
    profiled window of ``iters`` calls, over ``iters``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total = sum(getattr(e, "device_time_total", 0.0) for e in prof.key_averages())
    return total / iters / 1e3


def _marked_events(fn, calls, burst=FILLER_LAUNCHES) -> list:
    """The device events of ``calls`` calls of ``fn``, profiled, in launch
    order. The calls are found on the device's own timeline, after a marker
    kernel (``torch.cuda._sleep``'s ``spin_kernel``, which no wrapper
    launches), and not by the host's clock: late in a long process on the
    H100, a mark set on the host's clock 25 ms before the calls once kept
    only the last two of the 40 launches of ten 25 ms calls of kernel 7,
    in five windows in a row. The profiler can also miss the first launches of
    its window (from 3 to about 40 launches of 40 us calls), so the window
    opens with ``burst`` marker launches, then ``fn`` runs, synchronised,
    for 50 ms and at least twice, then one marker, then the calls."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(burst):
            torch.cuda._sleep(MARKER_CYCLES)
        torch.cuda.synchronize()
        t0, warm = time.perf_counter(), 0
        while time.perf_counter() - t0 < 0.05 or warm < 2:
            fn()
            torch.cuda.synchronize()
            warm += 1
        torch.cuda._sleep(MARKER_CYCLES)
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    events = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA),
                    key=lambda e: e.time_range.start)
    marks = [i for i, e in enumerate(events) if "spin_kernel" in e.name]
    return events[marks[-1] + 1:] if marks else []


def launch_ms(fn, n, iters=10, tries=5) -> list:
    """``(kernel name, ms)`` for each of the ``n`` kernel launches of one call
    of ``fn``, in launch order: the device time of each launch over ``iters``
    profiled calls (``_marked_events``), averaged. Now and then a profiled
    window comes back without the marked calls' device events (on the H100,
    an empty window among many full ones); up to ``tries`` windows are
    profiled, and it raises unless one of them shows the same ``n`` kernels
    in the same order in every call."""
    for _ in range(tries):
        evs = _marked_events(fn, iters)
        names = [e.name for e in evs[:n]]
        if len(evs) == n * iters and all(evs[i].name == names[i % n] for i in range(len(evs))):
            return [(names[j], sum(evs[i * n + j].time_range.elapsed_us() for i in range(iters))
                     / iters / 1e3) for j in range(n)]
    raise RuntimeError(f"{len(evs)} device events do not repeat every {n}: "
                       f"{[e.name[:120] for e in evs[:2 * n]]}")


def call_ms(fn, iters=10, tries=3) -> list:
    """``launch_ms`` of every launch of one call of ``fn``, however many
    kernels it launches (counted in one marked call first, the largest count
    of ``tries`` windows; a round of ``tries`` windows that all come back
    empty, as three did once on the H100, is counted again, up to three
    rounds)."""
    for _ in range(3):
        n = max(len(_marked_events(fn, 1)) for _ in range(tries))
        if n:
            break
    return launch_ms(fn, n, iters)


def _split(res, prefix, split) -> None:
    """A call's device time and its launches into ``res``: the total, each
    launch by position (its name in the ``kernels`` entry)."""
    res[f"{prefix} device ms"] = sum(t for _, t in split)
    for i, (_, t) in enumerate(split):
        res[f"{prefix} launch {i} ms"] = t
    res[f"{prefix} kernels"] = " | ".join(
        name.replace("(anonymous namespace)::", "").split("(")[0] for name, _ in split)


def kernel1_ms(cs, ba, gen, dev, b, x_dtype) -> dict:
    """Kernel 1 at ViT-L batch ``b``: its device time, and that of each of
    its four launches (K1_LAUNCHES), in ms."""
    inp = cs.attn_inputs(gen, b, cs.N_TOKENS, 1024, 16, 64, x_dtype, dev)
    a = [inp[k] for k in ("x", "ln_scale", "ln_bias", "wqkv", "wout", "bout")]
    split = launch_ms(lambda: ba.fused_attention_block(*a, 16), len(K1_LAUNCHES))
    return {"total": sum(t for _, t in split),
            **{what: t for what, (_, t) in zip(K1_LAUNCHES, split)},
            "kernels": [name for name, _ in split]}


def child(tree: Path, e2e: bool) -> dict:
    """The measurements of one turn, in the tree's own code."""
    sys.path.insert(0, str(tree))
    import importlib

    import torch

    cs = importlib.import_module("chip_smoke")
    ba = importlib.import_module("vit_tpu_torch.ops.block_attention")
    qa = importlib.import_module("vit_tpu_torch.ops.qkv_attention")
    fa = importlib.import_module("vit_tpu_torch.ops.flash_attention")
    from vit_tpu_torch.ops import _build

    assert Path(cs.__file__).resolve().parent == tree.resolve(), cs.__file__
    # the tree's chip_smoke splits launches with this tool's launch_ms, so
    # that both sides are timed alike
    importlib.import_module("vit_tpu_torch.tools.ab_attention").launch_ms = launch_ms
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.build()
    _build.load_library()
    dev = torch.device("cuda:0")
    smi = cs.nvidia_smi()
    gen = torch.Generator(device=dev).manual_seed(cs.SEED + 20)
    # End to end first, while the process is fresh: a host-bound forward
    # (ViT-L at batch 1 once kernel 2 is fast) shows as latency any host
    # work that the profiling windows below may leave behind.
    res = _e2e(cs, dev) if e2e else {}
    with torch.inference_mode():
        for cfg, x_dtype in (("bf16", torch.bfloat16), ("mixed", torch.float32)):
            for b in (1, 8, 128):
                k1 = kernel1_ms(cs, ba, gen, dev, b, x_dtype)
                res[f"k1 ViT-L {cfg} batch {b} device ms"] = k1["total"]
                for what in K1_LAUNCHES:
                    res[f"k1 ViT-L {cfg} batch {b} {what} ms"] = k1[what]
                res[f"k1 ViT-L {cfg} batch {b} kernels"] = ", ".join(k1["kernels"])
        fm = importlib.import_module("vit_tpu_torch.ops.fused_mlp")
        for b in (1, 8, 128):
            m_in = cs.mlp_inputs(gen, cs.N_TOKENS, 1024, 4096, torch.bfloat16, dev)
            m_in["x"] = torch.randn(b, cs.N_TOKENS, 1024, generator=gen, device=dev).bfloat16()
            _split(res, f"k2 ViT-L bf16 batch {b}",
                   call_ms(lambda: fm.fused_mlp(**m_in, activation="gelu", residual=False)))
            del m_in
        for s, (n, d) in enumerate(cs.T2T_STAGES):
            qkv = torch.randn(128, n, 3 * d, generator=gen, device=dev).bfloat16()
            q, k, v = cs.split_heads(qkv, 1)
            _split(res, f"k5 T2T stage {s} batch 128", call_ms(
                lambda: fa.flash_attention_kv_blocked(q, k, v)))
            del qkv, q, k, v
        for b in (1, 4, 128):
            qkv = torch.randn(b, cs.N_TOKENS, 3 * 1024, generator=gen, device=dev).bfloat16()
            fn = lambda: qa.fused_qkv_attention(qkv, 16)
            res[f"k3 ViT-L batch {b} ms"] = cs.cuda_ms(fn)
            res[f"k3 ViT-L batch {b} device ms"] = _device_ms(fn)
            del qkv
        for nq, nk in GSA:
            q, k, v = cs.twins_qkv(gen, 128, 8, nq, nk, 64, 64, dev)
            fn = lambda: fa.flash_attention(q, k, v)
            res[f"k4 GSA {nq}x{nk} ms"] = cs.cuda_ms(fn)
            res[f"k4 GSA {nq}x{nk} device ms"] = _device_ms(fn)
            del q, k, v
        wa = importlib.import_module("vit_tpu_torch.ops.window_attention")
        for s, (windows, c) in enumerate(LSA, start=1):
            inp = cs.attn_inputs(gen, 128 * windows, 49, c, 8, 64, torch.bfloat16, dev)
            w = [inp[k] for k in ("x", "ln_scale", "ln_bias", "wqkv", "wout", "bout")]
            _split(res, f"k6 Twins LSA stage {s} batch 128",
                   call_ms(lambda: wa.fused_window_attention_block(*w, 8)))
            del inp, w
        rb = importlib.import_module("vit_tpu_torch.ops.reattention_block")
        h = cs.hm_inputs(gen, "th", 128, 64, 1024, 16, 64, torch.bfloat16, dev)
        _split(res, "k7 CaiT batch 128", call_ms(lambda: rb.fused_talking_heads_block(*h, 16)))
        del h
        h = cs.hm_inputs(gen, "ra", 128, 65, 1024, 16, 64, torch.bfloat16, dev)
        _split(res, "k8 DeepViT batch 128", call_ms(lambda: rb.fused_reattention_block(*h, 16)))
        del h
        qb = importlib.import_module("vit_tpu_torch.ops.quant_block")
        q_in = cs.qblock_inputs(gen, 128, cs.N_TOKENS, 1024, 16, 64, dev)
        # a tree whose kernel 9 reads K-major weights says so (chip_smoke.qblock_kernel_args)
        q = getattr(cs, "qblock_kernel_args", list)([q_in[k] for k in cs.QBLOCK_ARGS])
        _split(res, "k9 ViT-L int8 batch 128",
               call_ms(lambda: qb.fused_quant_attention_block(*q, 16)))
        del q, q_in
        for b in (1, 8, 128):
            m_in = cs.qmlp_inputs(gen, b, cs.N_TOKENS, 1024, 4096, torch.bfloat16, dev)
            # a tree whose kernel 10 reads K-major weights says so (chip_smoke.qmlp_kernel_args)
            qm = getattr(cs, "qmlp_kernel_args", list)([m_in[k] for k in cs.QMLP_ARGS])
            _split(res, f"k10 ViT-L int8 batch {b}", call_ms(lambda: qb.fused_quant_mlp(*qm)))
            del qm, m_in
    torch.cuda.empty_cache()
    for name, (kern, _, _, _) in cs.phase_op_times(dev, smi).items():
        res[f"op {name} ms"] = kern
    res["op flash_attention_kv_blocked ms"] = cs.phase_t2t_op_times(dev, smi)[0]
    res["card"] = smi
    return res


def _e2e(cs, dev) -> dict:
    """ViT-L bf16 img/s at batch 128 and p50 at batch 1; T2T-ViT, CaiT,
    DeepViT, Twins-SVT and CrossFormer img/s at batch 128 (bf16); int8 auto
    p50 at batch 1, 8 and 128, and img/s at 128."""
    import torch

    from vit_tpu_torch.models import CaiT, CrossFormer, DeepViT, T2TViT, TwinsSVT, ViT
    from vit_tpu_torch.utils import from_jax_params, quantize_vit

    out = {}
    gen = torch.Generator(device=dev).manual_seed(cs.SEED + 21)
    vit = ViT(**cs.VIT_L, dtype=torch.bfloat16, device=dev)
    vit.load_state_dict(from_jax_params(cs.vit_tree(cs.VIT_L, cs.SEED)), strict=True)
    vit.eval()
    with torch.inference_mode():
        # batch 1 is host-bound, and the host's clock jitters: 60 forwards
        for b, reps in ((128, 5), (1, 60)):
            x = torch.randn(b, 224, 224, 3, generator=gen, device=dev).bfloat16()
            cs.p50_ms(lambda: vit(x), 2)
            p50 = cs.p50_ms(lambda: vit(x), reps)
            out[f"vit-l bf16 batch {b} p50 ms"] = p50
            if b == 128:
                out["vit-l bf16 batch 128 img/s"] = 128 / p50 * 1e3
    t2t = T2TViT(**cs.T2T, dtype=torch.bfloat16, device=dev).eval()
    t2t.load_state_dict(from_jax_params(cs.t2t_tree(cs.T2T, cs.SEED + 13), t2t.jax_stages))
    with torch.inference_mode():
        x = torch.randn(128, 224, 224, 3, generator=gen, device=dev).bfloat16()
        cs.p50_ms(lambda: t2t(x), 2)
        out["t2t bf16 batch 128 img/s"] = 128 / cs.p50_ms(lambda: t2t(x), 5) * 1e3
    del t2t
    torch.cuda.empty_cache()
    for fam, ctor, cfg in (("cait", CaiT, cs.CAIT), ("deepvit", DeepViT, cs.DEEPVIT)):
        # weights drawn on the card: the time does not depend on them
        model = ctor(**cfg, dtype=torch.bfloat16, device=dev).eval()
        with torch.no_grad():
            for prm in model.parameters():
                prm.copy_(0.02 * torch.randn(prm.shape, generator=gen, device=dev))
        with torch.inference_mode():
            x = torch.randn(128, 256, 256, 3, generator=gen, device=dev).bfloat16()
            cs.p50_ms(lambda: model(x), 2)
            out[f"{fam} bf16 batch 128 img/s"] = 128 / cs.p50_ms(lambda: model(x), 5) * 1e3
        del model
        torch.cuda.empty_cache()
    twins = TwinsSVT(**cs.TWINS, dtype=torch.bfloat16, device=dev).eval()
    twins.load_state_dict(from_jax_params(cs.twins_tree(cs.TWINS, cs.SEED + 11), twins.jax_stages))
    with torch.inference_mode():
        x = torch.randn(128, 224, 224, 3, generator=gen, device=dev).bfloat16()
        cs.p50_ms(lambda: twins(x), 2)
        out["twins bf16 batch 128 img/s"] = 128 / cs.p50_ms(lambda: twins(x), 5) * 1e3
    del twins
    torch.cuda.empty_cache()
    # CrossFormer: the most host-bound preset at batch 128 (~35% idle)
    cf = CrossFormer(**cs.CROSSFORMER, dtype=torch.bfloat16, device=dev).eval()
    cf.load_state_dict(from_jax_params(cs.crossformer_tree(cs.CROSSFORMER, cs.SEED + 29),
                                       cf.jax_stages))
    with torch.inference_mode():
        x = torch.randn(128, 224, 224, 3, generator=gen, device=dev).bfloat16()
        cs.p50_ms(lambda: cf(x), 2)
        out["crossformer bf16 batch 128 img/s"] = 128 / cs.p50_ms(lambda: cf(x), 5) * 1e3
    del cf
    torch.cuda.empty_cache()
    qmodel = quantize_vit(vit)
    del vit
    with torch.inference_mode():
        for b in (1, 8, 128):
            x = torch.randn(b, 224, 224, 3, generator=gen, device=dev).bfloat16()
            cs.p50_ms(lambda: qmodel(x), 3)
            out[f"int8 auto batch {b} p50 ms"] = cs.p50_ms(lambda: qmodel(x), 9)
            if b == 128:
                out["int8 auto batch 128 img/s"] = 128 / out[f"int8 auto batch {b} p50 ms"] * 1e3
    return out


def p50_child(tree: Path) -> dict:
    """ViT-L/16 bf16 p50 at batch 1 in a fresh process, in the tree's own
    code: weights drawn on the card (the time does not depend on them)."""
    sys.path.insert(0, str(tree))
    import importlib

    import torch

    cs = importlib.import_module("chip_smoke")
    from vit_tpu_torch.models import ViT
    from vit_tpu_torch.ops import _build

    assert Path(cs.__file__).resolve().parent == tree.resolve(), cs.__file__
    _build.build()
    _build.load_library()
    dev = torch.device("cuda:0")
    gen = torch.Generator(device=dev).manual_seed(cs.SEED + 22)
    vit = ViT(**cs.VIT_L, dtype=torch.bfloat16, device=dev).eval()
    with torch.no_grad():
        for prm in vit.parameters():
            prm.copy_(0.02 * torch.randn(prm.shape, generator=gen, device=dev))
    with torch.inference_mode():
        x = torch.randn(1, 224, 224, 3, generator=gen, device=dev).bfloat16()
        cs.p50_ms(lambda: vit(x), 5)
        return {"vit-l bf16 batch 1 p50 ms": cs.p50_ms(lambda: vit(x), 100)}


SERVE_MODELS = ("vit-l", "hf vit-b/16", "cait", "crossformer")


def serve_child(tree: Path) -> dict:
    """``--serve``: p50 of a bf16 forward at batch 1, 8 and 128 of each of
    SERVE_MODELS, in the tree's own code."""
    sys.path.insert(0, str(tree))
    import importlib

    import torch

    cs = importlib.import_module("chip_smoke")
    from vit_tpu_torch.models import CaiT, CrossFormer, ViT
    from vit_tpu_torch.ops import _build
    from vit_tpu_torch.utils import vit_from_hf

    assert Path(cs.__file__).resolve().parent == tree.resolve(), cs.__file__
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.build()
    _build.load_library()
    dev = torch.device("cuda:0")
    gen = torch.Generator(device=dev).manual_seed(cs.SEED + 23)
    ctors = {
        "vit-l": (lambda: ViT(**cs.VIT_L, dtype=torch.bfloat16, device=dev), 224),
        "hf vit-b/16": (lambda: vit_from_hf(cs.hf_vit_state_dict(cs.HF_VIT_B, cs.SEED + 62),
                                            cs.HF_VIT_B, dtype=torch.bfloat16, device=dev), 224),
        "cait": (lambda: CaiT(**cs.CAIT, dtype=torch.bfloat16, device=dev), 256),
        "crossformer": (lambda: CrossFormer(**cs.CROSSFORMER, dtype=torch.bfloat16, device=dev),
                        224),
    }
    out = {"card": cs.nvidia_smi()}
    for name in SERVE_MODELS:
        ctor, size = ctors[name]
        model = ctor().eval()
        with torch.no_grad():
            for prm in model.parameters():
                prm.copy_(0.02 * torch.randn(prm.shape, generator=gen, device=dev))
        with torch.inference_mode():
            for b, reps in ((1, 60), (8, 30), (128, 6)):
                x = torch.randn(b, size, size, 3, generator=gen, device=dev).bfloat16()
                cs.p50_ms(lambda: model(x), 3)
                out[f"{name} bf16 batch {b} p50 ms"] = cs.p50_ms(lambda: model(x), reps)
                if b == 1:  # the host's CPU time a forward, 200 back to back
                    torch.cuda.synchronize()
                    t0 = time.process_time()
                    for _ in range(200):
                        model(x)
                    torch.cuda.synchronize()
                    out[f"{name} bf16 batch 1 host cpu ms a forward"] = (
                        (time.process_time() - t0) / 200 * 1e3)
        del model
        torch.cuda.empty_cache()
    return out


def _run_child(args, side, tree, log, extra) -> dict:
    """One turn in a child process; its result, or None if it failed."""
    cmd = [sys.executable, str(Path(__file__).resolve()), str(args.parent), str(args.change),
           "--child", str(tree.resolve())] + extra
    proc = subprocess.run(cmd, capture_output=True, text=True, cwd=tree)
    log.write(f"== {side} {tree} {' '.join(extra)}\n{proc.stdout}\n{proc.stderr}\n")
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith(TAG)]
    if proc.returncode != 0 or not lines:
        print(f"{side} turn failed (rc {proc.returncode}):\n{proc.stderr[-3000:]}")
        return None
    return json.loads(lines[-1][len(TAG):])


def pairs(args, log, n, extra, card=None) -> None:
    """``n`` pairs of fresh child processes (``extra`` their mode), the
    pair's order alternating (parent first in even pairs); for each number
    they report: each side's median, min and max, the distance between the
    parent's quartiles, and the pairs the change won (took less)."""
    got = {"parent": [], "change": []}
    for i in range(n):
        order = ("parent", "change") if i % 2 == 0 else ("change", "parent")
        for side in order:
            res = _run_child(args, side, getattr(args, side), log, extra)
            if res is None:
                raise SystemExit(1)
            got[side].append(res)
        print(f"pair {i} done", flush=True)
    card = card or got["change"][0]["card"]
    fmt = lambda xs: ", ".join(f"{x:.4f}" for x in xs)
    for key, value in got["parent"][0].items():
        if isinstance(value, str):
            continue
        xs = {side: [r[key] for r in got[side]] for side in got}
        p, c = statistics.median(xs["parent"]), statistics.median(xs["change"])
        won = sum(ci < pi for pi, ci in zip(xs["parent"], xs["change"]))
        q1, _, q3 = statistics.quantiles(xs["parent"], n=4) if n > 1 else (p, p, p)
        print(f"ab {key} ({n} fresh-process pairs): parent median {p:.4f} (min "
              f"{min(xs['parent']):.4f}, max {max(xs['parent']):.4f}, quartiles {q1:.4f} - "
              f"{q3:.4f}), change median {c:.4f} (min {min(xs['change']):.4f}, max "
              f"{max(xs['change']):.4f}) ({c / p - 1:+.2%}); change faster in {won} of {n} "
              f"pairs [{card}]")
        print(f"ab {key} readings: parent {fmt(xs['parent'])}; change {fmt(xs['change'])}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("parent", type=Path)
    ap.add_argument("change", type=Path)
    ap.add_argument("--e2e", action="store_true")
    ap.add_argument("--p50-pairs", type=int, default=0)
    ap.add_argument("--serve", type=int, default=0, metavar="PAIRS")
    ap.add_argument("--log", type=Path,
                    default=Path(__file__).resolve().parent.parent / "_build" / "ab_attention.log")
    ap.add_argument("--child", type=Path, help=argparse.SUPPRESS)
    ap.add_argument("--p50-only", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child is not None:
        if args.serve:
            res = serve_child(args.child)
        else:
            res = p50_child(args.child) if args.p50_only else child(args.child, args.e2e)
        print(TAG + json.dumps(res), flush=True)
        return 0

    args.log.parent.mkdir(parents=True, exist_ok=True)
    if args.serve:
        with args.log.open("w") as log:
            pairs(args, log, args.serve, ["--serve", "1"])
        return 0
    runs = {"parent": [], "change": []}
    with args.log.open("w") as log:
        for side in ("parent", "change", "change", "parent"):
            res = _run_child(args, side, getattr(args, side), log, ["--e2e"] if args.e2e else [])
            if res is None:
                return 1
            runs[side].append(res)
            print(f"turn {side}: " + ", ".join(f"{k} {v:.4f}" for k, v in res.items()
                                               if not isinstance(v, str)), flush=True)
    card = runs["change"][0]["card"]
    for key in runs["change"][0]:
        if key not in runs["parent"][0]:  # a launch the parent's design does not have
            if not isinstance(runs["change"][0][key], str):
                c = statistics.mean(r[key] for r in runs["change"])
                print(f"ab {key}: change only {c:.4f} [{card}]")
    for key in runs["parent"][0]:
        if key == "card":
            continue
        if key not in runs["change"][0]:  # a launch the change's design does not have
            if not isinstance(runs["parent"][0][key], str):
                p = statistics.mean(r[key] for r in runs["parent"])
                print(f"ab {key}: parent only {p:.4f} [{card}]")
            continue
        if isinstance(runs["parent"][0][key], str):
            print(f"ab {key}: parent {runs['parent'][0][key]}; change {runs['change'][0][key]}")
            continue
        p = statistics.mean(r[key] for r in runs["parent"])
        c = statistics.mean(r[key] for r in runs["change"])
        readings = {side: [r[key] for r in runs[side]] for side in runs}
        spread = max(max(xs) - min(xs) for xs in readings.values())
        print(f"ab {key}: parent {p:.4f}, change {c:.4f} ({c / p - 1:+.2%}; largest gap between "
              f"one side's turns {spread:.4f}; readings parent "
              f"{', '.join(f'{x:.4f}' for x in readings['parent'])}, change "
              f"{', '.join(f'{x:.4f}' for x in readings['change'])}) [{card}]")
    if args.p50_pairs:
        with args.log.open("a") as log:
            pairs(args, log, args.p50_pairs, ["--p50-only"], card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
