"""``python -m vit_tpu_torch`` — the port's command-line front door (after
``python -m vit_tpu``).

    python -m vit_tpu_torch list [--presets]   # families and their configs
    python -m vit_tpu_torch smoke vit          # build + one forward on the card
    python -m vit_tpu_torch smoke all --device cpu
    python -m vit_tpu_torch version

``smoke`` builds a family's tiny ``MODEL_REGISTRY`` config in bf16 (the
operand dtype of the card's kernels), draws its parameters from a seeded
``torch.Generator`` (weights normal with std fan_in^-0.5, norm scales 1,
biases 0; the rest as the constructor makes them), runs one forward on a
random image and prints the logits' shape, the parameter count and ok or
FAIL. It runs on the card unless ``--device cpu`` is given, and without a
card it stops: it never carries on on the CPU by itself.
"""

from __future__ import annotations

import argparse
import sys
import time
import traceback

SEED = 0


def cmd_list(args) -> int:
    if args.presets:
        from vit_tpu_torch.models import REFERENCE_PRESETS as table
        note = ("Reference-scale constructors (docs/MODELS.md); build one with "
                "vit_tpu_torch.models.create(name, **overrides).")
    else:
        from vit_tpu_torch.models import MODEL_REGISTRY as table
        note = ("These are the smoke-test shapes; reference-scale constructors for every "
                "family: `python -m vit_tpu_torch list --presets`.")
    for name in sorted(table):
        ctor, cfg, image_size = table[name]
        kwargs = ", ".join(f"{k}={v!r}" for k, v in cfg.items())
        print(f"{name:20s} {ctor.__name__}({kwargs})  # img {image_size}")
    print(f"\n{note}")
    return 0


def init_parameters(model, generator) -> None:
    """Redraw ``model``'s parameters in place from ``generator`` (a CPU
    generator, so a seed gives the same values on every device): biases 0,
    norm scales 1, every parameter of two or more axes normal with std
    fan_in^-0.5 (fan-in: the input axis of a ``[..., in, out]`` kernel, ``in
    x kh x kw`` of an OIHW conv kernel); the rest as constructed."""
    import torch

    with torch.no_grad():
        for name, p in model.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf.endswith("bias"):
                p.zero_()
            elif "scale" in leaf:
                p.fill_(1.0)
            elif p.dim() >= 2:
                fan_in = p[0].numel() if p.dim() == 4 else p.shape[-2]
                w = torch.randn(p.shape, generator=generator) * fan_in**-0.5
                p.copy_(w.to(p.device))


def _smoke_one(name: str, device: str) -> bool:
    import torch

    from vit_tpu_torch.models import MODEL_REGISTRY

    cls, cfg, image_size = MODEL_REGISTRY[name]
    gen = torch.Generator().manual_seed(SEED)
    t0 = time.perf_counter()
    model = cls(**cfg, dtype=torch.bfloat16, device=device).eval()
    init_parameters(model, gen)
    img = torch.randn(1, image_size, image_size, 3, generator=gen).to(device, torch.bfloat16)
    with torch.inference_mode():
        logits = model(img)
    ok = tuple(logits.shape) == (1, cfg["num_classes"]) and bool(torch.isfinite(logits).all())
    dt = time.perf_counter() - t0
    count = sum(p.numel() for p in model.parameters())
    print(f"{name:20s} logits {tuple(logits.shape)}  params {count:>9,d}  build+forward "
          f"{dt:5.1f}s on {device}  {'ok' if ok else 'FAIL'}")
    return ok


def cmd_smoke(args) -> int:
    import torch

    from vit_tpu_torch.models import MODEL_REGISTRY

    names = sorted(MODEL_REGISTRY) if args.family == "all" else [args.family]
    unknown = [n for n in names if n not in MODEL_REGISTRY]
    if unknown:
        print(f"unknown family {unknown[0]!r}; `python -m vit_tpu_torch list`", file=sys.stderr)
        return 2
    if args.device == "cuda" and not torch.cuda.is_available():
        print("smoke runs on an NVIDIA card and torch.cuda.is_available() is false; "
              "pass --device cpu to run the plain PyTorch twins on the CPU", file=sys.stderr)
        return 1
    ok = True
    for n in names:  # a family that raises reports FAIL and the sweep goes on
        try:
            ok &= _smoke_one(n, args.device)
        except Exception as e:
            traceback.print_exc()
            print(f"{n:20s} FAIL ({type(e).__name__}: {e})")
            ok = False
    return 0 if ok else 1


def cmd_version(_args) -> int:
    import torch

    import vit_tpu_torch

    print(f"vit_tpu_torch {vit_tpu_torch.__version__}")
    print(f"torch {torch.__version__}  cuda {torch.version.cuda}")
    if torch.cuda.is_available():
        print(f"device {torch.cuda.get_device_name(0)}  count {torch.cuda.device_count()}")
    else:
        print("device none (torch.cuda.is_available() is false)  count 0")
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m vit_tpu_torch",
        description=__doc__.split("\n\n")[0],
        epilog="on the card: python3 chip_smoke.py",
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    sub = parser.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("list", help="model families and smoke configs")
    p.add_argument("--presets", action="store_true",
                   help="reference-scale constructors instead of smoke shapes")
    p.set_defaults(fn=cmd_list)
    p = sub.add_parser("smoke", help="build + one forward of a family (or 'all')")
    p.add_argument("family")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="where to run (default: the card)")
    p.set_defaults(fn=cmd_smoke)
    sub.add_parser("version", help="package, torch, CUDA and device").set_defaults(
        fn=cmd_version)
    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
