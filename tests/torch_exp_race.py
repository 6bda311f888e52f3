"""Counts fresh processes whose first parallel ``torch.exp`` on the CPU comes
out inaccurate, with and without the port's warm-up.

    python tests/torch_exp_race.py [--procs 80] [--parallel 8] [--cold]

On the CPU ``torch.exp`` runs MKL's vector math, split over the intra-op
threads, and MKL sets itself up on its first call. When two threads make
that first call together, one of them can get an exp about 1.5e-4 off
(relative) where 1e-7 is right. ``vit_tpu_torch/ops/block_attention.py``
takes the exp of one element at import, on one thread, which sets MKL up
first. Each child process here caps torch at 2 threads, starts its OpenMP
pool, imports the port's ops (unless ``--cold``), and takes the exp of 2888
fp32 values in one parallel call; a relative error above 1e-6 is a fault.
The fault is rare (a few in a few hundred cold processes), so this is a
measurement to run by hand, not a test.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

CHILD = """
import sys
import numpy as np, torch
torch.set_num_threads(2)
for _ in range(3):
    torch.ones(1 << 20).add_(1)  # the OpenMP pool is up before the first exp
if sys.argv[1] == "warm":
    sys.path.insert(0, sys.argv[2])
    import vit_tpu_torch.ops  # noqa: F401
x = torch.from_numpy(np.random.default_rng(0).uniform(-8, 0, 2888).astype(np.float32))
y = torch.exp(x)  # the first exp of the process, unless the import made one
ref = np.exp(x.numpy().astype(np.float64))
print(float((np.abs(y.numpy() - ref) / ref).max()))
"""


def first_exp_errors(procs: int, parallel: int, warm: bool) -> list:
    """Largest relative error of the first parallel exp in each of ``procs``
    fresh processes, started in waves of ``parallel`` at once (the fault
    needs the threads of a process to meet in MKL's set-up, which a loaded
    machine makes likelier)."""
    cmd = [sys.executable, "-c", CHILD, "warm" if warm else "cold", str(REPO)]
    errs = []
    for start in range(0, procs, parallel):
        wave = [subprocess.Popen(cmd, stdout=subprocess.PIPE, text=True)
                for _ in range(min(parallel, procs - start))]
        for p in wave:
            out = p.communicate(timeout=120)[0]
            if p.returncode != 0:
                raise RuntimeError(f"child process failed ({p.returncode})")
            errs.append(float(out))
    return errs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--procs", type=int, default=80)
    ap.add_argument("--parallel", type=int, default=8)
    ap.add_argument("--cold", action="store_true", help="without the port's warm-up")
    args = ap.parse_args()
    errs = first_exp_errors(args.procs, args.parallel, warm=not args.cold)
    faults = sum(e > 1e-6 for e in errs)
    print(f"{'cold' if args.cold else 'warm'}: {faults} of {len(errs)} processes had a first "
          f"exp off by more than 1e-6 (largest {max(errs):.3g})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
