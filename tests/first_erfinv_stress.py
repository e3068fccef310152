"""How often the first draw of a kernel in a fresh process differs from the
same draw on one thread (a script, not a test).

    python tests/first_erfinv_stress.py [--processes 400] [--parallel 8] [--pooled]

Starts ``--processes`` Python processes, ``--parallel`` at a time. Each
draws a 64x3x7x7 kernel (ResNet-18's conv1, the first kernel that
``DynamoModel`` draws) from seed 0 through
``dynamo_depth_torch/models/init.py::lecun_normal_`` on torch's default
thread pool, and prints the draw's hash. With ``--pooled`` each process
instead maps the same uniform draw through ``erfinv_`` on the thread pool,
as ``lecun_normal_`` did before it kept erfinv on the calling thread. The
script prints how many processes drew each hash: one line when every
process drew the same weights.
"""

import argparse
import collections
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

DRAW = """
import hashlib, math, sys, torch
from dynamo_depth_torch.models.init import _TRUNCATED_STD, lecun_normal_
w, g = torch.empty(64, 3, 7, 7), torch.Generator().manual_seed(0)
if sys.argv[1] == "pooled":
    std, edge = math.sqrt(1 / 147) / _TRUNCATED_STD, math.erf(2 / math.sqrt(2))
    w.uniform_(-edge, edge, generator=g).erfinv_().mul_(std * math.sqrt(2)).clamp_(-2 * std, 2 * std)
else:
    lecun_normal_(w, 147, g)
print(hashlib.sha256(w.numpy().tobytes()).hexdigest()[:12], torch.get_num_threads())
"""


def draw(mode: str) -> str:
    out = subprocess.run([sys.executable, "-c", DRAW, mode], cwd=str(ROOT), capture_output=True, text=True,
                         timeout=300)
    return out.stdout.strip() or f"rc={out.returncode}: {out.stderr.strip()[-200:]}"


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--processes", type=int, default=400)
    ap.add_argument("--parallel", type=int, default=8)
    ap.add_argument("--pooled", action="store_true")
    args = ap.parse_args(argv)
    mode = "pooled" if args.pooled else "lecun_normal_"
    with ThreadPoolExecutor(args.parallel) as pool:
        counts = collections.Counter(pool.map(draw, [mode] * args.processes))
    print(f"{mode}: {args.processes} processes, {args.parallel} at a time (hash, threads: processes)")
    for line, n in counts.most_common():
        print(f"  {line}: {n}")


if __name__ == "__main__":
    main()
