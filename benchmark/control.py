"""The readings the check's limits are set from, in one process per cell:
the program's compared numbers on each seed after one chunk of the
window's entry, and the control's (the reference computed in TF32 in the
program's place) on the control seeds.  Prints one JSON line per seed.

    python3 benchmark/control.py --workload <cell> --seeds 1,2,3 \
        --control-seeds 1,2,3 [--steps n]

``--steps`` runs that many steps first (in chunks of the cell's, as the
window does) instead of one chunk, so that the readings come from a state
as far from the placements as a window's end.

Needs the card, as the benchmark does.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def readings(cell, seeds, control_seeds, steps, device):
    """Yield {seed, program: numbers[, control: numbers]} per seed, after
    ``steps`` steps (0: one chunk)."""
    import torch

    from benchmark import check, harness, system, traffic
    from benchmark.reference.arith import TF32

    for seed in seeds:
        t0 = time.perf_counter()
        sysm = system.build(cell, seed, device)
        gen = torch.Generator(device=device).manual_seed(
            traffic.stream(seed, traffic.DRAWS))
        state, done = sysm.state, 0
        while done < (steps or sysm.chunk):
            n = min(sysm.chunk, (steps or sysm.chunk) - done)
            state, _ = system.run_chunk(sysm, state, n, gen, sysm.force_fn)
            done += n
        out, rows = harness.outputs(cell, sysm, state, seed, device)
        row = {"seed": seed, "program": check.judge(
            out, sysm.sim, sysm.shell, rows, device)}
        if seed in control_seeds:
            row["control"] = check.judge(out, sysm.sim, sysm.shell, rows,
                                         device, TF32)
        row["seconds"] = time.perf_counter() - t0
        yield row


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--steps", type=int, default=0)
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    from benchmark import spec

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    cell = spec.cell(args.workload)
    seeds = [int(s) for s in args.seeds.split(",")]
    ctrl = {int(s) for s in args.control_seeds.split(",") if s}
    for row in readings(cell, seeds, ctrl, args.steps,
                        torch.device("cuda", 0)):
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
