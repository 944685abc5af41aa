"""The controls of a cell's check, one precision below the bf16 the
configurations state; their numbers set the upper readings of the cell's
limits, and the check has to find each not correct:

- ``w8a8``: the run with the program's own lower-precision path switched
  on (``DiffusionModel.requantize_i8``: int8 weights and int8 activations
  through the w8a8 kernels). It fails ``op_gap``; in the whole-stage gaps
  its int8 rounding hides under the bf16 path's own.
- ``fp8``: the reference with every activation rounded to float8 e4m3
  (``refops.rounded``) in the program's place in the whole-stage gaps
  (``fwd_gap``, and for text to image ``text_gap`` and ``image_gap``), on
  the latents a sound run of the program produced. The program's own
  readings of the same run come beside it (``info.program``), so one run
  gives both readings of those limits.
- ``none``: the program alone (its readings, for the lower ends).

    python benchmark/control.py --workload NAME --kind fp8 --seconds S SEED [SEED ...]

prints one JSON line per seed, then a summary; exits 0 when every seed's
run came out as the kind should (a control not correct, ``none``
correct). Needs the card, as the benchmark does.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import run


def w8a8(model) -> None:
    model.requantize_i8()


# each kind's arguments to ``run.run_cell``
KINDS = {"w8a8": {"tree_hook": w8a8}, "fp8": {"control": "fp8"},
         "none": {}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--kind", choices=sorted(KINDS), default="w8a8")
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("seeds", type=int, nargs="+")
    args = ap.parse_args(argv)
    run._cache_dirs(run.ROOT)
    import torch

    if not torch.cuda.is_available():
        print("refused: no CUDA card", file=sys.stderr)
        return 3
    run._paths(run.BENCH)
    import program

    program.enable_build_cache(str(run.ROOT / ".bench_cache" / "kernels"))
    caught = 0
    for seed in args.seeds:
        res = run.run_cell(run.ROOT, args.workload, seed, args.seconds,
                           False, t0=time.perf_counter(),
                           **KINDS[args.kind])
        caught += not res["correct"]
        print(json.dumps({"seed": seed, "correct": res["correct"],
                          "checks": res["checks"], "info": res["info"],
                          "device": res["device"]}), flush=True)
        torch.cuda.empty_cache()
    print(f"{args.kind}: not correct on {caught} of {len(args.seeds)} "
          f"seeds", flush=True)
    want = 0 if args.kind == "none" else len(args.seeds)
    return 0 if caught == want else 1


if __name__ == "__main__":
    sys.exit(main())
