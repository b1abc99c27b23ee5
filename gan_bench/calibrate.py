"""The readings a cell's limits are set from (``correct.py``): for each seed,
the gaps of the program's first three steps from the plain reference's
(sound runs), of the control's (the reference in float8 put in the
program's place), of the half-batch fault's (the reference on the first
half of every batch), and of the reference rounded to bfloat16 as the
control rounds to float8 (what rounding alone does at the program's
precision). No window is measured.

    python3 -m gan_bench.calibrate --workload <cell> --seeds 1,2,3 \\
        [--modes program,control,half_batch,bf16] [--out FILE.jsonl]

One JSON line per seed and mode, on standard output and appended to
``--out``. A state left unchanged, or one group of it (G's EMA, the
spectral norms' ``u``, the batch-norm statistics), reads about 1 on
``change_group_gap`` by its definition and needs no run.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from typing import Optional

MODES = ("program", "control", "half_batch", "bf16")


def readings(name: str, seed: int, modes=MODES, device: str = "cuda",
             overrides=None, require_card: bool = True,
             raw: Optional[list] = None) -> list:
    """One row of numbers per mode; each side's and the reference's
    readings appended to ``raw`` when given."""
    import torch

    from . import run
    from . import traffic as tr
    from .correct import gaps

    cell = run.Cell.load(run.benchmark(), name, overrides)
    if require_card:
        run.check_card(cell)
    seeds = tr.Seeds(seed)
    rows, t0 = [], time.perf_counter()
    prog_readings = None
    if "program" in modes:
        prog, prog_readings = run.prepare(cell, seeds, device)
        del prog
        gc.collect()
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
    ref = run.follow_reference(cell, seeds, device)
    sides = {"program": lambda: prog_readings,
             "control": lambda: run.follow_reference(cell, seeds, device, precision="fp8",
                                                     kink_margin=0.0),
             "half_batch": lambda: run.follow_reference(cell, seeds, device, half_batch=True,
                                                        kink_margin=0.0),
             "bf16": lambda: run.follow_reference(cell, seeds, device, precision="bf16",
                                                  kink_margin=0.0)}
    if raw is not None:
        raw.append({"workload": name, "seed": seed, "mode": "reference", "readings": ref})
    for mode in modes:
        side = sides[mode]()
        if raw is not None:
            raw.append({"workload": name, "seed": seed, "mode": mode, "readings": side})
        numbers, where = gaps(side, ref)
        rows.append({"workload": name, "seed": seed, "mode": mode, **numbers,
                     "where": where, "seconds": time.perf_counter() - t0})
    return rows


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--modes", default=",".join(MODES))
    p.add_argument("--out", default=None)
    p.add_argument("--raw", default=None,
                   help="append each side's readings (norms by leaf) to this JSONL file")
    p.add_argument("--overrides", default=None,
                   help='JSON, e.g. {"config": {"compute_dtype": "fp32"}}: the program '
                        "run otherwise than the configuration states (a witness)")
    args = p.parse_args(argv)
    from . import run
    run._cache_dirs()
    overrides = json.loads(args.overrides) if args.overrides else None
    for seed in (int(s) for s in args.seeds.split(",")):
        raw = [] if args.raw else None
        rows = readings(args.workload, seed, tuple(args.modes.split(",")),
                        overrides=overrides, raw=raw)
        if raw:
            with open(args.raw, "a") as f:
                f.writelines(json.dumps(r) + "\n" for r in raw)
        for row in rows:
            row["overrides"] = overrides
            line = json.dumps(row)
            print(line, flush=True)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
