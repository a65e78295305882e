"""The readings that the limits of `correct` are set from, on the card:

    python3 -m gtobench.control --workload <name> --seeds 1,2,3 [--control-seeds 1,2,3]
        [--fault-seeds 1,2,3] [--seconds 5]

For each seed of `--seeds`, a run of the cell (set-up, a window of
`--seconds`, the program's state freed) and the comparison with the
reference: the lower readings. For each seed of `--control-seeds`, the
control: the reference computed in the precision below the
configuration's (float32 with TF32 matrix products, for a configuration of
float32 with TF32 off) put in the program's place: the upper readings.
For each seed of `--fault-seeds`, the numbers of the faults the driver
plants in the window's outputs (a state returned unchanged, half the batch
left out): the readings of the numbers the control leaves alone. With
`--seeds`, the driver's `notes` too (counts the comparison leaves out).
One JSON line a seed. The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import importlib
import json

from gtobench.run import ROOT, _environment


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--seconds", type=float, default=5.0)
    args = ap.parse_args(argv)
    _environment()
    import torch

    from gtobench import manifest

    cell = manifest.cell(manifest.load(ROOT), ROOT, args.workload)
    drivers = importlib.import_module(f"gtobench.drivers.{cell.config['driver']}")
    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    seeds = [int(s) for s in args.seeds.split(",") if s]
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    faults = {int(s) for s in args.fault_seeds.split(",") if s}
    for seed in seeds + sorted((controls | faults) - set(seeds)):
        driver = drivers.Driver(cell, seed, device)
        window = driver.window(args.seconds)
        driver.release()
        out = {"workload": args.workload, "seed": seed, "calls": len(window.calls)}
        if seed in seeds:
            out["program"] = dict(driver.check())
            out["notes"] = driver.notes
        if seed in controls:
            out["control"] = dict(driver.control())
        if seed in faults:
            out["faults"] = {k: dict(v) for k, v in driver.faults().items()}
        print(json.dumps(out), flush=True)
        del driver
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
