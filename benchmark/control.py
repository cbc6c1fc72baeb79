"""The readings that a cell's limits are set from, on the card, in one
process (the benchmark's own runs never run this):

  python3 benchmark/control.py --workload <name> --seeds <n,n,...>
      --control-seeds <n,n,n> [--out FILE]

For each of --seeds: the program's set-up and check steps, as a run makes
them, then the plain reference's; the gaps are the lower readings. For
each of --control-seeds: the reference in float32 against the control
(the reference one precision step below the configuration's, as the
workload's `control` names it) and
against the reference with half of each step's views left out (a fault
planted in the reference); the least of those gaps are the upper readings.
A state left unchanged reads 1 in `grad` and `change` without a run.
Prints one JSON line (and writes it to --out)."""

import argparse
import gc
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None, device="cuda", adjust=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    import importlib

    import torch

    from benchmark import run as bench_run

    wl = bench_run.load_json(bench_run.HERE, "workloads",
                             f"{args.workload}.json")
    cfg = bench_run.load_json(bench_run.HERE, "configs",
                              f"{wl['config']}.json")
    if adjust is not None:
        adjust(cfg, wl)
    entries = importlib.import_module(f"benchmark.entries.{wl['entry']}")
    seeds = [int(s) for s in args.seeds.split(",") if s]
    cseeds = [int(s) for s in args.control_seeds.split(",") if s]

    def free():
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()

    def ctx(seed):
        return argparse.Namespace(cfg=cfg, params=wl["params"], seed=seed,
                                  device=device)

    out = {"workload": args.workload, "program": {}}
    if device == "cuda":
        out["device"] = torch.cuda.get_device_name(0)
    refs = {}
    for s in seeds:
        t0 = time.perf_counter()
        e = entries.Entry(ctx(s))
        e.unit()  # a window's first unit (stage 3's carries the densify)
        e.close()
        free()
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        prog, refs[s], out["program"][s] = e.check()
        if "grad" in prog:  # each leaf's first-gradient norm, both sides
            out.setdefault("grad_norms", {})[s] = {
                "program": prog["grad"], "reference": refs[s]["grad"]}
        if hasattr(e, "unchanged_densify"):
            out.setdefault("unchanged", {})[s] = e.unchanged_densify()
        del e
        free()
        print(f"seed {s}: {out['program'][s]} "
              f"({time.perf_counter() - t0:.1f} s)", file=sys.stderr,
              flush=True)
    for s in cseeds:
        ref = refs[s] if s in refs else entries.reference_readings(ctx(s))
        for kind, kw in ([("control", {"quant": wl["control"]})]
                         + [(f, {"fault": f}) for f in entries.FAULTS]):
            got = entries.reference_readings(ctx(s), **kw)
            out.setdefault(kind, {})[s] = entries.gaps(got, ref)
            free()
            print(f"{kind} {s}: {out[kind][s]}", file=sys.stderr,
                  flush=True)
    keys = sorted(next(iter(out["program"].values()), {}))
    out["lower"] = {k: max((g[k] for g in out["program"].values()),
                           default=None) for k in keys}
    for kind in ["control", *entries.FAULTS]:
        out[f"upper_{kind}"] = {k: min((g[k] for g in out.get(kind, {})
                                        .values() if k in g), default=None)
                                for k in keys}
    line = json.dumps(out)
    print(line, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return out


if __name__ == "__main__":
    main()
