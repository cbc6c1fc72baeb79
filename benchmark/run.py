"""Runs one cell of the benchmark once and prints its result line:

  python3 benchmark/run.py --workload <name> --seed <n> --seconds <s>
      --trace <0|1>

The cell is `benchmark/workloads/<name>.json`: its configuration
(`benchmark/configs/<config>.json`), its entry (`benchmark/entries/
<entry>.py`, which builds and drives the program) and its traffic
parameters. Set-up builds the program's state from the seed, drives its
check steps and warms up; the window then runs the entry's unit back to
back for --seconds (a unit that starts inside the window is finished and
counted). With --trace 1 a profiled run of the workload's `trace_units`
follows, and the cell's per-layer metrics (`benchmark/metrics/<metric>.py`,
each a reader) replace its end-to-end ones. Last, the program is freed and
the plain reference (benchmark/reference) decides `correct`.

Exits with 1 and prints no result without a CUDA device, or when JAX or
the JAX package was loaded."""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HERE = os.path.join(ROOT, "benchmark")
FORBIDDEN = ("jax", "jaxlib", "flax", "gaussianip_tpu")


def load_json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def cell_metrics(bench: dict, workload: str, kind: str) -> list:
    """The `kind` metrics of BENCHMARK.json that this workload reports."""
    return [m for m in bench[kind]
            if workload in m.get("workloads", [workload])]


def reader(name: str):
    spec = importlib.util.spec_from_file_location(
        f"benchmark_metric_{name.replace('.', '_')}",
        os.path.join(HERE, "metrics", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def device_info(torch, n: int) -> dict:
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": n,
            "memory_peak_bytes": max(torch.cuda.max_memory_allocated(i)
                                     for i in range(n))}


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None, device: str = "cuda", adjust=None) -> dict:
    """One run; returns the result line (also printed). For the CPU tests:
    a `device` other than cuda skips the look for a card, and
    `adjust(cfg, workload)` shrinks the sizes."""
    args = parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    bench = load_json(ROOT, "BENCHMARK.json")
    cell = next(w for w in bench["workloads"] if w["name"] == args.workload)
    wl = load_json(HERE, "workloads", f"{args.workload}.json")
    cfg = load_json(HERE, "configs", f"{cell['config']}.json")
    if adjust is not None:
        adjust(cfg, wl)
    chips = cell["chips"]
    if device == "cuda" and not (torch.cuda.is_available()
                                 and torch.cuda.device_count() >= chips):
        print(f"the cell needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        sys.exit(1)
    cuda = device == "cuda"
    if cuda:
        # the host's part of a step runs on one thread: no intra-op pool
        # spinning beside it on the machine's shared cores
        torch.set_num_threads(1)
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    run = argparse.Namespace(cfg=cfg, params=wl["params"], seed=args.seed,
                             device=device)
    entries = importlib.import_module(f"benchmark.entries.{wl['entry']}")

    entry = entries.Entry(run)
    sync()
    t0 = time.perf_counter()
    setup_s = t0 - T_START
    units = 0
    while time.perf_counter() - t0 < args.seconds:
        entry.unit()
        units += 1
    sync()
    wall = time.perf_counter() - t0
    e2e = dict(entry.end_to_end(wall, units), setup_s=setup_s)
    if args.trace:
        from benchmark import trace as tr

        counters = entries.counters()
        before = {k: c.launches for k, c in counters.items()}
        traced = tr.profile(entry.unit, wl["params"]["trace_units"], sync,
                            cuda)
        traced["launches"] = {k: c.launches - before[k]
                              for k, c in counters.items()}
        ctx = argparse.Namespace(trace=traced, work=entry.work(),
                                 unit_s=wall / units, entry=entry)
        metrics = {}
        for m in cell_metrics(bench, args.workload, "per_layer"):
            v = reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        breakdown = {"device_ops": tr.top_ops(traced["device"]),
                     "idle_gaps": tr.idle_gaps(traced["device"],
                                               traced["host"])}
    else:
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in cell_metrics(bench, args.workload, "end_to_end")}
    dev = (device_info(torch, chips) if cuda else
           {"platform": "cpu", "kind": "cpu", "count": 1,
            "memory_peak_bytes": 0})
    if args.trace:
        dev.update(busy_s=tr.busy_s(traced["device"]),
                   window_s=traced["window_s"])

    # the check: the program freed, then the reference
    entry.close()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _, _, gaps = entry.check()
    limits = wl["limits"]
    compared = {k: {"value": gaps[k], "limit": limits[k]} for k in limits}
    failed = sum(c["value"] > c["limit"] for c in compared.values())
    bad = forbidden_modules()
    if bad:
        print(f"loaded, and must not be: {bad}", file=sys.stderr)
        sys.exit(1)
    line = {"correct": failed == 0, "attempted": units, "failed": failed,
            "metrics": metrics, "device": dev}
    if args.trace:
        line["breakdown"] = breakdown
    line["compared"] = compared  # last: each compared number, its limit
    for k, c in compared.items():
        print(f"compared {k}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
