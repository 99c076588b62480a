"""Benchmark harness of the port: one module per paper table/figure.

Prints ``name,us_per_call,derived`` CSV (plus target/ok columns) and a
validation summary against the paper's published numbers, as the JAX
package's ``python -m benchmarks.run`` does, for the modules the port
carries.

Usage: PYTHONPATH=src python -m repro_torch.benchmarks.run [--full] [--smoke]
           [--only SUBSTRING] [--json out.json] [--device cuda|cpu]

``--smoke`` runs every benchmark at toy scale and fails only on
exceptions, not on missed paper targets. ``--json`` additionally writes
all rows, and each module's wall time in seconds, to a JSON file,
rewritten after every module. The simulations run on the card unless
``--device cpu`` is named; without a card and without it, the run raises.
"""
from __future__ import annotations

import argparse
import inspect
import json
import sys
import time

from repro_torch.benchmarks import (
    common,
    fig7_latency,
    fig8_traffic,
    fig9_area_power,
    fig10_rob,
    fig11_hbm,
    table1_links,
    table2_occamy,
    table3_soa,
)
from repro_torch.device import resolve_device

MODULES = (
    ("table1_links", table1_links),
    ("fig7_latency", fig7_latency),
    ("fig8_traffic", fig8_traffic),
    ("fig9_area_power", fig9_area_power),
    ("fig10_rob", fig10_rob),
    ("fig11_hbm", fig11_hbm),
    ("table2_occamy", table2_occamy),
    ("table3_soa", table3_soa),
)


def bench_rows(mod, full: bool, smoke: bool, device) -> list[dict]:
    """One module's rows: ``smoke`` and ``device`` go to the modules whose
    ``bench`` takes them."""
    kwargs = {"full": full}
    params = inspect.signature(mod.bench).parameters
    if smoke and "smoke" in params:
        kwargs["smoke"] = True
    if "device" in params:
        kwargs["device"] = device
    return mod.bench(**kwargs)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true", help="larger sweeps")
    ap.add_argument("--smoke", action="store_true",
                    help="toy scale, fail on exceptions only")
    ap.add_argument("--json", default=None, help="write rows to this JSON file")
    ap.add_argument("--only", default=None, help="substring filter on module name")
    ap.add_argument("--device", default=None,
                    help="where the simulator runs (default: cuda; name cpu "
                         "to run the plain PyTorch version)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    print(common.CSV_HEADER)
    n_checked = n_ok = 0
    failed = []
    all_rows = []
    seconds = {}
    for name, mod in MODULES:
        if args.only and args.only not in name:
            continue
        t0 = time.perf_counter()
        for r in bench_rows(mod, args.full, args.smoke, device):
            all_rows.append({"module": name, "device": str(device), **r})
            print(common.csv_line(r), flush=True)
            if r["ok"] is not None:
                n_checked += 1
                n_ok += bool(r["ok"])
                if not r["ok"]:
                    failed.append(r["name"])
        seconds[name] = time.perf_counter() - t0
        if args.json:
            with open(args.json, "w") as f:
                json.dump({"smoke": args.smoke, "full": args.full,
                           "device": str(device), "module_seconds": seconds,
                           "rows": all_rows}, f, indent=1, default=str,
                          sort_keys=True)
    print(f"\n# paper-validation: {n_ok}/{n_checked} targets matched", flush=True)
    if failed:
        print("# failed targets:", ", ".join(failed))
        if not args.smoke:
            sys.exit(1)


if __name__ == "__main__":
    main()
