"""Write ``src/repro_torch/benchmarks/jax_rows.json``: the JAX package's
own rows for the figure and table modules that the port carries, in
default and in ``--smoke`` mode.

    PYTHONPATH=src python tools/make_jax_rows.py

With ``--dse`` it writes the JAX package's design-space frontier artifacts
instead: ``src/repro_torch/benchmarks/dse_smoke_jax.json`` (the 4-point
smoke grid) and ``dse_default_jax.json`` (the 136-point default grid),
each the file that

    PYTHONPATH=src python examples/noc_explore.py --dse [--smoke] --json OUT

writes. ``python -m repro_torch.noc_explore --dse [--smoke] --json OUT``
must write the same bytes (``tests/test_torch_noc_spec.py`` for the smoke
grid on the CPU, ``chip_smoke.py`` for it on the card).

For each module and mode it runs

    PYTHONPATH=src python -m benchmarks.run [--smoke] --json OUT --only MODULE

and keeps each row's ``name``, ``derived``, ``target`` and ``ok`` (the
timing column ``us_per_call`` is dropped) with the run's
``# paper-validation`` footer. The port's benchmarks hold their rows
equal to this file; ``tests/test_torch_benchmarks.py`` checks that the
smoke rows still equal a fresh JAX run.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "src" / "repro_torch" / "benchmarks" / "jax_rows.json"
DSE_OUT = {True: OUT.with_name("dse_smoke_jax.json"),
           False: OUT.with_name("dse_default_jax.json")}
MODULES = ("table1_links", "fig7_latency", "fig8_traffic", "fig9_area_power",
           "fig10_rob", "fig11_hbm", "table2_occamy", "table3_soa")
KEYS = ("name", "derived", "target", "ok")


def jax_rows(module: str, smoke: bool) -> dict:
    """One module's rows and footer from ``python -m benchmarks.run``."""
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / "rows.json"
        cmd = [sys.executable, "-m", "benchmarks.run", "--json", str(out),
               "--only", module] + (["--smoke"] if smoke else [])
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
        proc = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True, text=True)
        footer = [ln for ln in proc.stdout.splitlines() if ln.startswith("# paper-validation")]
        if not footer or not out.exists():
            raise RuntimeError(f"{' '.join(cmd)} failed:\n{proc.stderr}")
        rows = json.loads(out.read_text())["rows"]
    return {"rows": [{k: r[k] for k in KEYS} for r in rows], "footer": footer[0]}


def jax_dse(smoke: bool) -> None:
    """The JAX explorer's ``--dse`` artifact, written to ``DSE_OUT``."""
    cmd = [sys.executable, "examples/noc_explore.py", "--dse", "--json",
           str(DSE_OUT[smoke])] + (["--smoke"] if smoke else [])
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    proc = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"{' '.join(cmd)} failed:\n{proc.stderr}")


def main() -> None:
    if "--dse" in sys.argv[1:]:
        for smoke in (True, False):
            jax_dse(smoke)
        return
    jobs = [(m, smoke) for smoke in (False, True) for m in MODULES]
    with ThreadPoolExecutor(4) as pool:
        results = list(pool.map(lambda j: jax_rows(*j), jobs))
    data = {"command": "PYTHONPATH=src python tools/make_jax_rows.py",
            "default": {}, "smoke": {}}
    for (m, smoke), res in zip(jobs, results):
        data["smoke" if smoke else "default"][m] = res
    OUT.write_text(json.dumps(data, indent=1) + "\n")


if __name__ == "__main__":
    main()
