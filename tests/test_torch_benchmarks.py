"""The port's figure and table modules (``repro_torch.benchmarks``) against
the JAX package's rows in ``src/repro_torch/benchmarks/jax_rows.json``.

* ``python -m repro_torch.benchmarks.run --smoke --device cpu``: every
  row's name, ``derived`` value, target and verdict equal to the JAX smoke
  rows, and the same ``# paper-validation`` count;
* the analytical modules' default rows equal too (the simulator modules'
  default rows take minutes per figure: they are held to the file on the
  card, by ``chip_smoke.py`` and the full run the README names);
* the file is not stale: the JAX package's own smoke rows, and its
  analytical modules' default rows, computed afresh, equal the file's;
* without a card and without ``--device cpu`` the run raises.

The simulator is exact and the models are the same arithmetic, so every
comparison is equality.
"""
import importlib
import inspect
import json
import re

import pytest
import torch

from repro_torch.benchmarks import run as TRUN
from repro_torch.benchmarks.run import MODULES

torch.set_num_threads(1)

ROWS_FILE = TRUN.__file__.replace("run.py", "jax_rows.json")
KEYS = ("name", "derived", "target", "ok")
ANALYTICAL = ("table1_links", "fig9_area_power", "table2_occamy", "table3_soa")


def _load():
    with open(ROWS_FILE) as f:
        return json.load(f)


def _as_json(rows):
    """Rows as the file stores them (numpy scalars through ``str``)."""
    return json.loads(json.dumps([{k: r[k] for k in KEYS} for r in rows], default=str))


def _count(footers):
    n = [tuple(map(int, re.search(r"(\d+)/(\d+)", f).groups())) for f in footers]
    return f"# paper-validation: {sum(a for a, _ in n)}/{sum(b for _, b in n)} targets matched"


def test_file_covers_every_module():
    data = _load()
    names = [m for m, _ in MODULES]
    assert sorted(data["smoke"]) == sorted(names) == sorted(data["default"])
    assert data["command"].startswith("PYTHONPATH=src python tools/make_jax_rows.py")


def test_smoke_run_on_cpu_equals_jax_rows(tmp_path, capsys):
    out = tmp_path / "rows.json"
    TRUN.main(["--smoke", "--device", "cpu", "--json", str(out)])
    got = json.loads(out.read_text())
    assert got["device"] == "cpu" and got["smoke"]
    data = _load()["smoke"]
    for name, _ in MODULES:
        rows = [r for r in got["rows"] if r["module"] == name]
        assert _as_json(rows) == data[name]["rows"], name
    footer = capsys.readouterr().out.strip().splitlines()[-1]
    assert footer == _count(v["footer"] for v in data.values())


@pytest.mark.parametrize("name", ANALYTICAL)
def test_analytical_default_rows_equal_jax_rows(name):
    mod = dict(MODULES)[name]
    assert _as_json(mod.bench()) == _load()["default"][name]["rows"]


def _jax_bench(name, smoke):
    mod = importlib.import_module(f"benchmarks.{name}")
    kw = {"smoke": True} if smoke and "smoke" in inspect.signature(mod.bench).parameters else {}
    return _as_json(mod.bench(**kw))


@pytest.mark.parametrize("name", [m for m, _ in MODULES])
def test_file_equals_a_fresh_jax_smoke_run(name):
    assert _jax_bench(name, smoke=True) == _load()["smoke"][name]["rows"]


@pytest.mark.parametrize("name", ANALYTICAL)
def test_file_equals_fresh_jax_analytical_default_rows(name):
    assert _jax_bench(name, smoke=False) == _load()["default"][name]["rows"]


def test_run_refuses_to_drop_to_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TRUN.main(["--smoke", "--only", "table1"])
