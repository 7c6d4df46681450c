r"""``BENCHMARK.json`` and its files: the rules ``perfbench/manifest.py``
holds (names and units a file can be made from, layer metrics read where
the metric they move is reported), and that a new configuration, traffic mix or metric is found by
name without an edit."""

from __future__ import annotations

import copy
import hashlib
import json
from pathlib import Path

import pytest

from conftest import ROOT, copy_benchmark
from perfbench import manifest
from perfbench.reference import NAMES


def _data() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_the_benchmark_is_valid_and_every_file_is_found():
    man = manifest.load(ROOT)
    assert set(man.workloads) == {"fit-1m-t030", "fit-10m-t065"}
    assert set(man.configs) == {"lib1m-t030", "lib10m-t065"}
    assert [m["name"] for m in man.data["end_to_end"]] == ["fit_rate", "fit_peak_mem", "setup_s"]
    assert len(man.per_layer) == 10
    for cell in man.workloads:
        assert {m["name"] for m in man.per_layer_of(cell)} == set(man.per_layer)
        for m in man.per_layer_of(cell):
            assert m["moves"] == "fit_rate" and man.reports(man.end_to_end["fit_rate"], cell)
            assert callable(man.metric(m["name"]).read)


def test_every_config_states_its_limits_and_cuts():
    man = manifest.load(ROOT)
    for c in man.data["configs"]:
        cfg = man.config(c["name"])
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"]
        assert set(cfg["limits"]) == set(NAMES)
        assert all(cfg["limits"][k] == 0 for k in NAMES[:4])
        assert 0 < cfg["merge_share"] < 1 and 0 < cfg["limits"]["merge_share_gap"] < 1


def _breaks(data: dict, match: str) -> None:
    with pytest.raises(manifest.ManifestError, match=match):
        manifest._check(data)


@pytest.mark.parametrize(
    "edit, match",
    [
        (lambda d: d["workloads"][0].update(name="fit 1m"), "bad name"),
        (lambda d: d["workloads"][0].update(name="a" * 65), "bad name"),
        (lambda d: d["workloads"][0].update(traffic="library/fits"), "bad name"),
        (lambda d: d["configs"][0].update(name="lib,1m"), "bad name"),
        (lambda d: d["per_layer"][0].update(name="fit host syncs"), "bad name"),
        (lambda d: d["end_to_end"][0].update(unit="fingerprints per s"), "bad unit"),
        (lambda d: d["end_to_end"][0].update(unit="µs"), "bad unit"),
        (lambda d: d["per_layer"][0].update(moves="queries_per_s"), "moves"),
    ],
)
def test_rules_are_held(edit, match):
    data = copy.deepcopy(_data())
    edit(data)
    _breaks(data, match)


def test_a_layer_metric_must_be_reported_where_it_moves_its_metric():
    data = copy.deepcopy(_data())
    # fit_rate reported by one cell only: a layer metric of the other moves nothing
    data["end_to_end"][0]["workloads"] = ["fit-1m-t030"]
    _breaks(data, "does not report fit_rate")


def _digests(root: Path) -> dict[str, str]:
    return {
        str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
        for p in sorted(root.rglob("*")) if p.is_file() and p.name != "BENCHMARK.json"
    }


def test_new_config_traffic_and_metric_are_found_by_name(tmp_path):
    root = copy_benchmark(tmp_path)
    before = _digests(root)
    (root / "perfbench/configs/lib1m-t065.json").write_text(json.dumps(
        {**json.loads((root / "perfbench/configs/lib1m-t030.json").read_text()),
         "name": "lib1m-t065", "threshold": 0.65}
    ))
    (root / "perfbench/traffic/library-fits-small-chunks.json").write_text(json.dumps(
        {**json.loads((root / "perfbench/traffic/library-fits.json").read_text()),
         "warm_prefix_rows": 32768}
    ))
    (root / "perfbench/metrics/fit.rows_seen.py").write_text(
        "def read(obs):\n    return float(obs.rows)\n"
    )
    data = json.loads((root / "BENCHMARK.json").read_text())
    data["configs"].append({
        "name": "lib1m-t065", "source": "https://github.com/mqcomplab/bblean/blob/main/bblean/bitbirch.py",
        "file": "perfbench/configs/lib1m-t065.json", "reduced": [], "why": "control at t = 0.65",
    })
    data["workloads"].append({
        "name": "fit-1m-t065", "config": "lib1m-t065", "traffic": "library-fits-small-chunks",
        "chips": 1, "why": "the same shapes at t = 0.65",
    })
    data["per_layer"].append({
        "name": "fit.rows_seen", "unit": "rows", "better": "higher", "source": "program_counter",
        "layer": "host driver", "moves": "fit_rate", "workloads": ["fit-1m-t065"],
    })
    (root / "BENCHMARK.json").write_text(json.dumps(data))
    man = manifest.load(root)
    assert man.config("lib1m-t065")["threshold"] == 0.65
    assert man.traffic("library-fits-small-chunks")["warm_prefix_rows"] == 32768
    assert [m["name"] for m in man.per_layer_of("fit-1m-t065")] == ["fit.rows_seen"]
    assert man.metric("fit.rows_seen").read(type("O", (), {"rows": 3})()) == 3.0
    after = _digests(root)
    assert {k: after[k] for k in before} == before  # no file that was there changed


def test_a_missing_file_is_refused(tmp_path):
    root = copy_benchmark(tmp_path)
    (root / "perfbench/metrics/fit.route_ms.py").unlink()
    with pytest.raises(manifest.ManifestError, match="fit.route_ms.py is missing"):
        manifest.load(root)
