"""The metrics that read the program's own spans and counters
(``metrics/_program_spans.py`` and its readers) on the CPU: each turns a
hand-made ``summary()`` into its per-request value, reads nothing where the
program has no tracing module or recorded no request, and reads a tiny
traced forward; each ``BENCHMARK.json`` entry names existing cells and has
its file.

    python -m pytest benchmark/tests/test_bench_program_spans.py -q
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import pytest
import torch

from benchmark.harness import spec
from benchmark.metrics import _program_spans
from generativedensification_torch.utils import tracing

ROOT = Path(__file__).resolve().parents[2]
REQUESTS = 4


def _totals(host, dev, self_host=None, self_dev=None, count=8):
    return {"count": count, "host_ms": host, "device_ms": dev,
            "self_host_ms": host if self_host is None else self_host,
            "self_device_ms": dev if self_dev is None else self_dev}


SUMMARY = {
    "requests": REQUESTS,
    "spans": {
        "gd.forward": _totals(400.0, 1000.0, self_host=60.0, self_dev=120.0, count=4),
        "gd.render": _totals(200.0, 480.0, self_host=20.0, self_dev=30.0, count=64),
        "gd.project": _totals(40.0, 80.0, count=64),
        "gd.bin": _totals(80.0, 200.0, count=64),
        "gd.composite": _totals(48.0, 120.0, count=64),
        "gd.sel_bwd": _totals(12.0, 50.0, count=16),
    },
    "counters": {"pairs": 4 * 6_500_000, "pairs_dropped": 4 * 1_234},
}
# metric -> the value per request SUMMARY gives
EXPECTED = {
    "project_ms.serve": 20.0,
    "bin_ms.serve": 50.0,
    "composite_ms.serve": 30.0,
    "sel_bwd_ms.serve": 12.5,
    "render_host_ms.serve": 50.0,
    "forward_host_ms.serve": 100.0,
    "glue_ms.serve": 30.0,
    "pairs_m.serve": 6.5,
    "pairs_dropped.serve": 1234.0,
}
TINY = dict(
    n_views=2, encoder_backbone="tiny_test", n_groups=(4,), n_offset_groups=8,
    num_layers=2, num_heads=4, view_embed_dim=8, embedding_dim=32,
    vol_feat_reso=4, vol_embedding_reso=8, vol_embedding_out_dim=16,
    k_num=96, dec_depths=(1, 1), dec_channels=(32, 48), dec_num_head=(4, 6),
    dec_patch_size=(48, 48), non_leaf_ratio=(0.75,), upscale_factor=(2, 4),
    mask_pool=192, tile_size=16, max_tiles=8, max_per_tile=256)


@pytest.fixture(autouse=True)
def _clean_record():
    tracing.disable()
    tracing.reset()
    yield
    tracing.disable()
    tracing.reset()


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_turns_a_summary_into_its_per_request_value(name, monkeypatch):
    monkeypatch.setattr(tracing, "summary", lambda: SUMMARY)
    assert spec.reader(name)({}) == pytest.approx(EXPECTED[name], rel=1e-12)


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reader_reads_nothing_without_the_module_or_a_record(name, monkeypatch):
    read = spec.reader(name)
    assert read({}) is None                      # the record is empty
    monkeypatch.setitem(sys.modules, _program_spans.TRACING, None)
    assert read({}) is None                      # an older program: no module


def test_device_metrics_read_nothing_without_device_times(monkeypatch):
    cpu = {k: dict(v, device_ms=None, self_device_ms=None)
           for k, v in SUMMARY["spans"].items()}
    monkeypatch.setattr(tracing, "summary", lambda: dict(SUMMARY, spans=cpu))
    for name in ("project_ms.serve", "bin_ms.serve", "composite_ms.serve",
                 "sel_bwd_ms.serve", "glue_ms.serve"):
        assert spec.reader(name)({}) is None, name
    assert spec.reader("forward_host_ms.serve")({}) == 100.0


@pytest.mark.parametrize("renderer", ("3dgs", "2dgs"))
def test_readers_of_a_tiny_traced_forward(renderer):
    from generativedensification_torch.data.synthetic import make_probe_batch
    from generativedensification_torch.models.network import Network, NetworkConfig

    net = Network(NetworkConfig(**TINY, renderer=renderer), device="cpu")
    batch = make_probe_batch(1, 4, 64, 64, 2, seed=1, device="cpu")
    tracing.enable()
    with torch.no_grad():
        out = net(batch, with_fine=True)
    tracing.disable()
    got = {n: spec.reader(n)({}) for n in EXPECTED}
    assert got["forward_host_ms.serve"] > got["render_host_ms.serve"] > 0
    assert 0 < got["pairs_m.serve"] <= 8 * 16 * 256 * 1e-6  # renders x tiles x cap
    assert got["pairs_dropped.serve"] == int(out["overflow"].sum())
    # the CPU has no device times
    assert got["project_ms.serve"] is None and got["glue_ms.serve"] is None


def test_entries_name_existing_cells_and_have_their_files():
    real = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = {w["name"] for w in real["workloads"]}
    entries = {m["name"]: m for m in real["per_layer"]}
    for name in EXPECTED:
        m = entries[name]
        assert set(m["workloads"]) <= cells and m["workloads"], name
        assert m["moves"] == "recon_per_s"
        assert m["source"] == ("program_counter" if name.startswith("pairs")
                               else "program_span")
        assert (ROOT / "benchmark" / "metrics" / f"{name}.py").is_file()
        assert callable(spec.reader(name))
