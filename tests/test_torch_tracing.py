"""The port's spans and pair counters (``utils/tracing.py``) on the CPU, at
the tiny network configuration of the port's tests, each case for 3DGS and
2DGS: off, a forward records nothing and opens no profiler range, and gives
bitwise the outputs it gives on; under ``torch.profiler`` each request is
one ``gd.forward`` tree whose spans are the profiler's ranges on the same
clock; the pair counters against the compositor's inputs and the
``overflow`` output; the names the benchmark patches and hooks still bind.

    python -m pytest tests/test_torch_tracing.py -q
"""

from __future__ import annotations

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from generativedensification_torch.data.synthetic import make_probe_batch
from generativedensification_torch.models import network as tnet
from generativedensification_torch.points import modules as pmod
from generativedensification_torch.splat import composite, surfel
from generativedensification_torch.utils import tracing

TINY = dict(   # tests/test_torch_fine.py's tiny configuration
    n_views=2, encoder_backbone="tiny_test", n_groups=(4,), n_offset_groups=8,
    num_layers=2, num_heads=4, view_embed_dim=8, embedding_dim=32,
    vol_feat_reso=4, vol_embedding_reso=8, vol_embedding_out_dim=16,
    k_num=96, dec_depths=(1, 1), dec_channels=(32, 48), dec_num_head=(4, 6),
    dec_patch_size=(48, 48), non_leaf_ratio=(0.75,), upscale_factor=(2, 4),
    mask_pool=192, tile_size=16, max_tiles=8, max_per_tile=256,
)
V_TOTAL = 4
RENDERERS = ("3dgs", "2dgs")
# per renderer: the compositor launches as the modules that call them hold
# them, and the render function as the network holds it
FWD = {"3dgs": (composite, "composite_fwd"), "2dgs": (surfel, "surfel_fwd")}
BWD = {"3dgs": (composite, "composite_bwd"), "2dgs": (surfel, "surfel_bwd")}
RASTER = {"3dgs": "rasterize", "2dgs": "rasterize_surfels"}


def _net(renderer: str, **over):
    cfg = tnet.NetworkConfig(**{**TINY, **over}, renderer=renderer)
    return tnet.Network(cfg, device="cpu", seed=3)


def _batch():
    return make_probe_batch(1, V_TOTAL, 64, 64, TINY["n_views"], seed=0, device="cpu")


def _serve(net, batch):
    with torch.no_grad():
        return net(batch, with_fine=True)


@pytest.fixture(autouse=True)
def _clean_record():
    tracing.disable()
    tracing.reset()
    yield
    tracing.disable()
    tracing.reset()


def _flat(out: dict) -> dict:
    flat = {}
    for k, v in out.items():
        if k == "render_pkg":
            for i, pkg in enumerate(v):
                flat.update({f"render_pkg{i}.{j}": t for j, t in enumerate(pkg)})
        else:
            flat[k] = v
    return flat


@pytest.mark.parametrize("renderer", RENDERERS)
def test_off_records_nothing_and_on_changes_no_output(renderer, monkeypatch):
    """(a) Off: no ``record_function`` constructed, nothing kept, one shared
    no-op context.  On: the same outputs, bit for bit."""
    made = []
    real = tracing.record_function
    monkeypatch.setattr(tracing, "record_function",
                        lambda name: made.append(name) or real(name))
    net, batch = _net(renderer), _batch()
    assert tracing.span("gd.a") is tracing.span("gd.b")
    off = _flat(_serve(net, batch))
    assert made == []
    assert tracing.records() == [] and tracing.summary()["requests"] == 0
    tracing.enable()
    on = _flat(_serve(net, batch))
    tracing.disable()
    assert made and made[0] == "gd.forward"
    assert tracing.summary()["requests"] == 1
    assert set(off) == set(on)
    for k in off:
        assert torch.equal(off[k], on[k]), k


@pytest.mark.parametrize("renderer", RENDERERS)
def test_profiler_ranges_are_the_spans_on_one_clock(renderer):
    """(b) Under the profiler: one ``gd.forward`` root per request, every
    parent enclosing its child, the counts per name the configuration
    gives, and each span a profiler range of its name whose start and
    duration are the record's host stamps within 1 ms."""
    net, batch = _net(renderer), _batch()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _serve(net, batch)
        _serve(net, batch)
    recs = tracing.records()
    by_id = {r["id"]: r for r in recs}
    roots = [r for r in recs if r["parent"] is None]
    assert [r["name"] for r in roots] == ["gd.forward", "gd.forward"]
    for r in recs:
        if r["parent"] is not None:
            up = by_id[r["parent"]]
            assert up["request"] == r["request"]
            assert up["t0"] <= r["t0"] and r["t1"] <= up["t1"], (up["name"], r["name"])
    want = {"gd.forward": 1, "gd.encoder": 1, "gd.voltx": 1,
            "gd.densifier": len(TINY["dec_channels"]),
            "gd.render": 2 * V_TOTAL, "gd.project": 2 * V_TOTAL, "gd.bin": 2 * V_TOTAL,
            "gd.composite": 2 * V_TOTAL, "gd.sel_bwd": TINY["n_views"]}
    for root in roots:
        got = {}
        for r in recs:
            if r["request"] == root["id"]:
                got[r["name"]] = got.get(r["name"], 0) + 1
        assert got == want
    s = tracing.summary()
    assert s["requests"] == 2
    assert {k: v["count"] for k, v in s["spans"].items()} == {k: 2 * n for k, n in want.items()}
    assert all(v["device_ms"] is None for v in s["spans"].values())
    fwd = s["spans"]["gd.forward"]
    children = sum(s["spans"][k]["host_ms"] for k in
                   ("gd.encoder", "gd.voltx", "gd.densifier", "gd.render"))
    assert fwd["self_host_ms"] == pytest.approx(fwd["host_ms"] - children)
    assert 0 < fwd["self_host_ms"] < fwd["host_ms"]
    # the shared clock: the profiler's ranges of each name, in order
    ranges = {}
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith("gd."):
            ranges.setdefault(e.name(), []).append((e.start_ns(), e.duration_ns()))
    for name in want:
        mine = sorted((r["t0"], r["t1"] - r["t0"]) for r in recs if r["name"] == name)
        theirs = sorted(ranges[name])
        assert len(mine) == len(theirs), name
        for (t0, d), (p0, pd) in zip(mine, theirs):
            assert abs(t0 - p0) < 1_000_000 and abs(d - pd) < 1_000_000, name


@pytest.mark.parametrize("renderer", RENDERERS)
def test_pair_counters_match_the_compositor_inputs_and_overflow(renderer, monkeypatch):
    """(c) ``pairs`` is the sum of the clamped tile counts handed to the
    forward compositor; ``pairs_dropped`` is the sum of the forward's
    ``overflow`` output, at budgets small enough to drop pairs."""
    mod, attr = FWD[renderer]
    real, handed = getattr(mod, attr), []

    def fwd(table, sorted_ids, tile_starts, tile_counts, *a, **k):
        handed.append(int(tile_counts.sum()))
        return real(table, sorted_ids, tile_starts, tile_counts, *a, **k)

    monkeypatch.setattr(mod, attr, fwd)
    net = _net(renderer, max_tiles=2, max_per_tile=24)
    tracing.enable()
    out = _serve(net, _batch())
    tracing.disable()
    c = tracing.summary()["counters"]
    assert len(handed) == 2 * V_TOTAL
    assert c["pairs"] == sum(handed) > 0
    assert c["pairs_dropped"] == int(out["overflow"].sum()) > 0


@pytest.mark.parametrize("renderer", RENDERERS)
def test_the_benchmarks_binding_points_still_bind(renderer, monkeypatch):
    """(d) With tracing on, patching the module-level names the benchmark
    patches (the renders as the network calls them, the compositor
    launches, ``topk_split``) and hooking the modules it hooks intercepts
    every call."""
    calls = {}

    def spy(owner, attr):
        real = getattr(owner, attr)
        key = f"{owner.__name__.rsplit('.', 1)[-1]}.{attr}"

        def run(*a, **k):
            calls[key] = calls.get(key, 0) + 1
            return real(*a, **k)

        monkeypatch.setattr(owner, attr, run)

    spy(tnet, RASTER[renderer])
    spy(*FWD[renderer])
    spy(*BWD[renderer])
    spy(tnet, "topk_split")
    spy(pmod, "topk_split")
    net = _net(renderer)
    hooked = []
    for name, m in (("encoder", net.img_encoder), ("voltx", net.vol_decoder),
                    *(("densifier", st) for st in net.stages)):
        m.register_forward_pre_hook(lambda mod, a, n=name: hooked.append(n))
    tracing.enable()
    _serve(net, _batch())
    tracing.disable()
    lib = "composite" if renderer == "3dgs" else "surfel"
    assert calls[f"network.{RASTER[renderer]}"] == 2 * V_TOTAL
    assert calls[f"{lib}.{FWD[renderer][1]}"] == 2 * V_TOTAL
    assert calls[f"{lib}.{BWD[renderer][1]}"] == TINY["n_views"]
    assert calls["network.topk_split"] == 2 and calls["modules.topk_split"] >= 1
    assert hooked == ["encoder", "voltx"] + ["densifier"] * len(TINY["dec_channels"])
    assert tracing.summary()["spans"]["gd.render"]["count"] == 2 * V_TOTAL
