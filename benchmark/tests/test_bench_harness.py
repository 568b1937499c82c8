"""The benchmark's harness on the CPU at a tiny size: cells found by name
and taken up as data, the result line, the numbers compared and the
faults they catch, the yardstick's counts against hand-worked cases, the
benchmark's compositors against the port's plain versions, and the check
for JAX by whole top-level module names.

    python -m pytest benchmark/tests -q
"""

from __future__ import annotations

import dataclasses
import json
import math
import shutil
import sys
import time
from pathlib import Path

import pytest
import torch

from benchmark.harness import counting, scenes, serve, spec, weights
from benchmark.reference.splat import kernels as rk
from benchmark.reference.splat import surfel_kernels as rs

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"
TINY_MODEL = dict(
    n_views=2, encoder_backbone="tiny_test", n_groups=[4], n_offset_groups=8,
    num_layers=2, num_heads=4, view_embed_dim=8, embedding_dim=32,
    vol_feat_reso=4, vol_embedding_reso=8, vol_embedding_out_dim=16,
    k_num=96, dec_depths=[1, 1], dec_channels=[32, 48], dec_num_head=[4, 6],
    dec_patch_size=[48, 48], non_leaf_ratio=[0.75], upscale_factor=[2, 4],
    mask_pool=192, tile_size=16, max_tiles=8, max_per_tile=256)
TINY_TRAFFIC = {"runner": "serve", "batch": 1, "views_in": 2, "views_total": 4,
                "image_size": 64, "fov": 0.8, "radius": [1.7, 2.1],
                "elevation": [0.1, 0.5], "warmup_requests": 1, "check_requests": 2,
                "check_span": 2, "trace_from": 1000, "trace_requests": 2}
LIMITS = {"prim_coarse": 1e-4, "prim_fine": 1e-3, "densifier": 3e-4,
          "sel_gap": 3e-4, "render": 1e-3}
CPU = torch.device("cpu")


def tiny_checkout(tmp_path: Path, renderer: str = "3dgs") -> tuple:
    """A benchmark folder holding the repository's metric readers and a
    tiny cell added as data only: its configuration, traffic and limits."""
    bench = tmp_path / "benchmark"
    shutil.copytree(BENCH / "metrics", bench / "metrics")
    (bench / "configs").mkdir()
    (bench / "traffic").mkdir()
    (bench / "limits").mkdir()
    cfg = {"model": dict(TINY_MODEL, renderer=renderer),
           "infer": {"compute_dtype": "float32"}}
    (bench / "configs" / "tiny.json").write_text(json.dumps(cfg))
    (bench / "traffic" / "tiny_serve.json").write_text(json.dumps(TINY_TRAFFIC))
    limits = dict(LIMITS, **({"depth_normal": 1e-3} if renderer == "2dgs" else {}))
    (bench / "limits" / "tiny.serve.json").write_text(json.dumps(limits))
    real = json.loads((ROOT / "BENCHMARK.json").read_text())
    spec_ = dict(real)
    spec_["configs"] = real["configs"] + [
        {"name": "tiny", "source": "test", "file": "benchmark/configs/tiny.json",
         "reduced": [], "why": "test"}]
    spec_["workloads"] = real["workloads"] + [
        {"name": "tiny.serve", "config": "tiny", "traffic": "tiny_serve", "chips": 1,
         "why": "test"}]
    spec_["per_layer"] = [dict(m, workloads=m["workloads"] + ["tiny.serve"])
                          for m in real["per_layer"]]
    spec_["end_to_end"] = [dict(m, workloads=m["workloads"] + ["tiny.serve"])
                           if "serve.3dgs" in m.get("workloads", ()) else m
                           for m in real["end_to_end"]]
    return spec_, bench


def run_tiny(tmp_path, renderer="3dgs", seconds=1.0):
    spec_, bench = tiny_checkout(tmp_path, renderer)
    cell = spec.Cell(tmp_path, spec_, "tiny.serve", bench)
    return spec.run_cell(cell, 20240917 + 2**31, seconds, False, CPU, time.time())


# ------------------------------------------------------------ cells as data


def test_every_cell_finds_its_files_by_name():
    real = json.loads((ROOT / "BENCHMARK.json").read_text())
    from generativedensification_torch.models.network import NetworkConfig
    from benchmark.reference.models.network import NetworkConfig as RefConfig

    for w in real["workloads"]:
        cell = spec.Cell(ROOT, real, w["name"])
        if cell.traffic["runner"] != "serve":       # test_bench_train.py
            continue
        assert set(cell.limits) - {"depth_normal"} == {
            "prim_coarse", "prim_fine", "densifier", "sel_gap", "render"}
        assert ("depth_normal" in cell.limits) == (cell.config["model"]["renderer"] == "2dgs")
        for fields in (NetworkConfig, RefConfig):
            serve.network_kwargs(cell.config, [f.name for f in dataclasses.fields(fields)])
        names = [m["name"] for m in cell.end_to_end + cell.per_layer]
        assert "setup_s" in names
        for n in names:
            assert callable(spec.reader(n))


def test_a_cell_added_as_data_is_taken_up(tmp_path):
    spec_, bench = tiny_checkout(tmp_path)
    (bench / "metrics" / "requests.tiny.py").write_text(
        "def read(r):\n    return float(r['attempted'])\n")
    spec_["per_layer"].append({"name": "requests.tiny", "unit": "1", "better": "higher",
                               "source": "host_clock", "layer": "entry",
                               "moves": "recon_per_s", "workloads": ["tiny.serve"]})
    cell = spec.Cell(tmp_path, spec_, "tiny.serve", bench)
    assert cell.traffic == TINY_TRAFFIC and cell.limits == LIMITS
    assert cell.config["model"]["k_num"] == 96
    assert "requests.tiny" in [m["name"] for m in cell.per_layer]
    assert spec.reader("requests.tiny", bench)({"attempted": 7}) == 7.0


# ------------------------------------------------------------- result line


def test_result_line_keys_and_a_sound_run_is_correct(tmp_path):
    out = run_tiny(tmp_path)
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(out)[-1] == "checks"
    assert out["correct"] is True, out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert set(out["metrics"]) == {"recon_per_s", "recon_p95_ms", "setup_s"}
    for m in out["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert set(out["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    assert {k: lim for k, (_, lim) in out["checks"].items()} == LIMITS
    assert all(v <= lim for v, lim in out["checks"].values())
    json.dumps(out, allow_nan=False)


def test_2dgs_run_is_correct(tmp_path):
    out = run_tiny(tmp_path, "2dgs")
    assert out["correct"] is True, out["checks"]


# --------------------------------------------------------- faults caught


def _altered(monkeypatch, alter):
    from generativedensification_torch.models import network

    forward = network.Network.forward

    def wrong(self, batch, with_fine=False, generator=None):
        out = forward(self, batch, with_fine=with_fine, generator=generator)
        alter(out)
        return out

    monkeypatch.setattr(network.Network, "forward", wrong)


@pytest.mark.parametrize("fault", ["image", "coarse", "fine", "choice", "depth_normal"])
def test_an_altered_answer_is_not_correct(tmp_path, monkeypatch, fault):
    """An answer altered where it is produced: a served image, a coarse or
    fine primitive, the AbsGS selection, or a 2DGS depth-derived normal."""
    def alter(out):
        if fault == "image":
            out["image_fine"][..., 10, 10, :] += 0.05
        elif fault == "coarse":
            out["render_pkg"][0][0][:, 3] += 1e-3
        elif fault == "fine":
            out["render_pkg"][1][2][:, -1] += 1e-2
        elif fault == "depth_normal":
            out["depth_normal"][..., 20, 20, :] *= -1.0

    if fault == "choice":
        from generativedensification_torch.points import ops

        real = ops.topk_split

        def worst_k(score, mask, k):
            return real(-score, mask, k)          # the k lowest instead

        from generativedensification_torch.models import network
        monkeypatch.setattr(network, "topk_split", worst_k)
    else:
        _altered(monkeypatch, alter)
    out = run_tiny(tmp_path, "2dgs" if fault == "depth_normal" else "3dgs")
    assert out["correct"] is False
    bad = {"image": "render", "coarse": "prim_coarse", "fine": "prim_fine",
           "choice": "sel_gap", "depth_normal": "depth_normal"}[fault]
    v, lim = out["checks"][bad]
    assert v > lim


# ------------------------------------------------ the yardstick's counts


def _launch(gauss, ts=16, tiles=(2, 2)):
    """Inputs of one 3DGS compositor launch: each Gaussian (x, y, conic a,
    b, c, opacity) in every tile, in the given (depth) order."""
    rows = torch.zeros((len(gauss), 12))
    for i, (x, y, a, b, c, o) in enumerate(gauss):
        rows[i, :6] = torch.tensor([x, y, a, b, c, o])
        rows[i, 6:10] = torch.tensor([0.5, 0.5, 0.5, 1.0 + i])
        rows[i, 10] = 1.0
    T = tiles[0] * tiles[1]
    ids = torch.arange(len(gauss), dtype=torch.int32).repeat(T)
    starts = (torch.arange(T, dtype=torch.int32) * len(gauss))
    counts = torch.full((T,), len(gauss), dtype=torch.int32)
    return rows, ids, starts, counts, tiles[0], tiles[1], ts


def test_pair_count_of_one_gaussian_by_hand():
    sig2, opa = 9.0, 0.5
    args = _launch([(15.5, 15.5, 1 / sig2, 0.0, 1 / sig2, opa)])
    n = 0
    for y in range(32):
        for x in range(32):
            d2 = (x - 15.5) ** 2 + (y - 15.5) ** 2
            n += min(opa * math.exp(-0.5 * d2 / sig2), 0.99) >= 1 / 255
    assert rk.pair_counts(*args) == n
    nbytes, ops = counting.launch_cost("composite_fwd", args)
    assert ops == n * (counting.OPS_PER_EVAL + counting.OPS_PER_CONTRIB)
    assert nbytes == (12 * 4 + 4 * 4 + 2 * 4 * 4) + 4 * 5 * 256 * 4


def test_pair_count_stops_at_the_transmittance_floor():
    """Five Gaussians of alpha 0.95 on every pixel: T falls to 0.05,
    2.5e-3, 1.25e-4, and the fourth would take it to 6.25e-6, below 1e-4,
    so each pixel takes three."""
    flat = 1e-8
    args = _launch([(8.0, 8.0, flat, 0.0, flat, 0.95)] * 5)
    assert rk.pair_counts(*args) == 3 * 32 * 32


def _captured_launches():
    """Every compositor launch of a tiny forward on the CPU (3DGS and
    2DGS), as the traced run captures them."""
    cfg = {"infer": {"compute_dtype": "float32"}}
    launches = []
    for renderer in ("3dgs", "2dgs"):
        net = serve.build_program(dict(cfg, model=dict(TINY_MODEL, renderer=renderer)),
                                  7, CPU)
        stop = serve._capture(launches)
        with torch.no_grad():
            serve.serve(net, scenes.scene(TINY_TRAFFIC, 7, 0, 0), CPU)
        stop()
    return launches


@pytest.fixture(scope="module")
def launches():
    return _captured_launches()


def test_pair_count_is_the_same_with_the_skip_off_and_on(launches):
    for name, a, _ in launches:
        if name == "composite_fwd":
            off = rk.pair_counts(*a[:7])
            assert off > 0 and rk.pair_counts(*a[:7], skip=True) == off


def test_reference_compositors_match_the_port_plain_versions(launches):
    """The benchmark's batched compositors against the port's plain
    versions on a tiny forward's launches (the test may import the port;
    the reference does not)."""
    from generativedensification_torch.splat import kernels as pk
    from generativedensification_torch.splat import surfel_kernels as ps

    seen = set()
    for name, a, k in launches:
        mode = a[-1] if name.endswith("bwd") and len(a) > (9 if name[0] == "c" else 10) \
            else k.get("mode", "full")
        if name == "composite_fwd":
            got, want = rk.composite_fwd(*a), pk.composite_fwd_plain(*a)
        elif name == "composite_bwd":
            got, want = rk.composite_bwd(*a[:9], mode), pk.composite_bwd_plain(*a[:9], mode)
        elif name == "surfel_fwd":
            got, want = rs.surfel_fwd(*a), ps.surfel_fwd_plain(*a)
        else:
            got, want = rs.surfel_bwd(*a[:10], mode), ps.surfel_bwd_plain(*a[:10], mode)
        seen.add((name, mode if name.endswith("bwd") else ""))
        # each output row against its largest value
        scale = (want.abs().amax(0) if name.endswith("bwd")
                 else want.abs().amax((0, 2), keepdim=True)).clamp(min=1e-12)
        err = ((got - want).abs() / scale).max()
        print(name, mode, float(err))
        assert err <= 2e-4, name
    assert {n for n, _ in seen} == {"composite_fwd", "composite_bwd", "surfel_fwd",
                                    "surfel_bwd"}


def test_model_flops_by_hand():
    class Net(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.a = torch.nn.Linear(4, 8)
            self.b = torch.nn.ModuleList([torch.nn.Linear(8, 2)])

        def forward(self, x):
            y = self.b[0](self.a(x))
            return y @ torch.ones(2, 5)           # outside every sub-module

    net = Net().requires_grad_(False)
    with torch.no_grad():
        f = counting.model_flops(lambda: net(torch.ones(3, 4)))
    assert f == 2 * 3 * 4 * 8 + 2 * 3 * 8 * 2


# ------------------------------------------------------- weights, imports


def test_program_and_reference_get_the_same_weights():
    cfg = {"model": dict(TINY_MODEL), "infer": {"compute_dtype": "float32"}}
    net = serve.build_program(cfg, 99, CPU)
    ref = serve.build_reference(cfg, 99, CPU)
    a, b = net.state_dict(), ref.state_dict()
    assert list(a) == list(b)
    assert all(torch.equal(a[k], b[k]) for k in a)
    other = serve.build_program(cfg, 100, CPU).state_dict()
    assert not torch.equal(a["decoder.coarse_out.weight"], other["decoder.coarse_out.weight"])
    kinds = {k for _, _, k, _ in weights.leaves(net)}
    assert kinds == {"trunc", "xavier", "normal", "zeros", "ones"}


def test_forbidden_modules_by_whole_top_level_name(monkeypatch):
    assert spec.loaded_forbidden() == []
    for name in ("jaxtyping", "generativedensification_torch.x", "benchmark.x",
                 "flaxen"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert spec.loaded_forbidden() == []
    for name in ("jax.numpy", "generativedensification_tpu.splat"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert spec.loaded_forbidden() == ["generativedensification_tpu", "jax"]


def test_reference_imports_nothing_of_the_program():
    for path in (BENCH / "reference").rglob("*.py"):
        for line in path.read_text().splitlines():
            words = line.split()
            if words and words[0] in ("import", "from"):
                top = words[1].split(".")[0]
                assert top not in ("generativedensification_torch", "jax", "jaxlib",
                                   "flax", "generativedensification_tpu"), (path, line)


def test_scenes_repeat_from_the_seed_and_keep_their_sizes():
    a = scenes.scene(TINY_TRAFFIC, 2**33 + 5, 0, 3)
    b = scenes.scene(TINY_TRAFFIC, 2**33 + 5, 0, 3)
    c = scenes.scene(TINY_TRAFFIC, 2**33 + 6, 0, 3)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["tar_rgb"], c["tar_rgb"])
    assert {k: v.shape for k, v in a.items()} == {k: v.shape for k, v in c.items()}


@pytest.mark.parametrize("mode", ["full", "noabs", "selonly"])
def test_reference_backwards_match_the_port_plain_versions_in_every_mode(launches, mode):
    """The training modes too, on random cotangents."""
    from generativedensification_torch.splat import kernels as pk
    from generativedensification_torch.splat import surfel_kernels as ps

    gen = torch.Generator().manual_seed(3)
    fwd = [(n, a) for n, a, _ in launches if n in ("composite_fwd", "surfel_fwd")]
    for name, a in (fwd[0], fwd[-1]):
        T, npix = a[-3] * a[-2], a[-1] ** 2
        if name == "composite_fwd":
            extra = (torch.randn((T, 4, npix), generator=gen),
                     torch.randn((T, npix), generator=gen))
            got = rk.composite_bwd(*a[:4], *extra, *a[4:], mode)
            want = pk.composite_bwd_plain(*a[:4], *extra, *a[4:], mode)
        else:
            if mode == "noabs":
                continue
            extra = (torch.randn((T, 8, npix), generator=gen),
                     torch.rand((T, 5, npix), generator=gen))
            got = rs.surfel_bwd(*a[:5], *extra, *a[5:], mode)
            want = ps.surfel_bwd_plain(*a[:5], *extra, *a[5:], mode)
        err = ((got - want).abs() / want.abs().amax(0).clamp(min=1e-12)).max()
        assert err <= 2e-4, (name, mode, float(err))


def test_a_non_finite_answer_counts_as_failed(tmp_path, monkeypatch):
    def alter(out):
        out["image_fine"][..., 0, 0, 0] = float("nan")

    _altered(monkeypatch, alter)
    out = run_tiny(tmp_path)
    assert out["failed"] == out["attempted"] >= 1
    assert out["correct"] is False and out["checks"]["render"][0] > LIMITS["render"]
    assert out["metrics"]["recon_per_s"]["value"] == 0.0
