"""The harness finds a cell's pieces by name: a configuration, a traffic
mix, a cell and a per-layer metric added only as files and entries are
found and run."""

import json

import pytest

from srbench import harness


def _clock():
    return 0.0


def test_pieces_found_by_name(tiny_root):
    bench = harness.Bench(tiny_root)
    for cell in bench.spec["workloads"]:
        cfg = bench.config(cell["config"])
        assert cfg["reference"] and cfg["model"]
        assert bench.traffic(cell["traffic"])["kind"]
        assert bench.limits(cell["name"])
    for family, folder in (("end_to_end", "end_to_end"),
                           ("per_layer", "layer_metrics")):
        for m in bench.spec[family]:
            assert hasattr(bench.reader(folder, m["name"]), "read")


def test_throwaway_cell_added_as_files_runs(tiny_root):
    root = tiny_root
    # a configuration: EDSR at half the blocks, under a new name
    cfg = json.loads((root / "srbench/configs/edsr_baseline_x4.bf16.json")
                     .read_text())
    cfg["num_resblocks"] = 2
    (root / "srbench/configs/throwaway.json").write_text(json.dumps(cfg))
    # a mix: the frames kind at other sizes
    mix = json.loads((root / "srbench/traffic/reds_frames.json").read_text())
    mix.update(lr_height=16, lr_width=24)
    (root / "srbench/traffic/throwaway_mix.json").write_text(json.dumps(mix))
    # limits and a per-layer metric of its own
    (root / "srbench/limits/throwaway.cell.json").write_text(
        json.dumps({"worst_over3n_pct": 4.0}))
    (root / "srbench/layer_metrics/throwaway_batches.py").write_text(
        "def read(ctx):\n    return float(ctx.window['landed'])\n")
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "throwaway", "source": "x",
                            "file": "srbench/configs/throwaway.json",
                            "reduced": ["num_resblocks"], "why": "a test"})
    spec["workloads"].append({"name": "throwaway.cell", "config": "throwaway",
                              "traffic": "throwaway_mix", "chips": 1,
                              "why": "a test"})
    spec["per_layer"].append({"name": "throwaway_batches", "unit": "count",
                              "better": "higher", "source": "host_clock",
                              "layer": "device", "moves": "throughput_mps",
                              "workloads": ["throwaway.cell"]})
    spec["end_to_end"][0]["workloads"].append("throwaway.cell")
    (root / "BENCHMARK.json").write_text(json.dumps(spec))

    bench = harness.Bench(root)
    result, readings = harness.run_cell(bench, "throwaway.cell", 7, 0.5,
                                        False, _clock, device="cpu")
    assert result["correct"], readings
    assert set(result["metrics"]) == {"throughput_mps", "setup_s"}
    assert list(result)[-1] == "checks"
    traced, _ = harness.run_cell(bench, "throwaway.cell", 7, 0.5, True,
                                 _clock, device="cpu")
    assert traced["metrics"]["throwaway_batches"]["value"] >= 1
    assert "device_idle_pct.frames" not in traced["metrics"]
    assert traced["breakdown"]["device_ops"] == []


def test_unknown_cell_is_refused(tiny_root):
    with pytest.raises(KeyError):
        harness.Bench(tiny_root).cell("no.such.cell")


@pytest.mark.parametrize("name", ["mfu", "d2s_roofline", "device_idle_pct"])
@pytest.mark.parametrize("part", ["frames", "photo"])
def test_split_metric_shares_its_reader(name, part):
    module = harness.Bench().reader("layer_metrics", f"{name}.{part}")
    assert module.__file__.endswith(f"/layer_metrics/{name}.py")


def test_a_metric_file_of_its_own_comes_first():
    module = harness.Bench().reader("layer_metrics", "host_enqueue_ms.frames")
    assert module.__file__.endswith("/layer_metrics/host_enqueue_ms.frames.py")
