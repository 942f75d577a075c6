"""bench.py is the record-producing entry point — a regression here means no
benchmark record at all, so its measure() path gets CPU coverage (the pallas
backend in the interpreter), and main() must refuse any platform but the
GPU."""

import json
import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import bench  # noqa: E402


@pytest.mark.quick
@pytest.mark.parametrize("backend,objects", [("xla", None), ("pallas", None),
                                             ("pallas", 64)])
def test_measure_smoke(backend, objects):
    # ``objects`` switches to the stress field of that many polyhedra.
    scene = "stress" if objects else "tetrahedron"
    r = bench.measure(scene, 160, 120, frames=2, backend=backend,
                      objects=objects, interpret=(backend == "pallas"))
    from swift3drenderer_tpu.models import SCENES
    kw = {"objects": objects} if objects else {}
    assert r["tris"] == SCENES[scene](seed=0, **kw).num_triangles
    assert r["pixels"] == 160 * 120 and r["batch"] == 1
    assert r["frame_ms"] > 0 and r["fps"] > 0


@pytest.mark.quick
def test_measure_batch():
    r = bench.measure("tetrahedron", 160, 120, frames=2, backend="pallas",
                      batch=2, interpret=True)
    assert r["frame_ms"] > 0


@pytest.mark.quick
def test_all_configs_writes_json_artifact(tmp_path, monkeypatch, capsys):
    # --all-configs writes a machine-readable artifact over the scene
    # families, with the device it ran on, the tetrahedron as the B=8
    # serving batch, and the CPU-baseline ratio where one was measured.
    calls = []

    def fake_measure(name, w, h, frames, backend, batch=1, **kw):
        calls.append((name, w, h, batch))
        return dict(frame_ms=1.0, fps=1000.0, tris=51, pixels=w * h,
                    batch=batch)

    monkeypatch.setattr(bench, "measure", fake_measure)
    import swift3drenderer_tpu.utils.profiling as prof
    monkeypatch.setattr(prof, "device_summary", lambda: {
        "platform": "gpu", "kind": "test card", "count": 1})
    monkeypatch.setattr(prof, "card_power_line", lambda: "test card, 1 W")
    import swift3drenderer_tpu.utils.compile_cache as cc
    monkeypatch.setattr(cc, "enable_compile_cache", lambda: "")
    out = tmp_path / "all.json"
    assert bench.main(["--all-configs", "--out", str(out)]) == 0
    data = json.loads(out.read_text())
    assert len(data["rows"]) == len(bench.ALL_CONFIGS) == 8
    assert [r["config"] for r in data["rows"][-2:]] == ["stress",
                                                        "stress100k"]
    tet = data["rows"][0]
    assert tet["config"] == "tetrahedron" and tet["batch"] == 8
    assert ("tetrahedron", 640, 480, 8) in calls
    assert data["device"]["kind"] == "test card"
    assert data["device"]["power"] == "test card, 1 W"
    for row in data["rows"]:
        assert {"fps", "Mpix_per_s", "Mtri_per_s", "frame_ms"} <= set(row)
    assert data["rows"][4]["vs_baseline"] == pytest.approx(1000.0 / 25.081)
    assert data["rows"][-1]["vs_baseline"] is None


@pytest.mark.quick
def test_main_off_gpu_exits_nonzero_naming_platform(capsys):
    assert bench.main([]) != 0
    captured = capsys.readouterr()
    assert "'cpu'" in captured.err
    assert captured.out == ""
