"""App shell tests: frame loop, double buffering, resize, scripted input,
checkpoint/resume, telemetry, ANSI presentation, and the CLIs."""

import json
import os

import numpy as np
import pytest

from swift3drenderer_tpu.app import (
    FrameLoop,
    ansi_frame,
    main as app_main,
    run_headless,
    scripted_inputs,
)
from swift3drenderer_tpu.datagen import main as datagen_main
from swift3drenderer_tpu.models import tetrahedron_scene
from swift3drenderer_tpu.utils.databin import load_scene
from swift3drenderer_tpu.utils.telemetry import FrameStats


def test_frame_loop_double_buffering():
    loop = FrameLoop(tetrahedron_scene(seed=0), 64, 48)
    a = loop.step()
    b = loop.step()
    # Alternating buffers: frame N+1 lands in a different host buffer.
    assert a is not b
    c = loop.step()
    assert c is a  # buffer reused on the next flip
    assert loop.frame_index == 3


def test_frame_loop_resize():
    loop = FrameLoop(tetrahedron_scene(seed=0), 64, 48)
    loop.step()
    loop.resize(80, 60)
    px = loop.step()
    assert px.shape == (60, 80)
    with pytest.raises(ValueError):
        loop.resize(0, 10)


def test_scripted_inputs():
    inputs = list(scripted_inputs("2:w;1:s+;2:d mx2", 10))
    assert len(inputs) == 10
    assert inputs[0].up == 1.0 and inputs[0].down == 0.0
    assert inputs[2].down == 2.0  # '+' doubles speed
    assert inputs[3].right == 1.0
    # Mouse accumulates only during mx segments.
    assert inputs[4].mouse[0] == inputs[3].mouse[0] + 2.0
    # Script exhausted -> idle frames with final mouse value.
    assert inputs[9].up == 0.0 and inputs[9].mouse == inputs[4].mouse


def test_checkpoint_resume(tmp_path):
    scene = tetrahedron_scene(seed=0)
    ckpt = str(tmp_path / "pose.json")
    px1, _ = run_headless(scene, width=64, height=48, frames=10, script="10:w",
                          checkpoint=ckpt)
    assert os.path.exists(ckpt)
    loop = FrameLoop(scene, 64, 48)
    loop.load_checkpoint(ckpt)
    assert loop.frame_index == 10
    assert abs(loop.camera.position[2] + 1.0) < 1e-5  # 10 frames x speed 0.1


def test_telemetry_report():
    lines = []
    stats = FrameStats(report_interval=0.0, printer=lines.append)
    stats.add_frame(1.0 / 120.0)  # half the 60 fps budget
    assert stats.reports and abs(stats.reports[0]["percentage"] - 50.0) < 1e-6
    assert any("50.00%" in line for line in lines)


def test_ansi_frame():
    px = np.full((8, 16), 0x112233, dtype=np.uint32)
    s = ansi_frame(px, columns=8)
    assert "\x1b[38;2;17;34;51m" in s and s.endswith("\x1b[0m")


def test_app_cli(tmp_path):
    out = str(tmp_path / "frames")
    rc = app_main(["--scene", "tetrahedron", "--width", "64", "--height", "48",
                   "--frames", "5", "--script", "5:w", "--out", out])
    assert rc == 0
    assert os.path.exists(os.path.join(out, "final.ppm"))


def test_datagen_cli(tmp_path):
    out = str(tmp_path / "data.bin")
    rc = datagen_main(["--scene", "default", "--seed", "3", "--out", out])
    assert rc == 0
    scene = load_scene(out)
    assert scene.num_triangles == 51


def test_datagen_atlas_cli(tmp_path):
    from swift3drenderer_tpu.utils.ppm import write_ppm
    base = np.full((256, 256, 3), 77, dtype=np.uint8)
    base_path = str(tmp_path / "base.ppm")
    write_ppm(base_path, base)
    out = str(tmp_path / "atlas.ppm")
    rc = datagen_main(["--atlas", base_path, "--out", out])
    assert rc == 0
    from swift3drenderer_tpu.utils.ppm import read_ppm
    atlas = read_ppm(out)
    assert atlas.shape == (512, 512, 3)
    assert np.all(atlas[0, 0] == 77)


def test_elastic_fallback_to_native_backend(monkeypatch, native_lib):
    # Failure detection / recovery: a dying device backend fails over to the
    # configured fallback and the frame loop keeps producing frames.
    from swift3drenderer_tpu.renderer import Renderer
    loop = FrameLoop(tetrahedron_scene(seed=0), 64, 48,
                     fallback_backend="native")
    ok = loop.step()

    def boom(*a, **k):
        raise RuntimeError("device worker process crashed or restarted")

    monkeypatch.setattr(loop.renderer, "render", boom)
    px = loop.step()
    assert loop.failed_over and loop.renderer.backend == "native"
    assert px.shape == ok.shape
    assert (px == ok).mean() > 0.99  # same frame content from the fallback
    loop.step()  # keeps running on the fallback
    assert loop.frame_index == 3


def test_elastic_failover_heals_and_survives_second_failure(monkeypatch,
                                                            native_lib):
    # Two-way recovery (round 4): after a failover the loop probes the
    # primary with backoff, returns to it when it heals, and a LATER failure
    # fails over again — fail -> recover -> fail, three backend transitions.
    clock = [0.0]
    loop = FrameLoop(tetrahedron_scene(seed=0), 64, 48, backend="xla",
                     fallback_backend="native", primary_retry_after=5.0,
                     clock=lambda: clock[0])
    ok = loop.step()

    def boom(*a, **k):
        raise RuntimeError("device worker process crashed or restarted")

    monkeypatch.setattr(loop.renderer, "render", boom)
    loop.step()
    assert loop.failed_over and loop.renderer.backend == "native"
    clock[0] = 4.0  # before the backoff expires: stays on the fallback
    loop.step()
    assert loop.failed_over and loop.renderer.backend == "native"
    clock[0] = 6.0  # backoff expired: a fresh primary Renderer works -> heal
    px = loop.step()
    assert not loop.failed_over and loop.renderer.backend == "xla"
    assert (px == ok).mean() > 0.99
    monkeypatch.setattr(loop.renderer, "render", boom)  # second failure
    px2 = loop.step()
    assert loop.failed_over and loop.renderer.backend == "native"
    assert px2.shape == ok.shape
    assert loop.frame_index == 5


def test_elastic_failover_retry_backoff_doubles(monkeypatch, native_lib):
    # While the primary stays down, failed probes double the backoff (no
    # probe storm against a flapping device).
    import swift3drenderer_tpu.app as app_mod

    clock = [0.0]
    loop = FrameLoop(tetrahedron_scene(seed=0), 64, 48, backend="xla",
                     fallback_backend="native", primary_retry_after=2.0,
                     clock=lambda: clock[0])
    loop.step()

    def boom(*a, **k):
        raise RuntimeError("device lost")

    monkeypatch.setattr(loop.renderer, "render", boom)
    loop.step()  # failover at t=0 -> first retry no earlier than t=2
    probes = []
    real_renderer = app_mod.Renderer

    def still_down(*a, **k):
        probes.append(k.get("backend"))
        raise RuntimeError("still down")

    monkeypatch.setattr(app_mod, "Renderer", still_down)
    clock[0] = 2.5
    loop.step()  # probe fails -> backoff doubles to 4 (next retry t>=6.5)
    assert loop.failed_over and probes == ["xla"]
    clock[0] = 5.0
    loop.step()  # inside the doubled backoff: no probe
    assert probes == ["xla"]
    clock[0] = 7.0
    monkeypatch.setattr(app_mod, "Renderer", real_renderer)
    loop.step()
    assert not loop.failed_over and loop.renderer.backend == "xla"


def test_terminal_input_parser():
    from swift3drenderer_tpu.app import TerminalInput
    from swift3drenderer_tpu.camera import Input, KeyboardState
    clock = [0.0]  # injectable wall clock — the hold decay is time-based
    term = TerminalInput(KeyboardState(), clock=lambda: clock[0])
    term.feed(b"w")
    term.tick()
    inp = term.keyboard.update_input(Input())
    assert inp.up == 1.0
    # SHIFT+key doubles speed.
    term.feed(b"D")
    term.tick()
    inp = term.keyboard.update_input(Input())
    assert inp.right == 2.0 and inp.up == 2.0  # w still held, shift applies
    # Arrow key = mouse look (auto-captures).
    term.feed(b"\x1b[C")
    inp = term.keyboard.update_input(Input())
    assert term.keyboard.mouse_captured and inp.mouse[0] == 15.0
    # Keys stay held for HOLD_SECONDS of wall clock, regardless of tick rate.
    clock[0] += term.HOLD_SECONDS / 2
    for _ in range(100):  # many fast frames — must NOT expire the hold early
        term.tick()
    inp = term.keyboard.update_input(Input())
    assert inp.up == 2.0 and inp.right == 2.0
    clock[0] += term.HOLD_SECONDS  # past expiry: keys decay even in ONE tick
    term.tick()
    inp = term.keyboard.update_input(Input())
    assert inp.up == 0.0 and inp.right == 0.0
    # Bare ESC and q request quit.
    term.feed(b"q")
    assert term.keyboard.quit_requested


def test_per_frame_resize_cycling():
    # BASELINE config 5 exercises a per-frame resizable framebuffer: cycle
    # resolutions every frame; executables are cached per size so revisiting a
    # size is cheap, and frames stay correct after each switch.
    from swift3drenderer_tpu.config import DEFAULT_CONFIG
    sizes = [(64, 48), (96, 72), (80, 60)]
    loop = FrameLoop(tetrahedron_scene(seed=0), *sizes[0])
    for i in range(9):
        w, h = sizes[i % 3]
        loop.resize(w, h)
        px = loop.step()
        assert px.shape == (h, w)
        assert (px != DEFAULT_CONFIG.background_packed).any()
