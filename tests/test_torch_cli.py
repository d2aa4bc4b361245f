"""The port's CLI against the JAX package's option set, and what it
refuses.

``nrc_tpu_torch/app/cli.py::build_parser`` must take the JAX CLI's options
(``nrc_tpu/app/cli.py:27-87``), each with the same flags, destination,
default, type, choices and requiredness, plus ``--device``; the same
command line must parse to the same values. What the port does not run
raises ``NotImplementedError`` naming its ``ROADMAP.md`` entry before any
frame: the orbax checkpoint container. ``--device cuda`` (the default) raises without a card, as
``Renderer`` does; the CPU is taken only when asked. ``present 1`` in the
system file serves the viewer in mode 0 (the loop itself is checked in
``test_torch_viewer.py``). ``--devices 2 --device cpu`` renders in two gloo
ranks and writes the PNG ``--devices 1`` writes; more ranks than cards
raise before any frame.
"""

import subprocess
import sys
from pathlib import Path

import pytest
import torch

from nrc_tpu.app import cli as jcli
from nrc_tpu_torch.app import cli
from nrc_tpu_torch.scene.scene_builder import write_cornell_box_files


def options(parser):
    return {
        a.dest: (tuple(a.option_strings), a.default, a.type, tuple(a.choices or ()), a.required, type(a).__name__)
        for a in parser._actions
    }


def test_options_equal_jax_plus_device():
    got, ref = options(cli.build_parser()), options(jcli.build_parser())
    assert set(got) == set(ref) | {"device"}
    for dest, spec in ref.items():
        assert got[dest] == spec, dest
    assert got["device"] == (("--device",), "cuda", None, ("cuda", "cpu"), False, "_StoreAction")


@pytest.mark.parametrize("argv", [
    ["-s", "sys.txt", "-d", "scene.txt"],
    ["-s", "a", "-d", "b", "-m", "1", "-w", "64", "-h", "48", "--spp", "4", "--render-mode", "no_cache",
     "--encoding", "hash", "--no-train", "--lr", "0.01", "--unbiased-ratio", "0.1", "--reflectance-factoring",
     "--area-spread", "0.02", "--checkpoint", "c", "--checkpoint-every", "2", "--resume", "r", "--output", "o",
     "--hdr", "--profile", "p", "--save-system", "s", "--stats-log", "l", "-o"],
])
def test_same_command_line_same_values(argv):
    got = vars(cli.build_parser().parse_args(argv))
    assert got.pop("device") == "cuda"
    assert got == vars(jcli.build_parser().parse_args(argv))


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    return write_cornell_box_files(str(tmp_path_factory.mktemp("cornell")), (16, 16))


@pytest.mark.parametrize("extra, item", [
    (["--checkpoint-format", "orbax", "-m", "1"], "Do not port"),
])
def test_unported_options_raise(files, extra, item):
    with pytest.raises(NotImplementedError, match=item):
        cli.main(["-s", files[0], "-d", files[1], "--device", "cpu", "--spp", "1"] + extra)


def test_present_in_the_system_file_serves_in_mode_0(files, tmp_path, monkeypatch):
    """``present 1`` serves the viewer in mode 0 until interrupted (here at
    the loop's first idle wait, once the frame is accumulated); mode 1
    renders in batch, as the JAX CLI does."""
    system = tmp_path / "system_present.txt"
    system.write_text(open(files[0]).read() + "present 1\n")
    waits = []

    def interrupt(seconds):
        waits.append(seconds)
        raise KeyboardInterrupt

    monkeypatch.setattr(cli.time, "sleep", interrupt)
    assert cli.main(["-s", str(system), "-d", files[1], "--device", "cpu", "--spp", "1", "--port", "0",
                     "--output", str(tmp_path / "shown")]) == 0
    assert waits == [0.05] and (tmp_path / "shown_1spp.png").exists()
    assert cli.main(["-s", str(system), "-d", files[1], "-m", "1", "--device", "cpu", "--spp", "1",
                     "--no-train", "--output", str(tmp_path / "frame")]) == 0
    assert (tmp_path / "frame_1spp.png").exists() and waits == [0.05]


def test_devices_2_writes_the_png_of_devices_1(files, tmp_path):
    """NO_CACHE frames in two gloo ranks (16x16, 8-row bands of 8x8 tiles:
    the system file's 16x16 tiles do not divide a band, so ``--devices 2``
    asks for 8x8 ones through the file) against one rank: the same PNG and
    HDR bytes. The ranks run in a child process with a time limit."""
    system = tmp_path / "system_8.txt"
    system.write_text(open(files[0]).read().replace("tileSize 16 16", "tileSize 8 8"))
    assert "tileSize 8 8" in system.read_text()
    common = ["-s", str(system), "-d", files[1], "-m", "1", "--device", "cpu", "--spp", "2",
              "--render-mode", "no_cache", "--hdr"]
    assert cli.main(common + ["--output", str(tmp_path / "one")]) == 0
    root = Path(__file__).resolve().parent.parent
    proc = subprocess.run([sys.executable, "-m", "nrc_tpu_torch.app.cli", *common, "--devices", "2",
                           "--output", str(tmp_path / "two")], cwd=root, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert proc.stdout.count("spp in ") == 1  # rank 0 alone prints
    for ext in ("png", "hdr"):
        assert (tmp_path / f"two_2spp.{ext}").read_bytes() == (tmp_path / f"one_2spp.{ext}").read_bytes()


def test_more_devices_than_cards_raise(files):
    cards = torch.cuda.device_count()
    ranks = max(cards + 1, 2)
    with pytest.raises(ValueError, match=f"--devices {ranks}: {cards} CUDA devices"):
        cli.main(["-s", files[0], "-d", files[1], "--spp", "1", "--devices", str(ranks)])


@pytest.mark.skipif(torch.cuda.is_available(), reason="the card is there: cuda does not raise")
def test_cuda_is_the_default_and_raises_without_a_card(files, tmp_path):
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["-s", files[0], "-d", files[1], "--spp", "1", "--output", str(tmp_path / "x")])
    assert not (tmp_path / "x_1spp.png").exists()


def test_mode_0_prints_progress_and_writes_files(files, tmp_path, capsys):
    """Mode 0 prints the frame rate every 16 frames; ``--hdr``,
    ``--save-system`` and ``--profile`` write their files."""
    prefix = str(tmp_path / "out")
    cli.main(["-s", files[0], "-d", files[1], "--device", "cpu", "--spp", "16", "-w", "8", "-h", "8",
              "--render-mode", "no_cache", "--no-train", "--output", prefix, "--hdr",
              "--save-system", str(tmp_path / "saved.txt"), "--profile", str(tmp_path / "trace")])
    printed = capsys.readouterr().out
    assert "[16/16] " in printed and (tmp_path / "out_16spp.hdr").exists()
    assert "resolution 8 8" in (tmp_path / "saved.txt").read_text()
    assert (tmp_path / "trace" / "trace.json").stat().st_size > 0
