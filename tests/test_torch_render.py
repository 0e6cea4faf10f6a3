"""The port's drawing without cv2 (``dorknet_tpu_torch/utils/render.py``) and
the synthetic CAM demo twin
(``dorknet_tpu_torch/examples/synthetic_cam_demo.py``) on the CPU.

The JET table equals ``cv2.applyColorMap(..., COLORMAP_JET)`` on all 256
levels, and a PNG the port writes reads back with ``cv2.imread`` equal to
what ``cv2.imwrite`` of the same array gives; those checks skip where cv2
is missing. The demo twin's ``__main__`` (60 steps) writes the JAX demo's
four file names, with the same predictions, and its overlays differ from
the JAX demo's by at most 3 of 255 levels on at most 1% of the pixels (the
CAMs agree to about 1e-4, and ``uint8(255 * cam)`` rounds a few of them to
the next level)."""

import os
import runpy
import struct
import sys
import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from dorknet_tpu_torch.utils.render import JET_BGR, apply_jet, write_png  # noqa: E402


def test_jet_matches_cv2_on_every_level():
    cv2 = pytest.importorskip("cv2")
    levels = np.arange(256, dtype=np.uint8).reshape(16, 16)
    np.testing.assert_array_equal(apply_jet(levels), cv2.applyColorMap(levels, cv2.COLORMAP_JET))
    assert JET_BGR.shape == (256, 3) and JET_BGR.dtype == np.uint8
    with pytest.raises(TypeError):
        apply_jet(levels.astype(np.float32))


@pytest.mark.parametrize("shape", [(17, 23, 3), (1, 1, 3), (9, 5)])
def test_png_reads_back_as_cv2_writes_it(shape, tmp_path):
    cv2 = pytest.importorskip("cv2")
    img = np.random.RandomState(0).randint(0, 256, shape).astype(np.uint8)
    write_png(str(tmp_path / "port.png"), img)
    cv2.imwrite(str(tmp_path / "cv2.png"), img)
    got = cv2.imread(str(tmp_path / "port.png"), cv2.IMREAD_UNCHANGED)
    want = cv2.imread(str(tmp_path / "cv2.png"), cv2.IMREAD_UNCHANGED)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, img)


def test_png_layout_without_cv2(tmp_path):
    """The chunks, by hand: signature, IHDR (8-bit RGB), one IDAT whose rows
    are filter 0 then RGB (the BGR input reversed), IEND; CRCs valid."""
    img = np.arange(2 * 3 * 3, dtype=np.uint8).reshape(2, 3, 3)
    write_png(str(tmp_path / "a.png"), img)
    data = (tmp_path / "a.png").read_bytes()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, chunks = 8, {}
    while pos < len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        assert struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])[0] == zlib.crc32(kind + body)
        chunks[kind] = body
        pos += 12 + n
    assert list(chunks) == [b"IHDR", b"IDAT", b"IEND"]
    assert struct.unpack(">IIBBBBB", chunks[b"IHDR"]) == (3, 2, 8, 2, 0, 0, 0)
    rows = np.frombuffer(zlib.decompress(chunks[b"IDAT"]), np.uint8).reshape(2, 10)
    assert (rows[:, 0] == 0).all()
    np.testing.assert_array_equal(rows[:, 1:].reshape(2, 3, 3), img[:, :, ::-1])
    with pytest.raises(ValueError):
        write_png(str(tmp_path / "b.png"), img.astype(np.float32))


def _run_demo(module, out_dir, monkeypatch):
    monkeypatch.setattr(sys, "argv", [module, out_dir])
    runpy.run_module(module, run_name="__main__")
    return sorted(os.listdir(out_dir))


def test_synthetic_cam_demo_twin(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("DORKNET_DEVICE", "cpu")
    got = _run_demo("dorknet_tpu_torch.examples.synthetic_cam_demo", str(tmp_path / "port"),
                    monkeypatch)
    out = capsys.readouterr().out
    assert len(got) == 4 and all(f.endswith(".png") for f in got)
    assert "accuracy on demo images:" in out and "step 40 loss" in out
    cv2 = pytest.importorskip("cv2")
    want = _run_demo("examples.synthetic_cam_demo", str(tmp_path / "jax"), monkeypatch)
    assert got == want
    for f in got:
        a = cv2.imread(str(tmp_path / "port" / f)).astype(int)
        b = cv2.imread(str(tmp_path / "jax" / f)).astype(int)
        assert a.shape == b.shape == (64, 64, 3)
        d = np.abs(a - b)
        assert d.max() <= 3 and (d > 0).mean() <= 0.01, (f, d.max(), (d > 0).mean())
