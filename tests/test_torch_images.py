"""The port's image reads without OpenCV (vitslam_tpu_torch/data/png.py and
the resizes of data/preprocess.py) against OpenCV on this machine:

* the PNG decoder bit-equal to ``cv2.imread`` under ``IMREAD_COLOR`` (then
  BGR to RGB) and ``IMREAD_ANYCOLOR | IMREAD_ANYDEPTH``, on PNGs cv2 writes
  (8-bit RGB, grey, RGBA; 16-bit grey and RGB) and hand-built ones (a
  palette with and without tRNS, grey + alpha, and rows under each of the
  five filters), through the native unfilter and the Python one;
* ``resize_nearest`` equal to ``cv2.INTER_NEAREST`` and ``resize_linear``
  within 1 LSB of ``cv2.INTER_LINEAR`` (exact on every pixel here), from
  the KITTI, VKITTI and Waymo native sizes to width 518;
* the port's KITTI Odometry reader with cv2 blocked against the JAX
  package's reader (which reads with cv2): images within 1 LSB (1 / 255),
  K and the poses exactly."""
import struct
import sys
import zlib

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from vitslam_tpu.data.base import CommonConfig as JCommon  # noqa: E402
from vitslam_tpu.data.kitti_odometry import KITTIOdometryDataset as JKitti  # noqa: E402
from vitslam_tpu.utils.fixtures import write_kitti_odometry_fixture  # noqa: E402
from vitslam_tpu_torch import native  # noqa: E402
from vitslam_tpu_torch.data import CommonConfig, KITTIOdometryDataset  # noqa: E402
from vitslam_tpu_torch.data import png  # noqa: E402
from vitslam_tpu_torch.data import preprocess as pp  # noqa: E402
from torch_weights import shared_jax_cache  # noqa: E402,F401

ANY = cv2.IMREAD_ANYCOLOR | cv2.IMREAD_ANYDEPTH
# native sizes (H, W): KITTI Odometry, VKITTI 2, Waymo front and side
SIZES = [(376, 1241), (375, 1242), (1280, 1920), (886, 1920)]


def _chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def _filter_row(row: np.ndarray, prior: np.ndarray, f: int, bpp: int) -> bytes:
    """Row ``row`` (uint8 bytes) under PNG filter ``f`` against ``prior``."""
    x = row.astype(np.int64)
    b = prior.astype(np.int64)
    a = np.concatenate([np.zeros(bpp, np.int64), x[:-bpp]])
    c = np.concatenate([np.zeros(bpp, np.int64), b[:-bpp]])
    if f == 0:
        pred = np.zeros_like(x)
    elif f == 1:
        pred = a
    elif f == 2:
        pred = b
    elif f == 3:
        pred = (a + b) >> 1
    else:  # 4, Paeth (and any other byte, for the malformed case)
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    return bytes([f]) + ((x - pred) & 255).astype(np.uint8).tobytes()


def png_bytes(samples: np.ndarray, ctype: int, filters=(0,), palette=None, trns=None,
              interlace: int = 0) -> bytes:
    """A PNG of ``samples`` (H, W[, C]) uint8 / uint16 (big-endian on disk),
    row y under filter ``filters[y % len(filters)]``."""
    s = samples if samples.ndim == 3 else samples[..., None]
    depth = 16 if s.dtype == np.uint16 else 8
    H, W, C = s.shape
    raw = s.astype(">u2").tobytes() if depth == 16 else s.tobytes()
    rows = np.frombuffer(raw, np.uint8).reshape(H, -1)
    bpp = C * depth // 8
    prior = np.zeros(rows.shape[1], np.uint8)
    body = b""
    for y in range(H):
        body += _filter_row(rows[y], prior, filters[y % len(filters)], bpp)
        prior = rows[y]
    out = png.SIGNATURE + _chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, depth, ctype, 0, 0,
                                                      interlace))
    if palette is not None:
        out += _chunk(b"PLTE", palette.astype(np.uint8).tobytes())
    if trns is not None:
        out += _chunk(b"tRNS", bytes(trns))
    return out + _chunk(b"IDAT", zlib.compress(body)) + _chunk(b"IEND", b"")


def _cases(tmp):
    """(name, path) of the test PNGs: cv2-written ones and hand-built ones."""
    rng = np.random.default_rng(0)
    H, W = 13, 17
    cases = []
    for name, arr in [("rgb8", rng.integers(0, 256, (H, W, 3), dtype=np.uint8)),
                      ("grey8", rng.integers(0, 256, (H, W), dtype=np.uint8)),
                      ("rgba8", rng.integers(0, 256, (H, W, 4), dtype=np.uint8)),
                      ("grey16", rng.integers(0, 65536, (H, W), dtype=np.uint16)),
                      ("rgb16", rng.integers(0, 65536, (H, W, 3), dtype=np.uint16))]:
        path = str(tmp / f"{name}.png")
        assert cv2.imwrite(path, arr)
        cases.append((name, path))
    pal = rng.integers(0, 256, (7, 3))
    idx = rng.integers(0, 7, (H, W), dtype=np.uint8)
    hand = {
        "palette": png_bytes(idx, 3, palette=pal),
        "palette_trns": png_bytes(idx, 3, palette=pal, trns=[0, 128, 255]),
        "grey_alpha8": png_bytes(rng.integers(0, 256, (H, W, 2), dtype=np.uint8), 4),
        "grey_alpha16": png_bytes(rng.integers(0, 65536, (H, W, 2), dtype=np.uint16), 4),
        # every row filter, on each colour type the readers meet
        "filters_rgb8": png_bytes(rng.integers(0, 256, (H, W, 3), dtype=np.uint8), 2,
                                  filters=(0, 1, 2, 3, 4)),
        "filters_rgb16": png_bytes(rng.integers(0, 65536, (H, W, 3), dtype=np.uint16), 2,
                                   filters=(4, 3, 2, 1, 0)),
        "filters_grey16": png_bytes(rng.integers(0, 65536, (H, W), dtype=np.uint16), 0,
                                    filters=(3, 4, 1, 2, 0)),
        "filters_rgba8": png_bytes(rng.integers(0, 256, (H, W, 4), dtype=np.uint8), 6,
                                   filters=(1, 4, 3, 0, 2)),
    }
    for name, data in hand.items():
        path = tmp / f"{name}.png"
        path.write_bytes(data)
        cases.append((name, str(path)))
    return cases


@pytest.fixture(params=["native", "python"])
def route(request, monkeypatch):
    """The native unfilter (g++ is here) or the Python one."""
    if request.param == "python":
        monkeypatch.setenv("VITSLAM_NATIVE", "0")
    assert native.native_available() == (request.param == "native")
    return request.param


def _rgb(img):
    return img[..., ::-1] if img.ndim == 3 else img


def test_png_decoder_bit_equal_to_cv2_imread(tmp_path, route):
    for name, path in _cases(tmp_path):
        want = cv2.imread(path, cv2.IMREAD_COLOR)
        got = png.read_color(path)
        assert got.dtype == np.uint8 and got.shape == want.shape, name
        np.testing.assert_array_equal(got, _rgb(want), err_msg=f"{name} IMREAD_COLOR")
        want = cv2.imread(path, ANY)
        got = png.read_any(path)
        assert got.dtype == want.dtype and got.shape == want.shape, name
        np.testing.assert_array_equal(got, _rgb(want), err_msg=f"{name} ANYCOLOR|ANYDEPTH")


def test_read_image_takes_pngs_without_cv2(tmp_path, monkeypatch):
    path = dict(_cases(tmp_path))["rgb8"]
    want = cv2.cvtColor(cv2.imread(path, cv2.IMREAD_COLOR), cv2.COLOR_BGR2RGB)
    monkeypatch.setitem(sys.modules, "cv2", None)
    np.testing.assert_array_equal(png.read_image(path), want)
    with pytest.raises(FileNotFoundError):
        png.read_image(str(tmp_path / "missing.png"))


def test_jpeg_without_a_decoder_names_the_file(tmp_path, monkeypatch):
    path = str(tmp_path / "frame.jpg")
    assert cv2.imwrite(path, np.zeros((8, 8, 3), np.uint8))
    monkeypatch.setitem(sys.modules, "cv2", None)
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError, match="frame.jpg.*neither cv2.*nor PIL"):
        png.read_image(path)


@pytest.mark.parametrize("kind", ["interlaced", "bit_depth_4", "bad_crc", "bad_filter"])
def test_unsupported_or_corrupt_pngs_raise(kind):
    img = np.zeros((4, 5, 3), np.uint8)
    if kind == "interlaced":
        data = png_bytes(img, 2, interlace=1)
    elif kind == "bit_depth_4":
        data = bytearray(png_bytes(img[..., 0], 0))
        data[24] = 4  # IHDR's bit depth
        body = bytes(data[12:29])
        data[29:33] = struct.pack(">I", zlib.crc32(body))
        data = bytes(data)
    elif kind == "bad_crc":
        data = bytearray(png_bytes(img, 2))
        data[30] ^= 1
        data = bytes(data)
    else:
        data = png_bytes(img, 2, filters=(7,))  # no such filter type
    with pytest.raises(png.PNGError):
        png.decode(data)


@pytest.mark.parametrize("hw", SIZES, ids=[f"{h}x{w}" for h, w in SIZES])
def test_resize_matches_cv2(hw):
    """Nearest exact; linear within 1 LSB, and the share of exact pixels,
    1.0 with this machine's OpenCV, at least 99.9%."""
    h, w = hw
    tw = 518
    th = max(1, int(round(h * tw / w)))
    rng = np.random.default_rng(h)
    img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    want = cv2.resize(img, (tw, th), interpolation=cv2.INTER_LINEAR)
    d = np.abs(pp.resize_linear(img, tw, th).astype(int) - want.astype(int))
    assert d.max() <= 1 and (d == 0).mean() >= 0.999, (d.max(), (d == 0).mean())
    for depth in (rng.uniform(0, 80, (h, w)).astype(np.float32),
                  rng.integers(0, 65536, (h, w), dtype=np.uint16)):
        np.testing.assert_array_equal(
            pp.resize_nearest(depth, tw, th),
            cv2.resize(depth, (tw, th), interpolation=cv2.INTER_NEAREST))


def test_resize_linear_of_a_grey_frame_and_its_dtype():
    """A 2-D uint8 frame resizes as cv2 resizes it, within 1 LSB and at
    least 99.9% exact as in test_resize_matches_cv2; any other dtype is
    refused, since the readers hand it uint8 frames only."""
    img = np.random.default_rng(1).integers(0, 256, (375, 1242), dtype=np.uint8)
    want = cv2.resize(img, (518, 156), interpolation=cv2.INTER_LINEAR)
    d = np.abs(pp.resize_linear(img, 518, 156).astype(int) - want.astype(int))
    assert d.max() <= 1 and (d == 0).mean() >= 0.999, (d.max(), (d == 0).mean())
    with pytest.raises(TypeError, match="uint8"):
        pp.resize_linear(img.astype(np.float32) / 255, 518, 156)


def test_kitti_odometry_reader_without_cv2_matches_the_jax_reader(tmp_path, monkeypatch):
    root = str(tmp_path / "kitti")
    write_kitti_odometry_fixture(root, seq="00", n_frames=6, hw=(56, 84))
    kw = dict(img_size=56, patch_size=14, fix_aspect_ratio=0.5, training=False)
    whole = dict(seq_index=0, img_per_seq=-1, ids=np.arange(6), aspect_ratio=0.5)
    want = JKitti(JCommon(**kw), split="test", KITTIOD_DIR=root,
                  sequence_ids=["00"]).get_data(**whole)
    monkeypatch.setitem(sys.modules, "cv2", None)
    got = KITTIOdometryDataset(CommonConfig(**kw), split="test", KITTIOD_DIR=root,
                               sequence_ids=["00"]).get_data(**whole)
    assert got["images"].shape == want["images"].shape == (6, 3, 28, 56)
    d = np.abs(got["images"] - want["images"]).max()
    assert d <= 1.0 / 255 + 1e-7, d
    for k in ("extrinsics", "intrinsics"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
