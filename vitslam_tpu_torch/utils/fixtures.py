"""Fixture writer (the port's copy of vitslam_tpu/utils/fixtures.py::
write_vkitti_fixture): a miniature VKITTI 2 tree with geometrically
consistent synthetic content, written with numpy alone, file for file the
bytes the reference writes through OpenCV.

OpenCV writes the RGB frames with libjpeg-turbo (baseline JPEG, quality 95,
4:2:0, the accurate integer DCT, the standard Huffman tables) and the depth
maps with libpng (16-bit grey, every row under the Sub filter, zlib's RLE
strategy, 8 KiB IDAT chunks). This module encodes both the same way:

* JPEG: the JFIF header, the two quantisation tables (quality 95's scaling
  of the standard tables), the frame, the standard Huffman tables and one
  interleaved scan; the colour conversion in libjpeg's 16-bit fixed point,
  the edge and bottom padding, the 2x2 box downsampling with its alternating
  bias, the islow forward DCT, quantisation by reciprocal as libjpeg-turbo
  does it, the dummy blocks past the image's edges, byte stuffing and the
  final 1-bit padding;
* PNG: the filtered rows deflated by Python's zlib (level 1, Z_RLE, memory
  level 8) with libpng's window size for small images.

Writing needs no OpenCV; reading the JPEG frames back
(``data/png.py::read_image``, as the VKITTI reader and the learning-loop
demo do) still needs cv2 or PIL, and raises without both.
"""
from __future__ import annotations

import os
import os.path as osp
import struct
import zlib

import numpy as np

# --- JPEG ----------------------------------------------------------------------

QUALITY = 95
ZIGZAG = np.array([0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33, 40,
                   48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36, 29,
                   22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54,
                   47, 55, 62, 63])
# the standard tables of the JPEG specification (K.1, K.2), natural order
STD_LUMA = np.array([16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
                     14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
                     18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
                     49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99])
STD_CHROMA = np.full(64, 99)
STD_CHROMA[[0, 1, 2, 3, 8, 9, 10, 11, 16, 17, 18, 24, 25]] = \
    [17, 18, 24, 47, 18, 21, 26, 66, 24, 26, 56, 47, 66]
# the standard Huffman tables (K.3-K.6): code counts by length, then the
# symbols; an AC table lists its first symbols out of order and the rest
# ascending
DC_BITS = ((0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0),
           (0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0))
AC_BITS = ((0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d),
           (0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77))
AC_HEAD = ((0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06, 0x13, 0x51,
            0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08, 0x23, 0x42, 0xb1, 0xc1,
            0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72, 0x82),
           (0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41, 0x51, 0x07,
            0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91, 0xa1, 0xb1, 0xc1, 0x09,
            0x23, 0x33, 0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1, 0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25,
            0xf1))


def _ac_symbols(head: tuple) -> list:
    every = {0x00, 0xf0} | {(r << 4) | s for r in range(16) for s in range(1, 11)}
    return list(head) + sorted(every - set(head))


def _huffman_codes(bits, symbols) -> dict:
    """symbol -> (code, length) of a canonical Huffman table."""
    codes, code, k = {}, 0, 0
    for length, count in enumerate(bits, start=1):
        for _ in range(count):
            codes[symbols[k]] = (code, length)
            code += 1
            k += 1
        code <<= 1
    return codes


def _quant_table(base: np.ndarray, quality: int = QUALITY) -> np.ndarray:
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    return np.clip((base * scale + 50) // 100, 1, 255)


def _rgb_to_ycc(rgb: np.ndarray) -> np.ndarray:
    """libjpeg's RGB -> YCbCr in 16-bit fixed point (jccolor.c)."""
    r, g, b = (rgb[..., i].astype(np.int64) for i in range(3))
    fix = lambda x: int(x * 65536 + 0.5)  # noqa: E731
    half, offset = 1 << 15, 128 << 16
    y = (fix(0.299) * r + fix(0.587) * g + fix(0.114) * b + half) >> 16
    cb = (-fix(0.16874) * r - fix(0.33126) * g + fix(0.5) * b + offset + half - 1) >> 16
    cr = (fix(0.5) * r - fix(0.41869) * g - fix(0.08131) * b + offset + half - 1) >> 16
    return np.stack([y, cb, cr], -1)


def _pad(plane: np.ndarray, rows: int, cols: int) -> np.ndarray:
    """``plane`` grown to (rows, cols) by repeating its last row and column."""
    return np.pad(plane, ((0, rows - plane.shape[0]), (0, cols - plane.shape[1])), mode="edge")


def _downsample(plane: np.ndarray) -> np.ndarray:
    """libjpeg's 2x2 box downsampling (jcsample.c h2v2_downsample): the sum
    of four samples plus a bias of 1, 2, 1, 2, ... along each row, >> 2."""
    s = plane[0::2, 0::2] + plane[0::2, 1::2] + plane[1::2, 0::2] + plane[1::2, 1::2]
    bias = np.where(np.arange(s.shape[1]) % 2 == 0, 1, 2)
    return (s + bias) >> 2


def _fdct_islow(blocks: np.ndarray) -> np.ndarray:
    """libjpeg's accurate integer forward DCT (jfdctint.c) of (n, 8, 8)
    level-shifted samples; the output is scaled up by 8."""
    c = dict(c0298=2446, c0390=3196, c0541=4433, c0765=6270, c0899=7373, c1175=9633,
             c1501=12299, c1847=15137, c1961=16069, c2053=16819, c2562=20995, c3072=25172)

    def descale(x, n):
        return (x + (1 << (n - 1))) >> n

    def one_pass(d, first: bool):
        d = d.copy()
        tmp0, tmp7 = d[..., 0] + d[..., 7], d[..., 0] - d[..., 7]
        tmp1, tmp6 = d[..., 1] + d[..., 6], d[..., 1] - d[..., 6]
        tmp2, tmp5 = d[..., 2] + d[..., 5], d[..., 2] - d[..., 5]
        tmp3, tmp4 = d[..., 3] + d[..., 4], d[..., 3] - d[..., 4]
        tmp10, tmp13, tmp11, tmp12 = tmp0 + tmp3, tmp0 - tmp3, tmp1 + tmp2, tmp1 - tmp2
        shift = 13 - 2 if first else 13 + 2
        if first:
            d[..., 0], d[..., 4] = (tmp10 + tmp11) << 2, (tmp10 - tmp11) << 2
        else:
            d[..., 0], d[..., 4] = descale(tmp10 + tmp11, 2), descale(tmp10 - tmp11, 2)
        z1 = (tmp12 + tmp13) * c["c0541"]
        d[..., 2] = descale(z1 + tmp13 * c["c0765"], shift)
        d[..., 6] = descale(z1 - tmp12 * c["c1847"], shift)
        z1, z2, z3, z4 = tmp4 + tmp7, tmp5 + tmp6, tmp4 + tmp6, tmp5 + tmp7
        z5 = (z3 + z4) * c["c1175"]
        tmp4, tmp5 = tmp4 * c["c0298"], tmp5 * c["c2053"]
        tmp6, tmp7 = tmp6 * c["c3072"], tmp7 * c["c1501"]
        z1, z2 = -z1 * c["c0899"], -z2 * c["c2562"]
        z3, z4 = -z3 * c["c1961"] + z5, -z4 * c["c0390"] + z5
        d[..., 7] = descale(tmp4 + z1 + z3, shift)
        d[..., 5] = descale(tmp5 + z2 + z4, shift)
        d[..., 3] = descale(tmp6 + z2 + z3, shift)
        d[..., 1] = descale(tmp7 + z1 + z4, shift)
        return d

    rows = one_pass(blocks.astype(np.int64), True)
    return one_pass(rows.transpose(0, 2, 1), False).transpose(0, 2, 1)


def _quantize(coefs: np.ndarray, table: np.ndarray) -> np.ndarray:
    """libjpeg-turbo's quantisation (jcdctmgr.c): |x| + c times a 16-bit
    reciprocal of the divisor (the table entry times 8), >> r, signed."""
    div = (table.astype(np.int64) << 3).reshape(8, 8)
    b = np.floor(np.log2(div)).astype(np.int64)
    r = 16 + b
    fq, fr = (np.int64(1) << r) // div, (np.int64(1) << r) % div
    c = div // 2
    pow2 = fr == 0
    fq = np.where(pow2, fq >> 1, np.where(fr > div // 2, fq + 1, fq))
    r = np.where(pow2, r - 1, r)
    c = np.where(~pow2 & (fr <= div // 2), c + 1, c)
    q = ((np.abs(coefs) + c) * fq) >> r
    return np.where(coefs < 0, -q, q)


class _BitWriter:
    def __init__(self):
        self.out = bytearray()
        self.acc = 0
        self.n = 0

    def put(self, code: int, length: int) -> None:
        self.acc = (self.acc << length) | code
        self.n += length
        while self.n >= 8:
            self.n -= 8
            byte = (self.acc >> self.n) & 0xFF
            self.out.append(byte)
            if byte == 0xFF:
                self.out.append(0)
        self.acc &= (1 << self.n) - 1

    def flush(self) -> bytes:
        if self.n:
            self.put((1 << (8 - self.n)) - 1, 8 - self.n)
        return bytes(self.out)


def _segment(marker: int, body: bytes) -> bytes:
    return struct.pack(">BBH", 0xFF, marker, len(body) + 2) + body


def _component_blocks(plane: np.ndarray, table: np.ndarray, rows: int, cols: int) -> np.ndarray:
    """Quantised coefficients (rows, cols, 64) of a padded plane's blocks."""
    blocks = plane[:rows * 8, :cols * 8].reshape(rows, 8, cols, 8).transpose(0, 2, 1, 3)
    coefs = _fdct_islow(blocks.reshape(-1, 8, 8) - 128)
    return _quantize(coefs, table).reshape(rows, cols, 64)


def encode_jpeg(bgr: np.ndarray) -> bytes:
    """The bytes OpenCV's ``imwrite`` gives for an (H, W, 3) uint8 BGR image
    as .jpg at its defaults (quality 95, 4:2:0)."""
    h, w, _ = bgr.shape
    ycc = _rgb_to_ycc(bgr[..., ::-1])
    mcu_rows, mcu_cols = -(-h // 16), -(-w // 16)
    # luma: blocks of the image (edge-padded within a block); the MCU grid's
    # blocks past them are dummies. Chroma: one block an MCU.
    yb_rows, yb_cols = -(-h // 8), -(-w // 8)
    luma_q, chroma_q = _quant_table(STD_LUMA), _quant_table(STD_CHROMA)
    y = _component_blocks(_pad(ycc[..., 0], yb_rows * 8, yb_cols * 8), luma_q, yb_rows, yb_cols)
    chroma = []
    for ch in (1, 2):
        full = _pad(ycc[..., ch], h + h % 2, 16 * mcu_cols)
        small = _pad(_downsample(full), 8 * mcu_rows, 8 * mcu_cols)
        chroma.append(_component_blocks(small, chroma_q, mcu_rows, mcu_cols))
    # the luma MCU grid with dummy blocks: AC zero, DC from the block before
    # it in the MCU (right edge) or the MCU's last block of the row above
    grid = np.zeros((mcu_rows * 2, mcu_cols * 2, 64), np.int64)
    grid[:yb_rows, :yb_cols] = y
    if yb_cols % 2:
        grid[:yb_rows, yb_cols, 0] = grid[:yb_rows, yb_cols - 1, 0]
    if yb_rows % 2:
        grid[yb_rows, :, 0] = grid[yb_rows - 1, 1::2, 0].repeat(2)

    codes = [(_huffman_codes(DC_BITS[t], list(range(12))),
              _huffman_codes(AC_BITS[t], _ac_symbols(AC_HEAD[t]))) for t in (0, 1)]
    bits = _BitWriter()
    last_dc = [0, 0, 0]

    def block(coef, comp: int, table: int) -> None:
        dc_codes, ac_codes = codes[table]
        zz = coef[ZIGZAG]
        diff = int(zz[0]) - last_dc[comp]
        last_dc[comp] = int(zz[0])
        n = abs(diff).bit_length()
        bits.put(*dc_codes[n])
        if n:
            bits.put(diff if diff > 0 else diff - 1 & ((1 << n) - 1), n)
        run = 0
        for v in zz[1:].tolist():
            if v == 0:
                run += 1
                continue
            while run > 15:
                bits.put(*ac_codes[0xF0])
                run -= 16
            n = abs(v).bit_length()
            bits.put(*ac_codes[(run << 4) | n])
            bits.put(v if v > 0 else (v - 1) & ((1 << n) - 1), n)
            run = 0
        if run:
            bits.put(*ac_codes[0x00])

    for my in range(mcu_rows):
        for mx in range(mcu_cols):
            for dy, dx in ((0, 0), (0, 1), (1, 0), (1, 1)):
                block(grid[2 * my + dy, 2 * mx + dx], 0, 0)
            block(chroma[0][my, mx], 1, 1)
            block(chroma[1][my, mx], 2, 1)

    out = [b"\xff\xd8", _segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")]
    for t, table in enumerate((luma_q, chroma_q)):
        out.append(_segment(0xDB, bytes([t]) + bytes(table[ZIGZAG].astype(np.uint8))))
    out.append(_segment(0xC0, struct.pack(">BHHB", 8, h, w, 3)
                        + bytes([1, 0x22, 0, 2, 0x11, 1, 3, 0x11, 1])))
    for t in (0, 1):
        out.append(_segment(0xC4, bytes([t]) + bytes(DC_BITS[t]) + bytes(range(12))))
        out.append(_segment(0xC4, bytes([0x10 | t]) + bytes(AC_BITS[t])
                            + bytes(_ac_symbols(AC_HEAD[t]))))
    out.append(_segment(0xDA, bytes([3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0])))
    out.append(bits.flush())
    out.append(b"\xff\xd9")
    return b"".join(out)


# --- PNG -----------------------------------------------------------------------

IDAT_BYTES = 8192


def _png_chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))


def encode_png16(gray: np.ndarray) -> bytes:
    """The bytes OpenCV's ``imwrite`` gives for an (H, W) uint16 image as
    .png at its defaults."""
    h, w = gray.shape
    rows = gray.astype(">u2").view(np.uint8).reshape(h, 2 * w).astype(np.int64)
    # libpng drops Sub for a one-pixel row (png_write_start_row): None
    sub = w > 1
    prev = np.pad(rows, ((0, 0), (2, 0)))[:, :-2] if sub else 0
    raw = np.concatenate([np.full((h, 1), int(sub)), (rows - prev) & 0xFF], 1)
    raw = raw.astype(np.uint8).tobytes()
    # libpng's window for small images (png_deflate_claim), and its smaller
    # CINFO in the stream's header (optimize_cmf)
    wbits, half = 15, 1 << 14
    if len(raw) <= 16384:
        while len(raw) + 262 <= half:
            half >>= 1
            wbits -= 1
    co = zlib.compressobj(1, zlib.DEFLATED, wbits, 8, zlib.Z_RLE)
    data = bytearray(co.compress(raw) + co.flush())
    if len(raw) <= 16384 and (data[0] & 0x0F) == 8 and (data[0] & 0xF0) <= 0x70:
        cinfo = data[0] >> 4
        half = 1 << (cinfo + 7)
        if len(raw) <= half:
            while cinfo > 0 and len(raw) <= half:
                half >>= 1
                cinfo -= 1
            data[0] = (data[0] & 0x0F) | (cinfo << 4)
            flg = data[1] & 0xE0
            data[1] = flg + 0x1F - ((data[0] << 8) + flg) % 0x1F
    data = bytes(data)
    return (b"\x89PNG\r\n\x1a\n" + _png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 16, 0, 0, 0, 0))
            + b"".join(_png_chunk(b"IDAT", data[i:i + IDAT_BYTES])
                       for i in range(0, len(data), IDAT_BYTES))
            + _png_chunk(b"IEND", b""))


# --- the VKITTI fixture ------------------------------------------------------------


def _se3(yaw: float, t: np.ndarray) -> np.ndarray:
    T = np.eye(4)
    T[:3, :3] = np.array([[np.cos(yaw), 0, np.sin(yaw)], [0, 1, 0], [-np.sin(yaw), 0, np.cos(yaw)]])
    T[:3, 3] = t
    return T


def write_vkitti_fixture(root: str, scene: str = "01", setting: str = "clone",
                         camera_id: int = 0, n_frames: int = 10, hw=(56, 84),
                         seed: int = 0) -> str:
    """Write Scene<scene>/<setting>/frames/{rgb,depth}/Camera_<id> with rgb
    jpgs, depth pngs (centimeters, uint16), extrinsic.txt and intrinsic.txt
    in the VKITTI 2 format the reader expects: the reference's files, byte
    for byte."""
    rng = np.random.default_rng(seed)
    H, W = hw
    scene_dir = osp.join(root, f"Scene{scene}", setting)
    rgb_dir = osp.join(scene_dir, "frames", "rgb", f"Camera_{camera_id}")
    depth_dir = osp.join(scene_dir, "frames", "depth", f"Camera_{camera_id}")
    os.makedirs(rgb_dir, exist_ok=True)
    os.makedirs(depth_dir, exist_ok=True)

    extr_rows = ["frame cameraID r1,1 r1,2 r1,3 t1 r2,1 r2,2 r2,3 t2 r3,1 r3,2 r3,3 t3 0 0 0 1"]
    intr_rows = ["frame cameraID K[0,0] K[1,1] K[0,2] K[1,2]"]
    f = 0.9 * W
    for i in range(n_frames):
        img = rng.uniform(0, 255, size=(H, W, 3)).astype(np.uint8)
        with open(osp.join(rgb_dir, f"rgb_{i:05d}.jpg"), "wb") as fh:
            fh.write(encode_jpeg(img))
        depth_m = rng.uniform(2.0, 40.0, size=(H, W)).astype(np.float32)
        with open(osp.join(depth_dir, f"depth_{i:05d}.png"), "wb") as fh:
            fh.write(encode_png16((depth_m * 100).astype(np.uint16)))
        for cam in (0, 1):
            T = _se3(0.01 * i, np.array([0.1 * i + 0.05 * cam, 0, -0.4 * i]))
            extr_rows.append(f"{i} {cam} " + " ".join(f"{v:.6f}" for v in T.reshape(-1)))
            intr_rows.append(f"{i} {cam} {f:.4f} {f:.4f} {W/2:.1f} {H/2:.1f}")
    with open(osp.join(scene_dir, "extrinsic.txt"), "w") as fh:
        fh.write("\n".join(extr_rows) + "\n")
    with open(osp.join(scene_dir, "intrinsic.txt"), "w") as fh:
        fh.write("\n".join(intr_rows) + "\n")
    return root
