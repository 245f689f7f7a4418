"""The port's zstd decoder (vitslam_tpu_torch/native/zstd.cpp, written from
RFC 8878, built by g++ at first use) against the ``zstandard`` package:
the same bytes, bit for bit, over drawn contents (runs, text, fp32 and bf16
normals, random bytes) at levels -5 to 19, with and without the content
checksum, with long-distance matching, over frames back to back and
skippable frames; corrupt frames raise; and the CRC-32C beside it against
its published check values."""
import numpy as np
import pytest

zstandard = pytest.importorskip("zstandard")
from hypothesis import HealthCheck, given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from vitslam_tpu_torch.native import bindings  # noqa: E402

LEVELS = (-5, 1, 3, 9, 19)
KINDS = ("runs", "text", "f32", "bf16", "bytes")


def content(kind: str, size: int, seed: int) -> bytes:
    """``size`` bytes of one kind, drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    if kind == "runs":
        n = size // 40 + 1
        out = np.repeat(rng.integers(0, 5, n, dtype=np.uint8), rng.integers(1, 80, n))
    elif kind == "text":
        words = np.array(b"the of a map key node chunk frame offset literal stream".split())
        out = np.frombuffer(b" ".join(words[rng.integers(0, len(words), size // 3 + 1)]),
                            np.uint8)
    elif kind == "f32":
        out = rng.standard_normal(size // 4 + 1, dtype=np.float32).view(np.uint8)
    elif kind == "bf16":
        f = rng.standard_normal(size // 2 + 1, dtype=np.float32)
        out = (f.view(np.uint32) >> 16).astype(np.uint16).view(np.uint8)
    else:
        out = rng.integers(0, 256, size, dtype=np.uint8)
    return out[:size].tobytes()


def decode(frames: bytes, size: int) -> bytes:
    out = np.empty(size, np.uint8)
    assert bindings.zstd_decompress_into(frames, out) == size
    return out.tobytes()


@settings(max_examples=40, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(kind=st.sampled_from(KINDS), size=st.integers(0, 1 << 20), seed=st.integers(0, 99),
       level=st.sampled_from(LEVELS), checksum=st.booleans())
def test_decoder_equals_zstandard(kind, size, seed, level, checksum):
    data = content(kind, size, seed)
    frame = zstandard.ZstdCompressor(level=level, write_checksum=checksum).compress(data)
    assert decode(frame, len(data)) == zstandard.ZstdDecompressor().decompress(frame) == data


@pytest.mark.parametrize("level", LEVELS)
def test_every_level_over_every_kind(level):
    """Each level over every kind at 300 kB (blocks of 128 kB, so the
    repeated Huffman and sequence tables of later blocks are read), also
    without the content size in the header."""
    for i, kind in enumerate(KINDS):
        data = content(kind, 300_000, i)
        for cctx in (zstandard.ZstdCompressor(level=level, write_checksum=True),
                     zstandard.ZstdCompressor(level=level, write_content_size=False)):
            assert decode(cctx.compress(data), len(data)) == data, kind


def test_long_distance_matching_and_large_windows():
    """Long-distance matching over 24 MiB with a 2^25 window: matches that
    reach 16 MiB back."""
    block = content("f32", 8 << 20, 7)
    data = block + content("text", 8 << 20, 8) + block
    params = zstandard.ZstdCompressionParameters.from_level(
        3, enable_ldm=True, window_log=25, write_checksum=True)
    frame = zstandard.ZstdCompressor(compression_params=params).compress(data)
    assert len(frame) < len(data) * 0.75  # the repeated block was matched
    assert decode(frame, len(data)) == data


def _skippable(payload: bytes, nibble: int = 0) -> bytes:
    return (0x184D2A50 + nibble).to_bytes(4, "little") + len(payload).to_bytes(4, "little") \
        + payload


def test_concatenated_and_skippable_frames():
    parts = [content(k, 50_000 + 999 * i, i) for i, k in enumerate(KINDS)]
    frames = b"".join(
        _skippable(b"x" * i, i) + zstandard.ZstdCompressor(
            level=LEVELS[i], write_checksum=i % 2, write_content_size=i != 2).compress(p)
        for i, p in enumerate(parts)) + _skippable(b"", 15)
    assert decode(frames, sum(map(len, parts))) == b"".join(parts)
    # one frame without its content size: the output sized by doubling
    assert bindings.zstd_decompress(frames, 1 << 20) == b"".join(parts)
    with pytest.raises(ValueError):
        bindings.zstd_decompress(frames, 100_000)


def test_corrupt_frames_raise():
    """Every truncation raises; a bit flipped anywhere past the frame
    header's unused bit, in a frame that carries its checksum, raises; so
    do a dictionary, a reserved bit and a content size that does not fit
    the buffer."""
    rng = np.random.default_rng(0)
    data = content("text", 20_000, 1) + content("f32", 20_000, 2)
    frame = zstandard.ZstdCompressor(level=3, write_checksum=True).compress(data)
    for cut in sorted(set(rng.integers(0, len(frame), 60).tolist()) | {0, 4, len(frame) - 1}):
        with pytest.raises(ValueError):
            decode(frame[:cut], len(data))
    for pos in rng.integers(0, len(frame), 200).tolist():
        bit = int(rng.integers(0, 8))
        if pos == 4 and bit == 4:  # the descriptor's unused bit, which decoders ignore
            continue
        bad = bytearray(frame)
        bad[pos] ^= 1 << bit
        with pytest.raises(ValueError):
            decode(bytes(bad), len(data))
    reserved = bytearray(frame)
    reserved[4] |= 8
    with pytest.raises(ValueError, match="reserved"):
        decode(bytes(reserved), len(data))
    with pytest.raises(ValueError, match="content size|buffer"):
        decode(frame, len(data) + 1)
    samples = [content("text", 400, s) for s in range(200)]
    d = zstandard.train_dictionary(2048, samples)
    with pytest.raises(ValueError, match="dictionar"):
        decode(zstandard.ZstdCompressor(dict_data=d).compress(samples[0]), 400)


def test_checksums_match_their_check_values():
    """CRC-32C (OCDBT's) against its check values; the decoder's XXH64 is
    held by every checksummed frame above."""
    assert bindings.crc32c(b"123456789") == 0xE3069283
    assert bindings.crc32c(b"") == 0
    assert bindings.crc32c(bytes(32)) == 0x8A9136AA
