"""The port's zstd decoder (``native/csrc/zstd_decode.cc`` through
``seldon_tpu_torch/servers/zstd.py``) against ``zstandard``.

Every frame here is written by ``zstandard`` from seeded inputs (random
bytes, random bf16 arrays, repetitive text, all zeros) at levels 1, 3, 9,
19 and 22, with and without the checksum and the content size; also
concatenated and skippable frames, a 32 MiB buffer, inputs shaped to
reach the decoder's rarer paths (matches across blocks at high levels,
runs of one byte, literal-only blocks; RLE literals in a frame built by
hand), and a hypothesis property over
levels 1-19. A truncated frame, a corrupted checksum and a dictionary
frame raise. The raw-block frames the port's checkpoint writer uses are
read back by ``zstandard``."""

import ctypes

import numpy as np
import pytest

from hypothesis import given, settings, strategies as st

from seldon_tpu_torch.servers import zstd

zstandard = pytest.importorskip("zstandard")

LEVELS = (1, 3, 9, 19, 22)


def _bf16(rng, n):
    f = rng.standard_normal(n).astype(np.float32)
    return (f.view(np.uint32) >> 16).astype(np.uint16).tobytes()


def _inputs():
    rng = np.random.default_rng(22)
    text = b"".join(b"row %d of a repetitive text, line %d\n" % (i % 53, i)
                    for i in range(6000))
    return {"random": rng.integers(0, 256, 150_000, np.uint8).tobytes(),
            "bf16": _bf16(rng, 120_000),
            "text": text,
            "zeros": bytes(400_000)}


INPUTS = _inputs()


def _compress(data, level, checksum=False, size=True):
    return zstandard.ZstdCompressor(
        level=level, write_checksum=checksum,
        write_content_size=size).compress(data)


@pytest.mark.parametrize("size", [True, False], ids=["size", "nosize"])
@pytest.mark.parametrize("checksum", [True, False], ids=["ck", "nock"])
@pytest.mark.parametrize("level", LEVELS)
@pytest.mark.parametrize("kind", sorted(INPUTS))
def test_decoder_equals_zstandard(kind, level, checksum, size):
    data = INPUTS[kind]
    frame = _compress(data, level, checksum, size)
    assert zstd.decompress(frame) == data
    assert zstd.content_size(frame) == (len(data) if size else None)
    out = np.empty(len(data), np.uint8)
    assert zstd.decompress_into(frame, out) == len(data)
    assert out.tobytes() == data


@pytest.mark.parametrize("level", [1, 19])
def test_concatenated_and_skippable_frames(level):
    parts = [INPUTS["text"][:5000], INPUTS["random"][:7000], b"",
             INPUTS["bf16"][:9000]]
    skip = b"\x50\x2a\x4d\x18" + (5).to_bytes(4, "little") + b"hello"
    skip2 = b"\x5f\x2a\x4d\x18" + (0).to_bytes(4, "little")
    stream = skip + b"".join(_compress(p, level) + skip2 for p in parts)
    assert zstd.decompress(stream) == b"".join(parts)
    assert zstd.content_size(stream) == sum(map(len, parts))


@pytest.mark.parametrize("level", [3, 19, 22])
def test_shapes_that_reach_rarer_paths(level):
    rng = np.random.default_rng(5)
    block = rng.integers(0, 256, 200_000, np.uint8).tobytes()
    cases = {
        # A match reaches back past the 128 KiB block into the window.
        "far": block + block[:150_000],
        # Runs of one byte (RLE blocks).
        "runs": b"".join(bytes([i % 7]) * int(n) for i, n in
                         enumerate(rng.integers(1, 3000, 400))),
        # Mostly literals with a few short repeats (treeless literals and
        # repeat offsets with a zero literal length across blocks).
        "literals": b"".join(block[i:i + 40] * 2 + block[i + 97:i + 300]
                             for i in range(0, 150_000, 300)),
        "small": b"abcabcabcabcabcd" * 3,
        "one": b"x",
        "empty": b"",
    }
    for name, data in cases.items():
        for ck in (False, True):
            frame = _compress(data, level, checksum=ck)
            assert zstd.decompress(frame) == data, (name, ck)


def test_rle_literals_frame():
    """A compressed block whose literals section is RLE (libzstd rarely
    emits one): built by hand, read alike by both decoders. Literals:
    type 1, 2-byte size header; sequences: none."""
    n = 1000
    lit = bytes([1 | (1 << 2) | ((n & 15) << 4), n >> 4]) + b"q"
    body = lit + b"\x00"
    block = ((len(body) << 3) | (2 << 1) | 1).to_bytes(3, "little") + body
    # Single segment with a 2-byte content size (stored as n - 256).
    frame = (zstd.MAGIC.to_bytes(4, "little") + bytes([0x60])
             + (n - 256).to_bytes(2, "little") + block)
    assert zstandard.ZstdDecompressor().decompress(frame) == b"q" * n
    assert zstd.decompress(frame) == b"q" * n


def test_large_buffer():
    rng = np.random.default_rng(7)
    data = _bf16(rng, 16 << 20)  # 32 MiB
    frame = _compress(data, 1)
    assert len(frame) < 0.9 * len(data)
    out = np.empty(len(data) // 2, np.uint16)
    assert zstd.decompress_into(frame, out) == len(data)
    assert out.tobytes() == data
    # Streamed (no content size in the header): the buffer grows.
    streamed = zstandard.ZstdCompressor(level=1).compressobj()
    frame = streamed.compress(data[:1 << 20]) + streamed.flush()
    assert zstd.decompress(frame) == data[:1 << 20]


@settings(max_examples=40, deadline=None)
@given(data=st.binary(max_size=6000), level=st.integers(1, 19),
       repeat=st.integers(1, 8), checksum=st.booleans())
def test_property_levels_1_to_19(data, level, repeat, checksum):
    data = data * repeat
    frame = _compress(data, level, checksum=checksum)
    assert zstd.decompress(frame) == data


def test_truncated_and_corrupted_frames_raise():
    data = INPUTS["text"]
    frame = _compress(data, 3, checksum=True)
    for cut in (3, 6, len(frame) // 2, len(frame) - 1):
        with pytest.raises(zstd.ZstdError):
            zstd.decompress(frame[:cut], size=len(data))
    bad = bytearray(frame)
    bad[-1] ^= 0x40  # the content checksum
    with pytest.raises(zstd.ZstdError, match="checksum"):
        zstd.decompress(bytes(bad))
    with pytest.raises(zstd.ZstdError, match="magic"):
        zstd.decompress(b"\x00" * 16)
    out = np.empty(len(data) - 1, np.uint8)
    with pytest.raises(zstd.OutputTooSmall):
        zstd.decompress_into(frame, out)
    with pytest.raises(zstd.OutputTooSmall):
        zstd.decompress(frame, size=len(data) - 1)


def test_dictionary_frame_refused():
    d = zstandard.train_dictionary(
        4096, [INPUTS["text"][i:i + 400] for i in range(0, 80_000, 400)])
    frame = zstandard.ZstdCompressor(dict_data=d).compress(
        INPUTS["text"][:3000])
    with pytest.raises(zstd.ZstdError, match="dictionar"):
        zstd.decompress(frame)


@pytest.mark.parametrize("n", [0, 1, zstd.BLOCK_MAX, zstd.BLOCK_MAX + 1,
                               3 * zstd.BLOCK_MAX + 17])
def test_raw_frames_read_by_zstandard(n):
    data = np.random.default_rng(n).integers(0, 256, n, np.uint8)
    frame = b"".join(bytes(p) for p in zstd.raw_frame_parts(data))
    assert len(frame) == zstd.raw_frame_size(n) == (
        14 + 3 * max(1, -(-n // zstd.BLOCK_MAX)) + n)
    assert zstandard.ZstdDecompressor().decompress(frame) == data.tobytes()
    assert zstd.decompress(frame) == data.tobytes()


def test_crc32c_and_xxh64():
    # CRC-32C check value (RFC 3720 B.4) and XXH64 against zstandard's
    # content checksum (its low 32 bits).
    assert zstd.crc32c(b"123456789") == 0xE3069283
    assert zstd.crc32c(bytes(32)) == 0x8A9136AA
    assert zstd.crc32c(b"56789", zstd.crc32c(b"1234")) == 0xE3069283
    for data in (b"", b"a", INPUTS["text"][:1000], INPUTS["random"]):
        frame = _compress(data, 1, checksum=True)
        assert _xxh64(data) & 0xFFFFFFFF == int.from_bytes(
            frame[-4:], "little")


def _xxh64(data: bytes) -> int:
    """XXH64 (seed 0), the decoder's own, called in its library."""
    lib = zstd._load()
    lib.seldon_xxh64.restype = ctypes.c_uint64
    buf = np.frombuffer(data, np.uint8)
    return lib.seldon_xxh64(ctypes.c_void_p(buf.ctypes.data),
                            ctypes.c_int64(buf.size))
