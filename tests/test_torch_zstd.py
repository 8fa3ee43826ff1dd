"""The port's zstd decoder (``factorized_tpu_torch/utils/zstd.py``) against
the ``zstandard`` package's compressor, on the CPU.

The corpus: 0 bytes, one byte, random bytes (raw blocks), zeros (RLE),
float32 weights (Huffman-coded literals), text (sequences with FSE
tables of every mode, repeat offsets) and a mix of them up to about 1 MB,
at levels -5, 1, 3 and 19, each with and without the content size and
the checksum; two frames back to back with a skippable frame between
them; a stream of flushed blocks (treeless literals and repeat tables);
every zstd frame the released ``best/mfn_mae`` store holds (at the
offsets its B+tree gives); and malformed frames that must raise
``ValueError``: a corrupted checksum, a dictionary id, a reserved block
type, a truncated frame. ``xxh64`` against the ``xxhash`` spec values
``zstandard`` writes into its checksums."""

import glob
import io
import os

import numpy as np
import pytest

from factorized_tpu_torch.utils import ocdbt, zstd

zstandard = pytest.importorskip("zstandard")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _text():
    return b"".join(open(p, "rb").read()
                    for p in sorted(glob.glob(os.path.join(ROOT, "*.md"))))


def _corpus():
    rng = np.random.default_rng(0)
    text = _text()[:400_000]
    words = text.split()
    shuffled = b" ".join(words[i] for i in rng.integers(0, len(words),
                                                        60_000))
    weights = (0.1 * rng.standard_normal(200_000)).astype(np.float32)
    mixed = b"".join([rng.bytes(3000), bytes(5000), text[:20000],
                      weights[:5000].tobytes()] * 6)
    return {"empty": b"", "one": b"x", "random": rng.bytes(150_000),
            "zeros": bytes(300_000), "weights": weights.tobytes(),
            "text": text, "shuffled": shuffled, "mixed": mixed}


CORPUS = _corpus()


@pytest.mark.parametrize("level", [-5, 1, 3, 19])
@pytest.mark.parametrize("name", list(CORPUS))
def test_the_decoder_is_zstandards(level, name):
    data = CORPUS[name]
    for size, check in ((True, True), (False, False)):
        frame = zstandard.ZstdCompressor(
            level=level, write_content_size=size,
            write_checksum=check).compress(data)
        assert zstd.decompress(frame) == data, (level, name, size, check)


def test_frames_back_to_back_with_a_skippable_one():
    text = CORPUS["text"]
    a = zstandard.ZstdCompressor(level=3).compress(text[:1000])
    b = zstandard.ZstdCompressor(level=1, write_content_size=False,
                                 write_checksum=True).compress(text[1000:9000])
    skip = (0x184D2A5E).to_bytes(4, "little") + (6).to_bytes(4, "little")
    assert zstd.decompress(a + skip + b"ignore" + b) == text[:9000]
    assert zstd.decompress(skip + b"ignore") == b""


def test_a_stream_of_flushed_blocks():
    data = CORPUS["shuffled"]
    out = io.BytesIO()
    with zstandard.ZstdCompressor(level=3).stream_writer(
            out, closefd=False) as w:
        for i in range(0, len(data), 5000):
            w.write(data[i:i + 5000])
            w.flush(zstandard.FLUSH_BLOCK)
    assert zstd.decompress(out.getvalue()) == data


def test_every_frame_of_the_released_store():
    """Each value of ``best/mfn_mae``'s store that is a zstd frame (its
    zarr chunks, inline or in the data files) decodes as ``zstandard``
    decodes it."""
    store = ocdbt.read(os.path.join(ROOT, "best", "mfn_mae", "state"))
    dctx = zstandard.ZstdDecompressor()
    n = 0
    for key in store:
        raw = store[key]
        if raw[:4] != zstd.MAGIC.to_bytes(4, "little"):
            continue
        want = dctx.decompressobj().decompress(raw)
        assert zstd.decompress(raw) == want, key
        n += 1
    assert n == 77


def _frame(data=b"hello zstd " * 50, **kw):
    return bytearray(zstandard.ZstdCompressor(level=3, **kw).compress(data))


def test_a_corrupted_checksum_raises():
    frame = _frame(write_checksum=True)
    frame[-1] ^= 0x40
    with pytest.raises(ValueError, match="checksum mismatch at byte"):
        zstd.decompress(bytes(frame))


def test_a_dictionary_id_raises():
    """A frame whose header names dictionary 7 (a 1-byte id field after
    the window descriptor, where the frame has one)."""
    frame = _frame()
    single = frame[4] & 0x20
    frame[4] |= 1
    frame[6 - bool(single):6 - bool(single)] = b"\x07"
    with pytest.raises(ValueError, match="dictionary 7"):
        zstd.decompress(bytes(frame))


def test_malformed_frames_raise_with_their_offset():
    with pytest.raises(ValueError, match="bad magic number .* at byte 0"):
        zstd.decompress(b"\x00\x01\x02\x03rest")
    frame = _frame()
    with pytest.raises(ValueError, match="at byte"):
        zstd.decompress(bytes(frame[:len(frame) // 2]))
    reserved = _frame(write_content_size=False)
    at = 4 + 2                              # magic, descriptor, window
    reserved[at] = (reserved[at] & ~0x06) | 0x06
    with pytest.raises(ValueError, match="reserved block type at byte 6"):
        zstd.decompress(bytes(reserved))
    header = _frame()
    header[4] |= 0x08                       # the reserved header bit
    with pytest.raises(ValueError, match="reserved bit"):
        zstd.decompress(bytes(header))


@pytest.mark.parametrize("n", [0, 1, 3, 4, 7, 8, 31, 32, 33, 100, 1000])
def test_xxh64_is_the_checksum_zstandard_writes(n):
    data = np.random.default_rng(n).bytes(n)
    frame = zstandard.ZstdCompressor(write_checksum=True).compress(data)
    assert zstd.xxh64(data) & 0xFFFFFFFF == int.from_bytes(frame[-4:],
                                                          "little")
