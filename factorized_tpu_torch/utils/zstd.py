"""A Zstandard decoder (RFC 8878) in Python and numpy.

The JAX package's Orbax checkpoints hold their arrays as zstd frames
(``utils/ocdbt.py``), and a host of the port need not have a zstd
library, so the port reads them with this decoder. It covers the whole
frame format but dictionaries:

- concatenated frames, skippable frames skipped;
- the frame header (window, dictionary id 0 only, content size checked
  where present) and the xxHash64 content checksum where the flag is set
  (``xxh64``, its own);
- raw, RLE and compressed blocks;
- literals raw, RLE, Huffman-coded in 1 or 4 streams, and treeless (the
  previous block's table);
- sequences with FSE tables in predefined, RLE, compressed and repeat
  modes, the three repeat offsets, and matches within the window.

A malformed input raises ``ValueError`` naming the byte offset in the
input where decoding stopped. The backward bit streams are read through
64-bit windows (``_windows``: the 8 bytes at every byte offset, as Python
ints), so each read is one shift and mask of a small integer.

    from factorized_tpu_torch.utils.zstd import decompress
    data = decompress(frames)
"""

from __future__ import annotations

import numpy as np

MAGIC = 0xFD2FB528
_SKIPPABLE = 0x184D2A50           # the high 28 bits of a skippable magic
_BLOCK_MAX = 128 * 1024
_M64 = (1 << 64) - 1

# ---------------------------------------------------------------- xxh64

_P1 = 11400714785074694791
_P2 = 14029467366897019727
_P3 = 1609587929392839161
_P4 = 9650029242287828579
_P5 = 2870177450012600261


def _rotl(x, r):
    return ((x << r) | (x >> (64 - r))) & _M64


def _round(acc, lane):
    acc = (acc + lane * _P2) & _M64
    return (((acc << 31) | (acc >> 33)) & _M64) * _P1 & _M64


def xxh64(data, seed: int = 0) -> int:
    """The 64-bit xxHash of ``data`` (bytes-like) with ``seed``."""
    data = bytes(data)
    n, i = len(data), 0
    if n >= 32:
        v1 = (seed + _P1 + _P2) & _M64
        v2 = (seed + _P2) & _M64
        v3 = seed & _M64
        v4 = (seed - _P1) & _M64
        stripes = n // 32
        lanes = np.frombuffer(data, "<u8", count=stripes * 4).tolist()
        for j in range(0, 4 * stripes, 4):
            v1 = _round(v1, lanes[j])
            v2 = _round(v2, lanes[j + 1])
            v3 = _round(v3, lanes[j + 2])
            v4 = _round(v4, lanes[j + 3])
        i = 32 * stripes
        h = (_rotl(v1, 1) + _rotl(v2, 7) + _rotl(v3, 12)
             + _rotl(v4, 18)) & _M64
        for v in (v1, v2, v3, v4):
            h = ((h ^ _round(0, v)) * _P1 + _P4) & _M64
    else:
        h = (seed + _P5) & _M64
    h = (h + n) & _M64
    while i + 8 <= n:
        h ^= _round(0, int.from_bytes(data[i:i + 8], "little"))
        h = (_rotl(h, 27) * _P1 + _P4) & _M64
        i += 8
    if i + 4 <= n:
        h ^= int.from_bytes(data[i:i + 4], "little") * _P1 & _M64
        h = (_rotl(h, 23) * _P2 + _P3) & _M64
        i += 4
    while i < n:
        h ^= data[i] * _P5 & _M64
        h = _rotl(h, 11) * _P1 & _M64
        i += 1
    h ^= h >> 33
    h = h * _P2 & _M64
    h ^= h >> 29
    h = h * _P3 & _M64
    return h ^ (h >> 32)


# ------------------------------------------------------------ bit reads

def _windows(stream):
    """The little-endian 64-bit word at every byte offset of ``stream``
    with 8 zero bytes before and after it, as a list of Python ints: bit
    ``p`` of the stream (``p`` from -64) starts the word ``w[(p + 64) >>
    3]`` at its bit ``(p + 64) & 7``."""
    a = np.frombuffer(bytes(8) + bytes(stream) + bytes(8), np.uint8)
    n = len(stream) + 9
    w = np.zeros(n, np.uint64)
    for k in range(8):
        w |= a[k:k + n].astype(np.uint64) << np.uint64(8 * k)
    return w.tolist()


def _backward_start(stream, at):
    """The bit count of a backward stream: the bits below the end marker
    (the highest set bit of its last byte)."""
    if not len(stream) or stream[-1] == 0:
        raise ValueError(f"zstd: bit stream without its end marker at "
                         f"byte {at + len(stream) - 1}")
    return 8 * (len(stream) - 1) + stream[-1].bit_length() - 1


class _Forward:
    """Little-endian bits read from the front of ``data[at:]`` (FSE table
    descriptions); bits past the input read as zeros, and ``end`` refuses
    a description that used them."""

    def __init__(self, data, at):
        self.data, self.at, self.bit = data, at, 0

    def read(self, n):
        b = self.at + (self.bit >> 3)
        chunk = int.from_bytes(self.data[b:b + 8], "little")
        v = (chunk >> (self.bit & 7)) & ((1 << n) - 1)
        self.bit += n
        return v

    def end(self):
        end = self.at + ((self.bit + 7) >> 3)
        if end > len(self.data):
            raise ValueError(f"zstd: table description runs past the "
                             f"input at byte {self.at}")
        return end


# ---------------------------------------------------------------- FSE

def _read_ncount(data, at, max_log, max_symbol):
    """An FSE table description at ``data[at:]``: (normalized counts,
    accuracy log, the byte after it)."""
    r = _Forward(data, at)
    log = r.read(4) + 5
    if log > max_log:
        raise ValueError(f"zstd: FSE accuracy log {log} above {max_log} at "
                         f"byte {at}")
    remaining = (1 << log) + 1
    threshold = 1 << log
    nbits = log + 1
    counts = []
    while remaining > 1:
        if len(counts) > max_symbol:
            raise ValueError(f"zstd: FSE table with too many symbols at "
                             f"byte {at}")
        top = 2 * threshold - 1 - remaining
        low = r.read(nbits - 1)
        if low < top:
            count = low
        else:
            r.bit -= nbits - 1
            count = r.read(nbits)
            if count >= threshold:
                count -= top
        count -= 1
        remaining -= abs(count)
        counts.append(count)
        if count == 0:
            while True:
                rep = r.read(2)
                counts.extend([0] * rep)
                if rep != 3:
                    break
            if len(counts) > max_symbol + 1:
                raise ValueError(f"zstd: FSE zero run past the last symbol "
                                 f"at byte {at}")
        while remaining < threshold:
            nbits -= 1
            threshold >>= 1
    if remaining != 1:
        raise ValueError(f"zstd: FSE counts do not fill the table at byte "
                         f"{at}")
    return counts, log, r.end()


def _fse_table(counts, log):
    """The decoding table of normalized ``counts`` at accuracy ``log``:
    per state (symbol, bits to read, baseline), as three lists."""
    size = 1 << log
    sym = [0] * size
    nxt = [0] * len(counts)
    high = size - 1
    for s, c in enumerate(counts):
        if c == -1:
            sym[high] = s
            high -= 1
            nxt[s] = 1
        else:
            nxt[s] = c
    step = (size >> 1) + (size >> 3) + 3
    mask = size - 1
    pos = 0
    for s, c in enumerate(counts):
        for _ in range(max(c, 0)):
            sym[pos] = s
            pos = (pos + step) & mask
            while pos > high:
                pos = (pos + step) & mask
    if pos != 0:
        raise ValueError("zstd: FSE counts do not spread over the table")
    nb = [0] * size
    base = [0] * size
    for u in range(size):
        s = sym[u]
        x = nxt[s]
        nxt[s] += 1
        b = log - (x.bit_length() - 1)
        nb[u] = b
        base[u] = (x << b) - size
    return sym, nb, base, log


def _rle_table(symbol):
    return [symbol], [0], [0], 0


_LL_DEFAULT = ([4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2, 2, 2,
                2, 2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1], 6)
_ML_DEFAULT = ([1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1], 6)
_OF_DEFAULT = ([1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                1, 1, 1, 1, -1, -1, -1, -1, -1], 5)
_DEFAULT_TABLES = {}

_LL_BASE = list(range(16)) + [16, 18, 20, 22, 24, 28, 32, 40, 48, 64, 128,
                              256, 512, 1024, 2048, 4096, 8192, 16384,
                              32768, 65536]
_LL_BITS = [0] * 16 + [1, 1, 1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12,
                       13, 14, 15, 16]
_ML_BASE = [c + 3 for c in range(32)] + [35, 37, 39, 41, 43, 47, 51, 59, 67,
                                         83, 99, 131, 259, 515, 1027, 2051,
                                         4099, 8195, 16387, 32771, 65539]
_ML_BITS = [0] * 32 + [1, 1, 1, 1, 2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12,
                       13, 14, 15, 16]
# (predefined counts and log, largest symbol, largest accuracy log)
_KINDS = {"literal lengths": (_LL_DEFAULT, 35, 9),
          "offsets": (_OF_DEFAULT, 31, 8),
          "match lengths": (_ML_DEFAULT, 52, 9)}


def _default_table(kind):
    if kind not in _DEFAULT_TABLES:
        counts, log = _KINDS[kind][0]
        _DEFAULT_TABLES[kind] = _fse_table(counts, log)
    return _DEFAULT_TABLES[kind]


# ------------------------------------------------------------- Huffman

def _huffman_weights(data, at, end):
    """The Huffman tree description at ``data[at:]`` -> (weights of the
    symbols but the last, the byte after it)."""
    if at >= end:
        raise ValueError(f"zstd: missing Huffman tree at byte {at}")
    head = data[at]
    if head >= 128:
        n = head - 127
        nbytes = (n + 1) // 2
        if at + 1 + nbytes > end:
            raise ValueError(f"zstd: Huffman weights run past the block at "
                             f"byte {at}")
        weights = []
        for b in data[at + 1:at + 1 + nbytes]:
            weights += (b >> 4, b & 15)
        return weights[:n], at + 1 + nbytes
    size = head
    start, stop = at + 1, at + 1 + size
    if stop > end or size == 0:
        raise ValueError(f"zstd: Huffman weights run past the block at "
                         f"byte {at}")
    counts, log, after = _read_ncount(data, start, 6, 255)
    sym, nb, base, _ = _fse_table(counts, log)
    stream = data[after:stop]
    pos = _backward_start(stream, after)
    w = _windows(stream)

    def read(n):
        nonlocal pos
        pos -= n
        q = pos + 64
        return (w[q >> 3] >> (q & 7)) & ((1 << n) - 1) if q >= 0 else 0

    s1 = read(log)
    s2 = read(log)
    out = []
    while True:
        out.append(sym[s1])
        s1 = base[s1] + read(nb[s1])
        if pos < 0:
            out.append(sym[s2])
            break
        out.append(sym[s2])
        s2 = base[s2] + read(nb[s2])
        if pos < 0:
            out.append(sym[s1])
            break
        if len(out) > 255:
            break
    if len(out) > 255:
        raise ValueError(f"zstd: more than 255 Huffman weights at byte {at}")
    return out, stop


def _huffman_table(weights, at):
    """The decoding table of ``weights``: (max bits, per code of max bits
    bits the symbol | bits << 8)."""
    if any(w > 11 for w in weights):
        raise ValueError(f"zstd: Huffman weight above 11 at byte {at}")
    total = sum(1 << w >> 1 for w in weights)
    if total == 0:
        raise ValueError(f"zstd: Huffman weights all zero at byte {at}")
    max_bits = total.bit_length()
    left = (1 << max_bits) - total
    if left & (left - 1):
        raise ValueError(f"zstd: Huffman weights leave no power of two at "
                         f"byte {at}")
    weights = weights + [left.bit_length()]
    if max_bits > 11:
        raise ValueError(f"zstd: Huffman code longer than 11 bits at byte "
                         f"{at}")
    rank = [0] * (max_bits + 2)
    for w in weights:
        if w:
            rank[w] += 1
    start, at_rank = [0] * (max_bits + 2), 0
    for w in range(1, max_bits + 1):
        start[w] = at_rank
        at_rank += rank[w] << (w - 1)
    table = [0] * (1 << max_bits)
    for s, w in enumerate(weights):
        if not w:
            continue
        n = (1 << w) >> 1
        entry = s | ((max_bits + 1 - w) << 8)
        table[start[w]:start[w] + n] = [entry] * n
        start[w] += n
    return max_bits, table


def _huffman_stream(data, a, b, count, huf, out):
    """``count`` symbols of the Huffman stream ``data[a:b]`` appended to
    ``out`` (a bytearray)."""
    stream = data[a:b]
    pos = _backward_start(stream, a)
    w = _windows(stream)
    mb, table = huf
    mask = (1 << mb) - 1
    shift = 64 - mb
    append = out.append
    try:
        for _ in range(count):
            q = pos + shift
            e = table[(w[q >> 3] >> (q & 7)) & mask]
            append(e & 255)
            pos -= e >> 8
    except IndexError:
        pos = -1
    if pos != 0:
        raise ValueError(f"zstd: Huffman stream of bytes {a}..{b} does not "
                         f"end on its last bit")


# ------------------------------------------------------------ decoder

class _Frame:
    """The state one frame carries from block to block."""

    def __init__(self, window):
        self.window = window
        self.huf = None
        self.tables = {}
        self.rep = [1, 4, 8]
        self.out = bytearray()


def _literals(data, at, end, fr):
    """The literals section at ``data[at:end]`` -> (literals, byte after
    the section)."""
    b0 = data[at]
    kind, fmt = b0 & 3, (b0 >> 2) & 3
    if kind < 2:
        if fmt in (0, 2):
            size, head = b0 >> 3, 1
        elif fmt == 1:
            size, head = (b0 >> 4) + (data[at + 1] << 4), 2
        else:
            size = (b0 >> 4) + (data[at + 1] << 4) + (data[at + 2] << 12)
            head = 3
        a = at + head
        if kind == 0:
            if a + size > end:
                raise ValueError(f"zstd: raw literals run past the block at "
                                 f"byte {at}")
            return bytes(data[a:a + size]), a + size
        if a >= end:
            raise ValueError(f"zstd: RLE literals without their byte at "
                             f"byte {at}")
        return bytes(data[a:a + 1]) * size, a + 1
    head = (3, 3, 4, 5)[fmt]
    h = int.from_bytes(data[at:at + head], "little")
    bits = (10, 10, 14, 18)[fmt]
    size = (h >> 4) & ((1 << bits) - 1)
    csize = (h >> (4 + bits)) & ((1 << bits) - 1)
    streams = 1 if fmt == 0 else 4
    a = at + head
    stop = a + csize
    if stop > end:
        raise ValueError(f"zstd: compressed literals run past the block at "
                         f"byte {at}")
    if size > _BLOCK_MAX:
        raise ValueError(f"zstd: {size} literals in one block at byte {at}")
    if kind == 2:
        weights, a = _huffman_weights(data, a, stop)
        fr.huf = _huffman_table(weights, at)
    elif fr.huf is None:
        raise ValueError(f"zstd: treeless literals without a previous "
                         f"Huffman table at byte {at}")
    out = bytearray()
    if streams == 1:
        _huffman_stream(data, a, stop, size, fr.huf, out)
    else:
        if a + 6 > stop:
            raise ValueError(f"zstd: literal jump table runs past the block "
                             f"at byte {a}")
        s1, s2, s3 = (int.from_bytes(data[a + 2 * i:a + 2 * i + 2],
                                     "little") for i in range(3))
        bounds = [a + 6, a + 6 + s1, a + 6 + s1 + s2,
                  a + 6 + s1 + s2 + s3, stop]
        if bounds[3] > stop:
            raise ValueError(f"zstd: literal jump table past the block at "
                             f"byte {a}")
        per = (size + 3) // 4
        if size < 3 * per:
            raise ValueError(f"zstd: {size} literals cannot fill 4 streams "
                             f"at byte {at}")
        for i in range(4):
            count = per if i < 3 else size - 3 * per
            _huffman_stream(data, bounds[i], bounds[i + 1], count, fr.huf,
                            out)
    return bytes(out), stop


def _sequence_tables(data, at, end, fr):
    """The compression modes byte and the three tables after it ->
    (literal length, offset, match length tables, byte after them)."""
    modes = data[at]
    if modes & 3:
        raise ValueError(f"zstd: reserved bits set in the sequence modes at "
                         f"byte {at}")
    a = at + 1
    out = []
    for kind, shift in (("literal lengths", 6), ("offsets", 4),
                        ("match lengths", 2)):
        mode = (modes >> shift) & 3
        _, max_symbol, max_log = _KINDS[kind]
        if mode == 0:
            table = _default_table(kind)
        elif mode == 1:
            if a >= end or data[a] > max_symbol:
                raise ValueError(f"zstd: bad RLE {kind} symbol at byte {a}")
            table = _rle_table(data[a])
            a += 1
        elif mode == 2:
            counts, log, a = _read_ncount(data, a, max_log, max_symbol)
            table = _fse_table(counts, log)
        else:
            table = fr.tables.get(kind)
            if table is None:
                raise ValueError(f"zstd: repeat mode for {kind} without a "
                                 f"previous table at byte {at}")
        fr.tables[kind] = table
        out.append(table)
    if a > end:
        raise ValueError(f"zstd: sequence tables run past the block at byte "
                         f"{at}")
    return out[0], out[1], out[2], a


def _sequences(data, at, end, lit, fr, nseq, tables):
    """Decode and execute ``nseq`` sequences of the bit stream
    ``data[at:end]`` with literals ``lit`` onto the frame's output, by the
    literal length, offset and match length ``tables``."""
    (ll_sym, ll_nb, ll_base, ll_log), (of_sym, of_nb, of_base, of_log), \
        (ml_sym, ml_nb, ml_base, ml_log) = tables
    stream = data[at:end]
    pos = _backward_start(stream, at)
    w = _windows(stream)

    def read(n):
        nonlocal pos
        pos -= n
        q = pos + 64
        return (w[q >> 3] >> (q & 7)) & ((1 << n) - 1)

    ll_state = read(ll_log)
    of_state = read(of_log)
    ml_state = read(ml_log)
    out = fr.out
    r0, r1, r2 = fr.rep
    lp = 0
    window = fr.window
    for i in range(nseq):
        of_code = of_sym[of_state]
        ll_code = ll_sym[ll_state]
        ml_code = ml_sym[ml_state]
        if of_code > 31:
            raise ValueError(f"zstd: offset code {of_code} at byte {at}")
        ov = (1 << of_code) + read(of_code) if of_code else 1
        ml = _ML_BASE[ml_code] + (read(_ML_BITS[ml_code])
                                  if _ML_BITS[ml_code] else 0)
        ll = _LL_BASE[ll_code] + (read(_LL_BITS[ll_code])
                                  if _LL_BITS[ll_code] else 0)
        if ov > 3:
            off = ov - 3
            r0, r1, r2 = off, r0, r1
        else:
            idx = ov - 1 + (ll == 0)
            if idx == 0:
                off = r0
            else:
                off = r0 - 1 if idx == 3 else (r1 if idx == 1 else r2)
                if off == 0:
                    raise ValueError(f"zstd: repeat offset 0 at byte {at}")
                if idx == 1:
                    r0, r1 = off, r0
                else:
                    r0, r1, r2 = off, r0, r1
        if i + 1 < nseq:
            ll_state = ll_base[ll_state] + read(ll_nb[ll_state])
            ml_state = ml_base[ml_state] + read(ml_nb[ml_state])
            of_state = of_base[of_state] + read(of_nb[of_state])
        if pos < 0:
            raise ValueError(f"zstd: sequence bit stream overrun at byte "
                             f"{at}")
        if ll:
            if lp + ll > len(lit):
                raise ValueError(f"zstd: sequence takes more literals than "
                                 f"the block has at byte {at}")
            out += lit[lp:lp + ll]
            lp += ll
        n = len(out)
        if off > n or off > window:
            raise ValueError(f"zstd: match offset {off} reaches before the "
                             f"frame's start or window at byte {at}")
        s = n - off
        if ml <= off:
            out += out[s:s + ml]
        else:
            piece = out[s:]
            out += (piece * (ml // off + 1))[:ml]
    if pos != 0:
        raise ValueError(f"zstd: sequence bit stream does not end on its "
                         f"last bit at byte {at}")
    fr.rep = [r0, r1, r2]
    out += lit[lp:]


def _compressed_block(data, at, end, fr):
    lit, a = _literals(data, at, end, fr)
    if a >= end:
        raise ValueError(f"zstd: block without its sequences section at "
                         f"byte {a}")
    b0 = data[a]
    if b0 < 128:
        nseq, a = b0, a + 1
    elif b0 < 255:
        nseq, a = ((b0 - 128) << 8) + data[a + 1], a + 2
    else:
        nseq, a = data[a + 1] + (data[a + 2] << 8) + 0x7F00, a + 3
    if nseq == 0:
        if a != end:
            raise ValueError(f"zstd: bytes after a block with no sequences "
                             f"at byte {a}")
        fr.out += lit
        return
    *tables, a = _sequence_tables(data, a, end, fr)
    _sequences(data, a, end, lit, fr, nseq, tables)


def _frame(data, at, out):
    """The frame whose header starts at ``data[at]`` (past the magic),
    appended to ``out``; returns the byte after the frame."""
    if at >= len(data):
        raise ValueError(f"zstd: truncated frame header at byte {at}")
    fhd = data[at]
    fcs_flag, single = fhd >> 6, (fhd >> 5) & 1
    if fhd & 8:
        raise ValueError(f"zstd: reserved bit set in the frame header at "
                         f"byte {at}")
    checksum, dict_flag = (fhd >> 2) & 1, fhd & 3
    a = at + 1
    window = None
    if not single:
        wd = data[a]
        base = 1 << (10 + (wd >> 3))
        window = base + (base >> 3) * (wd & 7)
        a += 1
    dsize = (0, 1, 2, 4)[dict_flag]
    dict_id = int.from_bytes(data[a:a + dsize], "little")
    if dict_id:
        raise ValueError(f"zstd: frame needs dictionary {dict_id}, which "
                         f"this decoder does not have (byte {a})")
    a += dsize
    fsize = (1 if single else 0, 2, 4, 8)[fcs_flag]
    content = None
    if fsize:
        content = int.from_bytes(data[a:a + fsize], "little")
        if fsize == 2:
            content += 256
        a += fsize
    if a > len(data):
        raise ValueError(f"zstd: truncated frame header at byte {at}")
    if single:
        window = content
    fr = _Frame(window)
    block_max = min(window, _BLOCK_MAX)
    while True:
        if a + 3 > len(data):
            raise ValueError(f"zstd: truncated block header at byte {a}")
        h = int.from_bytes(data[a:a + 3], "little")
        last, kind, size = h & 1, (h >> 1) & 3, h >> 3
        a += 3
        before = len(fr.out)
        if kind < 2 and size > block_max:
            raise ValueError(f"zstd: block of {size} bytes at byte {a - 3} "
                             f"past the block maximum {block_max}")
        if kind == 0:
            if a + size > len(data):
                raise ValueError(f"zstd: truncated raw block at byte {a}")
            fr.out += data[a:a + size]
            a += size
        elif kind == 1:
            if a >= len(data):
                raise ValueError(f"zstd: truncated RLE block at byte {a}")
            fr.out += bytes(data[a:a + 1]) * size
            a += 1
        elif kind == 2:
            if size > block_max or a + size > len(data):
                raise ValueError(f"zstd: compressed block of {size} bytes "
                                 f"at byte {a} (block maximum {block_max})")
            _compressed_block(data, a, a + size, fr)
            a += size
        else:
            raise ValueError(f"zstd: reserved block type at byte {a - 3}")
        if len(fr.out) - before > block_max:
            raise ValueError(f"zstd: block at byte {a} decodes past the "
                             f"block maximum {block_max}")
        if last:
            break
    if content is not None and len(fr.out) != content:
        raise ValueError(f"zstd: frame at byte {at} decodes to "
                         f"{len(fr.out)} bytes, its header says {content}")
    if checksum:
        if a + 4 > len(data):
            raise ValueError(f"zstd: truncated checksum at byte {a}")
        want = int.from_bytes(data[a:a + 4], "little")
        if xxh64(fr.out) & 0xFFFFFFFF != want:
            raise ValueError(f"zstd: content checksum mismatch at byte {a}")
        a += 4
    out += fr.out
    return a


def decompress(data) -> bytes:
    """The content of the zstd frames in ``data`` (bytes-like), one after
    another; skippable frames are skipped."""
    data = bytes(data)
    out = bytearray()
    at = 0
    while at < len(data):
        if at + 4 > len(data):
            raise ValueError(f"zstd: truncated magic number at byte {at}")
        magic = int.from_bytes(data[at:at + 4], "little")
        if magic >> 4 == _SKIPPABLE >> 4:
            if at + 8 > len(data):
                raise ValueError(f"zstd: truncated skippable frame at byte "
                                 f"{at}")
            at += 8 + int.from_bytes(data[at + 4:at + 8], "little")
            if at > len(data):
                raise ValueError(f"zstd: skippable frame runs past the "
                                 f"input at byte {at}")
            continue
        if magic != MAGIC:
            raise ValueError(f"zstd: bad magic number {magic:#010x} at byte "
                             f"{at}")
        at = _frame(data, at + 4, out)
    return bytes(out)
