"""Zstandard frames (RFC 8878) in plain Python and numpy.

* :func:`decompress`: every frame of a buffer, skippable frames skipped.
  Raw, RLE and compressed blocks; raw, RLE, Huffman and treeless literals in
  one or four streams; sequences in predefined, RLE, FSE and repeat modes;
  repeat offsets; the window descriptor and the single-segment flag; the
  content checksum (XXH64), checked when the frame has one.  A frame that
  needs a dictionary is refused.
* :func:`compress_raw`: one frame of raw blocks.  Any zstd decoder reads it
  (tensorstore's too), so no entropy coder is needed to write.

Huffman streams are decoded through lookup tables for every bit position at
once (numpy), then the chain of code starts is followed by pointer doubling:
the per-symbol work left in Python is one step every ``2**k`` symbols.
"""

from __future__ import annotations

import struct
from typing import List, Optional, Tuple

import numpy as np

MAGIC = 0xFD2FB528
_SKIPPABLE = 0x184D2A50  # ..0x184D2A5F
BLOCK_MAX = 1 << 17


class ZstdError(ValueError):
    """A buffer that is not a zstd frame this decoder reads."""


# ------------------------------------------------------------------ XXH64

_P1, _P2, _P3 = 11400714785074694791, 14029467366897019727, 1609587929392839161
_P4, _P5 = 9650029242287828579, 2870177450012600261
_M64 = (1 << 64) - 1


def _rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (64 - r))) & _M64


def _round(acc: int, lane: int) -> int:
    return _rotl((acc + lane * _P2) & _M64, 31) * _P1 & _M64


def xxh64(data: bytes, seed: int = 0) -> int:
    """XXH64 of ``data``."""
    n = len(data)
    p = 0
    if n >= 32:
        v1, v2, v3, v4 = (seed + _P1 + _P2) & _M64, (seed + _P2) & _M64, seed, (seed - _P1) & _M64
        stripes = n // 32
        lanes = np.frombuffer(data, "<u8", count=stripes * 4).tolist()
        for i in range(0, 4 * stripes, 4):
            v1 = _rotl((v1 + lanes[i] * _P2) & _M64, 31) * _P1 & _M64
            v2 = _rotl((v2 + lanes[i + 1] * _P2) & _M64, 31) * _P1 & _M64
            v3 = _rotl((v3 + lanes[i + 2] * _P2) & _M64, 31) * _P1 & _M64
            v4 = _rotl((v4 + lanes[i + 3] * _P2) & _M64, 31) * _P1 & _M64
        acc = (_rotl(v1, 1) + _rotl(v2, 7) + _rotl(v3, 12) + _rotl(v4, 18)) & _M64
        for lane in (v1, v2, v3, v4):
            acc = ((acc ^ _round(0, lane)) * _P1 + _P4) & _M64
        p = stripes * 32
    else:
        acc = (seed + _P5) & _M64
    acc = (acc + n) & _M64
    while p + 8 <= n:
        acc ^= _round(0, int.from_bytes(data[p:p + 8], "little"))
        acc = (_rotl(acc, 27) * _P1 + _P4) & _M64
        p += 8
    if p + 4 <= n:
        acc ^= int.from_bytes(data[p:p + 4], "little") * _P1 & _M64
        acc = (_rotl(acc, 23) * _P2 + _P3) & _M64
        p += 4
    while p < n:
        acc ^= data[p] * _P5 & _M64
        acc = _rotl(acc, 11) * _P1 & _M64
        p += 1
    acc ^= acc >> 33
    acc = acc * _P2 & _M64
    acc ^= acc >> 29
    acc = acc * _P3 & _M64
    return acc ^ (acc >> 32)


# ------------------------------------------------------------ bit readers


class _BackwardBits:
    """A backward bitstream (RFC 8878 4.1): read from the end, the last byte's
    highest set bit a marker.  ``pos`` counts the bits left; reading past the
    start yields zeros and takes ``pos`` below 0 (an overflow)."""

    def __init__(self, data: bytes):
        if not data or data[-1] == 0:
            raise ZstdError("a backward bitstream must end in a byte with its marker bit")
        self.value = int.from_bytes(data, "little")
        self.pos = (len(data) - 1) * 8 + data[-1].bit_length() - 1

    def read(self, n: int) -> int:
        if n == 0:
            return 0
        self.pos -= n
        p = self.pos
        if p >= 0:
            return (self.value >> p) & ((1 << n) - 1)
        return (self.value << -p) & ((1 << n) - 1)


# -------------------------------------------------------------------- FSE


def _read_ncount(data: bytes, start: int, max_symbol: int, max_log: int
                 ) -> Tuple[List[int], int, int]:
    """An FSE table description (RFC 8878 4.1.1) at ``data[start:]``:
    ``(normalized counts, accuracy log, bytes read)``."""
    window = data[start:start + 512]
    bits = int.from_bytes(window, "little")
    limit = len(window) * 8
    log = (bits & 15) + 5
    if log > max_log:
        raise ZstdError(f"FSE accuracy log {log} over the maximum {max_log}")
    p = 4
    remaining = (1 << log) + 1
    threshold = 1 << log
    nbits = log + 1
    norm: List[int] = []
    prev0 = False
    while remaining > 1:
        if prev0:
            while True:
                rep = (bits >> p) & 3
                p += 2
                norm.extend([0] * rep)
                if rep != 3:
                    break
        if len(norm) > max_symbol:
            raise ZstdError("FSE table description past the last symbol")
        mx = 2 * threshold - 1 - remaining
        low = (bits >> p) & (threshold - 1)
        if low < mx:
            count = low
            p += nbits - 1
        else:
            count = (bits >> p) & (2 * threshold - 1)
            if count >= threshold:
                count -= mx
            p += nbits
        count -= 1
        remaining -= abs(count)
        norm.append(count)
        prev0 = count == 0
        while remaining < threshold:
            nbits -= 1
            threshold >>= 1
        if p > limit:
            raise ZstdError("FSE table description runs past its block")
    if remaining != 1 or len(norm) > max_symbol + 1:
        raise ZstdError("corrupt FSE table description")
    return norm, log, (p + 7) // 8


def _fse_table(norm: List[int], log: int) -> Tuple[List[int], List[int], List[int]]:
    """The decoding table of normalized counts: per state ``(symbol, bits to
    read, baseline of the next state)``."""
    size = 1 << log
    sym = [0] * size
    high = size - 1
    nxt = [0] * len(norm)
    for s, c in enumerate(norm):
        if c == -1:
            sym[high] = s
            high -= 1
            nxt[s] = 1
        else:
            nxt[s] = c
    step = (size >> 1) + (size >> 3) + 3
    mask = size - 1
    pos = 0
    for s, c in enumerate(norm):
        for _ in range(max(c, 0)):
            sym[pos] = s
            pos = (pos + step) & mask
            while pos > high:
                pos = (pos + step) & mask
    if pos != 0:
        raise ZstdError("corrupt FSE table (spread does not close)")
    nbits = [0] * size
    base = [0] * size
    for u in range(size):
        s = sym[u]
        n = nxt[s]
        nxt[s] += 1
        nb = log - (n.bit_length() - 1)
        nbits[u] = nb
        base[u] = (n << nb) - size
    return sym, nbits, base


# literal length, match length and offset codes (RFC 8878 3.1.1.3.2.1)
_LL_BASE = list(range(16)) + [16, 18, 20, 22, 24, 28, 32, 40, 48, 64, 128, 256, 512, 1024,
                              2048, 4096, 8192, 16384, 32768, 65536]
_LL_BITS = [0] * 16 + [1, 1, 1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16]
_ML_BASE = list(range(3, 35)) + [35, 37, 39, 41, 43, 47, 51, 59, 67, 83, 99, 131, 259, 515,
                                 1027, 2051, 4099, 8195, 16387, 32771, 65539]
_ML_BITS = [0] * 32 + [1, 1, 1, 1, 2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16]
_LL_DEFAULT = ([4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2, 2, 2, 2, 2, 2, 2, 2, 3,
                2, 1, 1, 1, 1, 1, -1, -1, -1, -1], 6)
_ML_DEFAULT = ([1, 4, 3, 2, 2, 2, 2, 2, 2] + [1] * 37 + [-1] * 7, 6)
_OF_DEFAULT = ([1, 1, 1, 1, 1, 1, 2, 2, 2] + [1] * 15 + [-1] * 5, 5)
_MAX = {"ll": (35, 9), "of": (31, 8), "ml": (52, 9)}
_DEFAULT_TABLES = {"ll": _fse_table(*_LL_DEFAULT), "of": _fse_table(*_OF_DEFAULT),
                   "ml": _fse_table(*_ML_DEFAULT)}


# ---------------------------------------------------------------- Huffman


class _Huffman:
    """A literals Huffman table (RFC 8878 4.2): indexed by the next
    ``max_bits`` bits, the symbol and its code length."""

    def __init__(self, weights: List[int]):
        total = sum(1 << (w - 1) for w in weights if w > 0)
        if total == 0:
            raise ZstdError("Huffman weights all zero")
        max_bits = total.bit_length()
        rest = (1 << max_bits) - total
        if rest & (rest - 1):
            raise ZstdError("Huffman weights do not complete a power of two")
        weights = weights + [rest.bit_length()]
        if max_bits > 11:
            raise ZstdError(f"Huffman code length {max_bits} over 11")
        self.max_bits = max_bits
        size = 1 << max_bits
        sym = np.zeros(size, np.uint8)
        nb = np.zeros(size, np.int32)
        counts = [0] * (max_bits + 1)
        for w in weights:
            if w > max_bits:
                raise ZstdError("Huffman weight over the table's log")
            counts[w] += 1
        start = [0] * (max_bits + 2)
        nxt = 0
        for w in range(1, max_bits + 1):
            start[w] = nxt
            nxt += counts[w] << (w - 1)
        for s, w in enumerate(weights):
            if w == 0:
                continue
            length = 1 << (w - 1)
            sym[start[w]:start[w] + length] = s
            nb[start[w]:start[w] + length] = max_bits + 1 - w
            start[w] += length
        self.sym, self.nb = sym, nb

    def decode_stream(self, data: bytes, count: int) -> np.ndarray:
        """``count`` literals of one backward stream."""
        if count == 0:
            return np.zeros(0, np.uint8)
        if not data or data[-1] == 0:
            raise ZstdError("a Huffman stream must end in a byte with its marker bit")
        L = self.max_bits
        start = (len(data) - 1) * 8 + data[-1].bit_length() - 1  # bits of data
        # the stream shifted up by L zero bits: window(pos) = its bits [pos, pos + L)
        shifted = (int.from_bytes(data, "little") << L).to_bytes(len(data) + 3, "little")
        y = np.frombuffer(shifted, np.uint8).astype(np.int32)
        w24 = y[:-2] | (y[1:-1] << 8) | (y[2:] << 16)
        win = np.empty((len(w24), 8), np.int32)
        for r in range(8):
            win[:, r] = w24 >> r
        win = win.reshape(-1)[:start + 1] & ((1 << L) - 1)
        nb = np.take(self.nb, win)
        nxt = np.arange(start + 1, dtype=np.int32) - nb
        np.maximum(nxt, 0, out=nxt)
        path = _follow(nxt, start, count)
        if path[-1] - nb[path[-1]] != 0 or path.min() <= 0:
            raise ZstdError("a Huffman stream does not end where its literals do")
        return np.take(self.sym, np.take(win, path))


def _follow(nxt: np.ndarray, start: int, count: int) -> np.ndarray:
    """``start, nxt[start], nxt[nxt[start]], ...``, ``count`` long: jumps of
    ``2**k`` by pointer doubling, then the steps between them at once."""
    k = max(0, min(4, (count.bit_length() - 1) // 2 - 1))
    jump = nxt
    for _ in range(k):
        jump = np.take(jump, jump)
    stride = 1 << k
    rows = -(-count // stride)
    heads = [start]
    p = start
    for _ in range(rows - 1):
        p = int(jump[p])
        heads.append(p)
    cur = np.asarray(heads, np.int32)
    out = np.empty((rows, stride), np.int32)
    for s in range(stride):
        out[:, s] = cur
        cur = np.take(nxt, cur)
    return out.reshape(-1)[:count]


def _read_huffman(data: bytes, p: int) -> Tuple[_Huffman, int]:
    """The Huffman tree description at ``data[p]``: ``(table, bytes read)``."""
    hb = data[p]
    if hb >= 128:
        n = hb - 127
        raw = data[p + 1:p + 1 + (n + 1) // 2]
        weights = []
        for b in raw:
            weights += [b >> 4, b & 15]
        return _Huffman(weights[:n]), 1 + (n + 1) // 2
    norm, log, used = _read_ncount(data[p + 1:p + 1 + hb], 0, 255, 6)
    sym, nbits, base = _fse_table(norm, log)
    bits = _BackwardBits(data[p + 1 + used:p + 1 + hb])
    s1 = bits.read(log)
    s2 = bits.read(log)
    weights: List[int] = []
    while True:
        weights.append(sym[s1])
        s1 = base[s1] + bits.read(nbits[s1])
        if bits.pos < 0:
            weights.append(sym[s2])
            break
        weights.append(sym[s2])
        s2 = base[s2] + bits.read(nbits[s2])
        if bits.pos < 0:
            weights.append(sym[s1])
            break
        if len(weights) > 255:
            raise ZstdError("too many Huffman weights")
    return _Huffman(weights), 1 + hb


# ------------------------------------------------------------------ frames


class _Frame:
    """Decoding state that blocks of one frame share."""

    def __init__(self):
        self.out = bytearray()
        self.huffman: Optional[_Huffman] = None
        self.tables = {"ll": None, "of": None, "ml": None}
        self.reps = [1, 4, 8]

    def literals(self, block: bytes) -> Tuple[bytes, int]:
        b0 = block[0]
        kind, fmt = b0 & 3, (b0 >> 2) & 3
        if kind in (0, 1):  # raw, RLE
            if fmt in (0, 2):
                size, p = b0 >> 3, 1
            elif fmt == 1:
                size, p = (b0 >> 4) + (block[1] << 4), 2
            else:
                size, p = (b0 >> 4) + (block[1] << 4) + (block[2] << 12), 3
            if kind == 0:
                if p + size > len(block):
                    raise ZstdError("raw literals run past their block")
                return bytes(block[p:p + size]), p + size
            return bytes(block[p:p + 1]) * size, p + 1
        streams = 1 if fmt == 0 else 4
        hlen, bits = {0: (3, 10), 1: (3, 10), 2: (4, 14), 3: (5, 18)}[fmt]
        h = int.from_bytes(block[:hlen], "little") >> 4
        regen, comp = h & ((1 << bits) - 1), h >> bits
        p = hlen
        end = p + comp
        if end > len(block):
            raise ZstdError("compressed literals run past their block")
        if kind == 2:
            self.huffman, used = _read_huffman(block, p)
            p += used
        elif self.huffman is None:
            raise ZstdError("treeless literals with no earlier Huffman table")
        huf = self.huffman
        if streams == 1:
            lits = huf.decode_stream(bytes(block[p:end]), regen)
        else:
            s1, s2, s3 = struct.unpack_from("<3H", block, p)
            p += 6
            each = (regen + 3) // 4
            bounds = [p, p + s1, p + s1 + s2, p + s1 + s2 + s3, end]
            if bounds[3] > end:
                raise ZstdError("corrupt literals jump table")
            sizes = [each, each, each, regen - 3 * each]
            lits = np.concatenate([huf.decode_stream(bytes(block[bounds[i]:bounds[i + 1]]),
                                                     sizes[i]) for i in range(4)])
        return lits.tobytes(), end

    def table(self, name: str, mode: int, block: bytes, p: int):
        max_symbol, max_log = _MAX[name]
        if mode == 0:
            t = _DEFAULT_TABLES[name]
        elif mode == 1:
            t = [block[p]], [0], [0]  # RLE: one symbol, no bits
            p += 1
        elif mode == 2:
            norm, log, used = _read_ncount(block, p, max_symbol, max_log)
            t = _fse_table(norm, log)
            p += used
        else:
            t = self.tables[name]
            if t is None:
                raise ZstdError(f"repeat mode for the {name} table with no earlier table")
        self.tables[name] = t
        return t, p

    def block(self, block: bytes) -> None:
        lits, p = self.literals(block)
        b0 = block[p]
        if b0 == 0:
            if p + 1 != len(block):
                raise ZstdError("bytes after a block with no sequences")
            self.out += lits
            return
        if b0 < 128:
            nseq, p = b0, p + 1
        elif b0 < 255:
            nseq, p = ((b0 - 128) << 8) + block[p + 1], p + 2
        else:
            nseq, p = block[p + 1] + (block[p + 2] << 8) + 0x7F00, p + 3
        modes = block[p]
        p += 1
        if modes & 3:
            raise ZstdError("reserved bits set in the sequence modes")
        ll, p = self.table("ll", modes >> 6, block, p)
        of, p = self.table("of", (modes >> 4) & 3, block, p)
        ml, p = self.table("ml", (modes >> 2) & 3, block, p)
        self._sequences(lits, bytes(block[p:]), nseq, ll, of, ml)

    def _sequences(self, lits: bytes, stream: bytes, nseq: int, ll, of, ml) -> None:
        bits = _BackwardBits(stream)
        read = bits.read
        ll_sym, ll_nb, ll_base = ll
        of_sym, of_nb, of_base = of
        ml_sym, ml_nb, ml_base = ml
        ll_state = read(len(ll_sym).bit_length() - 1)
        of_state = read(len(of_sym).bit_length() - 1)
        ml_state = read(len(ml_sym).bit_length() - 1)
        out = self.out
        reps = self.reps
        lp = 0
        for i in range(nseq):
            of_code = of_sym[of_state]
            ml_code = ml_sym[ml_state]
            ll_code = ll_sym[ll_state]
            if of_code > 31:
                raise ZstdError(f"offset code {of_code}")
            offset_value = (1 << of_code) + read(of_code)
            match = _ML_BASE[ml_code] + read(_ML_BITS[ml_code])
            litlen = _LL_BASE[ll_code] + read(_LL_BITS[ll_code])
            if offset_value > 3:
                offset = offset_value - 3
                reps[2], reps[1], reps[0] = reps[1], reps[0], offset
            else:
                idx = offset_value - 1 + (litlen == 0)
                if idx == 0:
                    offset = reps[0]
                else:
                    offset = reps[0] - 1 if idx == 3 else reps[idx]
                    if idx > 1:
                        reps[2] = reps[1]
                    reps[1] = reps[0]
                    reps[0] = offset
            if i + 1 < nseq:
                ll_state = ll_base[ll_state] + read(ll_nb[ll_state])
                ml_state = ml_base[ml_state] + read(ml_nb[ml_state])
                of_state = of_base[of_state] + read(of_nb[of_state])
            if lp + litlen > len(lits):
                raise ZstdError("a sequence takes more literals than the block has")
            out += lits[lp:lp + litlen]
            lp += litlen
            if offset == 0 or offset > len(out):
                raise ZstdError(f"match offset {offset} before the start of the output")
            begin = len(out) - offset
            if offset >= match:
                out += out[begin:begin + match]
            else:
                chunk = bytes(out[begin:])
                out += (chunk * (match // offset + 1))[:match]
        if bits.pos != 0:
            raise ZstdError("a sequence bitstream does not end where its sequences do")
        out += lits[lp:]


def _frame(data: bytes, p: int) -> Tuple[bytes, int]:
    fhd = data[p]
    p += 1
    fcs_flag, single, checksum, dict_flag = fhd >> 6, (fhd >> 5) & 1, (fhd >> 2) & 1, fhd & 3
    if fhd & 8:
        raise ZstdError("reserved bit set in the frame header")
    if not single:
        p += 1  # window descriptor: the decoder keeps the whole frame
    dict_len = (0, 1, 2, 4)[dict_flag]
    dict_id = int.from_bytes(data[p:p + dict_len], "little")
    p += dict_len
    if dict_id:
        raise ZstdError(f"the frame needs dictionary {dict_id}: dictionaries are not read")
    fcs_len = (1 if single else 0, 2, 4, 8)[fcs_flag]
    content_size = int.from_bytes(data[p:p + fcs_len], "little") if fcs_len else None
    if fcs_len == 2:
        content_size += 256
    p += fcs_len
    frame = _Frame()
    while True:
        if p + 3 > len(data):
            raise ZstdError("truncated block header")
        h = int.from_bytes(data[p:p + 3], "little")
        p += 3
        last, kind, size = h & 1, (h >> 1) & 3, h >> 3
        if kind == 0:
            if p + size > len(data):
                raise ZstdError("truncated raw block")
            frame.out += data[p:p + size]
            p += size
        elif kind == 1:
            frame.out += data[p:p + 1] * size
            p += 1
        elif kind == 2:
            if size > BLOCK_MAX or p + size > len(data):
                raise ZstdError("compressed block too large or truncated")
            frame.block(memoryview(data)[p:p + size])
            p += size
        else:
            raise ZstdError("reserved block type")
        if last:
            break
    out = bytes(frame.out)
    if content_size is not None and len(out) != content_size:
        raise ZstdError(f"frame content {len(out)} bytes, its header says {content_size}")
    if checksum:
        want = int.from_bytes(data[p:p + 4], "little")
        p += 4
        if xxh64(out) & 0xFFFFFFFF != want:
            raise ZstdError("frame content checksum mismatch")
    return out, p


def decompress(data: bytes) -> bytes:
    """The content of every zstd frame in ``data``, concatenated."""
    data = bytes(data)
    parts = []
    p = 0
    if not data:
        raise ZstdError("empty input")
    while p < len(data):
        magic = int.from_bytes(data[p:p + 4], "little")
        if magic & 0xFFFFFFF0 == _SKIPPABLE:
            p += 8 + int.from_bytes(data[p + 4:p + 8], "little")
            continue
        if magic != MAGIC:
            raise ZstdError(f"not a zstd frame (magic {magic:#010x})")
        out, p = _frame(data, p + 4)
        parts.append(out)
    return b"".join(parts)


def compress_raw(data: bytes) -> bytes:
    """One single-segment frame of ``data`` in raw blocks (no checksum)."""
    data = bytes(data)
    n = len(data)
    if n < 256:
        fcs_flag, fcs = 0, n.to_bytes(1, "little")
    elif n < 65536 + 256:
        fcs_flag, fcs = 1, (n - 256).to_bytes(2, "little")
    elif n < 1 << 32:
        fcs_flag, fcs = 2, n.to_bytes(4, "little")
    else:
        fcs_flag, fcs = 3, n.to_bytes(8, "little")
    parts = [struct.pack("<I", MAGIC), bytes([(fcs_flag << 6) | 0x20]), fcs]
    p = 0
    while True:
        size = min(BLOCK_MAX, n - p)
        last = p + size >= n
        parts.append(((size << 3) | int(last)).to_bytes(3, "little"))
        parts.append(data[p:p + size])
        p += size
        if last:
            return b"".join(parts)
