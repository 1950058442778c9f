"""Image file formats from the standard library: PNG (write and read), GIF,
mp4 through an ``ffmpeg`` found on ``PATH``, and PDF.

* :func:`write_png`: 8-bit RGB, the ``Up`` filter on every row,
  ``zlib.compress``, CRCs from ``zlib.crc32``.
* :func:`read_png`: bit depth 8, colour types 0, 2, 4 and 6, filters 0-4, no
  interlace: the port's own PNGs and matplotlib's RGBA ones.
* :func:`write_gif`: LZW with a palette of the frames' most frequent
  colours (255 and a transparent slot), looped; a frame after the first holds
  only the box of pixels that changed, the unchanged ones transparent, and a
  frame equal to the one before lengthens it instead (as Pillow writes a GIF).
* :func:`write_mp4`: raw RGB frames piped into ``ffmpeg`` (H.264, yuv420p).
* :func:`write_pdf`: a page per image, the image a FlateDecode RGB stream
  under a title, with a correct ``xref`` table.
"""

from __future__ import annotations

import os
import shutil
import struct
import subprocess
import zlib
from typing import Iterable, List, Sequence, Tuple

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}  # PNG colour type -> samples a pixel


# -------------------------------------------------------------------- PNG


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def png_bytes(img: np.ndarray) -> bytes:
    """An RGB ``uint8`` image ``[H, W, 3]`` as PNG."""
    img = np.ascontiguousarray(img, dtype=np.uint8)
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"want an RGB image [H, W, 3], got {img.shape}")
    H, W, _ = img.shape
    rows = img.reshape(H, W * 3)
    filtered = np.empty((H, W * 3 + 1), np.uint8)
    filtered[:, 0] = 2  # Up: each byte less the one above it
    filtered[0, 1:] = rows[0]
    filtered[1:, 1:] = rows[1:] - rows[:-1]  # uint8 wraps modulo 256
    header = struct.pack(">IIBBBBB", W, H, 8, 2, 0, 0, 0)
    return (PNG_SIGNATURE + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(filtered.tobytes(), 6)) + _chunk(b"IEND", b""))


def write_png(path: str, img: np.ndarray) -> str:
    with open(path, "wb") as f:
        f.write(png_bytes(img))
    return path


def _unfilter_sequential(kind: int, line: bytearray, prev: bytes, bpp: int) -> bytearray:
    """Average (3) and Paeth (4), which depend on the byte to the left."""
    out = bytearray(len(line))
    for i, v in enumerate(line):
        a = out[i - bpp] if i >= bpp else 0
        b = prev[i]
        if kind == 3:
            out[i] = (v + ((a + b) >> 1)) & 0xFF
        else:
            c = prev[i - bpp] if i >= bpp else 0
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
            out[i] = (v + pred) & 0xFF
    return out


def read_png(source) -> np.ndarray:
    """A PNG (a path or its bytes) as ``uint8 [H, W, C]``, C the colour type's
    samples (1 grey, 2 grey-alpha, 3 RGB, 4 RGBA)."""
    if isinstance(source, (bytes, bytearray)):
        data = bytes(source)
    else:
        with open(source, "rb") as f:
            data = f.read()
    if data[:8] != PNG_SIGNATURE:
        raise ValueError("not a PNG file")
    pos, idat, header = 8, [], None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        if zlib.crc32(kind + body) & 0xFFFFFFFF != crc:
            raise ValueError(f"PNG chunk {kind!r}: bad CRC")
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
        pos += 12 + n
    if header is None:
        raise ValueError("PNG without IHDR")
    W, H, depth, ctype, _, _, interlace = header
    if depth != 8 or ctype not in _CHANNELS or interlace:
        raise ValueError(f"unsupported PNG: bit depth {depth}, colour type {ctype}, "
                         f"interlace {interlace}")
    C = _CHANNELS[ctype]
    stride = W * C
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8).reshape(H, stride + 1)
    if (raw[:, 0] == 2).all():  # Up on every row (this module's writer): a running sum
        return np.cumsum(raw[:, 1:], axis=0, dtype=np.uint8).reshape(H, W, C)
    out = np.zeros((H, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(H):
        kind, line = int(raw[y, 0]), raw[y, 1:]
        if kind == 0:
            cur = line
        elif kind == 1:
            cur = np.cumsum(line.reshape(W, C), axis=0, dtype=np.uint8).reshape(stride)
        elif kind == 2:
            cur = line + prev
        elif kind in (3, 4):
            cur = np.frombuffer(_unfilter_sequential(kind, bytearray(line.tobytes()),
                                                     prev.tobytes(), C), np.uint8)
        else:
            raise ValueError(f"PNG row {y}: unknown filter {kind}")
        out[y] = cur
        prev = out[y]
    return out.reshape(H, W, C)


def as_rgb(img: np.ndarray) -> np.ndarray:
    """A decoded PNG as RGB ``uint8``: grey spread, alpha composited on white."""
    C = img.shape[2]
    color = img[..., :3] if C >= 3 else np.repeat(img[..., :1], 3, axis=2)
    if C in (2, 4):
        a = img[..., -1:].astype(np.float64) / 255.0
        color = (color * a + 255.0 * (1.0 - a) + 0.5).astype(np.uint8)
    return np.ascontiguousarray(color)


# -------------------------------------------------------------------- GIF


RUN_BREAK = 8


def _lzw(pixels: np.ndarray, min_size: int = 8) -> bytes:
    """GIF's variable-width LZW of a stream of indices < 2**min_size.

    A run of one index is consumed a dictionary string at a time: the codes
    of the strings ``vv, vvv, ...`` are kept per index, so a long run costs one
    step per code sent, not one per pixel.  Before a run of ``RUN_BREAK`` or
    more pixels the current string is sent as it is, so that the run starts a
    string of its own (LZW need not be greedy: the entry added is still the
    decoder's, sent string + next pixel, a second code for it if it exists).
    The codes are packed into bits afterwards, in numpy."""
    clear, eoi = 1 << min_size, (1 << min_size) + 1
    flat = np.asarray(pixels, np.uint8).ravel()
    if flat.size == 0:
        raise ValueError("empty frame")
    change = np.flatnonzero(flat[1:] != flat[:-1]) + 1
    values = flat[np.concatenate([[0], change])].tolist()
    lengths = np.diff(np.concatenate([[0], change, [flat.size]])).tolist()

    width = min_size + 1
    shift, limit, free = width << 12, 1 << width, eoi + 1
    codes = [clear | shift]  # code | width << 12, in the order sent
    emit = codes.append
    table: dict = {}
    get = table.get
    runs: List[List[int]] = [[] for _ in range(clear)]  # runs[v][j]: code of v^(j + 2)
    w, w_val, w_len = values[0], values[0], 1  # the current string: code, pure value, length
    lengths[0] -= 1
    for v, n in zip(values, lengths):
        # before a long run the current string is sent as it is (no lookup)
        send = n >= RUN_BREAK and w_val != v
        while n:
            if w_val == v:  # a pure run of v continues: take the longest string known
                r = runs[v]
                take = len(r) + 1 - w_len
                if take > n:
                    take = n
                if take > 0:
                    w_len += take
                    n -= take
                    w = r[w_len - 2]
                    continue
            key = (w << 8) | v
            code = None if send else get(key)
            send = False
            if code is not None:
                w, w_val, w_len = code, -1, w_len + 1
                n -= 1
                continue
            emit(w | shift)
            if free < 4095:
                table[key] = free  # the decoder's entry (a second code for it if sent early)
                if w_val == v:  # w was the longest pure run of v: this is the next one
                    runs[v].append(free)
                free += 1
                if free > limit and width < 12:
                    width += 1
                    shift, limit = width << 12, limit << 1
            else:  # the table is full: start again
                emit(clear | shift)
                table.clear()
                runs = [[] for _ in range(clear)]
                width = min_size + 1
                shift, limit, free = width << 12, 1 << width, eoi + 1
            w, w_val, w_len = v, v, 1
            n -= 1
    emit(w | shift)
    emit(eoi | shift)
    packed = np.array(codes, np.int64)
    bits = (packed[:, None] >> np.arange(12)) & 1
    keep = np.arange(12) < (packed >> 12)[:, None]
    return np.packbits(bits[keep].astype(np.uint8), bitorder="little").tobytes()


def _sub_blocks(data: bytes) -> bytes:
    return b"".join(bytes([len(data[i:i + 255])]) + data[i:i + 255]
                    for i in range(0, len(data), 255)) + b"\x00"


def _pack(img: np.ndarray) -> np.ndarray:
    img = img.astype(np.int64)
    return (img[..., 0] << 16) | (img[..., 1] << 8) | img[..., 2]


def _cell(img: np.ndarray) -> np.ndarray:
    """The 15-bit colour cell of each pixel (5 bits a channel)."""
    r, g, b = (img[..., i].astype(np.int32) >> 3 for i in range(3))
    return (r << 10) | (g << 5) | b


def gif_palette(frames: Sequence[np.ndarray], size: int = 255) -> np.ndarray:
    """The ``size`` most frequent colours of a few evenly spaced frames, most
    frequent first (255: the 256th index is the transparent one)."""
    picks = sorted({int(round(j)) for j in np.linspace(0, len(frames) - 1,
                                                       min(len(frames), 8))})
    packed = np.concatenate([_pack(frames[i]).ravel() for i in picks])
    colours, counts = np.unique(packed, return_counts=True)
    top = colours[np.argsort(-counts, kind="stable")[:size]]
    pal = np.stack([(top >> 16) & 255, (top >> 8) & 255, top & 255], axis=1).astype(np.uint8)
    if len(pal) < size:
        pal = np.concatenate([pal, np.zeros((size - len(pal), 3), np.uint8)])
    return pal


class _Indexer:
    """RGB pixels to palette indices through their 15-bit cell: a cell that
    holds a palette colour maps to it (the most frequent one), any other cell
    to the palette colour nearest its centre, worked out the first time the
    cell is met."""

    def __init__(self, pal: np.ndarray):
        self.pal = pal.astype(np.int64)
        self.lut = np.full(1 << 15, -1, np.int16)
        cells = _cell(pal)
        self.lut[cells[::-1]] = np.arange(len(pal))[::-1]

    def __call__(self, img: np.ndarray) -> np.ndarray:
        cells = _cell(img)
        idx = self.lut[cells]
        missing = np.unique(cells[idx < 0])
        if missing.size:
            centres = np.stack([(missing >> 10) & 31, (missing >> 5) & 31, missing & 31],
                               axis=1) * 8 + 4
            d = ((centres[:, None, :] - self.pal[None, :, :]) ** 2).sum(-1)
            self.lut[missing] = np.argmin(d, axis=1)
            idx = self.lut[cells]
        return idx.astype(np.uint8)


def write_gif(path: str, frames: Sequence[np.ndarray], fps: float) -> int:
    """Write RGB ``uint8`` frames as a looping GIF; returns the frames written
    (a frame equal to the one before lengthens it instead)."""
    if not len(frames):
        raise ValueError("no frames")
    H, W, _ = frames[0].shape
    pal = gif_palette(frames)
    index = _Indexer(pal)
    transparent = 255
    delay = max(1, int(round(100.0 / fps)))
    parts = [b"GIF89a", struct.pack("<HHBBB", W, H, 0xF7, 0, 0),
             np.concatenate([pal, np.zeros((1, 3), np.uint8)]).tobytes(),
             b"\x21\xff\x0bNETSCAPE2.0\x03\x01\x00\x00\x00"]
    encoded: List[list] = []  # [delay, GCE flags, the frame's blocks]
    prev_rgb = prev = None
    for frame in frames:
        if prev is None:
            idx = index(frame)
            box, data, flags = (0, 0, W, H), idx, 0x04  # do not dispose
        else:
            ne = frame != prev_rgb
            moved = ne[..., 0] | ne[..., 1] | ne[..., 2]
            idx = prev.copy()
            idx[moved] = index(frame[moved])
            diff = idx != prev
            at = np.flatnonzero(diff)
            if at.size == 0:
                encoded[-1][0] += delay
                prev_rgb = frame
                continue
            rows, cols = at // W, at % W
            r0, r1, c0, c1 = rows.min(), rows.max() + 1, cols.min(), cols.max() + 1
            box = (int(c0), int(r0), int(c1 - c0), int(r1 - r0))
            data = np.where(diff[r0:r1, c0:c1], idx[r0:r1, c0:c1], transparent)
            flags = 0x05  # do not dispose, transparent index
        prev_rgb, prev = frame, idx
        encoded.append([delay, flags, b"\x2c" + struct.pack("<HHHHB", *box, 0) + b"\x08"
                        + _sub_blocks(_lzw(data))])
    for d, flags, blocks in encoded:
        parts.append(b"\x21\xf9\x04" + struct.pack("<BHB", flags, d, transparent) + b"\x00")
        parts.append(blocks)
    parts.append(b"\x3b")
    with open(path, "wb") as f:
        f.write(b"".join(parts))
    return len(encoded)


# -------------------------------------------------------------------- mp4


def write_mp4(path: str, frames: Iterable[np.ndarray], size: Tuple[int, int],
              fps: float) -> None:
    """Pipe raw RGB frames of ``size = (W, H)`` into ``ffmpeg``; raises
    ``FileNotFoundError`` without one on ``PATH`` and ``RuntimeError`` when it
    fails (a partial file removed)."""
    exe = shutil.which("ffmpeg")
    if exe is None:
        raise FileNotFoundError("no ffmpeg on PATH")
    W, H = size
    cmd = [exe, "-y", "-loglevel", "error", "-f", "rawvideo", "-pix_fmt", "rgb24",
           "-s", f"{W}x{H}", "-r", str(fps), "-i", "-", "-vcodec", "h264",
           "-pix_fmt", "yuv420p", path]
    proc = subprocess.Popen(cmd, stdin=subprocess.PIPE, stdout=subprocess.DEVNULL,
                            stderr=subprocess.PIPE)
    try:
        for frame in frames:
            proc.stdin.write(np.ascontiguousarray(frame, np.uint8).tobytes())
        proc.stdin.close()
    except BrokenPipeError:
        pass
    err = proc.stderr.read()
    proc.stderr.close()
    if proc.wait() != 0:
        if os.path.exists(path):
            os.remove(path)
        raise RuntimeError(f"ffmpeg failed: {err.decode(errors='replace')[-500:]}")


# -------------------------------------------------------------------- PDF


def _pdf_text(s: str) -> str:
    s = "".join(c if " " <= c <= "~" else "-" for c in s)
    return s.replace("\\", "\\\\").replace("(", "\\(").replace(")", "\\)")


def pdf_bytes(pages: Sequence[Tuple[str, np.ndarray]]) -> bytes:
    """One 8-inch square page (the JAX package's ``figsize=(8, 8)``) per
    ``(title, RGB image)``: the title in Helvetica at the top, the image fitted
    below it."""
    side = 8.0 * 72.0
    objects: List[bytes] = []  # object i + 1

    def new(body: bytes) -> int:
        objects.append(body)
        return len(objects)

    catalog = new(b"")  # filled once the page tree exists
    tree = new(b"")
    font = new(b"<< /Type /Font /Subtype /Type1 /BaseFont /Helvetica >>")
    kids = []
    for title, img in pages:
        img = np.ascontiguousarray(img, np.uint8)
        H, W, _ = img.shape
        data = zlib.compress(img.tobytes(), 6)
        image = new(b"<< /Type /XObject /Subtype /Image /Width %d /Height %d /ColorSpace "
                    b"/DeviceRGB /BitsPerComponent 8 /Filter /FlateDecode /Length %d >>\n"
                    b"stream\n" % (W, H, len(data)) + data + b"\nendstream")
        box = side - 2 * 36.0
        scale = min(box / W, (box - 24.0) / H)
        w, h = W * scale, H * scale
        x, y = (side - w) / 2, 36.0 + (box - 24.0 - h) / 2
        content = (f"q {w:.3f} 0 0 {h:.3f} {x:.3f} {y:.3f} cm /Im0 Do Q\n"
                   f"BT /F1 12 Tf 36 {side - 36 - 12:.3f} Td ({_pdf_text(title)}) Tj ET\n"
                   ).encode()
        stream = new(b"<< /Length %d >>\nstream\n" % len(content) + content + b"\nendstream")
        kids.append(new(b"<< /Type /Page /Parent %d 0 R /MediaBox [0 0 %.3f %.3f] "
                        b"/Resources << /XObject << /Im0 %d 0 R >> /Font << /F1 %d 0 R >> >> "
                        b"/Contents %d 0 R >>" % (tree, side, side, image, font, stream)))
    objects[catalog - 1] = b"<< /Type /Catalog /Pages %d 0 R >>" % tree
    objects[tree - 1] = (b"<< /Type /Pages /Kids [%s] /Count %d >>"
                         % (b" ".join(b"%d 0 R" % k for k in kids), len(kids)))
    out = bytearray(b"%PDF-1.4\n%\xe2\xe3\xcf\xd3\n")
    offsets = []
    for i, body in enumerate(objects, start=1):
        offsets.append(len(out))
        out += b"%d 0 obj\n" % i + body + b"\nendobj\n"
    xref = len(out)
    out += b"xref\n0 %d\n0000000000 65535 f \n" % (len(objects) + 1)
    out += b"".join(b"%010d 00000 n \n" % o for o in offsets)
    out += (b"trailer\n<< /Size %d /Root %d 0 R >>\nstartxref\n%d\n%%%%EOF\n"
            % (len(objects) + 1, catalog, xref))
    return bytes(out)


def write_pdf(path: str, pages: Sequence[Tuple[str, np.ndarray]]) -> str:
    with open(path, "wb") as f:
        f.write(pdf_bytes(pages))
    return path
