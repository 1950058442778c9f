"""CRC-32C (Castagnoli, reflected polynomial 0x82F63B78), table-driven: the
checksum that closes every OCDBT manifest and B-tree node file."""

from __future__ import annotations

_POLY = 0x82F63B78


def _table():
    table = []
    for n in range(256):
        c = n
        for _ in range(8):
            c = (c >> 1) ^ _POLY if c & 1 else c >> 1
        table.append(c)
    return table


_TABLE = _table()


def crc32c(data: bytes, crc: int = 0) -> int:
    """CRC-32C of ``data``, continuing from ``crc`` (0 to start)."""
    t = _TABLE
    c = crc ^ 0xFFFFFFFF
    for b in bytes(data):
        c = t[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF
