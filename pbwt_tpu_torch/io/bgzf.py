"""Minimal BGZF (blocked gzip) writer.

BGZF is the block-compressed gzip variant used by htslib for .vcf.gz/.bcf:
a sequence of <=64KB gzip members, each carrying a BC extra subfield with
the compressed block size, terminated by a fixed 28-byte empty EOF block.
Reading is handled by Python's gzip module (multi-member capable).
"""

from __future__ import annotations

import struct
import zlib

MAX_BLOCK = 0xFF00  # uncompressed payload per block (htslib uses 0xff00)

BGZF_EOF = bytes([
    0x1f, 0x8b, 0x08, 0x04, 0x00, 0x00, 0x00, 0x00, 0x00, 0xff,
    0x06, 0x00, 0x42, 0x43, 0x02, 0x00, 0x1b, 0x00, 0x03, 0x00,
    0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00, 0x00])


def compress_block(data: bytes, level: int = 6) -> bytes:
    co = zlib.compressobj(level, zlib.DEFLATED, -15)
    payload = co.compress(data) + co.flush()
    bsize = len(payload) + 25 + 1  # header(18) + payload + crc(4) + isize(4) - 1
    header = struct.pack("<BBBBIBBHBBHH",
                         0x1f, 0x8b, 8, 4,    # magic, CM=deflate, FLG=FEXTRA
                         0,                   # MTIME
                         0, 0xff,             # XFL, OS=unknown
                         6,                   # XLEN
                         66, 67, 2,           # 'B','C', SLEN=2
                         bsize)               # BSIZE = total block size - 1
    footer = struct.pack("<II", zlib.crc32(data) & 0xFFFFFFFF, len(data))
    return header + payload + footer


class BgzfWriter:
    def __init__(self, fileobj, level: int = 6):
        self._fp = fileobj
        self._level = level
        self._buf = bytearray()

    def write(self, data: bytes) -> None:
        self._buf += data
        while len(self._buf) >= MAX_BLOCK:
            chunk = bytes(self._buf[:MAX_BLOCK])
            del self._buf[:MAX_BLOCK]
            self._fp.write(compress_block(chunk, self._level))

    def close(self) -> None:
        if self._buf:
            self._fp.write(compress_block(bytes(self._buf), self._level))
            self._buf.clear()
        self._fp.write(BGZF_EOF)
        self._fp.flush()
        if self._fp not in (None,) and hasattr(self._fp, "name"):
            try:
                import sys
                if self._fp is not sys.stdout.buffer:
                    self._fp.close()
            except Exception:
                pass
