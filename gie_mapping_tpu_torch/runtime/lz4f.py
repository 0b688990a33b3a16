"""Pure-python LZ4 frame codec (decompress + spec-conformant compress).

A copy of gie_mapping_tpu/runtime/lz4f.py for the PyTorch port.

rosbag v1 chunks may be lz4-compressed (roslz4 writes LZ4 frame format
v1.x); this environment has no `lz4` wheel, so the reader implements the
published LZ4 specs directly:

* Frame format (github.com/lz4/lz4/blob/dev/doc/lz4_Frame_format.md):
  magic 0x184D2204, FLG/BD descriptor (+optional content size, dict id),
  header checksum byte, data blocks (u32 size, high bit = "stored
  uncompressed"), end mark 0, optional xxHash32 content checksum.
* Block format (lz4_Block_format.md): sequences of
  [token][literal-length ext][literals][2-byte LE match offset]
  [match-length ext], last sequence literals-only.

`decompress` handles arbitrary conforming frames (compressed or stored
blocks, any block size, linked or independent blocks — matches may reach
back into previous blocks' output, which concatenated output handles
naturally).  Checksums are validated with a pure-python xxHash32.

`compress` emits a conforming frame using a greedy hash-chain block
compressor — any standard LZ4 reader (incl. roslz4) can decode it.  Both
directions are pure python: correctness/rehearsal-grade throughput, not a
performance path (real deployments with the `lz4` wheel installed are
auto-preferred by runtime/rosbag.py).
"""
from __future__ import annotations

import struct

MAGIC = 0x184D2204
_U32 = struct.Struct("<I")

_XXH_P1 = 2654435761
_XXH_P2 = 2246822519
_XXH_P3 = 3266489917
_XXH_P4 = 668265263
_XXH_P5 = 374761393
_M32 = 0xFFFFFFFF


def _rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (32 - r))) & _M32


def xxh32(data: bytes, seed: int = 0) -> int:
    """xxHash32 (github.com/Cyan4973/xxHash spec) — frame checksums."""
    n = len(data)
    i = 0
    if n >= 16:
        v1 = (seed + _XXH_P1 + _XXH_P2) & _M32
        v2 = (seed + _XXH_P2) & _M32
        v3 = seed
        v4 = (seed - _XXH_P1) & _M32
        lim = n - 16
        while i <= lim:
            for j, v in enumerate((v1, v2, v3, v4)):
                (lane,) = _U32.unpack_from(data, i + 4 * j)
                v = (v + lane * _XXH_P2) & _M32
                v = (_rotl(v, 13) * _XXH_P1) & _M32
                if j == 0:
                    v1 = v
                elif j == 1:
                    v2 = v
                elif j == 2:
                    v3 = v
                else:
                    v4 = v
            i += 16
        h = (_rotl(v1, 1) + _rotl(v2, 7) + _rotl(v3, 12) + _rotl(v4, 18)) & _M32
    else:
        h = (seed + _XXH_P5) & _M32
    h = (h + n) & _M32
    while i + 4 <= n:
        (lane,) = _U32.unpack_from(data, i)
        h = (h + lane * _XXH_P3) & _M32
        h = (_rotl(h, 17) * _XXH_P4) & _M32
        i += 4
    while i < n:
        h = (h + data[i] * _XXH_P5) & _M32
        h = (_rotl(h, 11) * _XXH_P1) & _M32
        i += 1
    h ^= h >> 15
    h = (h * _XXH_P2) & _M32
    h ^= h >> 13
    h = (h * _XXH_P3) & _M32
    h ^= h >> 16
    return h


# ---------------------------------------------------------------------------
# block codec
# ---------------------------------------------------------------------------

def decompress_block(src: bytes, out: bytearray,
                     limit: int | None = None) -> None:
    """Decode one LZ4 block, APPENDING to `out` (matches may reference bytes
    already in `out`, which implements linked-block frames for free).

    limit: cap on len(out); exceeding it raises ValueError mid-block, so a
    crafted block (LZ4 expands up to ~255x/byte) cannot exhaust memory."""
    i = 0
    n = len(src)
    while i < n:
        if limit is not None and len(out) > limit:
            raise ValueError("lz4 block: output exceeds size limit")
        token = src[i]
        i += 1
        lit = token >> 4
        if lit == 15:
            while True:
                if i >= n:
                    raise ValueError("lz4 block: truncated literal length")
                b = src[i]
                i += 1
                lit += b
                if b != 255:
                    break
        if lit:
            if i + lit > n:
                raise ValueError("lz4 block: literal run past end of block")
            out += src[i:i + lit]
            i += lit
        if i >= n:
            return  # last sequence is literals-only
        if i + 2 > n:
            raise ValueError("lz4 block: truncated match offset")
        offset = src[i] | (src[i + 1] << 8)
        i += 2
        if offset == 0:
            raise ValueError("lz4 block: zero match offset")
        mlen = token & 0xF
        if mlen == 15:
            while True:
                if i >= n:
                    raise ValueError("lz4 block: truncated match length")
                b = src[i]
                i += 1
                mlen += b
                if b != 255:
                    break
        mlen += 4
        pos = len(out) - offset
        if pos < 0:
            raise ValueError("lz4 block: match offset before output start")
        # overlapping copy semantics (offset < mlen repeats recent bytes)
        for _ in range(mlen):
            out.append(out[pos])
            pos += 1


def compress_block(src: bytes) -> bytes:
    """Greedy hash-table LZ4 block compressor (correctness-grade).

    Follows the spec's end conditions: the last 5 bytes are always literals
    and the last match must start >= 12 bytes before the block end."""
    n = len(src)
    out = bytearray()
    if n == 0:
        return bytes(out)
    table: dict[bytes, int] = {}
    anchor = 0
    i = 0
    limit = n - 12  # last match must begin before this

    def emit(lit_start, lit_end, offset=None, mlen=0):
        lit = lit_end - lit_start
        tok_lit = 15 if lit >= 15 else lit
        tok_m = 0
        if offset is not None:
            m = mlen - 4
            tok_m = 15 if m >= 15 else m
        out.append((tok_lit << 4) | tok_m)
        if lit >= 15:
            rem = lit - 15
            while rem >= 255:
                out.append(255)
                rem -= 255
            out.append(rem)
        out.extend(src[lit_start:lit_end])
        if offset is not None:
            out.append(offset & 0xFF)
            out.append(offset >> 8)
            m = mlen - 4
            if m >= 15:
                rem = m - 15
                while rem >= 255:
                    out.append(255)
                    rem -= 255
                out.append(rem)

    while i <= limit:
        key = src[i:i + 4]
        j = table.get(key, -1)
        table[key] = i
        if j >= 0 and i - j <= 0xFFFF and src[j:j + 4] == key:
            # extend the match (may not run into the final 5 literals)
            end = n - 5
            mlen = 4
            while i + mlen < end and src[j + mlen] == src[i + mlen]:
                mlen += 1
            emit(anchor, i, i - j, mlen)
            i += mlen
            anchor = i
        else:
            i += 1
    emit(anchor, n)  # trailing literals
    return bytes(out)


# ---------------------------------------------------------------------------
# frame codec
# ---------------------------------------------------------------------------

def decompress(data: bytes, max_output: int | None = None) -> bytes:
    """Decode one LZ4 frame (raises ValueError on malformed input).

    max_output: optional cap on the decoded size — a hostile frame can
    otherwise expand a few hundred bytes into gigabytes before any checksum
    is checked.  Callers that know the expected size (rosbag chunk headers
    carry it) should pass it."""
    if len(data) < 7:
        raise ValueError("lz4 frame: truncated header")
    (magic,) = _U32.unpack_from(data, 0)
    if magic != MAGIC:
        raise ValueError(f"lz4 frame: bad magic 0x{magic:08X}")
    flg = data[4]
    version = flg >> 6
    if version != 1:
        raise ValueError(f"lz4 frame: unsupported version {version}")
    b_checksum = (flg >> 4) & 1
    c_size = (flg >> 3) & 1
    c_checksum = (flg >> 2) & 1
    dict_id = flg & 1
    off = 6  # magic + FLG + BD
    expected = None
    if c_size:
        if off + 8 > len(data):
            raise ValueError("lz4 frame: truncated content-size field")
        (expected,) = struct.unpack_from("<Q", data, off)
        off += 8
    if dict_id:
        off += 4
    if off + 1 > len(data):
        raise ValueError("lz4 frame: truncated header checksum")
    hc = data[off]
    want_hc = (xxh32(data[4:off]) >> 8) & 0xFF
    if hc != want_hc:
        raise ValueError("lz4 frame: header checksum mismatch")
    off += 1

    out = bytearray()
    while True:
        if off + 4 > len(data):
            raise ValueError("lz4 frame: missing end mark")
        (bsize,) = _U32.unpack_from(data, off)
        off += 4
        if bsize == 0:
            break
        stored = bool(bsize & 0x80000000)
        bsize &= 0x7FFFFFFF
        if off + bsize > len(data):
            raise ValueError("lz4 frame: truncated block")
        block = data[off:off + bsize]
        off += bsize
        if b_checksum:
            if off + 4 > len(data):
                raise ValueError("lz4 frame: truncated block checksum")
            (bc,) = _U32.unpack_from(data, off)
            off += 4
            if bc != xxh32(block):
                raise ValueError("lz4 frame: block checksum mismatch")
        if stored:
            out += block
        else:
            decompress_block(block, out, limit=max_output)
        if max_output is not None and len(out) > max_output:
            raise ValueError("lz4 frame: output exceeds size limit")
    if c_checksum:
        if off + 4 > len(data):
            raise ValueError("lz4 frame: truncated content checksum")
        (cc,) = _U32.unpack_from(data, off)
        if cc != xxh32(bytes(out)):
            raise ValueError("lz4 frame: content checksum mismatch")
    if expected is not None and expected != len(out):
        raise ValueError(f"lz4 frame: content size mismatch "
                         f"({len(out)} != {expected})")
    return bytes(out)


def compress(data: bytes, block_size: int = 4 << 20,
             store_uncompressed: bool = False) -> bytes:
    """Encode one LZ4 frame (independent blocks, content checksum).

    store_uncompressed: emit stored blocks (still a conforming frame) —
    used by tests to pin the stored-block decode path."""
    flg = (1 << 6) | (1 << 5) | (1 << 2)  # v1, block-independent, c.checksum
    bd = 7 << 4  # 4 MB max block size
    hdr = bytes([flg, bd])
    out = bytearray(_U32.pack(MAGIC))
    out += hdr
    out.append((xxh32(hdr) >> 8) & 0xFF)
    for i in range(0, len(data), block_size):
        chunk = data[i:i + block_size]
        comp = None if store_uncompressed else compress_block(chunk)
        if comp is None or len(comp) >= len(chunk):
            out += _U32.pack(len(chunk) | 0x80000000)
            out += chunk
        else:
            out += _U32.pack(len(comp))
            out += comp
    out += _U32.pack(0)
    out += _U32.pack(xxh32(data))
    return bytes(out)
