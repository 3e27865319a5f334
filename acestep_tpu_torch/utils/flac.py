"""Pure-Python FLAC decoder: reads source and reference audio without ffmpeg.

A copy of `acestep_tpu/utils/flac.py`, written from the public FLAC format
spec: constant / verbatim / fixed / LPC subframes, Rice partitions (4- and
5-bit) with raw escapes, wasted bits, and the left/right/mid-side stereo
decorrelations, at 8/12/16/20/24 bps. Host-side; decode speed is bounded by
the Rice loop, fine for ingest-sized files.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np


class _BitReader:
    __slots__ = ("data", "pos")

    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0  # bit position

    def read(self, nbits: int) -> int:
        v = 0
        pos = self.pos
        data = self.data
        end = pos + nbits
        while pos < end:
            byte = data[pos >> 3]
            avail = 8 - (pos & 7)
            take = min(avail, end - pos)
            shift = avail - take
            v = (v << take) | ((byte >> shift) & ((1 << take) - 1))
            pos += take
        self.pos = end
        return v

    def read_signed(self, nbits: int) -> int:
        v = self.read(nbits)
        if v >= 1 << (nbits - 1):
            v -= 1 << nbits
        return v

    def read_unary(self) -> int:
        q = 0
        data = self.data
        pos = self.pos
        while True:
            byte = data[pos >> 3]
            rem = 8 - (pos & 7)
            chunk = byte & ((1 << rem) - 1)
            if chunk == 0:
                q += rem
                pos += rem
                continue
            lead = rem - chunk.bit_length()
            q += lead
            pos += lead + 1  # the terminating 1
            self.pos = pos
            return q

    def align(self) -> None:
        self.pos = (self.pos + 7) & ~7


def _read_utf8_number(br: _BitReader) -> int:
    b0 = br.read(8)
    if b0 < 0x80:
        return b0
    n = 0
    while (b0 << n) & 0x80:
        n += 1
    v = b0 & (0x7F >> n)
    for _ in range(n - 1):
        v = (v << 6) | (br.read(8) & 0x3F)
    return v


_BLOCKSIZE = {1: 192, 2: 576, 3: 1152, 4: 2304, 5: 4608,
              8: 256, 9: 512, 10: 1024, 11: 2048, 12: 4096,
              13: 8192, 14: 16384, 15: 32768}

_FIXED_COEFS = {0: [], 1: [1], 2: [2, -1], 3: [3, -3, 1], 4: [4, -6, 4, -1]}


def _decode_residual(br: _BitReader, n: int, order: int) -> List[int]:
    method = br.read(2)
    if method > 1:
        raise ValueError("reserved residual method")
    plen = 4 if method == 0 else 5
    escape = (1 << plen) - 1
    part_order = br.read(4)
    parts = 1 << part_order
    res: List[int] = []
    for p in range(parts):
        count = n >> part_order
        if p == 0:
            count -= order
        r = br.read(plen)
        if r == escape:
            bits = br.read(5)
            if bits == 0:
                res.extend([0] * count)
            else:
                res.extend(br.read_signed(bits) for _ in range(count))
        else:
            for _ in range(count):
                q = br.read_unary()
                u = (q << r) | br.read(r) if r else q
                res.append((u >> 1) ^ -(u & 1))  # un-zigzag
    return res


def _decode_subframe(br: _BitReader, n: int, bps: int) -> List[int]:
    if br.read(1):
        raise ValueError("subframe padding bit set")
    stype = br.read(6)
    wasted = 0
    if br.read(1):
        wasted = 1 + br.read_unary()
        bps -= wasted

    if stype == 0:  # constant
        x = [br.read_signed(bps)] * n
    elif stype == 1:  # verbatim
        x = [br.read_signed(bps) for _ in range(n)]
    elif 8 <= stype <= 12:  # fixed
        order = stype & 7
        x = [br.read_signed(bps) for _ in range(order)]
        res = _decode_residual(br, n, order)
        coefs = _FIXED_COEFS[order]
        for i, e in enumerate(res):
            pred = sum(c * x[order + i - 1 - j] for j, c in enumerate(coefs))
            x.append(e + pred)
    elif stype >= 32:  # LPC
        order = (stype & 31) + 1
        x = [br.read_signed(bps) for _ in range(order)]
        precision = br.read(4) + 1
        if precision == 16:
            raise ValueError("invalid LPC precision")
        shift = br.read_signed(5)
        coefs = [br.read_signed(precision) for _ in range(order)]
        res = _decode_residual(br, n, order)
        for i, e in enumerate(res):
            pred = sum(c * x[order + i - 1 - j] for j, c in enumerate(coefs)) >> shift
            x.append(e + pred)
    else:
        raise ValueError(f"reserved subframe type {stype}")

    if wasted:
        x = [v << wasted for v in x]
    return x


def decode(data: bytes) -> Tuple[np.ndarray, int, int]:
    """Decode a FLAC stream → ((channels, samples) int32, sample_rate, bps)."""
    if data[:4] != b"fLaC":
        raise ValueError("not a FLAC stream")
    pos = 4
    sample_rate = channels = bps = 0
    total = 0
    while True:
        hdr = data[pos:pos + 4]
        last = hdr[0] & 0x80
        btype = hdr[0] & 0x7F
        length = (hdr[1] << 16) | (hdr[2] << 8) | hdr[3]
        body = data[pos + 4:pos + 4 + length]
        if btype == 0:  # STREAMINFO
            br = _BitReader(body)
            br.read(16)  # min block
            br.read(16)  # max block
            br.read(24)  # min frame
            br.read(24)  # max frame
            sample_rate = br.read(20)
            channels = br.read(3) + 1
            bps = br.read(5) + 1
            total = br.read(36)
        pos += 4 + length
        if last:
            break

    out = [np.empty(total, np.int32) for _ in range(channels)]
    br = _BitReader(data)
    br.pos = pos * 8
    written = 0
    while written < total:
        if br.read(14) != 0x3FFE:
            raise ValueError(f"lost frame sync at sample {written}")
        br.read(1)  # reserved
        br.read(1)  # blocking strategy
        bs_bits = br.read(4)
        sr_bits = br.read(4)
        chan_assign = br.read(4)
        bps_bits = br.read(3)
        br.read(1)  # reserved
        _read_utf8_number(br)
        if bs_bits == 6:
            bs = br.read(8) + 1
        elif bs_bits == 7:
            bs = br.read(16) + 1
        else:
            bs = _BLOCKSIZE[bs_bits]
        if sr_bits == 12:
            br.read(8)
        elif sr_bits in (13, 14):
            br.read(16)
        br.read(8)  # header crc8 (not verified)

        frame_bps = {0: bps, 1: 8, 2: 12, 4: 16, 5: 20, 6: 24, 7: 32}[bps_bits]
        if chan_assign < 8:
            subs = [np.asarray(_decode_subframe(br, bs, frame_bps), np.int64)
                    for _ in range(chan_assign + 1)]
        else:
            # stereo decorrelation: the SIDE channel carries one extra bit
            extra = [1, 0] if chan_assign == 9 else [0, 1]
            a = np.asarray(_decode_subframe(br, bs, frame_bps + extra[0]), np.int64)
            b = np.asarray(_decode_subframe(br, bs, frame_bps + extra[1]), np.int64)
            if chan_assign == 8:    # left/side
                subs = [a, a - b]
            elif chan_assign == 9:  # right/side
                subs = [a + b, b]
            elif chan_assign == 10:  # mid/side
                mid, side = a, b
                m2 = (mid << 1) | (side & 1)
                subs = [(m2 + side) >> 1, (m2 - side) >> 1]
            else:
                raise ValueError("reserved channel assignment")
        br.align()
        br.read(16)  # frame crc16 (not verified)

        take = min(bs, total - written)
        for c in range(channels):
            out[c][written:written + take] = subs[c][:take]
        written += take

    return np.stack(out), sample_rate, bps
