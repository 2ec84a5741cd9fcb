"""GROMACS XTC trajectory I/O (magic 1995, xdr3dfcoord compression).

``read_xtc`` and ``write_xtc`` go through the C++ codec
(``native/mdx_native.cpp``, built and bound by ``io.native``). This module
also holds a from-scratch pure-Python decoder of the same public format,
``read_xtc_py``: the plain version the C++ decoder is held against (two
codebases agreeing on the bit format catch inverse-pair bugs a round-trip
test cannot).

Coordinates are returned in Angstrom (XTC stores nm).
"""

from __future__ import annotations

import struct

import numpy as np

_MAGIC = 1995
_MAGICINTS = [
    0, 0, 0, 0, 0, 0, 0, 0, 0, 8, 10, 12, 16, 20, 25, 32, 40, 50, 64, 80,
    101, 128, 161, 203, 256, 322, 406, 512, 645, 812, 1024, 1290, 1625,
    2048, 2580, 3250, 4096, 5060, 6501, 8192, 10321, 13003, 16384, 20642,
    26007, 32768, 41285, 52015, 65536, 82570, 104031, 131072, 165140,
    208063, 262144, 330280, 416127, 524287, 660561, 832255, 1048576,
    1321122, 1664510, 2097152, 2642245, 3329021, 4194304, 5284491, 6658042,
    8388607, 10568983, 13316085, 16777216,
]
_FIRSTIDX = 9


def _sizeofint(size: int) -> int:
    num, bits = 1, 0
    while size >= num and bits < 32:
        bits += 1
        num <<= 1
    return bits


def _sizeofints(sizes) -> int:
    """Bits for the multi-radix packed triple (arbitrary-precision here —
    Python ints make the byte-juggling of the C version unnecessary)."""
    prod = 1
    for s in sizes:
        prod *= int(s)
    # product fits in ceil(log2) bits, but the C algorithm counts whole
    # bytes for all but the leading byte
    num_of_bytes = (prod.bit_length() + 7) // 8 if prod > 0 else 1
    lead = prod >> ((num_of_bytes - 1) * 8)
    bits = 0
    num = 1
    while lead >= num:
        bits += 1
        num *= 2
    return bits + (num_of_bytes - 1) * 8


class _Bits:
    """MSB-first bit reader over the compressed payload."""

    def __init__(self, data: bytes):
        self.data = data
        self.cnt = 0
        self.lastbits = 0
        self.lastbyte = 0

    def _next(self) -> int:
        b = self.data[self.cnt] if self.cnt < len(self.data) else 0
        self.cnt += 1
        return b

    def receivebits(self, nbits: int) -> int:
        num = 0
        mask = (1 << nbits) - 1
        while nbits >= 8:
            self.lastbyte = ((self.lastbyte << 8) | self._next()) & 0xFFFFFFFF
            num |= (self.lastbyte >> self.lastbits) << (nbits - 8)
            nbits -= 8
        if nbits > 0:
            if self.lastbits < nbits:
                self.lastbits += 8
                self.lastbyte = (
                    (self.lastbyte << 8) | self._next()
                ) & 0xFFFFFFFF
            self.lastbits -= nbits
            num |= (self.lastbyte >> self.lastbits) & ((1 << nbits) - 1)
        return num & mask

    def receiveints(self, num_of_ints: int, num_of_bits: int, sizes) -> list:
        # big-endian byte stream -> little-endian arbitrary-precision int,
        # then peel radices off (the C version's byte-array long division)
        nbytes = []
        while num_of_bits > 8:
            nbytes.append(self.receivebits(8))
            num_of_bits -= 8
        if num_of_bits > 0:
            nbytes.append(self.receivebits(num_of_bits))
        big = 0
        for i, b in enumerate(nbytes):
            big |= b << (8 * i)
        nums = [0] * num_of_ints
        for i in range(num_of_ints - 1, 0, -1):
            big, nums[i] = divmod(big, int(sizes[i]))
        nums[0] = big
        return nums


def _decompress(data: bytes, natoms: int, precision: float) -> np.ndarray:
    """Decode one compressed coordinate block (after the precision field);
    returns (natoms, 3) float32 nm."""
    minint = list(struct.unpack(">3i", data[0:12]))
    maxint = list(struct.unpack(">3i", data[12:24]))
    smallidx = struct.unpack(">i", data[24:28])[0]
    sizeint = [maxint[d] - minint[d] + 1 for d in range(3)]
    if (sizeint[0] | sizeint[1] | sizeint[2]) > 0xFFFFFF:
        bitsizeint = [_sizeofint(s) for s in sizeint]
        bitsize = 0
    else:
        bitsize = _sizeofints(sizeint)
        bitsizeint = [0, 0, 0]
    smaller = _MAGICINTS[max(_FIRSTIDX, smallidx - 1)] // 2
    smallnum = _MAGICINTS[smallidx] // 2
    sizesmall = [_MAGICINTS[smallidx]] * 3
    nbytes = struct.unpack(">I", data[28:32])[0]
    bits = _Bits(data[32 : 32 + nbytes])

    inv = np.float32(1.0) / np.float32(precision)  # f32 like the C codec
    iout = np.empty((natoms, 3), np.int64)
    prev = [0, 0, 0]
    i = 0
    run = 0
    w = 0  # write cursor
    while i < natoms:
        if bitsize == 0:
            this = [bits.receivebits(bitsizeint[d]) for d in range(3)]
        else:
            this = bits.receiveints(3, bitsize, sizeint)
        i += 1
        this = [this[d] + minint[d] for d in range(3)]
        prev = list(this)
        flag = bits.receivebits(1)
        is_smaller = 0
        if flag == 1:
            run = bits.receivebits(5)
            is_smaller = run % 3
            run -= is_smaller
            is_smaller -= 1
        if run > 0:
            for k in range(0, run, 3):
                delta = bits.receiveints(3, smallidx, sizesmall)
                i += 1
                cur = [delta[d] + prev[d] - smallnum for d in range(3)]
                if k == 0:
                    # undo the bonded-pair swap: the run's first atom is the
                    # original earlier atom; prev stays on it for the next
                    # delta (matching the encoder's prevcoord walk)
                    cur, prev = prev, cur
                    iout[w] = prev
                    w += 1
                else:
                    prev = list(cur)
                iout[w] = cur
                w += 1
        else:
            iout[w] = this
            w += 1
        smallidx += is_smaller
        if is_smaller < 0:
            smallnum = smaller
            smaller = (
                _MAGICINTS[smallidx - 1] // 2 if smallidx > _FIRSTIDX else 0
            )
        elif is_smaller > 0:
            smaller = smallnum
            smallnum = _MAGICINTS[smallidx] // 2
        sizesmall = [_MAGICINTS[smallidx]] * 3
    return iout.astype(np.float32) * inv


def read_xtc_py(path: str, with_meta: bool = False):
    """Pure-Python XTC reader (slow path / cross-check); Angstrom out."""
    frames, steps, times = [], [], []
    with open(path, "rb") as f:
        data = f.read()
    pos = 0
    while pos + 56 <= len(data):
        magic, natoms, step = struct.unpack(">3i", data[pos : pos + 12])
        if magic != _MAGIC:
            raise IOError(f"not a GROMACS XTC file (magic {magic}): {path}")
        (t,) = struct.unpack(">f", data[pos + 12 : pos + 16])
        lsize = struct.unpack(">i", data[pos + 52 : pos + 56])[0]
        pos += 56
        if lsize <= 9:
            coords = np.array(
                struct.unpack(f">{lsize * 3}f", data[pos : pos + lsize * 12]),
                np.float32,
            ).reshape(lsize, 3)
            pos += lsize * 12
        else:
            (precision,) = struct.unpack(">f", data[pos : pos + 4])
            pos += 4
            nbytes = struct.unpack(">I", data[pos + 28 : pos + 32])[0]
            padded = (nbytes + 3) & ~3
            coords = _decompress(
                data[pos : pos + 32 + padded], natoms, precision
            )
            pos += 32 + padded
        frames.append(coords * 10.0)  # nm -> Angstrom
        steps.append(step)
        times.append(t)
    out = np.stack(frames) if frames else np.zeros((0, 0, 3), np.float32)
    if with_meta:
        return out, np.asarray(steps, np.int32), np.asarray(times, np.float32)
    return out


def read_xtc(path: str, with_meta: bool = False):
    """Read a GROMACS .xtc -> (n_frames, N, 3) float32 Angstrom, or
    (coords, steps, times_ps) with ``with_meta=True``.

    Decodes with the native C++ codec; where that library cannot be built
    this raises with the compiler's output (``read_xtc_py`` is the pure
    Python decoder)."""
    from molecular_dynamics_tpu_torch.io import native

    return native.xtc_read(path, with_meta=with_meta)


def write_xtc(path: str, coords: np.ndarray, precision: float = 1000.0):
    """Write a GROMACS .xtc through the native codec (Angstrom in; precision
    in 1/nm, 1000 keeps 0.001 nm)."""
    from molecular_dynamics_tpu_torch.io import native

    native.xtc_write(path, coords, precision=precision)
