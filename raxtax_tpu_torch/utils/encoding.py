"""DNA encoding primitives.

TPU-native re-design of the reference encoder (reference: src/parser.rs:11-34,
src/utils.rs:17-40). Nucleotides are encoded as a 4-bit one-hot union
(A=0b0001, C=0b0010, G=0b0100, T=0b1000; IUPAC ambiguity codes are bitwise
unions). Pure A/C/G/T map down to 2-bit codes used for packing 8-mers into
16-bit integers; any window containing an ambiguity code is dropped.

Everything here is vectorized numpy operating on byte buffers: the host side
only prepares compact integer tensors for the device.
"""

from __future__ import annotations

import math

import numpy as np

#: Number of decimal digits of printed confidence values
#: (reference: src/utils.rs:15).
F64_OUTPUT_ACCURACY = 2

K = 8  #: k-mer length (fixed 8-mers, 16-bit packed; reference: src/utils.rs:29)
NUM_KMERS = 1 << (2 * K)  #: 65,536 distinct packed 8-mers

_A, _C, _G, _T = 0b0001, 0b0010, 0b0100, 0b1000

#: char -> 4-bit code lookup (0 marks an invalid character).
#: Mirrors reference src/parser.rs:11-34 including all 15 IUPAC codes.
CHAR_TO_4BIT = np.zeros(256, dtype=np.uint8)
for _ch, _code in {
    "A": _A,
    "C": _C,
    "G": _G,
    "T": _T,
    "W": _A | _T,
    "S": _C | _G,
    "M": _A | _C,
    "K": _G | _T,
    "R": _A | _G,
    "Y": _C | _T,
    "B": _C | _G | _T,
    "D": _A | _G | _T,
    "H": _A | _C | _T,
    "V": _A | _C | _G,
    "N": _A | _C | _G | _T,
}.items():
    CHAR_TO_4BIT[ord(_ch)] = _code
    CHAR_TO_4BIT[ord(_ch.lower())] = _code

#: 4-bit one-hot -> 2-bit code; 255 marks ambiguity (reference: src/utils.rs:17-25).
FOUR_TO_TWO_BIT = np.full(16, 255, dtype=np.uint8)
FOUR_TO_TWO_BIT[_A] = 0b00
FOUR_TO_TWO_BIT[_C] = 0b01
FOUR_TO_TWO_BIT[_G] = 0b10
FOUR_TO_TWO_BIT[_T] = 0b11

#: 4-bit code -> display char for decompression (reference: src/utils.rs:70-81).
FOUR_BIT_TO_CHAR = np.full(16, ord("-"), dtype=np.uint8)
FOUR_BIT_TO_CHAR[_A] = ord("A")
FOUR_BIT_TO_CHAR[_C] = ord("C")
FOUR_BIT_TO_CHAR[_G] = ord("G")
FOUR_BIT_TO_CHAR[_T] = ord("T")


class InvalidCharacterError(ValueError):
    """Raised when a sequence contains a non-IUPAC character."""


def encode_sequence(seq: bytes | str) -> np.ndarray:
    """Encode an ASCII DNA sequence into 4-bit codes (uint8 array).

    Raises :class:`InvalidCharacterError` on any non-IUPAC character
    (the reference panics: src/parser.rs:32).
    """
    if isinstance(seq, str):
        seq = seq.encode("ascii")
    raw = np.frombuffer(seq, dtype=np.uint8)
    codes = CHAR_TO_4BIT[raw]
    if not codes.all():
        bad = raw[codes == 0]
        raise InvalidCharacterError(
            f"Unexpected character: {chr(int(bad[0]))}"
        )
    return codes


def decompress_sequence(codes: np.ndarray) -> str:
    """4-bit codes -> ACGT text; ambiguity codes render as '-'.

    Mirrors reference src/utils.rs:70-81.
    """
    return FOUR_BIT_TO_CHAR[codes].tobytes().decode("ascii")


# Window weights: first base is the high 2 bits (shift 14), last is bits 0-1
# (reference: src/utils.rs:33 `c << (14 - j * 2)`).
_KMER_SHIFTS = np.arange(14, -2, -2, dtype=np.int32)


def sequence_to_kmer_windows(codes: np.ndarray) -> np.ndarray:
    """All valid packed 8-mer windows of a 4-bit sequence, in sequence order.

    Windows containing any ambiguity code are dropped. Duplicates retained.
    """
    n = codes.shape[0]
    if n < K:
        return np.empty(0, dtype=np.uint16)
    two = FOUR_TO_TWO_BIT[codes].astype(np.int32)
    win = np.lib.stride_tricks.sliding_window_view(two, K)
    valid = (win != 255).all(axis=1)
    packed = (win << _KMER_SHIFTS).sum(axis=1, dtype=np.int32)
    return packed[valid].astype(np.uint16)


def sequence_to_kmers(codes: np.ndarray) -> np.ndarray:
    """Sorted distinct packed 8-mers of a sequence (reference: src/utils.rs:27-40)."""
    from .. import native

    out = native.distinct_kmers(codes)
    if out is not None:
        return out
    return np.unique(sequence_to_kmer_windows(codes))


def round_half_away(x, digits: int = F64_OUTPUT_ACCURACY):
    """Rust `f64::round` semantics (half away from zero) at `digits` decimals.

    Mirrors reference src/lineage.rs:128-129: `(x * f).round() / f`.
    numpy's `round` is half-to-even, so implement explicitly. Scalars take
    the pure-`math` path (hot in the per-query evaluation loop).
    """
    f = float(10**digits)
    if isinstance(x, (float, int)):
        scaled = x * f
        return math.copysign(math.floor(abs(scaled) + 0.5), scaled) / f
    scaled = np.multiply(x, f)
    return np.sign(scaled) * np.floor(np.abs(scaled) + 0.5) / f
