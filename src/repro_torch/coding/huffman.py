"""Canonical Huffman coding for quantized edit streams (paper §IV-B, [37]).

Encoder is fully vectorized (bit scatter over numpy); decoder is a fully
vectorized canonical-code LUT walk: code windows at EVERY bit position are
extracted at once from 32-bit reads of the packed stream, the LUT turns them
into per-position (symbol, advance) pairs, and the sequential chain of
decode positions is expanded with pointer doubling (log2(n) gather rounds)
instead of a per-symbol Python loop.  The paper chains Huffman with ZSTD;
see :mod:`repro_torch.coding.lossless` for the chained entry points.

Wire format (little-endian):
  u32  n_symbols_in_alphabet
  i64  per-alphabet-symbol raw value   (n_symbols entries, int64)
  u8   per-alphabet-symbol code length (n_symbols entries)
  u64  n_encoded_symbols
  u64  n_bits
  u8[] bitstream (MSB first within each byte)
"""

from __future__ import annotations

import heapq
import struct

import numpy as np

#: Bit-range chunk size of the vectorized decoder: bounds its per-position
#: temporaries (~50 bytes live per bit, so ~50 MB per chunk at this size)
#: however large the stream is.  Streams at most this long decode in one
#: chunk.
DECODE_CHUNK_BITS = 1 << 20


def _code_lengths(freqs: np.ndarray) -> np.ndarray:
    """Huffman code lengths from symbol frequencies (heap merge)."""
    n = len(freqs)
    if n == 1:
        return np.array([1], dtype=np.uint8)
    # heap entries: (freq, tiebreak, set-of-symbol-indices)
    heap = [(int(f), i, [i]) for i, f in enumerate(freqs)]
    heapq.heapify(heap)
    lengths = np.zeros(n, dtype=np.int64)
    tiebreak = n
    while len(heap) > 1:
        fa, _, sa = heapq.heappop(heap)
        fb, _, sb = heapq.heappop(heap)
        for s in sa:
            lengths[s] += 1
        for s in sb:
            lengths[s] += 1
        heapq.heappush(heap, (fa + fb, tiebreak, sa + sb))
        tiebreak += 1
    return lengths.astype(np.uint8)


def _canonical_codes(lengths: np.ndarray) -> np.ndarray:
    """Canonical Huffman code values (uint64) given code lengths.

    Symbols are ranked by (length, symbol-index); codes assigned in canonical
    order so the decoder only needs the lengths.
    """
    order = np.lexsort((np.arange(len(lengths)), lengths))
    codes = np.zeros(len(lengths), dtype=np.uint64)
    code = 0
    prev_len = int(lengths[order[0]])
    for rank, sym in enumerate(order):
        ln = int(lengths[sym])
        if rank > 0:
            code = (code + 1) << (ln - prev_len)
        codes[sym] = code
        prev_len = ln
    return codes


def huffman_encode(symbols: np.ndarray) -> bytes:
    """Encode an integer symbol stream; returns self-describing bytes."""
    symbols = np.asarray(symbols).astype(np.int64).ravel()
    if symbols.size == 0:
        return struct.pack("<I", 0) + struct.pack("<QQ", 0, 0)
    alphabet, inverse, counts = np.unique(symbols, return_inverse=True, return_counts=True)
    lengths = _code_lengths(counts)
    codes = _canonical_codes(lengths)

    sym_lengths = lengths[inverse].astype(np.int64)
    sym_codes = codes[inverse]
    offsets = np.concatenate(([0], np.cumsum(sym_lengths)))
    total_bits = int(offsets[-1])

    bits = np.zeros(total_bits, dtype=np.uint8)
    max_len = int(lengths.max())
    # Vectorized scatter: for bit j of each code (MSB first), write where len > j.
    for j in range(max_len):
        mask = sym_lengths > j
        if not mask.any():
            break
        shift = (sym_lengths[mask] - 1 - j).astype(np.uint64)
        bitvals = ((sym_codes[mask] >> shift) & np.uint64(1)).astype(np.uint8)
        bits[offsets[:-1][mask] + j] = bitvals

    payload = np.packbits(bits).tobytes()
    header = struct.pack("<I", len(alphabet))
    header += alphabet.astype("<i8").tobytes()
    header += lengths.astype(np.uint8).tobytes()
    header += struct.pack("<QQ", symbols.size, total_bits)
    return header + payload


def huffman_decode(data: bytes) -> np.ndarray:
    """Inverse of :func:`huffman_encode`; returns int64 symbols.

    Vectorized canonical LUT walk (no per-symbol Python loop):

    1. every bit position's next-``max_len``-bit window is read at once from
       four-byte little loads of the packed stream (``max_len + 7 <= 32``);
    2. the canonical LUT maps each window to its (symbol, code length), so
       ``jump[p] = p + len`` is the whole decode automaton as one array;
    3. the sequential position chain ``p_{i+1} = jump[p_i]`` is expanded by
       pointer doubling — after round r the first ``2^r`` positions are
       known and ``jump`` composes with itself, so ``n_syms`` positions
       materialize in ``ceil(log2 n_syms)`` numpy gather rounds.

    Decodes the exact byte streams the encoder writes (regression-gated
    against the reference walk in ``tests/test_coding.py``).
    """
    (n_alpha,) = struct.unpack_from("<I", data, 0)
    off = 4
    if n_alpha == 0:
        return np.zeros(0, dtype=np.int64)
    alphabet = np.frombuffer(data, dtype="<i8", count=n_alpha, offset=off).copy()
    off += 8 * n_alpha
    lengths = np.frombuffer(data, dtype=np.uint8, count=n_alpha, offset=off).copy()
    off += n_alpha
    n_syms, n_bits = struct.unpack_from("<QQ", data, off)
    off += 16
    if n_syms == 0:
        return np.zeros(0, dtype=np.int64)
    if n_bits > 8 * (len(data) - off):
        # the guard np.unpackbits(count=n_bits) used to provide: a truncated
        # payload must fail loudly, not decode missing bits as zeros
        raise ValueError(
            f"truncated Huffman stream: header wants {n_bits} bits, "
            f"payload has {8 * (len(data) - off)}"
        )

    codes = _canonical_codes(lengths)
    max_len = int(lengths.max())
    if max_len <= 20:
        # Full lookup table: next `max_len` bits -> (symbol index, code length).
        table_sym = np.zeros(1 << max_len, dtype=np.int64)
        table_len = np.zeros(1 << max_len, dtype=np.int64)
        for sym in range(n_alpha):
            ln = int(lengths[sym])
            base = int(codes[sym]) << (max_len - ln)
            span = 1 << (max_len - ln)
            table_sym[base : base + span] = sym
            table_len[base : base + span] = ln

        # Decode in bit-range chunks so the per-position temporaries stay
        # O(chunk) however large the stream is (the automaton arrays cost
        # ~50 bytes per payload bit while live).
        payload = np.frombuffer(data, dtype=np.uint8, offset=off)
        buf = np.zeros(len(payload) + 8, dtype=np.uint8)
        buf[: len(payload)] = payload
        mask = np.uint32((1 << max_len) - 1)
        out = np.empty(n_syms, dtype=np.int64)
        filled = 0
        abs_pos = 0
        while filled < n_syms:
            lo = abs_pos
            dom = min(DECODE_CHUNK_BITS, n_bits - lo)
            if dom <= 0:
                raise ValueError("corrupt Huffman stream: ran out of bits")
            # (1) window at every chunk position, from overlapping 32-bit
            # big-endian reads (the zero pad covers the trailing overreads)
            pos = np.arange(lo, lo + dom, dtype=np.int64)
            byte0 = pos >> 3
            word = (
                (buf[byte0].astype(np.uint32) << np.uint32(24))
                | (buf[byte0 + 1].astype(np.uint32) << np.uint32(16))
                | (buf[byte0 + 2].astype(np.uint32) << np.uint32(8))
                | buf[byte0 + 3].astype(np.uint32)
            )
            shift = (np.uint32(32 - max_len) - (pos & 7).astype(np.uint32)).astype(
                np.uint32
            )
            window = ((word >> shift) & mask).astype(np.int64)
            # (2) the chunk-relative decode automaton: jump[r] = r + code len
            # at position lo + r.  Values are EXACT even past the chunk end
            # (the window reads don't stop at dom), which is what hands the
            # next chunk its exact start; composition below treats >= dom as
            # absorbing so those values survive the doubling untouched.
            sym_at = table_sym[window]
            jump = pos + table_len[window] - lo
            # (3) pointer-doubling expansion of the position chain: cap + 1
            # entries so the first out-of-chunk position (the continuation)
            # is materialized alongside the in-chunk symbol starts
            cap = min(n_syms - filled, dom)
            length = cap + 1
            chain = np.empty(length, dtype=np.int64)
            chain[0] = 0
            m = 1
            while m < length:
                take = min(m, length - m)
                src = chain[:take]
                safe = np.minimum(src, dom - 1)
                chain[m : m + take] = np.where(src >= dom, src, jump[safe])
                m += take
                if m < length:
                    safe = np.minimum(jump, dom - 1)
                    jump = np.where(jump >= dom, jump, jump[safe])
            # positions are non-decreasing (code lengths >= 1, absorbing past
            # dom), so the first out-of-chunk entry is a searchsorted away
            k = min(int(np.searchsorted(chain, dom)), cap)
            out[filled : filled + k] = sym_at[chain[:k]]
            filled += k
            if filled < n_syms:
                abs_pos = lo + int(chain[k])
        return alphabet[out]
    # Fallback: per-bit canonical walk (rare: pathological length > 20).
    bits = np.unpackbits(np.frombuffer(data, dtype=np.uint8, offset=off), count=n_bits)
    out = np.empty(n_syms, dtype=np.int64)
    pos = 0
    lut = {(int(lengths[s]), int(codes[s])): s for s in range(n_alpha)}
    for i in range(n_syms):
        code = 0
        ln = 0
        while True:
            code = (code << 1) | int(bits[pos])
            pos += 1
            ln += 1
            sym = lut.get((ln, code))
            if sym is not None:
                out[i] = sym
                break
    return alphabet[out]
