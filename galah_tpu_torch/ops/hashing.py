"""Canonical k-mer positional hashes in torch.

The port of ``galah_tpu/ops/hashing.py``'s window hashing: for every
position of a genome, the canonical (lexicographic min of forward and
reverse complement) k-mer is hashed with murmur3 x64_128 h1 over its
ASCII bytes (seed 0, the reference's finch contract, reference:
src/finch.rs:33-47) or with the multiply-free ``tpufast`` mixer over
its 2-bit packing. Windows holding an ambiguous base or crossing a
contig boundary give the sentinel. The output is bit-identical to
``galah_tpu.ops.fragment_ani.positional_hashes``, in the biased-int64
form of ``ops/u64.py``.

Positions are processed in chunks of ``chunk`` windows so device
memory stays bounded for any genome length; every op is elementwise
over shifted slices of the chunk's codes.

``canonical_key_words`` stops before the hash: it gives each window's
canonical key as the words the hash reads (``galah_tpu``'s
``canonical_kmer_words``). It and ``_key_words`` are the plain preamble
of the sketch and profile kernels' plain versions and the route of
every other k and hash. The kernels themselves read the codes: at k=21
with murmur3, ``positional_hashes`` hands the genome's codes to
``ops/murmur3_k21``, and at k=15 to ``ops/positional_hashes`` (their
kernels on the card).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from galah_tpu_torch.device import resolve_device
from galah_tpu_torch.io.fasta import Genome
from galah_tpu_torch.ops.constants import SENTINEL_BIASED
from galah_tpu_torch.ops.u64 import as_int64, bias, lsr, rotl

# windows hashed per chunk: ~10 int64 temporaries of this length are
# live at once, under 1 GB on the card
DEFAULT_CHUNK = 1 << 23

# the longest k-mer: its 2-bit packs fill one 64-bit word
MAX_KMER = 32

_C1 = as_int64(0x87C37B91114253D5)
_C2 = as_int64(0x4CF5AD432745937F)
_F1 = as_int64(0xFF51AFD7ED558CCD)
_F2 = as_int64(0xC4CEB9FE1A85EC53)
_ASCII = (65, 67, 71, 84)  # A C G T


def _fmix64(x: torch.Tensor) -> torch.Tensor:
    x = x ^ lsr(x, 33)
    x = x * _F1
    x = x ^ lsr(x, 33)
    x = x * _F2
    return x ^ lsr(x, 33)


def murmur3_h1_words(words, length: int, seed: int = 0) -> torch.Tensor:
    """h1 of murmur3 x64_128 over `length`-byte keys given as their
    little-endian 8-byte words: ``ceil(length / 8)`` int64 tensors, the
    last one holding the partial tail. Wrap-around int64 ``*``/``+``
    equal the u64 ops bit for bit."""
    h1 = torch.full_like(words[0], as_int64(seed))
    h2 = h1.clone()
    nblocks = length // 16
    for blk in range(nblocks):
        k1 = rotl(words[2 * blk] * _C1, 31) * _C2
        h1 = rotl(h1 ^ k1, 27) + h2
        h1 = h1 * 5 + 0x52DCE729
        k2 = rotl(words[2 * blk + 1] * _C2, 33) * _C1
        h2 = rotl(h2 ^ k2, 31) + h1
        h2 = h2 * 5 + 0x38495AB5
    rem = length & 15
    if rem > 8:
        h2 = h2 ^ (rotl(words[2 * nblocks + 1] * _C2, 33) * _C1)
    if rem > 0:
        h1 = h1 ^ (rotl(words[2 * nblocks] * _C1, 31) * _C2)
    h1 = h1 ^ length
    h2 = h2 ^ length
    h1 = h1 + h2
    h2 = h2 + h1
    return _fmix64(h1) + _fmix64(h2)


def tpufast_mix(x: torch.Tensor, seed: int = 0) -> torch.Tensor:
    """The multiply-free shift-add mixer (``hashing._tpufast_mix``)."""
    x = x ^ as_int64((seed * 0x9E3779B97F4A7C15 + 0x1B873593) % (1 << 64))
    for sh_a, sh_b, sh_x in ((21, 37, 29), (13, 47, 31), (17, 41, 33)):
        x = x + (x << sh_a) + (x << sh_b)
        x = x ^ lsr(x, sh_x)
    x = x + (x << 26)
    return x ^ lsr(x, 32)


def _key_words(cs: torch.Tensor, k: int, algo: str):
    """The canonical key of each of the ``len(cs) - k + 1`` windows of
    `cs` (sanitized codes, int64 0-3), as the words its hash reads:
    for murmur3 the little-endian 8-byte words of its ASCII string
    (``ceil(k / 8)`` of them), for tpufast its one 2-bit packing."""
    m = cs.shape[0] - k + 1
    fwd = torch.zeros(m, dtype=torch.int64, device=cs.device)
    rev = torch.zeros_like(fwd)
    for j in range(k):
        c = cs[j:j + m]
        fwd = fwd | (c << (2 * (k - 1 - j)))
        rev = rev | ((3 - c) << (2 * j))
    # A<C<G<T in both code and ASCII order, so the packed-integer
    # compare is the lexicographic string compare (unsigned: at k = 32
    # the packs use the sign bit)
    use_fwd = bias(fwd) <= bias(rev)
    if algo == "tpufast":
        return (torch.where(use_fwd, fwd, rev),)
    if algo != "murmur3":
        raise ValueError(f"unknown hash algorithm {algo!r}")
    lut = torch.tensor(_ASCII, dtype=torch.int64, device=cs.device)
    af = lut[cs]
    ar = lut[3 - cs]
    words = []
    for lo in range(0, k, 8):
        wf = torch.zeros_like(fwd)
        wr = torch.zeros_like(fwd)
        for b in range(lo, min(lo + 8, k)):
            # byte b of the forward string, and of the reverse
            # complement (the complement of base k-1-b)
            wf = wf | (af[b:b + m] << (8 * (b - lo)))
            wr = wr | (ar[k - 1 - b:k - 1 - b + m] << (8 * (b - lo)))
        words.append(torch.where(use_fwd, wf, wr))
    return tuple(words)


def hash_key_words(words, k: int, algo: str) -> torch.Tensor:
    """Unbiased int64 hashes (u64 bits) of canonical key words."""
    if algo == "tpufast":
        return tpufast_mix(words[0])
    return murmur3_h1_words(words, k)


def masked_hashes(words, valid: torch.Tensor, k: int,
                  algo: str) -> torch.Tensor:
    """Biased hashes of windows given as their canonical key words and
    mask, the sentinel where the mask is false."""
    h = hash_key_words(words, k, algo)
    return torch.where(valid, bias(h),
                       torch.full_like(h, SENTINEL_BIASED))


def _window_chunks(codes_np: np.ndarray, contig_offsets: np.ndarray,
                   k: int, device: torch.device, chunk: int):
    """(s, e, cs, valid) for each chunk [s, e) of a sequence's windows:
    the sanitized int64 codes the chunk's windows read, and the mask of
    windows holding no ambiguous base and crossing no contig
    boundary."""
    n = codes_np.shape[0]
    codes = torch.from_numpy(codes_np).to(device)
    amb = codes == 255
    cs = torch.where(amb, torch.zeros_like(codes), codes).to(torch.int64)
    inv = torch.zeros(n + 1, dtype=torch.int32, device=device)
    inv[1:] = torch.cumsum(amb.to(torch.int32), 0)
    offs = np.asarray(contig_offsets[1:-1], dtype=np.int64)
    offs = offs[(offs > 0) & (offs < n)]
    start = torch.zeros(n, dtype=torch.int32, device=device)
    start[torch.from_numpy(offs).to(device)] = 1
    contig = torch.cumsum(start, 0)
    for s in range(0, n - k + 1, chunk):
        e = min(s + chunk, n - k + 1)
        valid = ((inv[s + k:e + k] == inv[s:e])
                 & (contig[s:e] == contig[s + k - 1:e + k - 1]))
        yield s, e, cs[s:e + k - 1], valid


def positional_hashes(genome: Genome, k: int, device="cuda",
                      algo: str = "murmur3",
                      chunk: int = DEFAULT_CHUNK,
                      k21_hash=None) -> torch.Tensor:
    """All canonical k-mer hashes of `genome` in genome order: a biased
    int64 (n - k + 1,) tensor on `device`, the sentinel where the window
    holds an ambiguous base or crosses a contig boundary. At k=21 with
    murmur3 the genome's codes go to the device once and each chunk of
    windows to `k21_hash(codes, starts, win0, n_win)`, by default
    ``ops/murmur3_k21.murmur3_k21`` (its kernel on cuda); at k=15, with
    either hash, to ``ops/positional_hashes.positional_hashes`` (its
    kernel on cuda)."""
    if not 1 <= k <= MAX_KMER:
        raise ValueError(f"k must be in [1, {MAX_KMER}], got {k}")
    device = resolve_device(device)
    n = genome.codes.shape[0]
    if n < k:
        return torch.zeros(0, dtype=torch.int64, device=device)
    n_win = n - k + 1
    hash_fn = None
    if k == 15:
        from galah_tpu_torch.ops import positional_hashes as k15
        hash_fn = functools.partial(k15.positional_hashes, algo=algo)
    elif algo == "murmur3" and k == 21:
        from galah_tpu_torch.ops.murmur3_k21 import murmur3_k21
        hash_fn = k21_hash or murmur3_k21
    if hash_fn is not None:
        codes = torch.from_numpy(genome.codes).to(device)
        starts = torch.from_numpy(np.asarray(genome.contig_offsets,
                                             dtype=np.int64)).to(device)
        parts = [hash_fn(codes, starts, s, min(chunk, n_win - s))
                 for s in range(0, n_win, chunk)]
        return parts[0] if len(parts) == 1 else torch.cat(parts)
    out = torch.empty(n_win, dtype=torch.int64, device=device)
    for s, e, cs, valid in _window_chunks(genome.codes,
                                          genome.contig_offsets, k,
                                          device, chunk):
        out[s:e] = masked_hashes(_key_words(cs, k, algo), valid, k, algo)
    return out


def canonical_key_words(codes: np.ndarray, contig_offsets: np.ndarray,
                        k: int, device="cuda", algo: str = "murmur3",
                        chunk: int = DEFAULT_CHUNK):
    """(words, valid) over the ``n - k + 1`` windows of a sequence given
    as a genome's codes and contig offsets (a launch group's genomes,
    concatenated, each start a contig boundary): the
    canonical key words each window's hash reads (``_key_words``:
    ``ceil(k / 8)`` for murmur3, one for tpufast) and the window mask
    of ``positional_hashes``. The preamble of the sketch kernels' plain
    versions (``ops/fused_sketch.py``, ``ops/murmur3_k21.py``)."""
    if not 1 <= k <= MAX_KMER:
        raise ValueError(f"k must be in [1, {MAX_KMER}], got {k}")
    if algo not in ("murmur3", "tpufast"):
        raise ValueError(f"unknown hash algorithm {algo!r}")
    device = resolve_device(device)
    n_win = max(codes.shape[0] - k + 1, 0)
    n_words = -(-k // 8) if algo == "murmur3" else 1
    words = tuple(torch.empty(n_win, dtype=torch.int64, device=device)
                  for _ in range(n_words))
    valid = torch.zeros(n_win, dtype=torch.bool, device=device)
    for s, e, cs, v in _window_chunks(codes, contig_offsets, k, device,
                                      chunk):
        for w, piece in zip(words, _key_words(cs, k, algo)):
            w[s:e] = piece
        valid[s:e] = v
    return words, valid
