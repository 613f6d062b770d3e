"""Port parity: FASTA ingest, positional hashes and profiles.

The same seeded inputs go through galah_tpu and galah_tpu_torch (on the
CPU). Tolerance: none — codes, offsets, stats and every 64-bit hash
must be equal bit for bit (the port holds hashes as biased int64,
converted back to uint64 before comparing).
"""

import dataclasses
import gzip

import numpy as np
import pytest
import torch

from galah_tpu.io.fasta import read_genome_numpy
from galah_tpu.ops import fragment_ani as jfa
from galah_tpu_torch import convert
from galah_tpu_torch.io.fasta import read_genome
from galah_tpu_torch.ops import fragment_ani as tfa
from galah_tpu_torch.ops import hashing
from galah_tpu_torch.ops.u64 import from_biased, to_biased

CPU = torch.device("cpu")

FASTA_CASES = [
    b">a\nACGT\nacgtN\n>b\n\n  GGCC  \r\n>c\n>d\nTTTT",
    b"ACGT\n>x desc\nAC GT\n\n\n>y\nNNNN\n",
    b">only\n",
    b">a\r\nAC\r\nGT\r\n",
    b"  >h\nACGTX\n\t\n>h2\nA",
]


@pytest.mark.parametrize("gz", [False, True])
@pytest.mark.parametrize("case", range(len(FASTA_CASES)))
def test_read_genome_matches_numpy_reader(tmp_path, case, gz):
    """Codes, contig offsets and stats equal the JAX package's numpy
    reader: multi-contig, blank and CRLF lines, leading sequence before
    the first record, ambiguous bases (code 255), gzip."""
    data = FASTA_CASES[case]
    p = tmp_path / "g.fa"
    p.write_bytes(gzip.compress(data) if gz else data)
    want = read_genome_numpy(str(p))
    got = read_genome(str(p))
    np.testing.assert_array_equal(got.codes, want.codes)
    np.testing.assert_array_equal(got.contig_offsets, want.contig_offsets)
    assert dataclasses.astuple(got.stats) == dataclasses.astuple(want.stats)


def test_read_genome_no_records_raises(tmp_path):
    p = tmp_path / "empty.fa"
    p.write_bytes(b"ACGT\n\n")
    with pytest.raises(ValueError, match="no FASTA records"):
        read_genome(str(p))


def _random_fasta(path, seed, n_contigs=4, max_len=3000):
    rng = np.random.default_rng(seed)
    letters = np.array(list("ACGTNacgt"))
    with open(path, "w") as f:
        for c in range(n_contigs):
            n = int(rng.integers(1, max_len))
            s = letters[rng.choice(9, size=n, p=[.2, .2, .2, .2, .04,
                                                  .04, .04, .04, .04])]
            # a run of Ns inside the contig
            s[n // 3: n // 3 + 7] = "N"
            f.write(f">c{c}\n" + "".join(s) + "\n")
        f.write(">empty\n>short\nAC\n")


@pytest.mark.parametrize("algo", ["murmur3", "tpufast"])
@pytest.mark.parametrize("k", [15, 21, 5])
def test_positional_hashes_bit_identical(tmp_path, algo, k):
    """Multi-contig genome with N runs and empty/short contigs; the
    port's small chunk forces the overlap path. Compared with the JAX
    package's C walker and its JAX chunk pipeline."""
    p = str(tmp_path / "g.fa")
    _random_fasta(p, seed=k)
    jg = read_genome_numpy(p)
    got = from_biased(hashing.positional_hashes(read_genome(p), k, CPU,
                                                algo=algo, chunk=777))
    np.testing.assert_array_equal(
        got, jfa.positional_hashes(jg, k, algo=algo))
    np.testing.assert_array_equal(
        got, jfa.positional_hashes(jg, k, algo=algo, chunk=1 << 16))


def test_short_genome_has_no_hashes(tmp_path):
    p = tmp_path / "s.fa"
    p.write_bytes(b">s\nACGT\n")
    assert hashing.positional_hashes(read_genome(str(p)), 15,
                                     CPU).numel() == 0


@pytest.mark.parametrize("seed", [0, 1])
def test_profile_arrays_equal_via_convert(tmp_path, seed):
    """flat hashes, distinct set and markers of a port profile equal
    galah_tpu's; convert round-trips them; the port's sorted query
    holds the same hashes and per-window counts as galah_tpu's."""
    p = str(tmp_path / "g.fa")
    _random_fasta(p, seed=seed, n_contigs=6, max_len=20_000)
    jp = jfa.build_profile(read_genome_numpy(p), k=15, fraglen=3000)
    tp = tfa.build_profile(read_genome(p), k=15, fraglen=3000, device=CPU)
    fields = convert.profile_to_galah_fields(tp)
    for name in ("flat_hashes", "ref_set", "markers"):
        np.testing.assert_array_equal(fields[name], getattr(jp, name))
    back = convert.profile_from_galah(jp)
    for name in ("flat_hashes", "ref_set", "markers"):
        assert torch.equal(getattr(back, name), getattr(tp, name))
    jqh, jqw, jtot = jp.sorted_query()
    tqh, tqw, ttot = tp.sorted_query()
    np.testing.assert_array_equal(from_biased(tqh), jqh)
    np.testing.assert_array_equal(ttot.numpy(), jtot)
    # equal hashes may sit in any window order: compare (hash, window)
    # pairs as multisets
    j_pairs = np.lexsort((jqw, jqh))
    t_pairs = np.lexsort((tqw.numpy(), from_biased(tqh)))
    np.testing.assert_array_equal(tqw.numpy()[t_pairs], jqw[j_pairs])


def test_ani_subsample_rejected(tmp_path):
    """Out of [1, 1000] the subsample is rejected with galah_tpu's
    message; inside it the profile builds (c = 125, skani's own)."""
    p = str(tmp_path / "g.fa")
    _random_fasta(p, seed=3)
    for c in (0, 1001):
        with pytest.raises(ValueError,
                           match=rf"subsample_c must be in \[1, 1000\], "
                                 rf"got {c}"):
            tfa.build_profile(read_genome(p), k=15, fraglen=3000,
                              device=CPU, subsample_c=c)
    prof = tfa.build_profile(read_genome(p), k=15, fraglen=3000, device=CPU,
                             subsample_c=125)
    assert prof.subsample_c == 125
    assert prof.ref_set.shape[0] < prof.flat_hashes.shape[0]


def test_biased_order_is_unsigned_order():
    """The biased int64 form sorts, searches and compares exactly like
    the uint64 values, and the sentinel sorts last."""
    rng = np.random.default_rng(5)
    u = rng.integers(0, 2**64 - 1, size=1000, dtype=np.uint64)
    u = np.concatenate([u, np.array([0, 2**63 - 1, 2**63, 2**64 - 1],
                                    dtype=np.uint64)])
    t = to_biased(u)
    np.testing.assert_array_equal(from_biased(torch.sort(t).values),
                                  np.sort(u))
    np.testing.assert_array_equal(from_biased(t), u)
    assert int(t.max()) == (1 << 63) - 1
