"""Port parity of the finch sketch stage: key words, the fused
candidate file's plain version, certified fused sketches, the exact
sketcher, the streaming sketch stage and the Mash distance, against
galah_tpu on the same numpy-seeded inputs.

Tolerance: none. Hashes and sketches are uint64 and must be equal bit
for bit; ANIs are float64 and must be equal. The fused kernel itself
needs the card and is held against ``fused_candidates_plain`` by
chip_smoke.py; here, on the CPU, the wrapper runs that plain version
(tests/test_torch_sketch_codes.py holds it against galah_tpu on edge
genomes).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from galah_tpu.io import read_genome as jread
from galah_tpu.ops import hashing as jhash
from galah_tpu.ops import minhash as jmh
from galah_tpu.ops import minhash_np as jmnp
from galah_tpu.ops import sketch_stream as jss
from galah_tpu_torch import convert
from galah_tpu_torch.backends import SketchStore
from galah_tpu_torch.io.fasta import read_genome
from galah_tpu_torch.kernels import LAUNCHES
from galah_tpu_torch.ops import fused_sketch as tfs
from galah_tpu_torch.ops import hashing as thash
from galah_tpu_torch.ops import minhash as tmh
from galah_tpu_torch.ops import minhash_np as tmnp
from galah_tpu_torch.ops import sketch_stream as tss
from galah_tpu_torch.ops.u64 import from_biased
from galah_tpu_torch.timing import StageClock

CPU = torch.device("cpu")
ACGT = np.array(list("ACGT"))


def _seq(rng, n):
    return "".join(ACGT[rng.integers(0, 4, size=n)])


def _write(tmp_path, name, body):
    p = tmp_path / name
    p.write_text(body)
    return str(p)


@pytest.fixture(scope="module")
def edge_paths(tmp_path_factory):
    """The edge bodies of tests/test_sketch_stream.py (two contigs and
    an N, a contig shorter than k, all-ambiguous, shorter than k, fewer
    distinct k-mers than the sketch size), a genome of a repeated 5 kb
    unit, and a 60 kb genome whose candidate file is suspect at sketch
    size 4096."""
    d = tmp_path_factory.mktemp("edge")
    rng = np.random.default_rng(11)
    unit = _seq(rng, 5000)
    bodies = {
        "normal.fna": (f">a\n{_seq(rng, 1500)}N{_seq(rng, 1500)}\n>b\n"
                       f"{_seq(rng, 40)}\n"),
        "subk.fna": f">tiny\n{_seq(rng, 10)}\n>real\n{_seq(rng, 800)}\n",
        "alln.fna": ">n\n" + "N" * 500 + "\n",
        "short.fna": ">s\nACGTA\n",
        "sparse.fna": f">p\n{_seq(rng, 60)}\n",
        "repeat.fna": f">r\n{unit * 12}\n",
        "suspect.fna": ">x\n" + "".join(ACGT[np.random.default_rng(2)
                                            .integers(0, 4, 60_000)]) + "\n",
    }
    return [_write(d, n, b) for n, b in sorted(bodies.items())]


@pytest.mark.parametrize("algo", ["murmur3", "tpufast"])
def test_key_words_match_galah_tpu(tmp_path, algo):
    """Canonical key words and window mask of a genome with contig
    breaks and N runs equal galah_tpu's canonical_kmer_words."""
    rng = np.random.default_rng(3)
    p = _write(tmp_path, "g.fna",
               f">a\n{_seq(rng, 3000)}NN{_seq(rng, 2000)}\n>b\n"
               f"{_seq(rng, 15)}\n>c\n{_seq(rng, 4000)}\n")
    g = read_genome(p)
    words, valid = thash.canonical_key_words(g.codes, g.contig_offsets, 21,
                                             CPU, algo)
    codes = jnp.asarray(g.codes)
    offs = np.asarray(g.contig_offsets[1:-1], dtype=np.int32)
    jwords, jvalid = jhash.canonical_kmer_words(
        jnp.where(codes == 255, jnp.uint8(0), codes), codes != 255,
        jnp.asarray(offs), jnp.int32(0), 21, algo)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))
    assert len(words) == len(jwords)
    for w, jw in zip(words, jwords):
        np.testing.assert_array_equal(w.numpy().view(np.uint64),
                                      np.asarray(jw))


@pytest.mark.parametrize("algo", ["murmur3", "tpufast"])
def test_fused_candidates_plain_match_pallas_interpret(edge_paths, algo):
    """The candidate file's plain version equals galah_tpu's fused
    Pallas kernel (interpret mode, span 1) on one job holding a
    repeated unit, an N and the tail of a random genome."""
    g = read_genome(edge_paths[2])  # normal.fna
    rep = read_genome(edge_paths[3])  # repeat.fna
    codes = np.concatenate([rep.codes, g.codes])[:65_000]
    offsets = np.array([0, rep.codes.shape[0], codes.shape[0]])
    words, valid = thash.canonical_key_words(codes, offsets, 21, CPU, algo)
    n = valid.shape[0]
    before = LAUNCHES["fused_sketch"]
    got = tfs.fused_sketch_candidates(torch.from_numpy(codes),
                                      torch.from_numpy(offsets), [(0, n)],
                                      21, algo)
    assert LAUNCHES["fused_sketch"] == before  # no kernel on the CPU
    width = 512 * 128

    def pad(t):
        out = np.zeros((1, width), dtype=t.numpy().dtype)
        out[0, :n] = t.numpy()
        return out

    want = jss.fused_sketch_candidates(
        tuple(jnp.asarray(pad(w).view(np.uint64)) for w in words),
        jnp.asarray(pad(valid)), algo=algo, interpret=True)
    np.testing.assert_array_equal(from_biased(got), np.asarray(want))


def test_fused_sketches_match_galah_tpu_fused_and_numpy(edge_paths):
    """Port fused sketches (plain candidates) equal galah_tpu's fused
    path (interpret mode) and the numpy oracle at sketch size 4096,
    where the 60 kb genome's file is suspect: both flag the same jobs
    and re-sketch them exactly."""
    tg = [read_genome(p) for p in edge_paths]
    jg = [jread(p) for p in edge_paths]
    clock = StageClock(CPU)
    got = tss.sketch_genomes_fused(tg, sketch_size=4096, device=CPU,
                                   clock=clock)
    want = jss.sketch_genomes_fused(jg, sketch_size=4096, interpret=True)
    for a, b, g in zip(got, want, jg):
        np.testing.assert_array_equal(a.hashes, b.hashes)
        np.testing.assert_array_equal(
            a.hashes, jmnp.sketch_genome(g, sketch_size=4096).hashes)

    # the certificate, job by job (galah_tpu's group dispatch is cached
    # from the call above)
    ((idxs, packed, ambits, offs, span),) = jss._pack_fused(jg)[1]
    _, jsusp = jss._fused_group_sketch(
        jnp.asarray(packed), jnp.asarray(ambits), jnp.asarray(offs), k=21,
        seed=0, algo="murmur3", sketch_size=4096, span=span,
        interpret=True)
    want_susp = np.asarray(jsusp)[:len(idxs)]
    codes, offsets, jobs = tss._concat(tg, 21)
    _, susp = tss.certify(
        tfs.fused_sketch_candidates(torch.from_numpy(codes),
                                    torch.from_numpy(offsets), jobs, 21,
                                    "murmur3"),
        4096)
    np.testing.assert_array_equal(susp.numpy()[idxs], want_susp)
    assert want_susp.sum() >= 1  # the input does force a re-sketch
    assert clock.counts["sketch-fused-suspect"] == want_susp.sum()
    assert clock.counts["sketch-fused-jobs"] == len(tg)


@pytest.mark.parametrize("algo,sketch_size", [("murmur3", 64),
                                              ("tpufast", 64),
                                              ("tpufast", 4096)])
def test_fused_and_exact_sketches_match_galah_tpu(edge_paths, algo,
                                                  sketch_size):
    """Fused and exact port sketches equal galah_tpu's batched device
    sketcher (murmur3 also the numpy oracle)."""
    tg = [read_genome(p) for p in edge_paths]
    jg = [jread(p) for p in edge_paths]
    want = jmh.sketch_genomes_device_batch(jg, sketch_size=sketch_size,
                                           algo=algo)
    fused = tss.sketch_genomes_fused(tg, sketch_size, algo=algo,
                                     device=CPU)
    exact = tmh.sketch_genomes_device_batch(tg, sketch_size, algo=algo,
                                            device=CPU)
    for f, e, w, g in zip(fused, exact, want, jg):
        np.testing.assert_array_equal(f.hashes, w.hashes)
        np.testing.assert_array_equal(e.hashes, w.hashes)
        if algo == "murmur3":
            np.testing.assert_array_equal(
                f.hashes, jmnp.sketch_genome(g, sketch_size).hashes)


def test_sketch_size_beyond_certificate_takes_exact_path(edge_paths):
    """Above a quarter of the candidate file the fused path launches
    nothing and returns the exact sketches."""
    tg = [read_genome(p) for p in edge_paths[-2:]]
    clock = StageClock(CPU)
    got = tss.sketch_genomes_fused(tg, 5000, device=CPU, clock=clock)
    assert "sketch-fused-launches" not in clock.counts
    for s, g in zip(got, edge_paths[-2:]):
        np.testing.assert_array_equal(
            s.hashes, jmnp.sketch_genome(jread(g), sketch_size=5000).hashes)


def test_iter_path_sketches_order_dedupe_and_store(edge_paths):
    """Unique paths in path order; sketches already in the store are
    not read again; duplicates share one sketch."""
    store = SketchStore(CPU, sketch_size=64)
    first = edge_paths[0]
    store.insert(first, tmnp.MinHashSketch(
        np.zeros(0, np.uint64), 64, 21))
    paths = edge_paths[::-1] + edge_paths[:3]
    got = list(tss.iter_path_sketches(paths, store))
    assert [p for p, _ in got] == list(dict.fromkeys(paths))
    assert store.clock.counts["genomes-read"] == len(edge_paths) - 1
    by_path = dict(got)
    assert by_path[first].size == 0
    for p in edge_paths[1:]:
        np.testing.assert_array_equal(
            by_path[p].hashes,
            jmnp.sketch_genome(jread(p), sketch_size=64).hashes)
        assert store.get_cached(p) is by_path[p]


def test_sketch_matrix_and_mash_ani_match_galah_tpu(edge_paths):
    """The (N, K) sketch matrix converts to galah_tpu's bit for bit, and
    Mash ANI over every sketch pair is equal."""
    jsk = [jmnp.sketch_genome(jread(p), sketch_size=1000)
           for p in edge_paths]
    tsk = [tmnp.MinHashSketch(s.hashes, s.sketch_size, s.kmer)
           for s in jsk]
    mat = tmh.sketch_matrix(tsk, 1000, CPU)
    want = jmh.sketch_matrix(jsk, sketch_size=1000)
    np.testing.assert_array_equal(convert.sketch_matrix_to_galah(mat), want)
    assert torch.equal(convert.sketch_matrix_from_galah(want), mat)
    for i in range(len(jsk)):
        for j in range(len(jsk)):
            assert tmnp.mash_ani(tsk[i], tsk[j]) == jmnp.mash_ani(jsk[i],
                                                                  jsk[j])


def test_fused_sketch_rejects_bad_inputs():
    c = torch.zeros(30, dtype=torch.uint8)
    st = torch.tensor([0, 30])
    with pytest.raises(ValueError):  # codes must be uint8
        tfs.fused_sketch_candidates(c.long(), st, [(0, 10)], 21, "murmur3")
    with pytest.raises(ValueError):  # k-mers of 1 to 32 bases
        tfs.fused_sketch_candidates(c, st, [(0, 10)], 33, "murmur3")
    # murmur3 takes any k of that range (dist --kmer-length)
    assert tfs.fused_sketch_candidates(c, st, [(0, 10)], 15,
                                       "murmur3").shape == (1, 8, 2048)
    with pytest.raises(ValueError):  # job outside the windows
        tfs.fused_sketch_candidates(c, st, [(5, 6)], 21, "tpufast")
    with pytest.raises(ValueError):  # starts must be int64
        tfs.fused_sketch_candidates(c, st.int(), [(0, 9)], 21, "tpufast")
    with pytest.raises(ValueError):
        thash.canonical_key_words(np.zeros(30, np.uint8),
                                  np.array([0, 30]), 33, CPU, "murmur3")
