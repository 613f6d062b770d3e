"""Port parity of the two kernels' plain torch versions.

``window_element_hits_plain`` and ``tile_stats_plain`` /
``tile_intersect_plain`` are what the CUDA kernels are held against on
the card; here, on the CPU, they are held against galah_tpu: the
Pallas kernels in interpret mode and their XLA twins. Tolerance: none — every int32 flag and count
must be equal. Tests of the CUDA kernels themselves need the card and
run in chip_smoke.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from galah_tpu.ops import fragment_ani as jfa
from galah_tpu.ops import pairwise as jpw
from galah_tpu.ops import pallas_fragment as jpf
from galah_tpu.ops import pallas_pairwise as jpp
from galah_tpu.ops.constants import SENTINEL
from galah_tpu_torch.kernels import LAUNCHES
from galah_tpu_torch.ops import tile_stats as tts
from galah_tpu_torch.ops import window_hits as twh
from galah_tpu_torch.ops.u64 import to_biased

CPU = torch.device("cpu")


def _pair(rng, n_ref, n_q, hit_frac=0.5):
    """(sorted query with duplicates, sorted distinct ref) as uint64."""
    ref = np.unique(rng.integers(0, 2**64 - 2, size=n_ref,
                                 dtype=np.uint64))
    n_hit = int(n_q * hit_frac) if ref.size else 0
    q = np.concatenate([
        ref[rng.integers(0, max(ref.size, 1), size=n_hit)],
        rng.integers(0, 2**64 - 2, size=n_q - n_hit, dtype=np.uint64)])
    q = np.sort(np.concatenate([q, q[: n_q // 10]]))
    return q, ref


@pytest.mark.parametrize("seed", [0, 1])
def test_window_element_hits_plain_matches_pallas_interpret(seed):
    """Random sorted sets, duplicate query values, a reference shorter
    than one block, an empty query and an empty reference, packed into
    one call; per-element flags equal the Pallas kernel's."""
    rng = np.random.default_rng(seed)
    shapes = [(3000, 2500), (50, 700), (1500, 0), (0, 40), (5000, 1200)]
    raw = [_pair(rng, nr, nq) for nr, nq in shapes]
    jitems = [(q, r, jfa.pad_ref_set(r)) for q, r in raw]
    want = jpf.window_element_hits(jitems, interpret=True)
    titems = [(to_biased(q), to_biased(r)) for q, r in raw]
    before = LAUNCHES["window_hits"]
    got = torch.split(twh.window_element_hits(titems, CPU),
                      [q.numel() for q, _ in titems])
    assert LAUNCHES["window_hits"] == before  # no kernel on the CPU
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)


def test_window_hits_sentinel_query_never_hits():
    ref = np.array([1, 2**64 - 1], dtype=np.uint64)
    q = np.array([1, 2**64 - 1], dtype=np.uint64)
    got = twh.window_element_hits_plain([(to_biased(q), to_biased(ref))], CPU)
    assert got.tolist() == [1, 0]


def test_window_hits_folded_counts_match_xla_twin(tmp_path):
    """Flags folded per window (the exact-ANI stage's bincount) equal
    galah_tpu's searchsorted window counts on a real profile pair."""
    from galah_tpu.io.fasta import read_genome_numpy
    from galah_tpu_torch import convert

    rng = np.random.default_rng(7)
    base = rng.integers(0, 4, size=30_000)
    paths = []
    for m in range(2):
        codes = base.copy()
        sites = rng.random(codes.size) < 0.02
        codes[sites] = (codes[sites] + 1) % 4
        p = tmp_path / f"g{m}.fa"
        p.write_text(">c\n" + "".join(np.array(list("ACGT"))[codes]) + "\n")
        paths.append(str(p))
    jq, jr = (jfa.build_profile(read_genome_numpy(p), k=15, fraglen=3000)
              for p in paths)
    matched, total = jfa._window_match_counts_impl(
        jnp.asarray(jq.windows()), jnp.asarray(jr.padded_ref_set()))
    tq, tr = (convert.profile_from_galah(x) for x in (jq, jr))
    qh, qw, totals = tq.sorted_query()
    flags = twh.window_element_hits([(qh, tr.ref_set)], CPU)
    counts = torch.bincount(qw[flags != 0].long(),
                            minlength=tq.n_windows)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(matched))
    np.testing.assert_array_equal(totals.numpy(), np.asarray(total))


def _sketch_rows(rng, n, k, pool):
    """n sorted SENTINEL-padded uint64 rows of width k, drawing from a
    shared pool so rows intersect; some rows full, some empty."""
    m = np.full((n, k), np.uint64(SENTINEL), dtype=np.uint64)
    for i in range(n):
        cnt = k if i % 5 == 0 else int(rng.integers(0, k + 1))
        m[i, :cnt] = np.sort(rng.choice(pool, size=cnt, replace=False))
    return m


@pytest.mark.parametrize("k,br,bc", [(100, 9, 13), (256, 5, 7)])
def test_tile_stats_plain_matches_xla_and_pallas(k, br, bc):
    """Br, Bc not multiples of 8 or 128; full and intersect forms."""
    rng = np.random.default_rng(k)
    pool = np.unique(rng.integers(0, 2**64 - 2, size=3 * k,
                                  dtype=np.uint64))
    rows, cols = _sketch_rows(rng, br, k, pool), _sketch_rows(rng, bc, k,
                                                              pool)
    trows, tcols = to_biased(rows), to_biased(cols)
    for sketch_size in (k, k // 2):
        jc, jt = jpw.tile_stats(jnp.asarray(rows), jnp.asarray(cols),
                                sketch_size, 21)
        tc, tt = tts.tile_stats(trows, tcols, sketch_size)
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    ic, itot = tts.tile_stats(trows, tcols, k, intersect=True)
    np.testing.assert_array_equal(
        ic.numpy(), np.asarray(jpw.tile_intersect_counts(
            jnp.asarray(rows), jnp.asarray(cols))))
    if k <= 128:
        # the Pallas kernel in interpret mode (compiles for seconds per
        # width, so one width)
        pc, pt = jpp.tile_stats_pallas(jnp.asarray(rows),
                                       jnp.asarray(cols), k,
                                       interpret=True)
        tc, tt = tts.tile_stats(trows, tcols, k)
        np.testing.assert_array_equal(tc.numpy(), np.asarray(pc))
        np.testing.assert_array_equal(tt.numpy(), np.asarray(pt))
        np.testing.assert_array_equal(
            ic.numpy(), np.asarray(jpp.tile_intersect_pallas(
                jnp.asarray(rows), jnp.asarray(cols), interpret=True)))
    np.testing.assert_array_equal(
        itot.numpy(), np.broadcast_to(
            (rows != np.uint64(SENTINEL)).sum(axis=1)[:, None], (br, bc)))


def test_tile_stats_rejects_bad_inputs():
    a = torch.zeros(3, 4, dtype=torch.int64)
    with pytest.raises(ValueError):
        tts.tile_stats(a, torch.zeros(3, 5, dtype=torch.int64), 4)
    with pytest.raises(ValueError):
        tts.tile_stats(a.to(torch.int32), a.to(torch.int32), 4)
    with pytest.raises(ValueError):
        twh.window_element_hits([(a[0], a[1].to(torch.int32))], CPU)
