"""Port parity: the marker screen and exact fragment ANI.

Profiles are built once by galah_tpu and carried into the port with
``convert``, so both sides score identical state. Tolerance: pair lists
equal; DirectedANI and bidirectional ANI floats equal with ``==`` (the
port keeps galah_tpu's float64 reduction order on the host).
"""

import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import jax

from galah_tpu.backends.fragment_backend import SkaniPreclusterer
from galah_tpu.io.fasta import read_genome_numpy
from galah_tpu.ops import fragment_ani as jfa
from galah_tpu.ops import pairwise as jpw
from galah_tpu_torch import convert
from galah_tpu_torch.backends import ProfileStore
from galah_tpu_torch.backends import SkaniPreclusterer as TSkaniPre
from galah_tpu_torch.ops import fragment_ani as tfa
from galah_tpu_torch.ops import pairwise as tpw
from galah_tpu_torch.ops.window_hits import window_element_hits_plain

CPU = torch.device("cpu")
ACGT = np.array(list("ACGT"))


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """4 families x 3 members of 30 kb (~1-3% divergence) plus two
    unrelated genomes, one of them 120 kb and sharing a 6 kb block with
    family 0 (a marginal, asymmetric pair at the gate)."""
    root = tmp_path_factory.mktemp("ani")
    rng = np.random.default_rng(11)
    paths = []

    def write(name, codes):
        p = root / f"{name}.fna"
        p.write_text(">c1\n" + "".join(ACGT[codes[:len(codes) // 2]])
                     + "\n>c2\n" + "".join(ACGT[codes[len(codes) // 2:]])
                     + "\n")
        paths.append(str(p))

    bases = []
    for fam in range(4):
        base = rng.integers(0, 4, size=30_000)
        bases.append(base)
        for m in range(3):
            codes = base.copy()
            sites = rng.random(codes.size) < 0.01 * (m + 1)
            codes[sites] = (codes[sites] + rng.integers(
                1, 4, size=int(sites.sum()))) % 4
            write(f"f{fam}m{m}", codes)
    write("loner", rng.integers(0, 4, size=30_000))
    chimera = rng.integers(0, 4, size=120_000)
    chimera[:6000] = bases[0][:6000]
    write("chimera", chimera)
    jprofs = [jfa.build_profile(read_genome_numpy(p), k=15, fraglen=3000)
              for p in paths]
    tprofs = [convert.profile_from_galah(p) for p in jprofs]
    return paths, jprofs, tprofs


def _one_device_mesh():
    return Mesh(np.array(jax.devices()[:1]), ("i",))


@pytest.mark.parametrize("c_floor", [0.80 ** 15, 0.3, 0.9])
def test_screen_pairs_match(corpus, c_floor):
    paths, jprofs, tprofs = corpus
    jmat, jcounts = SkaniPreclusterer(0.95, 0.15)._marker_matrix(
        jprofs, len(jprofs))
    tmat, tcounts = TSkaniPre(0.95, 0.15, ProfileStore(CPU)).marker_matrix(
        tprofs)
    np.testing.assert_array_equal(tcounts, jcounts)
    want = jpw.screen_pairs(jmat, jcounts, c_floor,
                            mesh=_one_device_mesh())
    got = tpw.screen_pairs(tmat, tcounts, c_floor)
    assert got == want
    # a tiny row tile and capacity force several row blocks and the
    # overflow rerun; the pair list is the same
    assert tpw.screen_pairs(tmat, tcounts, c_floor, row_tile=4,
                            col_tile=8, cap_per_row=1) == want


def test_stats_to_ani_and_jaccard_match():
    common = np.array([0, 1, 500, 999, 1000])
    total = np.array([1000, 1000, 1000, 1000, 1000])
    np.testing.assert_array_equal(tpw.stats_to_ani_f64(common, total, 21),
                                  jpw.stats_to_ani_f64(common, total, 21))
    for ani in (0.9, 0.95, 0.99):
        assert tpw.ani_to_jaccard(ani, 21) == jpw.ani_to_jaccard(ani, 21)


def test_directed_and_bidirectional_ani_bit_identical(corpus):
    paths, jprofs, tprofs = corpus
    n = len(paths)
    idx = [(i, j) for i in range(n) for j in range(i + 1, n)]
    for maf in (0.15, 0.5):
        want = jfa.bidirectional_ani_values(
            [(jprofs[i], jprofs[j]) for i, j in idx], maf)
        got = tfa.bidirectional_ani_values(
            [(tprofs[i], tprofs[j]) for i, j in idx], maf)
        assert got == want
    directed = idx + [(j, i) for i, j in idx]
    jd = jfa.directed_ani_batch([(jprofs[a], jprofs[b])
                                 for a, b in directed])
    td = tfa.directed_ani_batch([(tprofs[a], tprofs[b])
                                 for a, b in directed])
    assert [(d.ani, d.aligned_fraction, d.frags_matching, d.frags_total)
            for d in td] == \
        [(d.ani, d.aligned_fraction, d.frags_matching, d.frags_total)
         for d in jd]
    assert any(v is not None and v > 0.95 for v in got)


def test_launch_packing_does_not_change_values(corpus, monkeypatch):
    """A launch cap of a few thousand elements splits the batch into
    many window_hits calls; every float stays the same."""
    _paths, _j, tprofs = corpus
    pairs = [(tprofs[i], tprofs[j]) for i in range(6) for j in range(6)
             if i != j]
    whole = tfa.directed_ani_arrays(pairs)
    monkeypatch.setattr(tfa, "LAUNCH_ELEM_CAP", 5000)
    calls = []

    def counting(items, device):
        calls.append(len(items))
        return window_element_hits_plain(items, device)

    split = tfa.directed_ani_arrays(pairs, hits=counting)
    assert len(calls) > 1
    for a, b in zip(whole, split):
        np.testing.assert_array_equal(a, b)


def test_repeat_hazard_warns(corpus):
    """The chimera shares one 6 kb block with family 0: aligned
    fractions 2/10 and 2/40 pass the 0.15 gate marginally and
    asymmetrically, with a warning."""
    paths, jprofs, tprofs = corpus
    f0, chim = 0, len(paths) - 1
    with pytest.warns(RuntimeWarning, match="marginally"):
        got = tfa.bidirectional_ani_values([(tprofs[f0], tprofs[chim])],
                                           0.15)
    want = jfa.bidirectional_ani_values([(jprofs[f0], jprofs[chim])],
                                        0.15)
    assert got == want and got[0] is not None
