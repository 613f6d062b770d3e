"""Port parity of quality ordering: the three parsers, the four
formulas, the completeness and contamination filters, tie order, the
conflicting-input errors and the stats-only read, against
galah_tpu.quality and galah_tpu.api.quality_order_genomes on the same
files.

Tolerance: none. Tables must hold equal values, orders must be equal
lists, stats equal integers.
"""

import gzip

import numpy as np
import pytest

from galah_tpu import api as japi
from galah_tpu import quality as jq
from galah_tpu.io.fasta import calculate_genome_stats
from galah_tpu_torch import quality as tq
from galah_tpu_torch.io.fasta import read_genome, read_genome_stats

ACGT = np.array(list("ACGT"))
NAMES = ["g0", "g1", "g2", "g3", "g4", "g5"]
# completeness, contamination, strain heterogeneity: g1 and g4 tie
# under every formula but Parks2020_reduced and dRep (their stats
# differ)
QUAL = [(90.0, 2.0, 10.0), (80.0, 1.0, 0.0), (95.0, 6.0, 50.0),
        (70.0, 0.5, 0.0), (80.0, 1.0, 0.0), (99.0, 9.0, 100.0)]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Six genomes with different contig counts, N counts and N50, and
    the three quality inputs for them."""
    d = tmp_path_factory.mktemp("quality")
    rng = np.random.default_rng(4)
    paths = []
    for i, name in enumerate(NAMES):
        contigs = []
        for c in range(1 + i % 3):
            seq = "".join(ACGT[rng.integers(0, 4, 2000 + 500 * i + 300 * c)])
            if i % 2:
                seq = seq[:100] + "N" * (7 * i) + seq[100:]
            contigs.append(f">{name}_{c}\n{seq}\n")
        p = d / f"{name}.fna"
        p.write_text("".join(contigs))
        paths.append(str(p))
    checkm1 = d / "checkm1.tsv"
    checkm1.write_text(
        "Bin Id\tMarker lineage\tCompleteness\tContamination\t"
        "Strain heterogeneity\n" + "".join(
            f"{n}\tk__Bacteria\t{c}\t{x}\t{h}\n"
            for n, (c, x, h) in zip(NAMES, QUAL)))
    checkm2 = d / "quality_report.tsv"
    checkm2.write_text(
        "Name\tCompleteness\tContamination\tNotes\n" + "".join(
            f"{n}\t{c}\t{x}\tnone\n" for n, (c, x, _) in zip(NAMES, QUAL)))
    info = d / "genomeInfo.csv"
    info.write_text("genome,completeness,contamination\n" + "".join(
        f"{n},{c},{x}\n" for n, (c, x, _) in zip(NAMES, QUAL)))
    return paths, str(checkm1), str(checkm2), str(info)


@pytest.mark.parametrize("reader", ["read_checkm1_tab_table",
                                    "read_checkm2_quality_report",
                                    "read_genome_info_file"])
def test_parsers_match(corpus, reader):
    _paths, checkm1, checkm2, info = corpus
    path = {"read_checkm1_tab_table": checkm1,
            "read_checkm2_quality_report": checkm2,
            "read_genome_info_file": info}[reader]
    want = getattr(jq, reader)(path)
    got = getattr(tq, reader)(path)
    assert list(got) == list(want) == NAMES
    for name in NAMES:
        assert (got[name].completeness, got[name].contamination,
                got[name].strain_heterogeneity) == (
            want[name].completeness, want[name].contamination,
            want[name].strain_heterogeneity)


def _values(**kw):
    return {k.replace("-", "_"): v for k, v in kw.items()}


@pytest.mark.parametrize("formula", ["Parks2020_reduced",
                                     "completeness-4contamination",
                                     "completeness-5contamination",
                                     "dRep"])
@pytest.mark.parametrize("filters", [(None, None), (75, 5), (0.85, 0.07)])
def test_order_matches_galah_tpu(corpus, formula, filters):
    """CheckM1 input (the one all four formulas take), each filter as
    a percentage and as a fraction."""
    paths, checkm1, _, _ = corpus
    min_c, max_x = filters
    want, used = japi.quality_order_genomes(paths, _values(
        checkm_tab_table=checkm1, quality_formula=formula,
        min_completeness=min_c, max_contamination=max_x))
    got, tused = tq.quality_order_genomes(
        paths, checkm_tab_table=checkm1, formula=formula,
        min_completeness=min_c, max_contamination=max_x)
    assert got == want and used and tused
    if filters == (None, None):
        assert sorted(got) == sorted(paths)
    else:
        assert len(got) < len(paths)


@pytest.mark.parametrize("kind", ["checkm2_quality_report", "genome_info"])
def test_order_matches_for_other_inputs(corpus, kind):
    paths, _, checkm2, info = corpus
    path = checkm2 if kind == "checkm2_quality_report" else info
    for formula in ("Parks2020_reduced", "completeness-5contamination"):
        want, _ = japi.quality_order_genomes(
            paths, _values(**{kind: path, "quality_formula": formula}))
        got, _ = tq.quality_order_genomes(paths, formula=formula,
                                          **{kind: path})
        assert got == want


def test_ties_keep_input_order(corpus):
    """g1 and g4 have equal completeness and contamination: under
    completeness-4contamination they keep input order whichever comes
    first."""
    paths, checkm1, _, _ = corpus
    for order in (paths, paths[::-1]):
        got, _ = tq.quality_order_genomes(
            order, checkm_tab_table=checkm1,
            formula="completeness-4contamination")
        want, _ = japi.quality_order_genomes(order, _values(
            checkm_tab_table=checkm1,
            quality_formula="completeness-4contamination"))
        assert got == want
        ties = [p for p in got if p.endswith(("g1.fna", "g4.fna"))]
        assert ties == [p for p in order if p in ties]


def test_no_quality_input_keeps_input_order(corpus):
    paths = corpus[0]
    got, used = tq.quality_order_genomes(paths[::-1])
    assert (got, used) == (paths[::-1], False)


def test_conflicting_inputs_rejected(corpus):
    paths, checkm1, checkm2, info = corpus
    for kw in ({"checkm_tab_table": checkm1, "genome_info": info},
               {"checkm2_quality_report": checkm2, "genome_info": info}):
        with pytest.raises(ValueError, match="at most one"):
            japi.quality_order_genomes(paths, _values(**kw))
        with pytest.raises(ValueError, match="at most one"):
            tq.quality_order_genomes(paths, **kw)
    with pytest.raises(ValueError, match="genome-info"):
        japi.quality_order_genomes(paths, _values(
            genome_info=info, quality_formula="dRep"))
    with pytest.raises(ValueError, match="genome-info"):
        tq.quality_order_genomes(paths, genome_info=info, formula="dRep")
    with pytest.raises(ValueError, match="strain heterogeneity"):
        tq.quality_order_genomes(paths, checkm2_quality_report=checkm2,
                                 formula="dRep")
    with pytest.raises(KeyError, match="missing.fna"):
        tq.quality_order_genomes([*paths, "/x/missing.fna"],
                                 checkm_tab_table=checkm1)


def test_malformed_tables_rejected(tmp_path):
    bad = tmp_path / "bad.tsv"
    bad.write_text("Name\tCompleteness\n")
    with pytest.raises(ValueError, match="malformed"):
        tq.read_checkm2_quality_report(str(bad))
    dup = tmp_path / "dup.csv"
    dup.write_text("genome,completeness,contamination\na,1,2\na,3,4\n")
    with pytest.raises(ValueError, match="multiple times"):
        tq.read_genome_info_file(str(dup))
    hdr = tmp_path / "hdr.csv"
    hdr.write_text("genome,comp,cont\n")
    with pytest.raises(ValueError, match="Incorrect headers"):
        tq.read_genome_info_file(str(hdr))


@pytest.mark.parametrize("seed", range(6))
def test_readers_match_on_random_bytes(tmp_path, seed):
    """Both readers against galah_tpu's numpy reader on random byte
    soups of headers, bases, N and IUPAC codes, blank lines and every
    whitespace byte, leading or trailing a line or inside it."""
    from galah_tpu.io.fasta import read_genome_numpy

    rng = np.random.default_rng(seed)
    alphabet = np.frombuffer(b"ACGTacgtNRY> \t\r\n\x0b\x0c", dtype=np.uint8)
    weights = np.array([8, 8, 8, 8, 2, 2, 2, 2, 2, 1, 1, 3, 2, 2, 2, 6, 1, 1],
                       dtype=float)
    body = alphabet[rng.choice(alphabet.size, size=4000,
                               p=weights / weights.sum())].tobytes()
    p = tmp_path / "soup.fna"
    p.write_bytes(b">first\n" + body)
    want = read_genome_numpy(str(p))
    got = read_genome(str(p))
    np.testing.assert_array_equal(got.codes, want.codes)
    np.testing.assert_array_equal(got.contig_offsets, want.contig_offsets)
    assert got.stats == read_genome_stats(str(p))
    assert (got.stats.num_contigs, got.stats.num_ambiguous_bases,
            got.stats.n50) == (want.stats.num_contigs,
                               want.stats.num_ambiguous_bases,
                               want.stats.n50)


def test_stats_only_read(corpus, tmp_path):
    """read_genome_stats equals read_genome's stats and galah_tpu's
    calculate_genome_stats, with lowercase, IUPAC codes, an interior
    space, blank lines and gzip."""
    odd = tmp_path / "odd.fna"
    odd.write_text(">a desc\nACGTNNacgtRYK\n\n  ACG T  \n>b\nNNNN\n>c\n\n")
    gz = tmp_path / "z.fna.gz"
    with gzip.open(gz, "wt") as fh:
        fh.write(">q\nACGTACGTNN\nAC\n")
    bare = tmp_path / "bare.fna"  # no whitespace byte at all
    bare.write_bytes(b">hACGT")
    for p in [*corpus[0], str(odd), str(gz), str(bare)]:
        got = read_genome_stats(p)
        assert got == read_genome(p).stats
        want = calculate_genome_stats(p)
        assert (got.num_contigs, got.num_ambiguous_bases, got.n50) == (
            want.num_contigs, want.num_ambiguous_bases, want.n50)
