"""The port's command-line surface against galah_tpu's: genome inputs,
the representative outputs, -v/-q, the --full-help pages.

Tolerance: none — path lists equal, output files, symlink targets and
copied bytes equal, log levels and formats equal, help pages equal but
for the ENVIRONMENT section (and the dist epilog, which galah_tpu
lacks).
"""

import logging
import os

import pytest
import torch

from galah_tpu import manpage as jmanpage
from galah_tpu.cli import build_parser as jbuild_parser
from galah_tpu.cli import main as jmain
from galah_tpu.genome_inputs import parse_genome_inputs as jparse
from galah_tpu.ops import collision as jcol
from galah_tpu.utils.logging import set_log_level as jset_log_level
from galah_tpu_torch import cli as tcli
from galah_tpu_torch import manpage as tmanpage
from galah_tpu_torch.genome_inputs import parse_genome_inputs as tparse

from test_torch_cluster import _families

# several pytest workers share the host: one torch thread a worker (as
# tests/test_torch_hll.py sets for the whole run)
torch.set_num_threads(1)

SUBCOMMANDS = ("cluster", "cluster-validate", "dist")


@pytest.fixture
def root_logger():
    """main() replaces the root handlers (as galah-tpu's does); put
    them and the level back after the test."""
    root = logging.getLogger()
    handlers, level = root.handlers[:], root.level
    yield root
    root.handlers[:] = handlers
    root.setLevel(level)


@pytest.fixture(scope="module")
def clash_corpus(tmp_path_factory):
    """6 families x 3 members, 30 kb, ~2% divergence, each family in a
    directory of its own under the same file names (fam0_m0.fna, ...),
    so representatives' names clash in the output directories."""
    root = tmp_path_factory.mktemp("clash")
    paths, labels = [], []
    for fam in range(6):
        (root / f"d{fam}").mkdir()
        p, _ = _families(root / f"d{fam}", 100 + fam, 1, 3, 30_000, 0.02)
        paths += p
        labels += [fam] * len(p)
    listing = root / "genomes.txt"
    listing.write_text("\n".join(paths) + "\n")
    return paths, labels, str(listing)


def _input_cases(root, paths):
    d = os.path.dirname(paths[0])
    listing = root / "list.txt"
    listing.write_text(f"\n  {paths[2]}  \n\n{paths[0]}\n")
    other = root / "other.fa"
    other.write_text(">x\nACGT\n")
    return {
        "files": dict(genome_fasta_files=[paths[1], paths[0]]),
        "list": dict(genome_fasta_list=str(listing)),
        "directory": dict(genome_fasta_directory=d),
        "extension": dict(genome_fasta_directory=str(root),
                          genome_fasta_extension=".fa"),
        "all three": dict(genome_fasta_files=[paths[3]],
                          genome_fasta_list=str(listing),
                          genome_fasta_directory=d),
        "missing": dict(genome_fasta_files=[paths[0], str(root / "no.fna")]),
        "none": dict(),
    }


@pytest.mark.parametrize("case", ["files", "list", "directory", "extension",
                                  "all three", "missing", "none"])
def test_genome_inputs_match_galah_tpu(clash_corpus, tmp_path, case):
    """-f, then --genome-fasta-list, then -d/-x sorted: the same paths
    in the same order, or the same error, as galah_tpu."""
    paths = clash_corpus[0]
    kw = _input_cases(tmp_path, paths)[case]
    try:
        want = jparse(**kw)
    except (ValueError, OSError) as e:
        with pytest.raises(type(e)) as got:
            tparse(**kw)
        assert str(got.value) == str(e)
        return
    assert tparse(**kw) == want
    assert want


def _tree(directory):
    """{name: ("link", target) or ("copy", bytes)} of an output dir."""
    out = {}
    for name in sorted(os.listdir(directory)):
        p = os.path.join(directory, name)
        if os.path.islink(p):
            out[name] = ("link", os.readlink(p))
        else:
            with open(p, "rb") as fh:
                out[name] = ("copy", fh.read())
    return out


@pytest.mark.parametrize("method", ["skani", "finch"])
def test_representative_outputs_match_galah_tpu(clash_corpus, monkeypatch,
                                                tmp_path, root_logger,
                                                method):
    """The TSV, the representative list and both representative
    directories (symlink targets, copied bytes, .1.fna renames of
    clashing names) equal galah_tpu's for the same run."""
    monkeypatch.setattr(jcol, "SPARSE_SCREEN_MIN_N", 0)
    paths, _, listing = clash_corpus
    outs = {}
    for side, main, extra in (("jax", jmain, []),
                              ("port", tcli.main, ["--device", "cpu"])):
        o = tmp_path / side
        o.mkdir()
        (o / "links").mkdir()  # an empty directory that exists is taken
        argv = ["cluster", "--genome-fasta-list", listing, "-q",
                "--precluster-method", method, "--ani", "95",
                "--output-cluster-definition", str(o / "c.tsv"),
                "--output-representative-list", str(o / "reps.txt"),
                "--output-representative-fasta-directory", str(o / "links"),
                "--output-representative-fasta-directory-copy",
                str(o / "copies"), *extra]
        assert main(argv) == 0
        outs[side] = o
    j, t = outs["jax"], outs["port"]
    for name in ("c.tsv", "reps.txt"):
        assert (t / name).read_bytes() == (j / name).read_bytes(), name
    reps = (t / "reps.txt").read_text().splitlines()
    assert len(reps) == 6
    links, copies = _tree(t / "links"), _tree(t / "copies")
    assert links == _tree(j / "links")
    assert copies == _tree(j / "copies")
    assert sorted(links) == sorted(copies) == sorted(
        ["fam0_m0.fna"] + [f"fam0_m0.fna.{i}.fna" for i in range(1, 6)])
    assert {v for _, v in links.values()} == {os.path.realpath(r)
                                              for r in reps}


def test_output_directory_must_be_empty(clash_corpus, tmp_path,
                                        root_logger):
    """A non-empty output directory, or a file in its place, fails
    before any compute with exit 1, as in galah_tpu."""
    paths = clash_corpus[0]
    full = tmp_path / "full"
    full.mkdir()
    (full / "x").write_text("x")
    afile = tmp_path / "afile"
    afile.write_text("x")
    for target in (full, afile):
        for main, extra in ((jmain, []), (tcli.main, ["--device", "cpu"])):
            assert main(["cluster", "-f", *paths[:2],
                         "--output-representative-fasta-directory",
                         str(target), *extra]) == 1


@pytest.mark.parametrize("flags,level", [([], logging.INFO),
                                         (["-v"], logging.DEBUG),
                                         (["-q"], logging.ERROR),
                                         (["-v", "-q"], logging.ERROR)])
def test_verbosity_matches_galah_tpu(clash_corpus, tmp_path, root_logger,
                                     flags, level):
    """-v/-q set galah_tpu's levels and format, in set_log_level and
    through main."""
    verbose, quiet = "-v" in flags, "-q" in flags
    jset_log_level(verbose, quiet)
    want = (root_logger.level, root_logger.handlers[0].formatter._fmt,
            root_logger.handlers[0].formatter.datefmt)
    tcli.set_log_level(verbose, quiet)
    got = (root_logger.level, root_logger.handlers[0].formatter._fmt,
           root_logger.handlers[0].formatter.datefmt)
    assert got == want and want[0] == level
    root_logger.setLevel(logging.WARNING)
    out = tmp_path / "d.tsv"
    assert tcli.main(["dist", "-f", *clash_corpus[0][:2], "--device", "cpu",
                      "--output", str(out), *flags]) == 0
    assert root_logger.level == level
    assert len(out.read_text().splitlines()) == 1


def _split_roff(text):
    lines = text.split("\n")
    a = lines.index(".SH ENVIRONMENT")
    b = next((i for i in range(a + 1, len(lines))
              if lines[i].startswith(".SH ")), len(lines))
    return lines[:a], lines[b:]


@pytest.mark.parametrize("side", ["jax", "port"])
@pytest.mark.parametrize("sub", SUBCOMMANDS)
def test_full_help_matches_galah_tpu(side, sub):
    """On the same parser (galah_tpu's or the port's subcommand), the
    port's text and roff pages equal galah_tpu.manpage's outside the
    ENVIRONMENT section; after it, the epilogs are galah_tpu's, and for
    dist the port's own."""
    parser = (jbuild_parser()._subcommand_parsers[sub] if side == "jax"
              else tcli.build_parser().subcommand_parsers[sub])
    want = jmanpage.render_full_help(parser, sub)
    got = tmanpage.render_full_help(parser, sub)
    j_env = jmanpage.render_environment_section()
    t_env = tmanpage.render_environment_section()
    assert "GALAH_TPU_CACHE" in t_env
    j_head, j_tail = want.split(j_env, 1)
    t_head, t_tail = got.split(t_env, 1)
    assert t_head == j_head
    if sub == "dist":
        assert j_tail == "\n" and t_tail == "\n" + tmanpage._EPILOGS["dist"]
    else:
        assert t_tail == j_tail
    jr_head, jr_tail = _split_roff(jmanpage.render_full_help_roff(parser,
                                                                   sub))
    tr_head, tr_tail = _split_roff(tmanpage.render_full_help_roff(parser,
                                                                   sub))
    assert tr_head == jr_head
    if sub == "dist":
        assert jr_tail == [] and tr_tail[0] == ".SH OUTPUT"
    else:
        assert tr_tail == jr_tail


@pytest.mark.parametrize("sub", SUBCOMMANDS)
def test_full_help_runs_before_the_device(monkeypatch, capsys, sub):
    """--full-help and --full-help-roff print the page and exit 0 on a
    machine without a card, the device left at its cuda default."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    parser = tcli.build_parser().subcommand_parsers[sub]
    assert tcli.main([sub, "--full-help"]) == 0
    assert capsys.readouterr().out == tmanpage.render_full_help(parser, sub)
    assert tcli.main([sub, "--full-help-roff"]) == 0
    assert capsys.readouterr().out == tmanpage.render_full_help_roff(
        parser, sub)


@pytest.mark.parametrize("argv", [
    ["cluster", "-f", "a.fna", "--profile-trace-dir=d"],
    ["cluster-validate", "--cluster-file", "c.tsv", "--platform", "cpu"],
    ["dist", "-f", "a.fna", "--platform=cpu"]])
def test_unsupported_flags_are_refused_by_name(argv, capsys):
    with pytest.raises(SystemExit) as e:
        tcli.parse_args(argv)
    assert e.value.code == 2
    flag = argv[-2] if argv[-1] in ("skip", "cpu") else argv[-1]
    err = capsys.readouterr().err
    assert flag.split("=")[0] in err and f"`galah-tpu {argv[0]}`" in err
