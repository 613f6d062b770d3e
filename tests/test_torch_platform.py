"""``--platform`` and ``GALAH_TPU_PLATFORM`` on the port against
galah_tpu: the flag on the same subparsers with the same option
strings and default, the same bytes on the CPU, the same exit code and
message for a platform that cannot start, and the tools that return
before the platform is tried.

Tolerance: none; TSVs byte-identical, exit codes equal, messages equal
up to the bracket that holds each package's own reason.
"""

import logging
import os
import subprocess
import sys

import pytest
import torch

from galah_tpu.cli import build_parser as jbuild_parser
from galah_tpu.cli import main as jmain
from galah_tpu.ops import collision as jcol
from galah_tpu_torch import cli as tcli
from galah_tpu_torch import device as tdevice

from test_torch_cluster import REPO, _families

# several pytest workers share the host: one torch thread a worker (as
# tests/test_torch_hll.py sets for the whole run)
torch.set_num_threads(1)

SUBCOMMANDS = ("cluster", "cluster-validate", "dist", "index", "report",
               "perf", "flow", "top", "fleet", "lint")
MESSAGE = "--platform {}: backend failed to initialize ("


@pytest.fixture
def root_logger():
    """main() replaces the root handlers (as galah-tpu's does); put
    them and the level back after the test."""
    root = logging.getLogger()
    handlers, level = root.handlers[:], root.level
    yield root
    root.handlers[:] = handlers
    root.setLevel(level)


@pytest.fixture
def no_platform_env(monkeypatch):
    monkeypatch.delenv("GALAH_TPU_PLATFORM", raising=False)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """3 families x 3 members, 25 kb, ~0.5% divergence."""
    return _families(tmp_path_factory.mktemp("plat"), 5, 3, 3, 25_000,
                     0.005)


def _platform_action(parser):
    return next(((a.option_strings, a.default) for a in parser._actions
                 if a.dest == "platform"), None)


@pytest.mark.parametrize("sub", SUBCOMMANDS)
def test_platform_action_matches_galah_tpu(sub):
    """The same option strings and default on each subparser, and
    none on `lint`, where galah_tpu has none either."""
    want = _platform_action(jbuild_parser()._subcommand_parsers[sub])
    got = _platform_action(tcli.build_parser().subcommand_parsers[sub])
    assert got == want
    assert (want is None) == (sub == "lint")


def _walk(parser, path=()):
    """{(subcommand path, option string)} of a parser and every
    subparser under it."""
    out = set()
    for action in parser._actions:
        if isinstance(action.choices, dict) and action.option_strings == []:
            for name, sub in action.choices.items():
                out |= _walk(sub, path + (name,))
        for opt in action.option_strings:
            out.add((path, opt))
    return out


def test_parser_walk_differs_only_by_device():
    """Every subparser of both build_parser()s takes the same options
    but the port's --device (cluster, cluster-validate, dist, index,
    fleet run)."""
    want = _walk(jbuild_parser())
    got = _walk(tcli.build_parser())
    assert not want - got
    assert got - want == {(("cluster",), "--device"),
                          (("cluster-validate",), "--device"),
                          (("dist",), "--device"),
                          (("index",), "--device"),
                          (("fleet", "run"), "--device")}


@pytest.mark.parametrize("how", ["flag", "env"])
@pytest.mark.parametrize("sub", ["cluster", "dist"])
def test_platform_cpu_bytes_match_galah_tpu(corpus, monkeypatch, tmp_path,
                                            root_logger, sub, how):
    """`--platform cpu` and GALAH_TPU_PLATFORM=cpu, without --device,
    give galah_tpu's bytes (its screen pinned to the exact collision
    route, off conftest's 8-device mesh)."""
    paths, _ = corpus
    monkeypatch.setattr(jcol, "SPARSE_SCREEN_MIN_N", 0)
    if how == "env":
        monkeypatch.setenv("GALAH_TPU_PLATFORM", "cpu")
        flag = []
    else:
        monkeypatch.delenv("GALAH_TPU_PLATFORM", raising=False)
        flag = ["--platform", "cpu"]
    out = "--output-cluster-definition" if sub == "cluster" else "--output"
    argv = [sub, "-f", *paths, "-q", *flag]
    want, got = tmp_path / "jax.tsv", tmp_path / "port.tsv"
    assert jmain([*argv, out, str(want)]) == 0
    assert tcli.main([*argv, out, str(got)]) == 0
    assert got.read_bytes() == want.read_bytes()
    assert want.read_bytes()


def _galah_tpu_process(argv, env=None):
    """galah_tpu's main in a child: a JAX platform that cannot start is
    set process-wide, so it must not reach this pytest worker."""
    proc = subprocess.run(
        [sys.executable, "-m", "galah_tpu.cli", *argv], cwd=str(REPO),
        env={**os.environ, "JAX_PLATFORMS": "cpu", **(env or {})},
        capture_output=True, text=True, timeout=300)
    return proc.returncode, proc.stderr


@pytest.mark.parametrize("how", ["flag", "env"])
def test_unstartable_platform_matches_galah_tpu(corpus, monkeypatch,
                                                tmp_path, root_logger,
                                                capsys, how):
    """`tpu` exits 1 in both packages with `--platform tpu: backend
    failed to initialize (<reason>)`, each its own reason, before any
    work: no TSV is written."""
    paths, _ = corpus
    flag = ["--platform", "tpu"] if how == "flag" else []
    env = {"GALAH_TPU_PLATFORM": "tpu"} if how == "env" else {}
    want_tsv, got_tsv = tmp_path / "jax.tsv", tmp_path / "port.tsv"
    rc, err = _galah_tpu_process(
        ["cluster", "-f", *paths[:2], *flag, "--output-cluster-definition",
         str(want_tsv)], env)
    assert rc == 1
    assert MESSAGE.format("tpu") in err
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    if not env:
        monkeypatch.delenv("GALAH_TPU_PLATFORM", raising=False)
    assert tcli.main(["cluster", "-f", *paths[:2], *flag,
                      "--output-cluster-definition", str(got_tsv)]) == 1
    got = capsys.readouterr().err
    line = next(ln for ln in got.splitlines() if "--platform" in ln)
    assert line.split("] ", 1)[1].startswith(MESSAGE.format("tpu"))
    assert "galah_tpu_torch runs on cpu, cuda, gpu, not 'tpu'" in line
    assert not want_tsv.exists() and not got_tsv.exists()


def _tool_cases(tmp_path):
    """Each tool's command line under `--platform tpu`."""
    empty = tmp_path / "empty"
    empty.mkdir()
    missing = str(tmp_path / "missing.json")
    tpu = ["--platform", "tpu"]
    return {"report": ["report", *tpu, missing],
            "perf": ["perf", *tpu, "--ledger", str(tmp_path / "l.jsonl"),
                     "history", "run.duration_s"],
            "flow": ["flow", *tpu, "analyze", missing],
            "top": ["top", *tpu, str(empty)],
            "fleet status": ["fleet", *tpu, "status", str(empty)]}


@pytest.mark.parametrize("tool", ["report", "perf", "flow", "top",
                                  "fleet status"])
def test_tools_return_before_the_platform(tmp_path, monkeypatch,
                                          root_logger, capsys, tool):
    """report, perf, flow, top and fleet status never try the platform:
    under `--platform tpu` they exit as galah_tpu's do, and the port's
    resolve_platform is never called."""
    argv = _tool_cases(tmp_path)[tool]
    called = []
    monkeypatch.setattr(tdevice, "resolve_platform",
                        lambda p: called.append(p))
    want = jmain(argv)
    capsys.readouterr()
    assert tcli.main(argv) == want
    assert called == []
    assert MESSAGE.format("tpu") not in capsys.readouterr().err


@pytest.mark.parametrize("argv,env,named", [
    (["--platform", "cpu", "--device", "cuda"], {}, "--platform cpu"),
    (["--platform", "gpu", "--device", "cpu"], {}, "--platform gpu"),
    (["--device", "cpu"], {"GALAH_TPU_PLATFORM": "cuda"},
     "GALAH_TPU_PLATFORM=cuda")])
def test_device_disagreement_exits_2(monkeypatch, capsys, argv, env, named):
    """An explicit --device that disagrees with the platform is a parser
    error naming both; one that agrees parses."""
    monkeypatch.delenv("GALAH_TPU_PLATFORM", raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(SystemExit) as e:
        tcli.parse_args(["cluster", "-f", "a.fna", *argv])
    assert e.value.code == 2
    err = capsys.readouterr().err
    assert f"--device {argv[argv.index('--device') + 1]}" in err
    assert named in err
    agree = tcli.parse_args(["dist", "-f", "a.fna", "--platform", "gpu",
                             "--device", "cuda"])
    assert tcli.device_type(agree) == "cuda"


@pytest.mark.parametrize("platform", ["cuda", "gpu"])
def test_card_without_a_card_exits_1(corpus, monkeypatch, tmp_path,
                                     root_logger, capsys, no_platform_env,
                                     platform):
    """`cuda` and `gpu` name the card: with torch.cuda.is_available
    False the run exits 1 with the message and writes nothing."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = tmp_path / "o.tsv"
    assert tcli.main(["cluster", "-f", *corpus[0][:2], "--platform",
                      platform, "--output-cluster-definition",
                      str(out)]) == 1
    err = capsys.readouterr().err
    assert MESSAGE.format(platform) in err
    assert "torch.cuda.is_available() is False" in err
    assert not out.exists()


def test_platform_devices(monkeypatch, no_platform_env):
    """cpu is the CPU; cuda and gpu are the card with no index, so that
    a torchrun rank keeps cuda:LOCAL_RANK (distributed.initialize sets
    the current device); the flag wins over the variable."""
    assert tdevice.resolve_platform("cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    for name in ("cuda", "gpu"):
        dev = tdevice.resolve_platform(name)
        assert dev.type == "cuda" and dev.index is None
    with pytest.raises(RuntimeError, match="'rocm'"):
        tdevice.resolve_platform("rocm")
    monkeypatch.setenv("GALAH_TPU_PLATFORM", "tpu")
    args = tcli.parse_args(["cluster", "-f", "a.fna", "--platform", "cpu"])
    assert tcli.device_type(args) == "cpu"
    assert tcli.device_of(args) == torch.device("cpu")


@pytest.mark.parametrize("argv,env,want", [
    (["fleet", "--platform", "cpu", "run"], {}, "cpu"),
    (["fleet", "run"], {"GALAH_TPU_PLATFORM": "cpu"}, "cpu"),
    (["fleet", "--platform", "gpu", "run"], {}, "cuda"),
    (["fleet", "run"], {}, "cuda")])
def test_fleet_workers_get_the_resolved_device(monkeypatch, argv, env,
                                               want):
    """A worker gets the supervisor's resolved device as --device and
    no --platform, so an inherited GALAH_TPU_PLATFORM always agrees
    with it."""
    from galah_tpu_torch.fleet import plan as tplan

    monkeypatch.delenv("GALAH_TPU_PLATFORM", raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    args = tcli.parse_args([*argv, "-f", "a.fna", "--fleet-dir", "fl"])
    spec = tplan.build_plan(["a.fna"], 1)[0]
    worker = tcli._fleet_worker_argv(args, "fl", "")(spec, False)
    assert worker[worker.index("--device") + 1] == want
    assert "--platform" not in worker
    assert tcli.parse_args(worker[3:]).device == want
