"""Interprocedural effect auditors (GL11xx) over GalahIR. The port's
copy of ``galah_tpu/analysis/effects_check.py``.

The lexical families (GL1006, GL806, GL1001, GL8xx) read one function
body at a time; one helper in between defeats them. This family audits
the same contracts over the whole-program call graph that
:mod:`galah_tpu_torch.analysis.ir` builds, so a ``device_round`` body
that calls a local ``_sync()`` wrapper around ``.cpu()`` is caught, with
the whole chain in the message.

Checks
  GL1101  a host sync reached from a declared
          ``PIPELINE_STAGE["device_round"]`` function through at least
          one call edge (the direct case stays lexical GL1006: the two
          rules partition and never report twice).
  GL1102  a filesystem write reached from a function of a durable
          module (fs_check.DURABLE_MODULES) other than through
          io/atomic.py. Effects never propagate out of atomic's own
          functions, nor out of the two build installers
          (``ir.BUILD_ARTIFACT_WRITERS``), so those paths are silent by
          construction; direct writes stay lexical GL806.
  GL1103  a streamed producer (``iter_*`` / ``*_streamed`` /
          ``process_stream``) passed into a function that materializes
          that parameter, directly (``list(p)``) or by forwarding it to
          a materializer. The direct-call case stays lexical GL1001.
  GL1007  (the interprocedural arm; the in-function cases stay lexical
          in pipeline_check) a gathered band submatrix, a ``gather()``
          / ``band_gather()`` value inside a ``PAGED_MODULES`` band-walk
          function, passed into a callee that retains its parameter
          (stores it on ``self`` or a container, directly or through
          further forwarding): the reference pins the band's pages past
          eviction. The message carries the retention chain.
  GL1104  a lock acquired as a bare ``.acquire()`` statement with no
          ``with`` block and no try/finally releasing the same
          receiver: a raise between acquire and release leaks the lock.
          A ``return self.acquire()`` passthrough (context-manager
          delegation) is exempt: the caller owns the release.
  GL1105  a callback submitted to a pool (``pool.submit`` /
          ``Thread(target=...)``) in an annotated threaded module whose
          target carries inferred effects but never adopts a flow token
          (``obs/flow.adopt`` / ``stage_token``): its time and failures
          escape stage attribution (the interprocedural completion of
          GL804).

GL1101 checks the port's one ``device_round``, the slab fold's launch
wrapper (``ops/megakernel.run_launch``). ``PAGED_MODULES`` is empty
until the paged sketch tier is ported, so the GL1007 arm runs on
fixtures only, as the lexical GL1007 does.

Scope of GL1104/GL1105: ``galah_tpu_torch/`` without
``galah_tpu_torch/analysis/`` (the sanitizer implements lock plumbing
on purpose).

Every finding's message carries the witness chain down to the direct
sink (``f -> g -> h: x.cpu() at path.py:42``).

Suppression: the usual inline comment on the flagged line, e.g.
``# galah-lint: ignore[GL1104] <why>``.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from galah_tpu_torch.analysis import ir as girt
from galah_tpu_torch.analysis import pipeline_check
from galah_tpu_torch.analysis.core import Finding, Severity, SourceFile
from galah_tpu_torch.analysis.fs_check import DURABLE_MODULES

_EFFECT_SCOPE_PREFIX = "galah_tpu_torch/"
_EFFECT_EXEMPT_PREFIXES = ("galah_tpu_torch/analysis/",)


def _in_effect_scope(path: str) -> bool:
    p = path.replace("\\", "/")
    return (p.startswith(_EFFECT_SCOPE_PREFIX)
            and not p.startswith(_EFFECT_EXEMPT_PREFIXES))


def _check_device_round_sync(program: girt.ProgramIR,
                             out: List[Finding]) -> None:
    """GL1101: host sync reaches a device_round body transitively."""
    for mod in program.modules.values():
        for name in mod.device_round:
            key = (mod.path, name)
            chain = program.witness_chain(key, "host_sync")
            if len(chain) < 2:
                continue  # absent, or direct (lexical GL1006's case)
            _, first = chain[0]
            out.append(Finding(
                code="GL1101", severity=Severity.WARNING,
                path=mod.path, line=first.line,
                message=("device-round body reaches a host sync "
                         "through its call graph ("
                         + program.render_chain(key, "host_sync")
                         + "); a transfer mid-trace splits the "
                         "persistent round program back into "
                         "per-window dispatches"),
                symbol=name))


def _check_durable_writes(program: girt.ProgramIR,
                          out: List[Finding]) -> None:
    """GL1102: a durable module writes through a helper that is not
    io/atomic.py."""
    for mod in program.modules.values():
        if mod.path not in DURABLE_MODULES:
            continue
        for qual in sorted(mod.functions):
            key = (mod.path, qual)
            chain = program.witness_chain(key, "fs_write")
            if len(chain) < 2:
                continue  # absent, or direct (lexical GL806's case)
            _, first = chain[0]
            out.append(Finding(
                code="GL1102", severity=Severity.WARNING,
                path=mod.path, line=first.line,
                message=("durable module writes through a non-atomic "
                         "helper ("
                         + program.render_chain(key, "fs_write")
                         + "); route the write through io/atomic.py "
                         "so a killed writer can't leave a torn "
                         "artifact"),
                symbol=qual))


def _check_stream_materialization(program: girt.ProgramIR,
                                  out: List[Finding]) -> None:
    """GL1103: a streamed producer handed to a materializing callee."""
    for mod in program.modules.values():
        if not pipeline_check.in_scope(mod.path):
            continue
        for qual in sorted(mod.functions):
            fn = mod.functions[qual]
            for cname, idx, line, producer in fn.stream_args:
                if cname.rsplit(".", 1)[-1] in girt.MATERIALIZERS:
                    continue  # lexical GL1001's case
                callee = program.resolve(mod, qual, cname)
                if callee is None:
                    continue
                param = program.materializing_param(callee, idx)
                if param is None:
                    continue
                out.append(Finding(
                    code="GL1103", severity=Severity.WARNING,
                    path=mod.path, line=line,
                    message=(f"streamed iterator {producer}() is "
                             f"materialized by {callee[1]}() "
                             f"(parameter {param!r}, defined at "
                             f"{callee[0]}:"
                             f"{program.functions[callee].line}): "
                             "the stage drains instead of "
                             "overlapping; consume incrementally or "
                             "bound the buffer"),
                    symbol=producer))


def _check_paged_retention(program: girt.ProgramIR,
                           out: List[Finding]) -> None:
    """GL1007 (interprocedural): a gathered band submatrix handed to
    a callee that retains it, the helper indirection the lexical arm
    in pipeline_check cannot see."""
    for mod in program.modules.values():
        names = pipeline_check.PAGED_MODULES.get(mod.path)
        if not names:
            continue
        for qual in sorted(mod.functions):
            if qual.split(".")[-1] not in names:
                continue
            fn = mod.functions[qual]
            for cname, idx, line, producer in fn.gather_args:
                callee = program.resolve(mod, qual, cname)
                if callee is None:
                    continue
                param = program.retaining_param(callee, idx)
                if param is None:
                    continue
                out.append(Finding(
                    code="GL1007", severity=Severity.WARNING,
                    path=mod.path, line=line,
                    message=(f"band submatrix from {producer}() is "
                             f"retained by {callee[1]}() ("
                             + program.render_retention_chain(
                                 callee, param)
                             + "): the reference pins the band's "
                             "backing pages past eviction and the "
                             "paging schedule silently degrades to "
                             "all-resident (docs/memory.md); reduce "
                             "the band to its result instead of "
                             "storing it"),
                    symbol=producer))


def _check_unsafe_acquires(program: girt.ProgramIR,
                           out: List[Finding]) -> None:
    """GL1104: bare acquire with no release on the raising path."""
    for mod in program.modules.values():
        if not _in_effect_scope(mod.path):
            continue
        for qual in sorted(mod.functions):
            for line, recv in mod.functions[qual].unsafe_acquires:
                out.append(Finding(
                    code="GL1104", severity=Severity.WARNING,
                    path=mod.path, line=line,
                    message=(f"{recv}.acquire() in {qual}() has no "
                             "with-block or try/finally release: any "
                             "raise before the release leaks the "
                             "lock; use `with` or move the acquire "
                             "directly above a try/finally that "
                             "releases it"),
                    symbol=qual))


def _check_submit_adoption(program: girt.ProgramIR,
                           out: List[Finding]) -> None:
    """GL1105: effectful pool callbacks without flow-token adoption."""
    for mod in program.modules.values():
        if not mod.annotated or not _in_effect_scope(mod.path):
            continue
        for qual in sorted(mod.functions):
            fn = mod.functions[qual]
            for edge in fn.calls:
                if edge.kind != "submit":
                    continue
                callee = program.resolve(mod, qual, edge.name)
                if callee is None:
                    continue
                if program.adopts(callee):
                    continue
                effects = sorted(program.effects_of(callee))
                if not effects:
                    continue
                out.append(Finding(
                    code="GL1105", severity=Severity.WARNING,
                    path=mod.path, line=edge.line,
                    message=(f"callback {callee[1]}() (defined at "
                             f"{callee[0]}:"
                             f"{program.functions[callee].line}) is "
                             "submitted to a pool carrying effects "
                             f"[{', '.join(effects)}] but never "
                             "adopts a stage token: its duration and "
                             "failures escape stage attribution; "
                             "adopt the submitter's token "
                             "(obs/flow.adopt(token)) inside the "
                             "callback"),
                    symbol=callee[1]))


def check_effects(sources: Dict[str, SourceFile],
                  cache: Optional[girt.IRCache] = None,
                  program: Optional[girt.ProgramIR] = None
                  ) -> List[Finding]:
    """All GL11xx checks over the whole loaded tree (Python sources).

    Pass ``cache`` to reuse per-file IR across runs (content-hash
    keyed); pass ``program`` to reuse an already-built ProgramIR."""
    if program is None:
        program = girt.build_program_ir(sources, cache=cache)
    out: List[Finding] = []
    _check_device_round_sync(program, out)
    _check_durable_writes(program, out)
    _check_stream_materialization(program, out)
    _check_paged_retention(program, out)
    _check_unsafe_acquires(program, out)
    _check_submit_adoption(program, out)
    return out
