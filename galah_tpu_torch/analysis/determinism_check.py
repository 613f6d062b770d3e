"""Numeric determinism (GL9xx): bit-stable reductions by contract.
The port's copy of ``galah_tpu/analysis/determinism_check.py``, with
torch's idioms beside numpy's.

The port promises ``galah_tpu``'s TSVs byte for byte, whatever the
device, the mesh or the order of the read-ahead, and that rests on
reductions that do not drift. The canonical fault is
``np.where(mask, x, 0)`` summed with ``np.add.reduceat`` instead of
compressing to ``x[mask]`` first: reduceat and pairwise summation group
by RUN LENGTH, so zero-filling masked slots shifts the block boundaries
and drifts the float. That class, and its neighbors, are what this
family flags. (The port's float64 post-math stays numpy:
``ops/fragment_ani.py``'s ``_segment_compressed_sums``.)

Strategy modules declare a machine-readable contract (a plain literal,
harvested from the AST, never imported):

    DETERMINISM_CONTRACT = {
        "family": "fragment",        # pairlist | fragment | greedy_select
        "dtype": "float64",          # the accumulation dtype promised
        "functions": ["directed_ani_batch", "_seq_sum", ...],
    }

Checks
  GL901  (contract functions) a sum / reduceat over an operand that is
         a masked ZERO-FILLED ``np.where`` / ``torch.where`` array:
         ``.sum()``, ``np.sum``, ``torch.sum``, ``np.add.reduceat``,
         or the source of ``index_add_`` / ``scatter_add_``. Compress
         first (``x[mask]``, or ``_segment_compressed_sums`` for
         batched segments); a subscript-compressed operand is clean.
  GL902  (pipeline modules) iteration over a ``set``/``frozenset``
         value, or materializing one via list/tuple/np.array, whose
         order is hash-seed-dependent and must not feed device buffers
         or pair ordering; wrap in ``sorted(...)``. dict iteration is
         insertion-ordered and deliberately NOT flagged.
  GL903  (contract functions, float64 contracts) an f64->f32 narrowing
         (``.astype(float32)``, ``np.float32(x)``, ``dtype=float32``,
         ``.float()``, ``.to(torch.float32)``) inside a function the
         contract promises accumulates in f64.
  GL904  (pipeline modules) unseeded RNG: the ``random`` module's
         global functions, ``random.Random()`` / ``np.random.*`` /
         ``default_rng()`` / ``RandomState()`` without a seed;
         ``torch.rand*`` / ``torch.randint`` / ``torch.randperm`` /
         ``torch.normal`` without ``generator=``, a global
         ``torch.manual_seed`` (or ``torch.seed``), or a
         ``torch.Generator()`` that is never seeded. Seeded
         constructions (``random.Random(f"site:{seed}")``,
         ``torch.Generator().manual_seed(seed)``) pass.
  GL905  contract hygiene: a strategy module without a
         DETERMINISM_CONTRACT, a malformed contract, or an entry
         naming a function that no longer exists.

Scope: GL902/GL904 use the GL7xx pipeline-module scope
(``obs_check.in_scope``); GL901/GL903 run wherever a contract is
declared, so fixtures fire regardless of path.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional

from galah_tpu_torch.analysis.concurrency_check import harvest_literal
from galah_tpu_torch.analysis.core import (Finding, Severity, SourceFile,
                                           dotted_name)
from galah_tpu_torch.analysis.obs_check import in_scope

#: Modules that MUST declare a DETERMINISM_CONTRACT (GL905 if absent):
#: the strategy families whose variants must stay bit-identical.
#: (``galah_tpu``'s ``ops/bucketing.py`` has no counterpart.)
STRATEGY_MODULES = (
    "galah_tpu_torch/ops/pairlist.py",
    "galah_tpu_torch/ops/sparse_device.py",
    "galah_tpu_torch/ops/fragment_ani.py",
    "galah_tpu_torch/ops/window_hits.py",
    "galah_tpu_torch/ops/greedy_select.py",
    "galah_tpu_torch/ops/megakernel.py",
    "galah_tpu_torch/ops/device_queue.py",
    "galah_tpu_torch/ops/sketch_stream.py",
    "galah_tpu_torch/parallel/mesh.py",
)

#: Element sizes of the dtype names ``dtype_from_node`` recognizes
#: (``galah_tpu/analysis/contracts.py``'s table).
ITEMSIZE = {
    "float32": 4, "int32": 4, "uint32": 4,
    "bfloat16": 2, "float16": 2, "int16": 2, "uint16": 2,
    "int8": 1, "uint8": 1, "bool": 1, "bool_": 1,
    "float64": 8, "int64": 8, "uint64": 8,
}

#: torch's dtype aliases, by their dotted name.
_TORCH_ALIASES = {"torch.float": "float32", "torch.double": "float64",
                  "torch.half": "float16", "torch.long": "int64",
                  "torch.int": "int32"}


def dtype_from_node(node: ast.AST) -> Optional[str]:
    """'int32' from an AST reference like ``torch.int32`` / ``np.uint8``
    / ``"float32"`` / ``torch.float``; None when the node is not a
    recognizable dtype."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value if node.value in ITEMSIZE else None
    alias = _TORCH_ALIASES.get(dotted_name(node))
    if alias is not None:
        return alias
    if isinstance(node, ast.Attribute) and node.attr in ITEMSIZE:
        return node.attr
    if isinstance(node, ast.Name) and node.id in ITEMSIZE:
        return node.id
    return None

_WHERE_CALLS = frozenset({
    "np.where", "jnp.where", "numpy.where", "jax.numpy.where",
    "torch.where",
})
_SUM_CALLS = frozenset({
    "np.sum", "jnp.sum", "numpy.sum", "math.fsum", "sum",
    "np.add.reduceat", "jnp.add.reduceat", "numpy.add.reduceat",
    "torch.sum",
})
#: torch's scatter-adds: the summed operand is the third argument
#: (``out.index_add_(dim, index, source)``) or its keyword.
_SCATTER_ADDS = {"index_add_": "source", "index_add": "source",
                 "scatter_add_": "src", "scatter_add": "src"}
_ARRAY_BUILDERS = frozenset({
    "list", "tuple", "np.array", "np.asarray", "numpy.array",
    "numpy.asarray", "jnp.array", "jnp.asarray", "np.fromiter",
})
#: The stdlib `random` module's global-state functions.
RANDOM_GLOBAL_FNS = frozenset({
    "random", "randint", "randrange", "uniform", "choice", "choices",
    "shuffle", "sample", "gauss", "normalvariate", "expovariate",
    "betavariate", "triangular", "getrandbits", "randbytes",
})
#: torch's sampling functions, seeded only through ``generator=``.
TORCH_RANDOM_FNS = frozenset({
    "rand", "rand_like", "randn", "randn_like", "randint",
    "randint_like", "randperm", "normal", "bernoulli", "multinomial",
    "poisson",
})
#: torch calls that set or draw the process-global seed.
TORCH_GLOBAL_SEED = frozenset({
    "torch.manual_seed", "torch.seed", "torch.cuda.manual_seed",
    "torch.cuda.manual_seed_all", "torch.cuda.seed",
    "torch.cuda.seed_all", "torch.random.manual_seed",
    "torch.random.seed",
})
#: numpy's legacy global-state RNG functions.
NP_RANDOM_GLOBAL_FNS = frozenset({
    "random", "rand", "randn", "randint", "random_sample", "ranf",
    "choice", "shuffle", "permutation", "uniform", "normal", "beta",
    "binomial", "poisson", "exponential", "standard_normal",
})


def _is_zero(node: ast.AST) -> bool:
    return (isinstance(node, ast.Constant)
            and not isinstance(node.value, bool)
            and node.value == 0)


def _is_zero_fill_where(node: ast.AST) -> bool:
    return (isinstance(node, ast.Call)
            and dotted_name(node.func) in _WHERE_CALLS
            and len(node.args) == 3
            and _is_zero(node.args[2]))


def _function_defs(tree: ast.Module) -> Dict[str, List[ast.AST]]:
    """Every def in the module (any nesting) by simple name."""
    out: Dict[str, List[ast.AST]] = {}
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out.setdefault(node.name, []).append(node)
    return out


# ---------------------------------------------------------------------------
# GL901 / GL903: contract-function checks
# ---------------------------------------------------------------------------


def _check_contract_function(fn: ast.AST, src: SourceFile,
                             contract_dtype: Optional[str]) -> \
        List[Finding]:
    findings: List[Finding] = []
    # local name -> lineno of its zero-filled np.where assignment
    zero_filled: Dict[str, int] = {}
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name):
            if _is_zero_fill_where(node.value):
                zero_filled[node.targets[0].id] = node.lineno
            elif node.targets[0].id in zero_filled:
                del zero_filled[node.targets[0].id]  # rebound clean

    def summed_operand(call: ast.Call) -> Optional[ast.AST]:
        name = dotted_name(call.func)
        if name in _SUM_CALLS and call.args:
            return call.args[0]
        if (isinstance(call.func, ast.Attribute)
                and call.func.attr in _SCATTER_ADDS):
            if len(call.args) >= 3:
                return call.args[2]
            for kw in call.keywords:
                if kw.arg == _SCATTER_ADDS[call.func.attr]:
                    return kw.value
            return None
        # x.sum() / x.sum(axis=...) — receiver is the operand
        if isinstance(call.func, ast.Attribute) and call.func.attr == "sum":
            return call.func.value
        return None

    for node in ast.walk(fn):
        if not isinstance(node, ast.Call):
            continue
        operand = summed_operand(node)
        if operand is not None:
            bad = (_is_zero_fill_where(operand)
                   or (isinstance(operand, ast.Name)
                       and operand.id in zero_filled))
            # a Subscript operand (c_w[mask]) is the compressed form —
            # exactly what the contract wants — and never flags
            if bad:
                findings.append(Finding(
                    "GL901", Severity.ERROR, src.path, node.lineno,
                    "sum over a masked zero-filled array: "
                    "np.where(mask, x, 0) keeps the full run length, "
                    "so reduceat/pairwise summation blocks differ "
                    "from the compressed segment's and the float "
                    "drifts a ulp — compress first "
                    "(x[mask] / _segment_compressed_sums)",
                    symbol=getattr(fn, "name", "")))
        if contract_dtype == "float64":
            narrow = None
            fname = dotted_name(node.func)
            if (isinstance(node.func, ast.Attribute)
                    and node.func.attr == "astype" and node.args
                    and dtype_from_node(node.args[0]) == "float32"):
                narrow = ".astype(float32)"
            elif fname.endswith(".float32") or fname == "float32":
                narrow = "float32() cast"
            elif (isinstance(node.func, ast.Attribute)
                  and node.func.attr == "float" and not node.args
                  and fname != "float"):
                narrow = ".float()"
            elif (isinstance(node.func, ast.Attribute)
                  and node.func.attr == "to" and any(
                      dtype_from_node(a) == "float32"
                      for a in node.args)):
                narrow = ".to(float32)"
            for kw in node.keywords:
                if (kw.arg == "dtype"
                        and dtype_from_node(kw.value) == "float32"):
                    narrow = "dtype=float32"
            if narrow is not None:
                findings.append(Finding(
                    "GL903", Severity.WARNING, src.path, node.lineno,
                    f"{narrow} inside a function whose "
                    "DETERMINISM_CONTRACT promises float64 "
                    "accumulation — narrowing changes rounding and "
                    "breaks cross-strategy bit-identity",
                    symbol=getattr(fn, "name", "")))
    return findings


# ---------------------------------------------------------------------------
# GL902 / GL904: pipeline-module checks
# ---------------------------------------------------------------------------


def _set_typed(node: ast.AST, set_names: Dict[str, int]) -> bool:
    if isinstance(node, (ast.Set, ast.SetComp)):
        return True
    if isinstance(node, ast.Call) and dotted_name(node.func) in (
            "set", "frozenset"):
        return True
    if isinstance(node, ast.Name):
        return node.id in set_names
    return False


def _check_hash_order(src: SourceFile) -> List[Finding]:
    findings: List[Finding] = []
    # module-wide linear map of names assigned set-typed values; a
    # later non-set rebind clears the entry (lexical, good enough)
    set_names: Dict[str, int] = {}
    for node in src.walk():
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name):
            if _set_typed(node.value, set_names):
                set_names[node.targets[0].id] = node.lineno
            else:
                set_names.pop(node.targets[0].id, None)

    def flag(lineno: int, how: str) -> None:
        findings.append(Finding(
            "GL902", Severity.WARNING, src.path, lineno,
            f"{how} a set — its order is hash-dependent and must not "
            "feed device buffers or pair ordering; wrap in sorted() "
            "(dict iteration is insertion-ordered and fine)"))

    for node in src.walk():
        if isinstance(node, ast.For) and _set_typed(node.iter,
                                                    set_names):
            flag(node.lineno, "for-loop over")
        elif isinstance(node, (ast.ListComp, ast.GeneratorExp,
                               ast.DictComp, ast.SetComp)):
            for gen in node.generators:
                if _set_typed(gen.iter, set_names):
                    flag(node.lineno, "comprehension over")
        elif isinstance(node, ast.Call):
            if (dotted_name(node.func) in _ARRAY_BUILDERS
                    and len(node.args) == 1
                    and _set_typed(node.args[0], set_names)):
                flag(node.lineno,
                     f"{dotted_name(node.func)}() materializes")
    return findings


def seeded_generators(src: SourceFile) -> set:
    """ids of the ``torch.Generator(...)`` calls that are seeded: the
    receiver of a chained ``.manual_seed(...)``, or bound to a name
    (or attribute) that has ``.manual_seed(...)`` called on it."""
    gens = [n for n in src.walk() if isinstance(n, ast.Call)
            and dotted_name(n.func) == "torch.Generator"]
    if not gens:
        return set()
    seeded: set = set()
    seeded_names: set = set()
    for node in src.walk():
        if (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "manual_seed"):
            recv = node.func.value
            if isinstance(recv, ast.Call):
                seeded.add(id(recv))
            elif dotted_name(recv):
                seeded_names.add(dotted_name(recv))
    for node in src.walk():
        if (isinstance(node, ast.Assign) and isinstance(node.value,
                                                        ast.Call)
                and any(dotted_name(t) in seeded_names
                        for t in node.targets)):
            seeded.add(id(node.value))
    return seeded


def _check_rng(src: SourceFile) -> List[Finding]:
    findings: List[Finding] = []
    seeded_gens = seeded_generators(src)
    for node in src.walk():
        if not isinstance(node, ast.Call):
            continue
        name = dotted_name(node.func)
        parts = name.split(".")
        unseeded = None
        if len(parts) == 2 and parts[0] == "random" \
                and parts[1] in RANDOM_GLOBAL_FNS:
            unseeded = f"{name}() uses the global random state"
        elif len(parts) == 3 and parts[0] in ("np", "numpy") \
                and parts[1] == "random" \
                and parts[2] in NP_RANDOM_GLOBAL_FNS:
            unseeded = f"{name}() uses numpy's legacy global state"
        elif name in ("random.Random", "np.random.RandomState",
                      "numpy.random.RandomState",
                      "np.random.default_rng",
                      "numpy.random.default_rng", "default_rng") \
                and not node.args and not node.keywords:
            unseeded = f"{name}() constructed without a seed"
        elif name in TORCH_GLOBAL_SEED:
            unseeded = (f"{name}() sets the process-global torch "
                        "generator")
        elif (len(parts) == 2 and parts[0] == "torch"
              and parts[1] in TORCH_RANDOM_FNS
              and not any(kw.arg == "generator"
                          for kw in node.keywords)):
            unseeded = (f"{name}() without generator= uses the global "
                        "torch generator")
        elif name == "torch.Generator" and id(node) not in seeded_gens:
            unseeded = f"{name}() is never seeded"
        if unseeded is not None:
            findings.append(Finding(
                "GL904", Severity.WARNING, src.path, node.lineno,
                f"unseeded RNG in a pipeline module: {unseeded}; "
                "seed it (random.Random(f'site:{seed}') / "
                "default_rng(seed)) so re-runs reproduce"))
    return findings


# ---------------------------------------------------------------------------
# The checker
# ---------------------------------------------------------------------------


def check_determinism_file(src: SourceFile) -> List[Finding]:
    findings: List[Finding] = []
    path = src.path.replace("\\", "/")
    contract = harvest_literal(src.tree, "DETERMINISM_CONTRACT")

    # GL905: registry coverage + contract hygiene
    if contract is None and path in STRATEGY_MODULES:
        findings.append(Finding(
            "GL905", Severity.WARNING, path, 1,
            "strategy module lacks a DETERMINISM_CONTRACT "
            "annotation (family/dtype/functions)"))
    fn_names: List[str] = []
    dtype: Optional[str] = None
    if contract is not None:
        if not isinstance(contract, dict) or not isinstance(
                contract.get("functions"), list) or not all(
                isinstance(f, str) for f in contract["functions"]):
            findings.append(Finding(
                "GL905", Severity.WARNING, path, 1,
                "DETERMINISM_CONTRACT must be a literal dict with a "
                "'functions' list of names (plus family/dtype)"))
            contract = None
        else:
            fn_names = list(contract["functions"])
            dtype = contract.get("dtype")

    defs = _function_defs(src.tree)
    for name in fn_names:
        nodes = defs.get(name)
        if not nodes:
            findings.append(Finding(
                "GL905", Severity.WARNING, path, 1,
                f"stale DETERMINISM_CONTRACT entry {name!r}: no such "
                "function in this module"))
            continue
        for fn in nodes:
            findings.extend(_check_contract_function(fn, src, dtype))

    if in_scope(path) or contract is not None:
        findings.extend(_check_hash_order(src))
        findings.extend(_check_rng(src))
    return findings
