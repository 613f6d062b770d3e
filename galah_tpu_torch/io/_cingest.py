"""Build and bind the port's native FASTA parser (``csrc/ingest.c``).

The C source compiles at first use with ``$CC`` (default ``gcc``)
``-O3 -shared -fPIC`` into ``galah_tpu_torch/_build/``; the library's
file name carries a content hash of the source and the flags, so an
unchanged source is built once per checkout and an edited one anew.
Several processes may build at once: each writes its own temporary
file and renames it into place.

A build or load failure raises with the compiler's output. There is no
numpy fallback and no switch to turn the parser off; the numpy parser
in ``io/fasta.py`` is the plain version that tests hold this one
against.

``parse_fasta(data)`` parses FASTA bytes that Python read (and, for
gzip input, decompressed). ctypes releases the interpreter lock for the
length of a foreign call, so reads on the read-ahead pool's threads
parse truly in parallel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Tuple

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "csrc", "ingest.c")
BUILD_DIR = os.path.join(_PKG, "_build")
CFLAGS = ["-O3", "-shared", "-fPIC"]


class _GalahGenome(ctypes.Structure):
    _fields_ = [
        ("codes", ctypes.POINTER(ctypes.c_uint8)),
        ("total_len", ctypes.c_int64),
        ("offsets", ctypes.POINTER(ctypes.c_int64)),
        ("n_contigs", ctypes.c_int64),
        ("num_ambiguous", ctypes.c_int64),
        ("n50", ctypes.c_int64),
    ]


_ERRORS = {-2: "no FASTA records found", -3: "out of memory"}

_LIB = None
_LOCK = threading.Lock()

# Concurrency contract (GL8xx lint and the GALAH_SAN sanitizer): the
# read threads parse at once, so the first build and binding of the
# library happen once, under _LOCK (which is never held while another
# lock is taken).
GUARDED_BY = {"_LIB": "_LOCK"}
LOCK_ORDER = ["_LOCK"]


def build(source: str = SOURCE, build_dir: str = BUILD_DIR) -> str:
    """Compile `source` unless its library exists; returns the
    library's path. Raises RuntimeError with the compiler's output."""
    try:
        with open(source, "rb") as fh:
            text = fh.read()
    except OSError as e:
        raise RuntimeError(f"C parser source unreadable: {e}") from e
    cc = os.environ.get("CC", "gcc")
    digest = hashlib.sha256(
        " ".join([cc, *CFLAGS]).encode() + b"\0" + text).hexdigest()[:16]
    lib = os.path.join(build_dir, f"libingest-{digest}.so")
    if os.path.isfile(lib):
        return lib
    os.makedirs(build_dir, exist_ok=True)
    tmp = f"{lib}.{os.getpid()}.{threading.get_ident()}.tmp"
    cmd = [cc, *CFLAGS, "-o", tmp, source]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=120)
    except OSError as e:
        raise RuntimeError(f"C parser build could not run "
                           f"{' '.join(cmd)}: {e}") from e
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(
            f"C parser build failed ({proc.returncode}): {' '.join(cmd)}"
            f"\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)
    return lib


def load() -> ctypes.CDLL:
    """The bound parser library, built on first use."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(build(SOURCE, BUILD_DIR))
            lib.galah_parse_fasta.argtypes = [
                ctypes.c_char_p, ctypes.c_int64,
                ctypes.POINTER(_GalahGenome)]
            lib.galah_parse_fasta.restype = ctypes.c_int
            lib.galah_free_genome.argtypes = [ctypes.POINTER(_GalahGenome)]
            lib.galah_free_genome.restype = None
            _LIB = lib
        return _LIB


def parse_fasta(data: bytes, path: str
                ) -> Tuple[np.ndarray, np.ndarray, int, int]:
    """(codes uint8, contig offsets int64, ambiguous bases, N50) of the
    FASTA bytes `data`; `path` names the file in errors."""
    lib = load()
    g = _GalahGenome()
    rc = lib.galah_parse_fasta(data, len(data), ctypes.byref(g))
    if rc != 0:
        raise ValueError(f"{_ERRORS.get(rc, f'error {rc}')} in {path}")
    try:
        codes = (np.ctypeslib.as_array(g.codes, shape=(g.total_len,)).copy()
                 if g.total_len > 0 else np.zeros(0, dtype=np.uint8))
        offsets = np.ctypeslib.as_array(
            g.offsets, shape=(g.n_contigs + 1,)).copy()
        return codes, offsets, int(g.num_ambiguous), int(g.n50)
    finally:
        lib.galah_free_genome(ctypes.byref(g))
