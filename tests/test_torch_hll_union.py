"""The hll_union kernel's launch plan and slice-and-combine arithmetic,
held against the plain version and galah_tpu's Pallas kernel, and the
input builders of its rehearsal script.

The kernel itself needs the card; ``chip_smoke.py`` holds it against
``hll_union_stats_plain`` there. Here a numpy model repeats its
arithmetic in its order: per slice of the register axis, four threads
a column each summing every fourth 16-register word in double, those
four combined as (p0 + p1) + (p2 + p3), the slices added in slice
order, and the sum rounded to f32 once.

Tolerances: zeros exact. powsum against the plain version (a float64
sum in torch's order, rounded once) bit for bit at registers <= 41,
where every partial sum is exact, and within one f32 ulp beyond.
Against galah_tpu's kernel, which sums 2^-reg in f32, rtol 1e-5
(tests/test_pallas.py's own tolerance).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from galah_tpu.ops.pallas_hll import hll_union_stats_tile
from galah_tpu_torch.kernels import rehearse_hll_union as rhu
from galah_tpu_torch.ops import hll as thll
from galah_tpu_torch.ops import hll_union as thu

# one intra-op thread a worker process (tests/test_torch_hll.py says why)
torch.set_num_threads(1)

# the pair pass over 1,024 genomes: 16 row blocks of 64 rows against
# mat[c0:], c0 the block's diagonal column tile
PASS = [(thll.ROW_TILE, 1024 - (r0 // thll.COL_TILE) * thll.COL_TILE)
        for r0 in range(0, 1024, thll.ROW_TILE)]


def _slices(plan, words):
    return [(z * plan.chunk, min(words, (z + 1) * plan.chunk))
            for z in range(plan.slices)]


# -- the launch plan ------------------------------------------------------


@pytest.mark.parametrize("m", [16, 1040, 4096])
@pytest.mark.parametrize("launch", range(len(PASS)))
def test_plan_slices_cover_every_word_once(launch, m):
    br, bc = PASS[launch]
    words = m // 16
    plan = thu.plan_launch(br, bc, m)
    covered = np.zeros(words, dtype=np.int64)
    for lo, hi in _slices(plan, words):
        assert lo < hi
        covered[lo:hi] += 1
    assert covered.tolist() == [1] * words
    tiles = -(-bc // thu.COLS) * -(-br // thu.ROWS)
    assert plan.blocks == tiles * plan.slices
    if words == 1:
        assert plan.slices == 1


@pytest.mark.parametrize("launch", range(len(PASS)))
def test_plan_fills_the_card_on_every_pass_launch(launch):
    br, bc = PASS[launch]
    plan = thu.plan_launch(br, bc, 4096)
    assert plan.blocks >= thu.TARGET_BLOCKS
    assert plan.chunk % thu.SPLIT == 0
    # no more slices than that takes: one fewer would miss the target
    if plan.slices > 1:
        tiles = plan.blocks // plan.slices
        bigger = plan.chunk + thu.SPLIT
        assert tiles * -(-256 // bigger) < thu.TARGET_BLOCKS


@pytest.mark.parametrize("br, bc, m, slices", [
    (64, 8192, 4096, 1),    # 1,024 tiles fill the card unsplit
    (13, 77, 1040, 17),     # too few tiles: SPLIT words a slice
    (9, 3, 16, 1),          # one word
])
def test_plan_edges(br, bc, m, slices):
    plan = thu.plan_launch(br, bc, m)
    assert plan.slices == slices
    if slices == 1:
        assert plan.chunk == m // 16
    else:
        assert plan.chunk == thu.SPLIT and (m // 16) % plan.chunk


# -- the slice-and-combine arithmetic --------------------------------------


def model_union_stats(rows: np.ndarray, cols: np.ndarray):
    """The kernel's sums, in its order, as numpy f32 (powsum, zeros)."""
    br, m = rows.shape
    bc = cols.shape[0]
    plan = thu.plan_launch(br, bc, m)
    total = np.zeros((br, bc))
    zeros = np.zeros((br, bc), dtype=np.int64)
    for lo, hi in _slices(plan, m // 16):
        acc = np.zeros((thu.SPLIT, br, bc))
        for w in range(lo, hi):
            q = (w - lo) % thu.SPLIT
            mx = np.maximum(rows[:, None, 16 * w:16 * w + 16],
                            cols[None, :, 16 * w:16 * w + 16])
            terms = np.ldexp(1.0, -mx.astype(np.int64))
            for b in range(16):
                acc[q] += terms[:, :, b]
            zeros += (mx == 0).sum(-1)
        total += (acc[0] + acc[1]) + (acc[2] + acc[3])
    return total.astype(np.float32), zeros.astype(np.float32)


def _case(seed, br, bc, m, hi):
    rng = np.random.default_rng(seed)
    r = rng.integers(0, hi + 1, size=(br, m)).astype(np.uint8)
    c = rng.integers(0, hi + 1, size=(bc, m)).astype(np.uint8)
    r[0] = 0                 # all-zero rows
    c[min(1, bc - 1)] = 0
    r[-1] = hi               # all-max rows
    c[-1] = hi
    return r, c


def _ulps(a: np.ndarray, b: np.ndarray) -> int:
    return int(np.abs(a.view(np.int32).astype(np.int64)
                      - b.view(np.int32).astype(np.int64)).max())


@pytest.mark.parametrize("hi", [41, 53, 255])
@pytest.mark.parametrize("br, bc, m", [(64, 256, 4096), (13, 77, 1040)])
def test_model_matches_plain_and_galah_tpu(br, bc, m, hi):
    r, c = _case(br * 1000 + hi, br, bc, m, hi)
    assert thu.plan_launch(br, bc, m).slices > 1
    ps, z = model_union_stats(r, c)
    tps, tz = thu.hll_union_stats_plain(torch.from_numpy(r),
                                        torch.from_numpy(c))
    np.testing.assert_array_equal(z, tz.numpy())
    assert _ulps(ps, tps.numpy()) <= (0 if hi <= 41 else 1)
    jps, jz = hll_union_stats_tile(
        jnp.asarray(np.ldexp(1.0, -r.astype(np.int64)).astype(np.float32)),
        jnp.asarray(np.ldexp(1.0, -c.astype(np.int64)).astype(np.float32)),
        chunk=1024 if m % 1024 == 0 else m, interpret=True)
    np.testing.assert_array_equal(z, np.asarray(jz))
    np.testing.assert_allclose(ps, np.asarray(jps), rtol=1e-5)


def test_model_split_equals_unsplit_at_hll_registers():
    """At registers as genomes give them the split changes no bit:
    the model with its slices against one slice (the unsplit kernel)."""
    rng = np.random.default_rng(7)
    regs = rhu.hll_registers(rng, 64 + 256)
    r, c = regs[:64], regs[64:]
    ps, z = model_union_stats(r, c)
    mx = np.maximum(r[:, None, :], c[None, :, :]).astype(np.int64)
    exact = (np.left_shift(1, 41 - mx).sum(-1) / 2.0 ** 41)
    np.testing.assert_array_equal(ps, exact.astype(np.float32))
    np.testing.assert_array_equal(z, (mx == 0).sum(-1).astype(np.float32))


# -- the rehearsal script --------------------------------------------------


def test_rehearsal_args_and_inputs():
    args = rhu.parse_args([])
    assert (args.earlier, args.seed, args.reps) == (None, 0, 20)
    args = rhu.parse_args(["--earlier", "d", "--seed", "3", "--reps", "5"])
    assert (args.earlier, args.seed, args.reps) == ("d", 3, 5)

    rng = np.random.default_rng(0)
    regs = rhu.hll_registers(rng, 32)
    assert regs.shape == (32, rhu.M) and regs.dtype == np.uint8
    assert 1 <= regs.min() and regs.max() <= 30
    # ~500 hashes a register: the median register is log2(500) + ~1
    assert 9 <= np.median(regs) <= 11
    u = rhu.uniform_registers(rng, 8, 53)
    assert (u[0] == 0).all() and (u[1] == 53).all() and u.max() == 53
    # the pass's launches are ops/hll.py's row blocks
    assert [(64, 1024 - c0) for _, c0 in rhu.pass_launches()] == PASS
    assert (rhu.ROW_TILE, rhu.COL_TILE) == (thll.ROW_TILE, thll.COL_TILE)


def test_rehearsal_reads_either_c_signature():
    with open(rhu.os.path.join(rhu._HERE, "hll_union.cu")) as fh:
        assert rhu._n_params(fh.read()) == 11
    old = ('extern "C" int hll_union_launch(const void* rows, const void* '
           'cols, int br,\n int bc, int m, void* powsum, void* zeros,\n'
           ' void* stream) {')
    assert rhu._n_params(old) == 8
    with pytest.raises(RuntimeError):
        rhu._n_params("int main() {}")


def test_rehearsal_counts_the_inner_loop():
    sass = """
        Function : _ZN12_GLOBAL__N_116hll_union_kernelEv
        /*0000*/                   MOV R1, c[0x0][0x28] ;
        /*0010*/                   DADD R2, R2, R4 ;
        /*0020*/                   IMAD.MOV.U32 R4, RZ, RZ, RZ ;
        /*0030*/              @P0  BRA 0x10 ;
        /*0040*/                   BRA 0x0 ;
        /*0050*/                   EXIT ;
        Function : _ZN12_GLOBAL__N_117hll_union_combineEv
        /*0000*/                   DADD R2, R2, R4 ;
        /*0010*/                   BRA 0x0 ;
    """
    # the shorter of the two loops that add doubles, in the main kernel
    assert rhu.loop_opcodes(sass) == (3, {"DADD": 1, "IMAD": 1, "BRA": 1})
    assert rhu.loop_opcodes("") == (0, {})
