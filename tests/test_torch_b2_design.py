"""Kernel B2's redesign, held on the CPU.

* The launch plan (``kernels/lut_dense.py::launch_plan``) and the kernel's
  mapping of blocks, warps and lanes to (row, o) (``csrc/lut_dense.cu``,
  modelled here in Python) cover every output exactly once, with blocks of a
  multiple of 32 rows a row group, in one wave of the card's resident blocks
  where the batch allows, in the shared memory a block may use.
* The wrapper's checks raise on what the kernel does not read, and take any
  hidden width H >= 1 (H > 16 runs the kernel's generic instantiation).
* The kernel's output quantizer (``csrc/lut_cell.cuh``: y * 2^f_out where
  |f_out| <= 126, an IEEE division elsewhere, then the SAT clip), modelled in
  numpy float32, is bit for bit the plain version's SAT at the edge widths,
  on NaN, +-inf and signed zeros.
* The plain B2 (``LUTDense.apply_fused`` on the CPU) against the reference's
  Pallas kernel in interpret mode at hidden widths 1, 3, 16 and 17 and a
  ragged batch.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.lut_dense import lut_dense_fused as ref_lut_dense_fused
from repro_torch.core import quant as port_quant
from repro_torch.core.lut_layers import LUTDense
from repro_torch.kernels import lut_dense as b2
from repro_torch.kernels.ref import fake_quant_ref

torch.set_num_threads(2)

H100_SMS = 132
SMEM_MAX = 227 * 1024          # csrc/lut_dense.cu: dynamic shared memory of a block


def _ldexp(e):
    """Exact float32 2^e (0 below 2^-149, inf above 2^127)."""
    with np.errstate(over="ignore"):
        return np.ldexp(np.float32(1.0), np.asarray(e, np.int32)).astype(np.float32)


def _same_bits(a, b):
    """Identical bit patterns, any NaN matching any NaN."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    nan = np.isnan(a)
    if not np.array_equal(nan, np.isnan(b)):
        return False
    return np.array_equal(np.where(nan, 0, a).view(np.int32),
                          np.where(nan, 0, b).view(np.int32))


def _kernel_outputs(plan, batch, c_out):
    """Every (row, o) the kernel computes under ``plan``: block (s, c) owns
    rows [s*R, s*R + n_rows) and outputs [c*O, c*O + o_n); its warp (g, ol)
    takes output c*O + ol if ol < o_n, and lane l the rows 32 g + l, 32 (g +
    groups) + l, ... < n_rows."""
    seen = np.zeros((batch, c_out), np.int64)
    for s in range(plan.n_row_blocks):
        row0 = s * plan.block_rows
        n_rows = min(plan.block_rows, batch - row0)
        for c in range(plan.n_o_chunks):
            o0 = c * plan.o_chunk
            o_n = min(plan.o_chunk, c_out - o0)
            assert n_rows > 0 and o_n > 0, "an empty block"
            for warp in range(plan.groups * plan.o_chunk):
                g, ol = divmod(warp, plan.o_chunk)
                if ol >= o_n:
                    continue
                for lane in range(32):
                    rows = np.arange(32 * g + lane, n_rows, 32 * plan.groups)
                    seen[row0 + rows, o0 + ol] += 1
    return seen


def _occupancy(most):
    """Resident blocks an SM by threads alone, at most ``most``: 64 warps."""
    return lambda warps: max(1, min(most, 64 // warps))


def _slots(occ_threads, smem):
    occ = min(occ_threads, b2.SMEM_PER_SM // (smem + b2.SMEM_PER_BLOCK))
    return H100_SMS * max(1, occ)


# ------------------------------------------------------------ launch plan
@pytest.mark.parametrize("batch", [1, 31, 4099, 16600])
@pytest.mark.parametrize("c_out", [1, 5, 20, 33])
@pytest.mark.parametrize("c_in,hidden", [(16, 8), (20, 8), (3, 17), (300, 16)])
@pytest.mark.parametrize("most", [1, 4])
def test_launch_plan_covers_every_output_once(batch, c_out, c_in, hidden, most):
    occupancy = _occupancy(most)
    plan = b2.launch_plan(batch, c_in, c_out, hidden, H100_SMS, occupancy)
    assert (_kernel_outputs(plan, batch, c_out) == 1).all()
    warps = plan.groups * plan.o_chunk
    assert plan.block_rows % (32 * plan.groups) == 0 and warps <= b2.MAX_WARPS
    assert plan.n_o_chunks == -(-c_out // plan.o_chunk)
    # outputs split into near-equal chunks: no chunk more than one warp short
    assert c_out - (plan.n_o_chunks - 1) * plan.o_chunk >= plan.o_chunk - plan.n_o_chunks + 1
    # shared memory: the kernel's own layout, within a block's limit; cells and
    # weights of a chunk of channels and the x tile each within STAGE_BYTES
    staged_h = hidden if hidden <= b2.MAX_HIDDEN else 0
    per_j = plan.o_chunk * (b2.CELL_BYTES + 16 * staged_h)
    x_tile = plan.block_rows * (plan.j_chunk | 1) * 4
    assert plan.smem == plan.j_chunk * per_j + x_tile <= SMEM_MAX
    assert (plan.j_chunk, plan.smem) == b2.block_smem(plan.block_rows, c_in, plan.o_chunk,
                                                      hidden)
    assert 1 <= plan.j_chunk <= c_in
    assert plan.j_chunk * per_j <= b2.STAGE_BYTES and x_tile <= b2.STAGE_BYTES
    assert plan.j_chunk == c_in or (plan.j_chunk + 1) * per_j > b2.STAGE_BYTES or \
        plan.block_rows * ((plan.j_chunk + 1) | 1) * 4 > b2.STAGE_BYTES
    # one wave of resident blocks, with the fewest rows a block that gives one
    # at this many warps a block
    n_blocks = plan.n_row_blocks * plan.n_o_chunks
    assert n_blocks <= _slots(occupancy(warps), plan.smem)
    if plan.block_rows > 32 * plan.groups:
        fewer = plan.block_rows - 32 * plan.groups
        smem = b2.block_smem(fewer, c_in, plan.o_chunk, hidden)[1]
        assert -(-batch // fewer) * plan.n_o_chunks > _slots(occupancy(warps), smem)
    # no warp idles where the batch fills the block's row groups
    assert plan.groups == 1 or batch >= 32 * plan.groups


@pytest.mark.parametrize("c_in,c_out,want", [
    # the JSC-HLF layers at B = 16600 with 56 registers a thread (36 warps an
    # SM): 20 -> 5 as 130 blocks of 4 x 5 warps over 128 rows, one an SM
    # (not 519 blocks of 5 warps, which load the SMs alike but stage their
    # cells and weights four times as often); 16 -> 20 as 130 blocks of 20
    # warps, each warp taking four rows of 32 in turn
    (20, 5, (128, 5, 4, 20, 130, 1)),
    (16, 20, (128, 20, 1, 16, 130, 1)),
])
def test_launch_plan_at_the_path_shapes_on_an_h100(c_in, c_out, want):
    plan = b2.launch_plan(16600, c_in, c_out, 8, H100_SMS, lambda warps: 36 // warps)
    assert plan[:6] == want


# --------------------------------------------------------- wrapper checks
def _args(c_in=4, c_out=3, hidden=2, seed=1):
    layer = LUTDense(c_in, c_out, hidden=hidden, device="cpu",
                     generator=torch.Generator().manual_seed(seed))
    return [a.detach().clone() for a in layer.kernel_args()]


def test_wrapper_checks_raise_on_what_the_kernel_does_not_read():
    args = _args()
    x = torch.zeros(9, 4)
    b2._check((x, *args))                           # accepted
    bad = {
        "x must be \\(B, C_in\\)": (torch.zeros(9), *args),
        "w0 \\(C_in, H >= 1, C_out\\)": (torch.zeros(9, 5), *args),
        "w0 \\(C_in, H >= 1, C_out\\), got": (x, args[0][:, :0], *args[1:]),
        "w_out must be": (x, *args[:2], args[2][:, :1], *args[3:]),
        "b_out must be": (x, *args[:3], args[3][:, :2], *args[4:]),
        "f_in must be contiguous float32": (x, *args[:4], args[4].double(), *args[5:]),
        "b0 must be contiguous float32": (x, args[0], args[1].transpose(0, 1).contiguous()
                                          .transpose(0, 1), *args[2:]),
        "x must be contiguous float32": (torch.zeros(4, 9).T, *args),
        "i_out must be contiguous float32 on cpu": (x, *args[:7], args[7].to("meta")),
    }
    for match, call in bad.items():
        with pytest.raises(ValueError, match=match):
            b2._check(call)
    with pytest.raises(ValueError, match="no kernel for device"):
        b2.lut_dense_fused(x.to("meta"), *args)


@pytest.mark.parametrize("hidden", [1, 17, 40])
def test_wrapper_takes_any_hidden_width(hidden):
    """H past the widest instantiation is the generic one's, not an error."""
    args = _args(hidden=hidden)
    x = torch.as_tensor(np.random.default_rng(hidden).normal(0, 3, (33, 4)),
                        dtype=torch.float32)
    b2._check((x, *args))
    plan = b2.launch_plan(33, 4, 3, hidden, H100_SMS, _occupancy(4))
    assert plan.smem <= SMEM_MAX
    out = b2.lut_dense_fused(x, *args)
    assert out.shape == (33, 3) and bool(torch.isfinite(out).all())


def test_wrapper_on_an_empty_sum_gives_zeros():
    args = [torch.zeros(0, 2, 3)] * 3 + [torch.zeros(0, 3)] * 5      # C_in = 0
    b2._check((torch.zeros(5, 0), *args))
    out = b2.lut_dense_fused(torch.zeros(5, 0), *args)
    assert torch.equal(out, torch.zeros(5, 3))


# ------------------------------------------- the output quantizer (SAT)
def _kernel_sat(y, f, i):
    """lut::round_out and lut::sat_out on float32 numpy: y * 2^f rounded
    where |f| <= 126 and f is an integer, else y / 2^-f (lut::round_slow);
    then the SAT clip, NaN propagating, 0 in a dead cell.  Returns the
    rounded and the clipped values."""
    y = np.asarray(y, np.float32)
    fast = abs(f) <= 126 and f == int(f)
    scale, p2 = _ldexp(-int(f)), _ldexp(int(i))
    with np.errstate(over="ignore", invalid="ignore", divide="ignore"):
        if fast:
            r = np.rint(y * _ldexp(int(f))) * scale
        else:
            r = np.rint(y / scale) * scale
    hi = np.float32(p2 - scale)
    q = np.where(np.isnan(r), r, np.minimum(np.maximum(r, -p2), hi))
    alive = np.float32(f) + np.float32(i) + np.float32(1) > 0
    return r, np.where(alive, q, np.float32(0)).astype(np.float32)


def _sat_values(rng, f):
    """y on and between the codes of grid f (ties included), near the clip
    bounds, huge, subnormal, +-0, +-inf and NaN."""
    s = np.float64(2.0) ** -int(np.clip(f, -126, 126))
    k = np.concatenate([rng.integers(-2 ** 25, 2 ** 25, 300), [0, 1, -1, 2 ** 24, -2 ** 24]])
    with np.errstate(over="ignore", under="ignore"):
        y = np.concatenate([k * s, (k + 0.5) * s, (k + 0.25) * s,
                            rng.normal(0, 1, 300) * 10.0 ** rng.integers(-45, 38, 300)])
    special = [np.inf, -np.inf, np.nan, 0.0, -0.0, 1e-45, -1e-45, 3.4e38, -3.4e38,
               2.0 ** -127, -2.0 ** -127, 2.0 ** -126]
    with np.errstate(over="ignore"):
        return np.concatenate([y, special]).astype(np.float32)


@pytest.mark.parametrize("f_out", [-127, -126, 0, 126, 127])
@pytest.mark.parametrize("i_out", [-127, -1, 3, 126])
def test_kernel_output_sat_equals_the_plain_version(f_out, i_out):
    """The rounding bit for bit, signed zeros included; the clipped value bit
    for bit but for the sign of a zero clipped against hi = +0 (f + i = 0),
    which the CPU's vectorised torch.minimum orders as it likes (ROADMAP C5;
    on the card fminf and torch.minimum agree)."""
    rng = np.random.default_rng(abs(f_out) * 257 + abs(i_out))
    y = _sat_values(rng, f_out)
    f, i = torch.tensor(float(f_out)), torch.tensor(float(i_out))
    scale = port_quant.pow2(-f)
    want_r = (torch.round(torch.as_tensor(y) / scale) * scale).numpy()
    want = fake_quant_ref(torch.as_tensor(y), f, i, True, "SAT").numpy()
    got_r, got = _kernel_sat(y, f_out, i_out)
    assert _same_bits(got_r, want_r), (f_out, i_out)
    zero = np.float32(0.0)
    assert _same_bits(np.where(got == 0, zero, got), np.where(want == 0, zero, want))
    if f_out + i_out != 0:
        assert _same_bits(got, want), (f_out, i_out)


# ------------------------------- the plain B2 against the Pallas kernel
@pytest.mark.parametrize("hidden", [1, 3, 16, 17])
@pytest.mark.parametrize("c_in,c_out", [(5, 7), (3, 33)])
def test_plain_b2_matches_reference_kernel_at_any_hidden(hidden, c_in, c_out):
    """``apply_fused`` on the CPU (kernel B2's plain version) against the
    reference's ``lut_dense_fused(interpret=True)`` on the same kernel args,
    batch 31 (ragged against any tile), integer widths in the reference's
    [-8, 12] (ROADMAP C7), dead cells included.  torch's and XLA's CPU tanh
    differ in their last ulps, so a cell on a rounding boundary of its output
    grid may flip one code: outputs may differ by at most two steps of their
    finest grid, in at most 2% of them."""
    rng = np.random.default_rng(hidden * 100 + c_in)
    layer = LUTDense(c_in, c_out, hidden=hidden, device="cpu",
                     generator=torch.Generator().manual_seed(hidden))
    grid = (c_in, c_out)
    with torch.no_grad():
        layer.b_out.copy_(torch.as_tensor(rng.normal(0, 0.3, grid)))
        for q, (f_lo, f_hi), (i_lo, i_hi) in ((layer.q_in, (-2, 9), (-3, 5)),
                                              (layer.q_out, (-2, 10), (-3, 4))):
            q["f"].copy_(torch.as_tensor(rng.integers(f_lo, f_hi, grid), dtype=torch.float32))
            q["i"].copy_(torch.as_tensor(rng.integers(i_lo, i_hi, grid), dtype=torch.float32))
    x = rng.normal(0, 3, (31, c_in)).astype(np.float32)
    args = layer.kernel_args()
    assert bool((args[4] + args[5] + 1 <= 0).any() or (args[6] + args[7] + 1 <= 0).any())
    want = np.asarray(ref_lut_dense_fused(
        jnp.asarray(x), *(jnp.asarray(a.numpy()) for a in args), interpret=True))
    with torch.no_grad():
        got = layer.apply_fused(torch.as_tensor(x)).numpy()
    assert got.shape == (31, c_out) and np.isfinite(got).all()
    step = np.exp2(-args[6].numpy().max(axis=0))          # finest f_out per o
    d = np.abs(got.astype(np.float64) - want) / step
    assert d.max() <= 2, "an output moved by more than two cell flips"
    assert np.count_nonzero(d) <= 0.02 * d.size
