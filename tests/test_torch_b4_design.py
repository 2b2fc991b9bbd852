"""Kernel B4's redesign, and the repair of B3 at any hidden width (C10),
held on the CPU.

* The planner (``kernels/lut_serve_cuda.py``: ``launch_plan`` lays a chain
  out in a block's shared memory, ``tile_plan`` cuts a batch into tiles over
  a grid) on the JSC-HLF chain in int32 and int64, a 16->64->5 chain whose
  first stage's 524 KB of tables cannot be resident while its second
  stage's 160 KB can, the seeded synthetic chain of ``chip_smoke`` (sum
  stages, in-shifts, epilogues, int8/int16/int32/int64 lanes) and a wide
  chain whose constants stay in global memory: every row in exactly one
  tile, the grid within the card's resident blocks, shared memory within a
  block's 232,448 bytes, every staged region 16-byte aligned and disjoint.
* A model of the kernel in PyTorch (``csrc/lut_serve.cu``: the bulk copies
  into a shared-memory image poisoned everywhere else, the tiles each block
  walks, the warp units and lanes, each term added once, the fast lookup
  where the lowering marks a stage for it) run over
  the lowered chain equals the plain version ``run_chain_plain`` bit for
  bit.
* The lane buffers' padding leaves every table where the plain version
  reads it.
* C10: B3's launch plan and wrapper checks take H > 16; the plain backward
  holds against ``jax.grad`` of the reference's oracle at H = 17 and 24.
"""

import contextlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from repro.kernels import ref as jref
from repro_torch.core.analysis import analyze_ranges
from repro_torch.core.lower import compile_sequential
from repro_torch.core.lut_layers import LUTDense
from repro_torch.kernels import lut_dense_bwd as b3
from repro_torch.kernels import lut_serve_cuda as b4
from repro_torch.kernels import ref as pref
from repro_torch.kernels.lut_serve import _requant_cols, _shift_round, compose_fused_stages
from repro_torch.launch.serve import build_lut_stack

torch.set_num_threads(2)

H100_SMS = 132
BY_THREADS = 4                   # resident 512-thread blocks an SM holds by threads
BATCHES = (1, 31, 1024, 4099, 16600, 66400)
CHAINS = ("jsc-int32", "jsc-int64", "c64-int32", "synthetic-int32", "synthetic-int64",
          "wide-int32", "wide-int64")
PLAIN_ROWS = 2048                # rows of one plain call: it holds (rows, S, J, co) indices


def _lut_chain(dims, dtype):
    layers = build_lut_stack(list(dims), 8, device="cpu",
                             generator=torch.Generator().manual_seed(0))
    prog = compile_sequential(layers, 4, 2)
    stages, why = compose_fused_stages(prog, ranges=analyze_ranges(prog))
    assert stages is not None, why
    return prog, b4.pack_stages(stages, dtype)


@pytest.fixture(scope="module")
def chains():
    jsc, jsc32 = _lut_chain((16, 20, 5), torch.int32)
    _, jsc64 = _lut_chain((16, 20, 5), torch.int64)
    _, c64 = _lut_chain((16, 64, 5), torch.int32)
    out = {"jsc-int32": (jsc32, torch.int32), "jsc-int64": (jsc64, torch.int64),
           "c64-int32": (c64, torch.int32)}
    for dt, name in ((torch.int32, "int32"), (torch.int64, "int64")):
        out[f"synthetic-{name}"] = (chip_smoke.synthetic_chain(np.random.default_rng(3), dt), dt)
        out[f"wide-{name}"] = (chip_smoke.wide_chain(np.random.default_rng(4), dt), dt)
    out["jsc-prog"] = jsc
    return out


def _blocks(plan):
    return H100_SMS * b4.blocks_per_sm(plan, BY_THREADS)


def _codes(name, packed, batch, seed):
    rng = np.random.default_rng(seed)
    if name.startswith(("jsc", "c64")):
        lo, hi = -(1 << 6), 1 << 6              # the f=4, i=2 request grid
    else:
        lo, hi = -2 ** 10, 2 ** 10
    return rng.integers(lo, hi, (batch, packed.n_cols0))


def _plain(chain, x):
    """``run_chain_plain`` a slice of rows at a time (it is row by row)."""
    return torch.cat([b4.run_chain_plain(chain, x[k:k + PLAIN_ROWS])
                      for k in range(0, max(len(x), 1), PLAIN_ROWS)])


# ------------------------------------------------------------- the layout
def _regions(low):
    """Every region the kernel places in shared memory: (offset, bytes, what)."""
    plan = low.plan
    rows = low.desc[b4.N_HEADER:b4.N_HEADER + len(plan.table_soff) * b4.N_FIELDS]
    out = []
    if plan.consts_soff >= 0:
        out.append((plan.consts_soff, low.consts.nbytes, "consts"))
    for k, d in enumerate(rows.reshape(-1, b4.N_FIELDS)):
        if d[b4.F_SOFF] >= 0:
            item = 1 << int(d[b4.F_LANE])
            n = int(d[b4.F_J] * d[b4.F_CO] * d[b4.F_E]) * item
            out.append((int(d[b4.F_SOFF]), -(-n // 16) * 16, f"stage {k}"))
    out.append((plan.bar_soff, 8 * plan.n_bar, "barriers"))
    return out


@pytest.mark.parametrize("name", CHAINS)
def test_launch_plan_lays_out_aligned_disjoint_regions(chains, name):
    packed, dtype = chains[name]
    low = b4.lower_chain(packed, dtype)
    plan = low.plan
    item = torch.empty((), dtype=dtype).element_size()
    assert plan.stride_a % 2 == 1 and plan.stride_b % 2 == 1
    assert plan.row_bytes == (plan.stride_a + plan.stride_b) * item
    assert 1 <= plan.max_tile_rows <= b4.MAX_TILE_ROWS
    assert plan.max_tile_rows % 32 == 0 or plan.max_tile_rows < 32
    assert plan.smem(plan.max_tile_rows) <= b4.SMEM_PER_BLOCK
    assert plan.buf_soff % 16 == 0 and plan.bar_soff % 16 == 0
    end = 0
    for off, n, what in sorted(_regions(low)):
        assert off % 16 == 0 and off >= end, (what, off, end)
        end = off + n
    assert end <= plan.buf_soff
    head = low.desc[:b4.N_HEADER]
    n_st = len(plan.table_soff)
    rows = low.desc[b4.N_HEADER:b4.N_HEADER + n_st * b4.N_FIELDS].reshape(-1, b4.N_FIELDS)
    copy_rows = low.desc[b4.N_HEADER + n_st * b4.N_FIELDS:].reshape(-1, b4.COPY_FIELDS)
    assert head[b4.H_NCOPIES] == len(low.copies) == len(copy_rows)
    # one copy a barrier; each copy 16-byte aligned at both ends and exactly
    # its region; the stage rows name their copy's barrier
    assert sorted(low.copies[:, 4]) == list(range(plan.n_bar))
    assert (copy_rows[:, [0, 2, 3]] == low.copies[:, [0, 3, 4]]).all()
    spans = {}
    for dst, src, off, n, _ in low.copies:
        assert dst % 16 == 0 and off % 16 == 0 and n % 16 == 0 and n > 0
        spans.setdefault(src, []).append((dst, n))
    for k, d in enumerate(rows):
        if d[b4.F_SOFF] < 0:
            continue
        lane = int(d[b4.F_LANE])
        (lo, n_reg, _), = [r for r in _regions(low) if r[2] == f"stage {k}"]
        assert [c for c in spans[lane] if lo <= c[0] < lo + n_reg] == [(lo, n_reg)]
        (bar,) = low.copies[low.copies[:, 0] == lo, 4]
        assert d[b4.F_BAR] == bar
    if plan.consts_soff >= 0:
        assert spans[-1] == [(plan.consts_soff, low.consts.nbytes)]
    assert low.consts.nbytes % 16 == 0


def test_launch_plan_keeps_what_fits_resident(chains):
    jsc = b4.lower_chain(*chains["jsc-int32"]).plan
    assert jsc.consts_soff == 0 and min(jsc.table_soff) >= 0    # 215,040 table bytes
    assert jsc.max_tile_rows == 96
    c64 = b4.lower_chain(*chains["c64-int32"]).plan
    assert c64.table_soff[0] == -1 and c64.table_soff[1] >= 0  # 524,288 and 163,840 bytes
    wide = b4.lower_chain(*chains["wide-int64"]).plan
    assert wide.consts_soff == -1 and wide.table_soff == (-1, -1) and wide.n_bar == 0
    assert wide.max_tile_rows == 30                            # fewer than a row group
    with pytest.raises(b4.PackError, match="does not fit"):
        b4.launch_plan(chains["c64-int32"][0], 4, 16, smem_budget=300)


@pytest.mark.parametrize("batch", BATCHES)
@pytest.mark.parametrize("name", CHAINS)
def test_tiles_cover_every_row_once(chains, name, batch):
    packed, dtype = chains[name]
    plan = b4.lower_chain(packed, dtype).plan
    blocks = _blocks(plan)
    t = b4.tile_plan(plan, batch, blocks)
    assert 1 <= t.grid <= blocks and t.grid <= t.n_tiles
    assert t.smem == plan.smem(t.tile_rows) <= b4.SMEM_PER_BLOCK
    assert 1 <= t.tile_rows <= plan.max_tile_rows
    seen = np.zeros(batch, np.int64)
    for block in range(t.grid):
        for tile in range(block, t.n_tiles, t.grid):
            lo = tile * t.tile_rows
            assert lo < batch                          # no empty tile
            seen[lo:min(lo + t.tile_rows, batch)] += 1
    assert (seen == 1).all()
    # the busiest block's rows: within a tile of the batch over the blocks
    per_block = -(-t.n_tiles // t.grid) * t.tile_rows
    assert per_block < -(-batch // blocks) + max(t.tile_rows, 32) + 32


def test_tile_plan_spreads_the_path_batches_on_an_h100(chains):
    plan = b4.lower_chain(*chains["jsc-int32"]).plan
    assert b4.blocks_per_sm(plan, BY_THREADS) == 1              # the tables fill an SM
    assert b4.tile_plan(plan, 1024, 132)[:3] == (32, 32, 32)
    assert b4.tile_plan(plan, 16600, 132)[:3] == (64, 260, 132)


def test_fast_lookup_only_where_it_gives_the_plain_index(chains):
    """The lowering marks a resident stage for the kernel's fast lookup only
    with no in-shift, one mask for every cell inside its table and
    contiguous gathers."""
    def marks(packed, dtype):
        low = b4.lower_chain(packed, dtype)
        rows = low.desc[b4.N_HEADER:b4.N_HEADER + len(packed.stages) * b4.N_FIELDS]
        return list(rows.reshape(-1, b4.N_FIELDS)[:, b4.F_FASTMASK])

    assert marks(*chains["jsc-int32"]) == [511, 511]
    assert marks(*chains["c64-int32"]) == [-1, 511]             # stage 0 reads global memory
    assert marks(*chains["synthetic-int32"]) == [-1, -1, -1, 15]
    packed, dtype = chains["jsc-int32"]
    st = packed.stages[1]
    swapped = st.gather.copy()
    swapped[0, [0, 1]] = swapped[0, [1, 0]]
    wider = st.mask.copy()
    wider[0, 0] = 1023                                          # past the 512-entry table
    for gather, mask in ((swapped, st.mask), (st.gather, wider)):
        other = b4.PackedStage(st.kind, gather, st.n_cols, st.bias, st.epilogue,
                               st.in_shift, mask, st.table)
        chain = b4.PackedStages([packed.stages[0], other], packed.out_cols, packed.n_cols0)
        assert marks(chain, dtype) == [511, -1]


# ------------------------------------------------------ the kernel, modelled
def _units(st_kind, s_n, co, j_n, n_rows):
    """How many times the kernel's warps add each term (row, output, j) of a
    tile of ``n_rows`` rows: warp w takes units w, w + 16, ...; unit u is
    (row group u % n_rg, then CC outputs of a lut stage or all co of a sum
    stage, then a site), its lane l the row 32 * row group + l where that is
    a row of the tile, and every j."""
    warps = b4.THREADS // 32
    n_rg = -(-n_rows // 32)
    cc = b4.OUTPUTS_PER_WARP if st_kind == 0 else co
    n_cc = -(-co // cc)
    seen = np.zeros((n_rows, s_n * co, j_n), np.int64)
    lanes = np.arange(32)
    for warp in range(warps):
        for u in range(warp, n_rg * s_n * n_cc, warps):
            rg, t = u % n_rg, u // n_rg
            c_blk, s = t % n_cc, t // n_cc
            r = rg * 32 + lanes
            r = r[r < n_rows]
            for c in range(c_blk * cc, min(c_blk * cc + cc, co)):
                seen[r, s * co + c, :] += 1
    return seen


def _model(low, dtype, x, blocks):
    """Kernel B4 on ``x`` as ``csrc/lut_serve.cu`` runs it, over the lowered
    chain ``low``: its shared memory an image that only the bulk copies
    fill (every other byte poisoned), the constants and tables read where
    the descriptors place them, the tile buffers with their strides and zero
    column, each stage by its warp units."""
    plan, head = low.plan, low.desc[:b4.N_HEADER]
    rows = low.desc[b4.N_HEADER:b4.N_HEADER + len(plan.table_soff) * b4.N_FIELDS]
    rows = rows.reshape(-1, b4.N_FIELDS)
    lanes = (np.int8, np.int16, np.int32, np.int64)
    batch, n_in = x.shape
    t = b4.tile_plan(plan, batch, blocks)
    smem = np.full(t.smem, 0xA5, np.uint8)
    landed = np.zeros(plan.n_bar, bool)
    for dst, src, off, n, bar in low.copies:         # the bulk copies, as the list says
        buf = low.consts if src < 0 else low.tables[src]
        smem[dst:dst + n] = buf.view(np.uint8)[off:off + n]
        assert not landed[bar]
        landed[bar] = True
    assert landed.all()
    if plan.consts_soff >= 0:
        n = low.consts.nbytes
        cst = torch.from_numpy(smem[plan.consts_soff:plan.consts_soff + n].view(low.consts.dtype))
    else:
        cst = torch.from_numpy(low.consts)
    tabs = {}
    for k, d in enumerate(rows):
        if d[b4.F_KIND] != 0:
            continue
        lane, item = int(d[b4.F_LANE]), 1 << int(d[b4.F_LANE])
        if d[b4.F_SOFF] >= 0:
            src = smem[int(d[b4.F_SOFF]):]
        else:
            src = low.tables[lane].view(np.uint8)[int(d[b4.F_TOFF]) * item:]
        n = int(d[b4.F_J] * d[b4.F_CO] * d[b4.F_E])
        tabs[k] = torch.from_numpy(src[:n * item].view(lanes[lane]).copy())

    poison = torch.tensor(-0x5A5A5A5A, dtype=dtype)
    n_t, tr = t.n_tiles, t.tile_rows
    xt = torch.zeros((n_t * tr, n_in), dtype=dtype)
    xt[:batch] = x
    bufs = [torch.full((n_t, tr, plan.stride_a), int(poison), dtype=dtype),
            torch.full((n_t, tr, plan.stride_b), int(poison), dtype=dtype)]
    bufs[0][..., :n_in] = xt.view(n_t, tr, n_in)
    bufs[0][..., n_in] = 0
    last_rows = batch - (n_t - 1) * tr
    for k, d in enumerate(rows):
        kind, s_n, j_n, co, e = (int(d[f]) for f in (b4.F_KIND, b4.F_S, b4.F_J, b4.F_CO,
                                                     b4.F_E))
        for n_rows in {tr, last_rows}:
            assert (_units(kind, s_n, co, j_n, n_rows) == 1).all()
        vin, vout = bufs[k % 2], bufs[1 - k % 2]
        gather = cst[int(d[b4.F_GATHER]):].long()

        def finish(acc, ks):
            acc = acc + cst[int(d[b4.F_BIAS]) + ks]
            for m in range(int(d[b4.F_NEPI])):
                op, wrap, off = (int(v) for v in d[b4.F_EPI0 + 3 * m:b4.F_EPI0 + 3 * m + 3])
                if op == 0:
                    p = [cst[off + 4 * ks + f] for f in range(4)]
                    res = _requant_cols(acc, p[0], p[1], p[2] != 0, "WRAP" if wrap else "SAT")
                    acc = torch.where(p[3] != 0, res, acc)
                else:
                    acc = acc * cst[off + ks]
            return acc

        if kind == 0:
            cc = b4.OUTPUTS_PER_WARP
            shift = int(d[b4.F_INSHIFT])
            for s in range(s_n):
                for c0 in range(0, co, cc):
                    cells0 = torch.arange(c0, min(c0 + cc, co))
                    acc = torch.zeros((n_t, tr, len(cells0)), dtype=dtype)
                    fast = int(d[b4.F_FASTMASK])
                    for j in range(j_n):
                        cells = j * co + cells0
                        if fast >= 0:                 # column gather[s, 0] + j, one mask
                            idx = vin[..., int(gather[s * j_n]) + j][..., None] & fast
                        else:
                            v = vin[..., int(gather[s * j_n + j])][..., None]
                            code = v if shift < 0 else _shift_round(v, cst[shift + cells])
                            idx = (code & cst[int(d[b4.F_MASK]) + cells]).clamp(0, e - 1)
                        acc = acc + tabs[k][cells * e + idx.long()].to(dtype)
                    ks = s * co + cells0
                    vout[..., ks] = finish(acc, ks)
        else:
            coef = cst[int(d[b4.F_COEF]):]
            for s in range(s_n):
                acc = torch.zeros((n_t, tr), dtype=dtype)
                for j in range(j_n):
                    acc = acc + vin[..., int(gather[s * j_n + j])] * coef[s * j_n + j]
                for c in range(co):
                    vout[..., s * co + c] = finish(acc, torch.tensor(s * co + c))
        vout[..., s_n * co] = 0
    final = bufs[len(rows) % 2]
    cols = cst[int(head[b4.H_OUTCOLS]):int(head[b4.H_OUTCOLS]) + int(head[b4.H_NOUT])]
    return final[..., cols.long()].reshape(n_t * tr, -1)[:batch]


@pytest.mark.parametrize("batch", BATCHES)
@pytest.mark.parametrize("name", CHAINS)
def test_kernel_model_equals_the_plain_version(chains, name, batch):
    packed, dtype = chains[name]
    if name.startswith("wide"):
        batch = min(batch, 64)          # the plain version holds (B, 1, 900, 64) indices
    chain = b4.PackedChain(packed, dtype, "cpu")
    low = b4.lower_chain(packed, dtype)
    x = torch.as_tensor(_codes(name, packed, batch, seed=batch), dtype=dtype)
    got = _model(low, dtype, x, _blocks(low.plan))
    want = _plain(chain, x)
    assert got.dtype == want.dtype and torch.equal(got, want)


@pytest.mark.parametrize("name", CHAINS)
def test_padded_lane_buffers_hold_every_table_where_the_plain_version_reads(chains, name):
    packed, dtype = chains[name]
    low = b4.lower_chain(packed, dtype)
    rows = low.desc[b4.N_HEADER:b4.N_HEADER + len(packed.stages) * b4.N_FIELDS]
    rows = rows.reshape(-1, b4.N_FIELDS)
    lane_end = [0, 0, 0, 0]
    for st, d in zip(packed.stages, rows):
        if st.kind != "lut":
            continue
        lane, toff = int(d[b4.F_LANE]), int(d[b4.F_TOFF])
        buf = low.tables[lane]
        assert buf.dtype == st.table.dtype
        assert np.array_equal(buf[toff:toff + st.table.size], st.table.ravel())
        assert (toff * buf.itemsize) % 16 == 0
        assert not buf[lane_end[lane]:toff].any()        # the padding before it is zero
        lane_end[lane] = toff + st.table.size
    for lane, buf in enumerate(low.tables):
        if buf is not None:
            assert buf.nbytes % 16 == 0 and not buf[lane_end[lane]:].any()


def test_plain_chain_still_equals_the_program(chains):
    """The lowering padded the lane buffers; the plain version, which reads
    the packed stages, still serves the JSC-HLF program bit for bit."""
    prog = chains["jsc-prog"]
    packed, dtype = chains["jsc-int32"]
    codes = _codes("jsc", packed, 4099, seed=5)
    chain = b4.PackedChain(packed, dtype, "cpu")
    got = b4.run_chain(chain, torch.as_tensor(codes, dtype=dtype))
    np.testing.assert_array_equal(got.numpy().astype(np.int64), prog.run(codes))


def test_lower_chain_refuses_what_the_kernel_cannot_read(chains):
    packed, dtype = chains["synthetic-int32"]
    bad = b4.PackedStages(list(packed.stages), packed.out_cols, packed.n_cols0)
    st = bad.stages[0]
    bad.stages[0] = b4.PackedStage(st.kind, st.gather + st.n_cols + 1, st.n_cols, st.bias,
                                   st.epilogue, st.in_shift, st.mask, st.table)
    with pytest.raises(b4.PackError, match="gathers outside"):
        b4.lower_chain(bad, dtype)


# ------------------------------------------------------------------- C10
@pytest.mark.parametrize("hidden", [17, 24, 32, 100])
def test_b3_plan_and_checks_take_any_hidden(hidden, monkeypatch):
    layer = LUTDense(4, 3, hidden=hidden, generator=torch.Generator().manual_seed(1),
                     device="cpu")
    args = [a.detach().clone() for a in layer.kernel_args()]
    b3._check((torch.zeros(9, 4), *args, torch.zeros(9, 3)))       # accepted
    plan = b3.launch_plan(16600, 20, 5, hidden, 132, 2)
    assert plan.n_partial == plan.n_split * 20 * (3 * hidden + 4) * 5
    # the wrapper's planning step, with the card's queries stubbed: no
    # maximum hidden width any more
    lib = types.SimpleNamespace(lut_dense_backward_blocks_per_sm=lambda h: 2,
                                lut_dense_backward_max_split_rows=lambda: 2048)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda dev: types.SimpleNamespace(multi_processor_count=132))
    dev = types.SimpleNamespace(index=0)
    monkeypatch.setattr(b3, "_PLANS", {})
    monkeypatch.setattr(b3, "_BLOCKS_PER_SM", {})
    assert b3._plan(lib, dev, 16600, 20, hidden, 5) == plan


def _bwd_args(b, ci, h, co, seed):
    rng = np.random.default_rng(seed)
    shapes = [(b, ci), (ci, h, co), (ci, h, co), (ci, h, co), (ci, co)]
    scales = [3.0, 1.0, 0.5, (h * ci) ** -0.5 * 3, 0.2]
    args = [rng.normal(0, s, sh) for s, sh in zip(scales, shapes)]
    # widths inside the reference's QuantConfig range [-8, 12] (ROADMAP C1, C7)
    for lo, hi in ((-8, 13), (-8, 5), (-2, 13), (-8, 3)):
        args.append(rng.integers(lo, hi, (ci, co)))
    g = rng.normal(0, 1, (b, co))
    return [a.astype(np.float32) for a in args], g.astype(np.float32)


@pytest.mark.parametrize("hidden", [17, 24])
def test_plain_b3_matches_jax_grad_past_sixteen_hidden(hidden):
    args, g = _bwd_args(53, 6, hidden, 7, seed=hidden)
    loss = lambda *a: jnp.sum(jref.lut_dense_train_ref(*a) * jnp.asarray(g))
    want = [np.asarray(a) for a in
            jax.grad(loss, argnums=tuple(range(9)))(*map(jnp.asarray, args))]
    got = pref.lut_dense_bwd_ref(*map(torch.as_tensor, args), torch.as_tensor(g))
    assert not want[6].any()                              # di_in: zero under WRAP
    for name, k, t in zip(("dx", "dw0", "db0", "dw_out", "db_out", "df_in", "df_out",
                           "di_out"), (0, 1, 2, 3, 4, 5, 7, 8), got):
        w = want[k]
        assert tuple(t.shape) == w.shape
        scale = max(float(np.abs(w).max()), 1e-6)
        assert float(np.abs(t.numpy() - w).max()) <= 1e-5 * scale, name


# a verbose CUDA graph DOT dump (cudaGraphDebugDotPrint) of two torch kernels,
# as the H100 machine's CUDA 12.8 writes it
_DOT = r'''digraph dot {
subgraph cluster_2 {
label="graph_2" graph[style="dashed"];
"graph_2_node_0"[style="bold" shape="record" label="{KERNEL
| {ID | 0 (topoId: 1) | _ZN2at6native29vectorized_elementwise_kernelILi4ENS0_21CUDAFunctorOnSelf_addIfEESt5arrayIPcLm2EEEEviT0_T1_\<\<\<1,128,0\>\>\>}
| {{node handle | func handle} | {0x0000000014553D80 | 0x000000000C475070}}
| {cooperative | 0}
| {priority | 0}
}"];

"graph_2_node_1"[style="bold" shape="record" label="{KERNEL
| {ID | 1 (topoId: 0) | _ZN45_GLOBAL__N__86f15fb6_12_lut_serve_cu_edcc227822lut_serve_chain_kernelIiLb1EEEvPKT_PS1_iPKlii\<\<\<32,512,221888\>\>\>}
| {{node handle | func handle} | {0x00000000145544E8 | 0x000000000940F740}}
| {cooperative | 0}
| {priority | 0}
}"];

"graph_2_node_0" -> "graph_2_node_1" [headlabel=0];
}
}
'''


def test_dot_kernel_names_reads_a_graph_dump():
    """``chip_smoke.device_kernels``' fallback counts a call's kernels from
    the DOT dump of its CUDA graph: one name per kernel node, without the
    launch configuration."""
    names = chip_smoke.dot_kernel_names(_DOT)
    assert len(names) == 2
    assert "vectorized_elementwise_kernel" in names[0]
    assert names[1].endswith("lut_serve_chain_kernelIiLb1EEEvPKT_PS1_iPKlii")
    assert chip_smoke.dot_kernel_names("digraph dot {\n}\n") == []
