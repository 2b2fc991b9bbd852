"""Port parity for the LUT-Conv slice: ``_same_pads``, ``im2col_1d/2d`` and
their backward, ``LUTConv1D/2D`` eval and train forwards, EBOPs and
gradients, and their lowerings, against the JAX package.

The same numpy inputs (from a seed) and the same reference parameters
(``repro.core.lut_layers.LUTConv1D/2D.init`` carried through
``repro_torch.interop`` into the conv's ``dense``) go through both packages.

Tolerances, and why:
* Patches are copies: equal values, exactly.  Their backward sums each
  input's windows, in another order than XLA's scatter-add, so it is held
  to ``VJP_RTOL`` of the largest cotangent sum.
* A LUT cell's value passes through each package's CPU ``tanh``, which
  differ in the last ulp, so a value on a rounding boundary of its grid may
  take the neighbouring code (ROADMAP C6c).  Each forward counts its
  flipped cells (at most ``FLIP_FRAC`` of them); an output holds exactly
  unless one of its cells flipped.  A flipped cell moves its row's
  gradient terms, allowed as ``FLIP_ATOL`` a flip; other gradients hold to
  ``GRAD_RTOL`` of their tensor's largest plus ``GRAD_ATOL``.  EBOPs are
  sums of the same integer widths: ``rel=1e-6``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import lut_layers as ref_ll
from repro.core.lower import lower as ref_lower
from repro.core.lower import GraphInput as RefGraphInput
from repro.core.lower import ModelGraph as RefModelGraph
from repro.core.quant import fake_quant as ref_fake_quant
from repro_torch.core import lower as port_lower
from repro_torch.core.lut_layers import (LUTConv1D, LUTConv2D, _same_pads,
                                         im2col_1d, im2col_2d)
from repro_torch.core.tables import LayerTables, extract_tables
from repro_torch.interop import layer_params_from_numpy, layer_params_to_numpy

torch.set_num_threads(2)

HIDDEN = 4
VJP_RTOL = 1e-6
FLIP_FRAC = 2e-3
FLIP_ATOL = 2e-3
GRAD_RTOL = 1e-4
GRAD_ATOL = 2e-6
# the reference's own sweep of SAME 1-D patches (tests/test_lut_layers.py)
SWEEP_1D = [(7, 3, 1), (7, 3, 2), (8, 3, 2), (5, 4, 2), (9, 2, 3), (10, 5, 4),
            (6, 3, 3)]
SWEEP_2D = [((7, 8), (3, 3), (2, 2)), ((8, 8), (3, 3), (1, 1)),
            ((7, 8), (2, 3), (3, 1)), ((5, 6), (3, 2), (1, 3)),
            ((6, 5), (4, 4), (2, 3))]


# ---------------------------------------------------------------- im2col
@pytest.mark.parametrize("size,k,s", [(t, k, s) for t, k, s in SWEEP_1D]
                         + [(1, 3, 1), (20, 20, 20), (3000, 20, 20), (4, 5, 2)])
def test_same_pads_match_reference(size, k, s):
    assert _same_pads(size, k, s) == ref_ll._same_pads(size, k, s)


def _vjp_check(ref_fn, port_fn, x, seed):
    want, vjp = jax.vjp(ref_fn, jnp.asarray(x))
    xt = torch.as_tensor(x).requires_grad_(True)
    got = port_fn(xt)
    assert tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
    ct = np.random.default_rng(seed).normal(0, 1, want.shape).astype(np.float32)
    (gx_ref,) = vjp(jnp.asarray(ct))
    (gx,) = torch.autograd.grad(got, xt, torch.as_tensor(ct))
    gx_ref = np.asarray(gx_ref)
    np.testing.assert_allclose(gx.numpy(), gx_ref, rtol=0,
                               atol=VJP_RTOL * max(float(np.abs(gx_ref).max()), 1.0))


@pytest.mark.parametrize("padding", ["SAME", "VALID"])
@pytest.mark.parametrize("t,k,s", SWEEP_1D)
def test_im2col_1d_and_vjp_match_reference(t, k, s, padding):
    x = np.random.default_rng(t * 100 + k * 10 + s).normal(0, 2, (2, 3, t, 3)) \
        .astype(np.float32)
    _vjp_check(lambda a: ref_ll.im2col_1d(a, k, s, padding),
               lambda a: im2col_1d(a, k, s, padding), x, seed=k)


@pytest.mark.parametrize("padding", ["SAME", "VALID"])
@pytest.mark.parametrize("hw,k,s", SWEEP_2D)
def test_im2col_2d_and_vjp_match_reference(hw, k, s, padding):
    x = np.random.default_rng(sum(hw) + sum(k)).normal(0, 2, (2,) + hw + (3,)) \
        .astype(np.float32)
    _vjp_check(lambda a: ref_ll.im2col_2d(a, k, s, padding),
               lambda a: im2col_2d(a, k, s, padding), x, seed=sum(s))


def test_im2col_shorter_than_a_window_is_empty():
    x = np.ones((2, 2, 3), np.float32)
    want = ref_ll.im2col_1d(jnp.asarray(x), 3)
    got = im2col_1d(torch.as_tensor(x), 3)
    assert tuple(got.shape) == want.shape == (2, 0, 9)


def test_im2col_backward_repeats_bit_for_bit():
    """No atomics in the patches' backward: two backward passes of one
    input and cotangent give the same bits."""
    x = torch.randn((4, 40, 8), generator=torch.Generator().manual_seed(0),
                    requires_grad=True)
    ct = torch.randn((4, 40, 24), generator=torch.Generator().manual_seed(1))
    g = [torch.autograd.grad(im2col_1d(x, 3, 1, "SAME"), x, ct)[0] for _ in range(2)]
    assert torch.equal(g[0], g[1])


# -------------------------------------------------------------- LUT-Conv
CONVS = {
    "1d_same": (dict(c_in=3, c_out=4, kernel=3, padding="SAME"), (16, 12, 3)),
    "1d_stride2": (dict(c_in=4, c_out=3, kernel=3, stride=2), (16, 11, 4)),
    "2d_same": (dict(c_in=2, c_out=3, kernel=(3, 3), padding="SAME"), (8, 6, 6, 2)),
    "2d_stride": (dict(c_in=2, c_out=2, kernel=(2, 3), stride=(2, 1)), (8, 7, 6, 2)),
}


def _conv_pair(name, seed):
    """The reference conv with heterogeneous widths and its port, carrying
    the same parameters; plus a numpy input."""
    kw, x_shape = CONVS[name]
    ref_cls, port_cls = ((ref_ll.LUTConv1D, LUTConv1D) if name.startswith("1d")
                         else (ref_ll.LUTConv2D, LUTConv2D))
    ref = ref_cls(hidden=HIDDEN, **kw)
    p = jax.tree_util.tree_map(np.asarray, ref.init(jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    grid = p["q_in"]["f"].shape
    p["q_in"] = {"f": rng.integers(2, 6, grid) + rng.uniform(-0.3, 0.3, grid),
                 "i": rng.integers(1, 4, grid) + rng.uniform(-0.3, 0.3, grid)}
    p["q_out"] = {"f": rng.integers(2, 6, grid) + rng.uniform(-0.3, 0.3, grid),
                  "i": rng.integers(0, 3, grid) + rng.uniform(-0.3, 0.3, grid)}
    p["b_out"] = rng.normal(0, 0.2, grid)
    p = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), p)
    port = port_cls(hidden=HIDDEN, device="cpu",
                    generator=torch.Generator().manual_seed(seed), **kw)
    layer_params_from_numpy(port, p)
    x = rng.normal(0, 2, x_shape).astype(np.float32)
    return ref, p, port, x


def _cell_flips(ref, p, port, x, train):
    """Cells whose SAT output code differs between the two packages, on the
    same patches."""
    dense = ref.dense
    pj = jax.tree_util.tree_map(jnp.asarray, p)
    patches = (ref_ll.im2col_1d(jnp.asarray(x), ref.kernel, ref.stride, ref.padding)
               if isinstance(ref, ref_ll.LUTConv1D)
               else ref_ll.im2col_2d(jnp.asarray(x), ref.kernel, ref.stride, ref.padding))
    xb = jnp.broadcast_to(patches[..., :, None], patches.shape + (dense.c_out,))
    want = ref_fake_quant(pj["q_out"], dense.cell_mlp(
        pj, ref_fake_quant(pj["q_in"], xb, dense.q_in, train=train)),
        dense.q_out, train=train)
    with torch.no_grad():
        got, _ = port.dense._cells(port._patches(torch.as_tensor(x)), train)
    n = int((got.numpy() != np.asarray(want)).sum())
    assert n <= FLIP_FRAC * got.numel(), f"{n} of {got.numel()} cells flipped"
    return n


@pytest.mark.parametrize("name", sorted(CONVS))
@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_lut_conv_forward_and_ebops_match_reference(name, train):
    ref, p, port, x = _conv_pair(name, seed=3)
    want, aux = ref.apply(jax.tree_util.tree_map(jnp.asarray, p), jnp.asarray(x),
                          train=train)
    port.train(train)
    with torch.no_grad():
        got, paux = port(torch.as_tensor(x))
    assert tuple(got.shape) == want.shape
    n_flips = _cell_flips(ref, p, port, x, train)
    d = np.abs(got.numpy() - np.asarray(want))
    assert int((d > 0).sum()) <= n_flips, "an output moved without a cell flip"
    assert float(paux.ebops) == pytest.approx(float(aux.ebops), rel=1e-6)
    assert paux.updates == {} and aux.updates == {}


@pytest.mark.parametrize("name", sorted(CONVS))
@pytest.mark.parametrize("fused", [False, True], ids=["einsum", "fused"])
def test_lut_conv_train_gradients_match_reference(name, fused):
    """Gradients of sum(y * r) + 1e-4 * EBOPs through the train forward:
    the port's einsum path and its fused pair (B2/B3's plain versions here)
    against ``jax.grad`` of the reference's einsum path."""
    ref, p, port, x = _conv_pair(name, seed=7)
    r = np.random.default_rng(11).normal(0, 1, ref.apply(
        jax.tree_util.tree_map(jnp.asarray, p), jnp.asarray(x))[0].shape) \
        .astype(np.float32)

    def loss(params):
        y, aux = ref.apply(params, jnp.asarray(x), train=True)
        return jnp.sum(y * r) + 1e-4 * aux.ebops

    want = jax.grad(loss)(jax.tree_util.tree_map(jnp.asarray, p))
    port.train(True)
    y, aux = port(torch.as_tensor(x), fused=fused)
    total = torch.sum(y * torch.as_tensor(r)) + 1e-4 * aux.ebops
    names = [n for n, _ in port.dense.named_parameters()]
    grads = torch.autograd.grad(total, list(port.dense.parameters()))
    n_flips = _cell_flips(ref, p, port, x, True)
    for n, g in zip(names, grads):
        key, _, sub = n.partition(".")
        w = np.asarray(want[key][sub] if sub else want[key])
        tol = GRAD_RTOL * float(np.abs(w).max()) + GRAD_ATOL + FLIP_ATOL * n_flips
        err = float(np.abs(g.numpy() - w).max())
        assert err <= tol, f"grad {n}: max|d| {err} > {tol}"


def test_lut_conv_parameters_are_the_dense_layer_and_round_trip():
    ref, p, port, _x = _conv_pair("1d_same", seed=1)
    assert port.dense.c_in == ref.dense.c_in == 9
    back = layer_params_to_numpy(port)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(p)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(p)):
        np.testing.assert_array_equal(a, b)


def test_lut_conv_use_fused_reaches_the_fused_pair(monkeypatch):
    """``use_fused`` passes through the wrapper to ``kernels/ops.lut_dense``
    (B2/B3 on the card)."""
    from repro_torch.kernels import ops

    _ref, _p, port, x = _conv_pair("1d_same", seed=2)
    calls = []
    real = ops.lut_dense
    monkeypatch.setattr(ops, "lut_dense", lambda *a: calls.append(1) or real(*a))
    port.dense.use_fused = True
    port(torch.as_tensor(x))
    port(torch.as_tensor(x), fused=False)
    assert calls == [1]


# --------------------------------------------------------------- lowering
@pytest.mark.parametrize("name", sorted(CONVS))
def test_lut_conv_lowering_identical_with_reference_tables(name, monkeypatch):
    """The conv lowered by both packages gives the same program arrays when
    the port is handed the reference's tables (one table set shared by
    every site; SAME pads read one cached CONST 0 register); the port's own
    tables differ from the reference's by at most counted one-code flips."""
    ref, p, port, _x = _conv_pair(name, seed=5)
    shape = CONVS[name][1][1:]
    gi = dict(shape=shape, f=3, i=2)
    want = ref_lower(RefModelGraph(RefGraphInput(**gi), [ref]),
                     [jax.tree_util.tree_map(jnp.asarray, p)])
    t = want.tables[0]
    monkeypatch.setattr(port_lower, "extract_tables", lambda layer: LayerTables(
        **{f: getattr(t, f) for f in LayerTables.__dataclass_fields__}))
    got = port_lower.lower(port_lower.ModelGraph(port_lower.GraphInput(**gi), [port]))
    a, b = got.to_arrays(), want.to_arrays()
    assert sorted(a) == sorted(b)
    for k in b:
        assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert sum(1 for s in got.segments if s.kind == "lut") == got.segments[-1].n_sites
    mine = extract_tables(port)
    d = mine.codes - t.codes
    assert np.all(np.abs(d) <= 1) and np.count_nonzero(d) <= 1e-3 * d.size
