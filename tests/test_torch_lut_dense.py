"""Port parity for the LUT-Dense layer and kernel B2's plain version.

The same reference parameters (``repro.core.lut_layers.LUTDense.init``, with
heterogeneous quantizer widths and non-trivial BN stats, carried as numpy
through ``repro_torch.interop``) and the same numpy-seeded inputs go through
the JAX eval ``apply`` / ``lut_dense_fused(interpret=True)`` and the port's
``forward`` / ``apply_fused``, at the JSC-HLF widths (16->20 with BN, 20->5,
H=8).

Tolerance: torch's and XLA's CPU ``tanh`` (and ``rsqrt``) differ in their last
ulps, so a cell value that lands within a few ulps of a rounding boundary of
its SAT output grid may round to the neighbouring code.  Such a flip moves a
per-cell code by exactly one step; each test counts the flips and bounds
them, and every output difference must be exactly the sum of its cells'
flips.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.lut_layers import LUTDense as RefLUTDense
from repro.core.quant import fake_quant as ref_fake_quant
from repro.core.quant import int_bits as ref_int_bits
from repro.kernels.lut_dense import lut_dense_fused as ref_lut_dense_fused
from repro_torch.core.lut_layers import LUTDense
from repro_torch.interop import (lut_dense_params_from_numpy,
                                 lut_dense_params_to_numpy)

torch.set_num_threads(2)

BATCH = 2048
HIDDEN = 8
# at most this share of cells may flip by one code (measured: none in 3.4 M
# cells over eight seeds); a systematic fault flips far more
CELL_FLIP_FRAC = 2e-4
LAYERS = [(16, 20, True), (20, 5, False)]


def ref_params(ci, co, bn, seed):
    """Reference init with heterogeneous widths, biases and BN stats."""
    layer = RefLUTDense(ci, co, hidden=HIDDEN, use_batchnorm=bn)
    p = jax.tree_util.tree_map(np.asarray, layer.init(jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    grid = (ci, co)
    p["q_in"] = {"f": rng.integers(2, 6, grid) + rng.uniform(-0.3, 0.3, grid),
                 "i": rng.integers(1, 4, grid) + rng.uniform(-0.3, 0.3, grid)}
    p["q_out"] = {"f": rng.integers(2, 7, grid) + rng.uniform(-0.3, 0.3, grid),
                  "i": rng.integers(0, 3, grid) + rng.uniform(-0.3, 0.3, grid)}
    p["b_out"] = rng.normal(0, 0.2, grid)
    if bn:
        p["bn_scale"] = rng.uniform(0.5, 1.5, grid)
        p["bn_bias"] = rng.normal(0, 0.3, grid)
        p["bn_mean"] = rng.normal(0, 0.3, grid)
        p["bn_var"] = rng.uniform(0.2, 2.0, grid)
    p = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), p)
    return layer, p


def port_layer(ci, co, bn, p):
    m = LUTDense(ci, co, hidden=HIDDEN, use_batchnorm=bn, device="cpu",
                 generator=torch.Generator().manual_seed(0))
    return lut_dense_params_from_numpy(m, p)


def inputs(ci, seed):
    return (np.random.default_rng(seed + 100).normal(0, 3, (BATCH, ci))
            .astype(np.float32))


def ref_cell_outputs(layer, p, x):
    jp = jax.tree_util.tree_map(jnp.asarray, p)
    xb = jnp.broadcast_to(jnp.asarray(x)[..., :, None], x.shape + (layer.c_out,))
    xq = ref_fake_quant(jp["q_in"], xb, layer.q_in, train=False)
    y = layer.cell_mlp(jp, xq)
    if layer.use_batchnorm:
        y = ((y - jp["bn_mean"]) * jax.lax.rsqrt(jp["bn_var"] + 1e-5)
             * jp["bn_scale"] + jp["bn_bias"])
    return np.asarray(ref_fake_quant(jp["q_out"], y, layer.q_out, train=False))


@pytest.mark.parametrize("ci,co,bn", LAYERS)
def test_params_round_trip(ci, co, bn):
    _layer, p = ref_params(ci, co, bn, seed=1)
    back = lut_dense_params_to_numpy(port_layer(ci, co, bn, p))
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(p)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(p)):
        np.testing.assert_array_equal(a, b)


def test_params_from_numpy_rejects_mismatch():
    _layer, p = ref_params(16, 20, True, seed=1)
    m = LUTDense(16, 20, hidden=HIDDEN, use_batchnorm=False, device="cpu",
                 generator=torch.Generator().manual_seed(0))
    with pytest.raises(KeyError):
        lut_dense_params_from_numpy(m, p)         # BN keys the module lacks


@pytest.mark.parametrize("ci,co,bn", LAYERS)
def test_eval_apply_matches_reference(ci, co, bn):
    layer, p = ref_params(ci, co, bn, seed=2)
    m = port_layer(ci, co, bn, p)
    x = inputs(ci, seed=2)
    f_out, _ = ref_int_bits(p["q_out"], layer.q_out)
    want_cells = ref_cell_outputs(layer, p, x)
    with torch.no_grad():
        got_cells = m.cell_outputs(torch.as_tensor(x)).numpy()
        got, aux = m(torch.as_tensor(x))
    d_codes = (got_cells.astype(np.float64) - want_cells) * np.exp2(f_out)
    n_flip = int(np.count_nonzero(d_codes))
    assert np.all(np.abs(d_codes) <= 1), "a cell moved by more than one code"
    assert n_flip <= CELL_FLIP_FRAC * d_codes.size, n_flip
    want, want_aux = layer.apply(jax.tree_util.tree_map(jnp.asarray, p),
                                 jnp.asarray(x))
    # the outputs differ by exactly the flipped cells' steps (sums are exact)
    np.testing.assert_array_equal(
        got.numpy().astype(np.float64) - np.asarray(want, np.float64),
        (got_cells.astype(np.float64) - want_cells).sum(axis=1))
    assert float(aux.ebops) == pytest.approx(float(want_aux.ebops), rel=1e-6)


@pytest.mark.parametrize("ci,co,bn", LAYERS)
def test_fused_plain_matches_reference_kernel(ci, co, bn):
    """Port ``apply_fused`` on the CPU (kernel B2's plain version) against the
    reference's Pallas kernel in interpret mode, on the same kernel args."""
    layer, p = ref_params(ci, co, bn, seed=3)
    m = port_layer(ci, co, bn, p)
    x = inputs(ci, seed=3)
    args = m.kernel_args()
    want = np.asarray(ref_lut_dense_fused(
        jnp.asarray(x), *(jnp.asarray(a.numpy()) for a in args),
        interpret=True))
    with torch.no_grad():
        got = m.apply_fused(torch.as_tensor(x)).numpy()
    step = np.exp2(-args[6].numpy().max(axis=0))          # finest f_out per o
    d = np.abs(got.astype(np.float64) - want) / step
    n_flip = int(np.count_nonzero(d))
    assert d.max() <= 2, "an output moved by more than two cell flips"
    assert n_flip <= CELL_FLIP_FRAC * ci * d.size, n_flip


@pytest.mark.parametrize("ci,co,bn", LAYERS)
def test_fused_plain_matches_port_eval(ci, co, bn):
    """``apply_fused`` folds BN into the output projection; against the eval
    forward it may differ only by counted boundary flips."""
    _layer, p = ref_params(ci, co, bn, seed=4)
    m = port_layer(ci, co, bn, p)
    x = torch.as_tensor(inputs(ci, seed=4))
    with torch.no_grad():
        y, _ = m(x)
        yf = m.apply_fused(x)
    step = torch.exp2(-m.kernel_args()[6].max(dim=0).values)
    d = ((yf - y).abs() / step).double()
    assert float(d.max()) <= 2
    assert int((d > 0).sum()) <= CELL_FLIP_FRAC * ci * d.numel()


def test_use_fused_forward_and_errors():
    _layer, p = ref_params(20, 5, False, seed=5)
    m = port_layer(20, 5, False, p)
    x = torch.as_tensor(inputs(20, seed=5))
    with torch.no_grad():
        want = m.apply_fused(x)
        m.use_fused = True
        got, aux = m(x)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert float(aux.ebops) > 0
    with pytest.raises(ValueError):
        m(torch.zeros(3, 7))
    m.train(True)
    with pytest.raises(NotImplementedError):
        m(x)
