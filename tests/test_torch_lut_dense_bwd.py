"""Port parity for kernel B3's plain version and the fused train pair.

``repro_torch.kernels.ref.lut_dense_bwd_ref`` (what B3 is held against on
the card) against ``jax.grad`` of ``repro.kernels.ref.lut_dense_train_ref``
for all nine gradients.  The Pallas B3 itself does not run under the
installed JAX (``pl.store`` / ``pl.load`` are gone: ROADMAP C1), so the
differentiable oracle stands in for it.  Shapes: the JSC layers 16->20 and
20->5 at a small batch, a ragged batch, a C_out that is no multiple of any
tile, and pruned cells (total width <= 0).

Tolerance: every per-element term is the same float32 expression in both
packages, but XLA's and torch's CPU ``tanh`` differ in their last ulps and
the sums over the batch run in another order, so each gradient holds to
``1e-5`` of its tensor's largest magnitude.  ``di_in`` is exactly zero.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.quant import QuantConfig as RefQuantConfig
from repro.core.quant import ste_bits as ref_ste_bits
from repro.kernels import ref as jref
from repro_torch.kernels import ops
from repro_torch.kernels import ref as pref

torch.set_num_threads(2)

REL = 1e-5
SHAPES = [(64, 16, 8, 20), (64, 20, 8, 5), (37, 20, 8, 5), (33, 5, 4, 7),
          (300, 7, 4, 13)]
NAMES = ("x", "w0", "b0", "w_out", "b_out", "f_in", "i_in", "f_out", "i_out")


def _args(b, ci, h, co, seed, pruned=True):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 3, (b, ci))
    w0 = rng.normal(0, 1, (ci, h, co))
    b0 = rng.normal(0, 0.5, (ci, h, co))
    wo = rng.normal(0, (h * ci) ** -0.5 * 3, (ci, h, co))
    bo = rng.normal(0, 0.2, (ci, co))
    fi = rng.integers(-1, 6, (ci, co))
    ii = rng.integers(-1, 4, (ci, co))
    fo = rng.integers(0, 6, (ci, co))
    io = rng.integers(-1, 2, (ci, co))          # narrow: many cells saturate
    if pruned:
        fi[0, :2], ii[0, :2] = -1, -1           # WRAP width <= 0
        fo[-1, -2:], io[-1, -2:] = -1, 0        # SAT width exactly 0
    g = rng.normal(0, 1, (b, co))
    return [a.astype(np.float32) for a in (x, w0, b0, wo, bo, fi, ii, fo, io)], \
        g.astype(np.float32)


def _jax_grads(args, g):
    loss = lambda *a: jnp.sum(jref.lut_dense_train_ref(*a) * jnp.asarray(g))
    return [np.asarray(a) for a in
            jax.grad(loss, argnums=tuple(range(9)))(*map(jnp.asarray, args))]


def _close(got, want, name):
    scale = max(float(np.abs(want).max()), 1e-6)
    err = float(np.abs(got - want).max())
    assert err <= REL * scale, f"{name}: max|d| {err} > {REL} * {scale}"


@pytest.mark.parametrize("b,ci,h,co", SHAPES)
def test_plain_b3_matches_jax_grad(b, ci, h, co):
    args, g = _args(b, ci, h, co, seed=b + ci)
    want = _jax_grads(args, g)
    got = pref.lut_dense_bwd_ref(*map(torch.as_tensor, args), torch.as_tensor(g))
    assert len(got) == 8
    for name, k, t in zip(("dx", "dw0", "db0", "dw_out", "db_out", "df_in",
                           "df_out", "di_out"), (0, 1, 2, 3, 4, 5, 7, 8), got):
        assert tuple(t.shape) == want[k].shape
        _close(t.numpy(), want[k], name)
    assert not want[6].any()                    # di_in: zero under WRAP
    # pruned cells: no gradient reaches their widths or their weights
    assert (got[5][0, :2] == 0).all() and (got[6][-1, -2:] == 0).all()
    assert (got[1][0, :, :2] == 0).all() and (got[4][-1, -2:] == 0).all()


@pytest.mark.parametrize("b,ci,h,co", SHAPES[1:3])
def test_lut_dense_function_matches_autograd_of_oracle(b, ci, h, co):
    """The port's ``ops.lut_dense`` autograd.Function (B2 + B3 pair) against
    autograd through the port's differentiable oracle, all nine inputs."""
    args, g = _args(b, ci, h, co, seed=7 * b)
    ta = [torch.tensor(a, requires_grad=True) for a in args]
    tb = [torch.tensor(a, requires_grad=True) for a in args]
    ya = ops.lut_dense(*ta)
    yb = pref.lut_dense_train_ref(*tb)
    np.testing.assert_array_equal(ya.detach().numpy(), yb.detach().numpy())
    (ya * torch.as_tensor(g)).sum().backward()
    (yb * torch.as_tensor(g)).sum().backward()
    for name, a, b_ in zip(NAMES, ta, tb):
        _close(a.grad.numpy(), b_.grad.numpy(), name)
    assert not ta[6].grad.any()


def test_lut_dense_train_continuous_widths():
    """``ops.lut_dense_train`` (clip + round-STE on continuous widths) against
    jax.grad of the same chain in the reference: ste_bits into the oracle."""
    args, g = _args(48, 20, 8, 5, seed=3, pruned=False)
    rng = np.random.default_rng(4)
    for k in (5, 6, 7, 8):
        args[k] = (args[k] + rng.uniform(-0.45, 0.45, args[k].shape)).astype(np.float32)
    args[5][1, 1] = 6.0                         # exactly on a clip bound
    clip = ((-2.0, 6.0), (-1.0, 4.0))

    def ref_loss(*a):
        cfg = RefQuantConfig(min_f=-2.0, max_f=6.0, min_i=-1.0, max_i=4.0)
        fi, ii = ref_ste_bits({"f": a[5], "i": a[6]}, cfg)
        fo, io = ref_ste_bits({"f": a[7], "i": a[8]}, cfg)
        return jnp.sum(jref.lut_dense_train_ref(*a[:5], fi, ii, fo, io) * jnp.asarray(g))

    want = [np.asarray(w) for w in
            jax.grad(ref_loss, argnums=tuple(range(9)))(*map(jnp.asarray, args))]
    ta = [torch.tensor(a, requires_grad=True) for a in args]
    y = ops.lut_dense_train(*ta, clip_in=clip, clip_out=clip)
    (y * torch.as_tensor(g)).sum().backward()
    for name, t, w in zip(NAMES, ta, want):
        _close(t.grad.numpy(), w, name)
