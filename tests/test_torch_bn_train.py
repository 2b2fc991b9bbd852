"""Train-mode batch-norm on the fused pair (``LUTDense`` with
``use_batchnorm``, ``fused=True``): the batch statistics of the cell outputs
from ``ops.lut_bn_stats`` (its plain versions ``ref.lut_bn_stats_ref`` and
``ref.lut_bn_stats_grad_ref`` here), folded into B2's output projection.

Held against the layer's einsum path and the JAX reference's
``LUTDense.apply(train=True)``: outputs (a cell on a rounding boundary of
its grid may take the neighbouring code, as in ``test_torch_train.py``),
the moving-stat updates and the gradient of every leaf.  The fold and the
einsum path round in another order, so each comparison counts the cells
whose SAT code differs from the reference's and allows ``FLIP_ATOL`` a flip,
as ``test_torch_train.py`` does.  A gradient that is zero in exact
arithmetic (``b_out`` under batch-norm; every weight of the cells at a batch
of one, whose output is ``bn_bias``) is rounding noise of sums of the terms
of the BN bias gradient, and is held to ``SHADOWED_RTOL`` of it.  So is
``q_out/f`` at a batch of one: the variance is 0 there, and the fold
multiplies the cells' rounding by ``rsqrt(1e-5)``, about 316, which moves
``y - round(y)`` in that width's surrogate.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.lut_layers import LUTDense as RefLUTDense
from repro.core.quant import fake_quant as ref_fake_quant
from repro_torch import interop
from repro_torch.core.lut_layers import LUTDense
from repro_torch.core.quant import fq_surrogate
from repro_torch.kernels import build, ops, ref

torch.set_num_threads(2)

FLIP_FRAC = 2e-3
FLIP_ATOL = 2e-3
GRAD_RTOL = 1e-4
GRAD_ATOL = 2e-6
SHADOWED_RTOL = 1e-3
C_IN, C_OUT = 16, 20


def _params(hidden, seed):
    """Reference init of a batch-norm 16 -> 20 layer with heterogeneous
    widths, biases and BN state, as ``test_torch_train._ref_params``."""
    rng = np.random.default_rng(seed)
    layer = RefLUTDense(C_IN, C_OUT, hidden=hidden, use_batchnorm=True)
    p = jax.tree_util.tree_map(np.asarray, layer.init(jax.random.PRNGKey(seed)))
    grid = (C_IN, C_OUT)
    p["q_in"] = {"f": rng.integers(2, 6, grid) + rng.uniform(-0.3, 0.3, grid),
                 "i": rng.integers(1, 4, grid) + rng.uniform(-0.3, 0.3, grid)}
    p["q_out"] = {"f": rng.integers(2, 6, grid) + rng.uniform(-0.3, 0.3, grid),
                  "i": rng.integers(0, 3, grid) + rng.uniform(-0.3, 0.3, grid)}
    p["b_out"] = rng.normal(0, 0.2, grid)
    p["bn_scale"] = rng.uniform(0.5, 1.5, grid)
    p["bn_bias"] = rng.normal(0, 0.3, grid)
    p["bn_mean"] = rng.normal(0, 0.3, grid)
    p["bn_var"] = rng.uniform(0.2, 2.0, grid)
    return layer, jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), p)


def _port(hidden, params, **kw):
    layer = LUTDense(C_IN, C_OUT, hidden=hidden, use_batchnorm=True, device="cpu",
                     generator=torch.Generator().manual_seed(0), **kw)
    interop.stack_params_from_numpy([layer], {"l0": params})
    return layer.train(True)


def _leaves(layer):
    return {k.replace(".", "/"): p for k, p in layer.named_parameters()}


def _ref_codes(ref_layer, params, x):
    """The reference's per-cell SAT codes in train mode."""
    p = jax.tree_util.tree_map(jnp.asarray, params)
    xb = jnp.broadcast_to(x[..., :, None], x.shape + (C_OUT,))
    y = ref_layer.cell_mlp(p, ref_fake_quant(p["q_in"], xb, ref_layer.q_in))
    y = (y - jnp.mean(y, 0)) * jax.lax.rsqrt(jnp.var(y, 0) + 1e-5) \
        * p["bn_scale"] + p["bn_bias"]
    return np.asarray(ref_fake_quant(p["q_out"], y, ref_layer.q_out))


def _fused_codes(layer, x):
    """The fused path's per-cell SAT codes: the fold of the plain statistics
    into the output projection, as ``LUTDense._fused_bn_train`` forms it."""
    with torch.no_grad():
        w0, b0, wo, bo, fi, ii, fo, io = layer._cell_args(False)
        mean, var = ref.lut_bn_stats_ref(x, w0, b0, wo, bo, fi, ii)
        inv = layer.bn_scale * torch.rsqrt(var + 1e-5)
        y = ref._recompute(x, w0, b0, wo * inv[:, None, :],
                           (bo - mean) * inv + layer.bn_bias, fi, ii)[-1]
        return ref.fake_quant_ref(y, fo[None], io[None], True, "SAT").numpy()


def _check_grads(got, want, n_flips, zero_paths):
    shadow = float(np.abs(want["bn_bias"]).max())
    for path, g in got.items():
        w = want[path]
        if path in zero_paths or not w.any():
            tol = SHADOWED_RTOL * shadow + GRAD_ATOL
        else:
            tol = GRAD_RTOL * float(np.abs(w).max()) + GRAD_ATOL
        tol += FLIP_ATOL * n_flips
        err = float(np.abs(g - w).max())
        assert err <= tol, f"grad {path}: max|d| {err} > {tol}"


@pytest.mark.parametrize("batch,hidden", [(1, 8), (33, 8), (1000, 8), (33, 20)])
def test_bn_train_fused_matches_einsum_and_reference(batch, hidden):
    """Outputs, moving-stat updates and every leaf's gradient of the fused
    batch-norm path against the layer's einsum path and the reference, at a
    batch of one, a ragged batch, a large one, and H = 20 (the kernels'
    generic instantiations on the card)."""
    ref_layer, params = _params(hidden, batch)
    rng = np.random.default_rng(batch + hidden)
    x = (np.round(rng.normal(0, 2, (batch, C_IN)) * 32) / 32).astype(np.float32)
    gy = rng.normal(0, 1, (batch, C_OUT)).astype(np.float32)

    def ref_loss(p):
        y, aux = ref_layer.apply(p, jnp.asarray(x), train=True)
        return jnp.sum(y * gy), (y, aux)

    (_, (want, aux)), rgrad = jax.value_and_grad(ref_loss, has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, params))
    want = np.asarray(want)
    rgrad = {f"{k}/{kk}" if isinstance(v, dict) else k: np.asarray(vv)
             for k, v in rgrad.items() for kk, vv in (v.items() if isinstance(v, dict)
                                                      else [(None, v)])}

    fused, einsum = _port(hidden, params), _port(hidden, params)
    xt = torch.as_tensor(x)
    n_flips = int((_fused_codes(fused, xt) != _ref_codes(ref_layer, params, x)).sum())
    assert n_flips <= FLIP_FRAC * batch * C_IN * C_OUT + 1
    out = {}
    for name, layer, fz in (("fused", fused, True), ("einsum", einsum, False)):
        ops.reset_launch_counts()
        y, paux = layer(xt, fused=fz)
        assert set(ops.launch_counts().values()) == {0}      # plain versions on the CPU
        (y * torch.as_tensor(gy)).sum().backward()
        out[name] = (y.detach().numpy(), paux,
                     {k: p.grad.numpy() for k, p in _leaves(layer).items()})
    got, paux, pgrad = out["fused"]
    d = np.abs(got - want)
    assert (d == 0).mean() >= 1 - FLIP_FRAC * C_IN
    assert np.abs(got - out["einsum"][0]).max() <= FLIP_ATOL * 8 * max(n_flips, 1)
    assert set(paux.updates) == {"bn_mean", "bn_var"} == set(aux.updates)
    for k in aux.updates:
        np.testing.assert_allclose(paux.updates[k].numpy(), np.asarray(aux.updates[k]),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(paux.updates[k].numpy(),
                                   out["einsum"][1].updates[k].numpy(), rtol=1e-5, atol=1e-6)
    zero = {"b_out"} | ({"w0", "b0", "w_out", "bn_scale", "q_in/f", "q_in/i", "q_out/f"}
                        if batch == 1 else set())
    _check_grads(pgrad, rgrad, n_flips, zero)
    _check_grads(pgrad, out["einsum"][2], n_flips, zero)


@pytest.mark.parametrize("kw", [dict(activation="relu"), dict(n_hidden_layers=2)],
                         ids=["relu", "two_hidden"])
def test_bn_train_layer_the_pair_does_not_cover_takes_the_einsum_path(kw):
    """A batch-norm layer outside the fused pair's cells trains on the
    einsum path under ``fused=True``, without raising, bit for bit."""
    layer = LUTDense(6, 4, hidden=4, use_batchnorm=True, device="cpu",
                     generator=torch.Generator().manual_seed(2), **kw).train(True)
    assert not layer.fused_covers()
    other = copy.deepcopy(layer)
    x = torch.randn(17, 6, generator=torch.Generator().manual_seed(3))
    (ya, aa), (yb, ab) = layer(x, fused=True), other(x, fused=False)
    assert torch.equal(ya, yb)
    assert all(torch.equal(aa.updates[k], ab.updates[k]) for k in ("bn_mean", "bn_var"))
    ya.sum().backward()
    yb.sum().backward()
    for (n, p), (_, q) in zip(layer.named_parameters(), other.named_parameters()):
        assert (p.grad is None) == (q.grad is None), n
        if p.grad is not None:
            assert torch.equal(p.grad, q.grad), n
    with pytest.raises(NotImplementedError):
        layer.eval()(x, fused=True)                  # eval on the pair: not covered


@pytest.mark.parametrize("batch,hidden", [(1, 3), (50, 8), (129, 17)])
def test_bn_stats_pair_matches_autograd(batch, hidden):
    """``ops.lut_bn_stats`` (plain versions): the mean and population
    variance of the raw cell outputs, and gradients of every input equal to
    autograd through the same cells built from ``fq_surrogate``."""
    rng = np.random.default_rng(batch * hidden)
    ci, co = 5, 7
    shapes = [(batch, ci), (ci, hidden, co), (ci, hidden, co), (ci, hidden, co), (ci, co)]
    scales = [3.0, 1.0, 0.5, 0.5, 0.2]
    args = [torch.as_tensor(rng.normal(0, s, sh), dtype=torch.float32).requires_grad_()
            for s, sh in zip(scales, shapes)]
    widths = [torch.as_tensor(rng.integers(lo, hi, (ci, co)), dtype=torch.float32)
              .requires_grad_() for lo, hi in ((-1, 6), (-1, 4))]
    g_mean, g_var = (torch.as_tensor(rng.normal(0, 1, (ci, co)), dtype=torch.float32)
                     for _ in range(2))
    mean, var = ops.lut_bn_stats(*args, *widths)
    got = torch.autograd.grad((mean * g_mean).sum() + (var * g_var).sum(), args + widths)

    x, w0, b0, wo, bo = args
    xb = x[:, :, None].expand(batch, ci, co)
    xq = fq_surrogate(xb, *widths, signed=True, overflow="WRAP")
    p = torch.tanh(xq[:, :, None, :] * w0 + b0) * wo
    y = p[:, :, 0]
    for k in range(1, hidden):
        y = y + p[:, :, k]
    y = y + bo
    m, v = y.mean(0), y.var(0, correction=0)
    want = torch.autograd.grad((m * g_mean).sum() + (v * g_var).sum(), args + widths,
                               allow_unused=True)
    torch.testing.assert_close(mean, m, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(var, v, rtol=1e-5, atol=1e-6)
    for k, (a, b) in enumerate(zip(got, want)):
        b = torch.zeros_like(a) if b is None else b
        tol = 1e-5 * float(b.abs().max()) + 1e-6
        assert float((a - b).abs().max()) <= tol, (k, float((a - b).abs().max()), tol)
    assert not got[-1].any()                          # i_in: no surrogate under WRAP


def test_bn_stats_counters_are_registered():
    """The pair's launch counters read 0 before their first launch, so a
    chunk's launches (``train/loop.py``) count them from the start."""
    assert set(build.COUNTERS) <= set(ops.launch_counts())
    assert {"lut_bn_stats", "lut_bn_stats_grad"} <= set(build.COUNTERS) - set(build.SOURCES)
