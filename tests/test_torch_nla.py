"""The port's ``NLALayer`` (``core/nla_baseline.py``) against the reference's.

Parameters come from the reference's ``init`` and cross as numpy
(``interop.nla_params_from_numpy``); inputs come from numpy seeds.  At
16->20, 20->5 and 13->4 (13 inputs: the last leaf's mapping still reads any
of them, as the leaves are ``ceil(C_in / F)``):

* the forward within ``FWD_RTOL`` of the reference's largest output;
* the same hard indices (``argmax`` takes the first maximum in both, ties
  included);
* every parameter's gradient of a CE loss, and the input's, within
  ``GRAD_RTOL`` of its tensor's largest magnitude against ``jax.grad``;
  the mapping logits get theirs through the softmax path only;
* a numpy round trip of the parameters.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.nla_baseline import NLALayer as RefNLALayer
from repro_torch import interop
from repro_torch.core.nla_baseline import NLALayer

torch.set_num_threads(2)

FWD_RTOL = 1e-5
GRAD_RTOL = 1e-4
BATCH = 48
SHAPES = [(16, 20), (20, 5), (13, 4)]


def _ref_params(ref, seed):
    return jax.tree_util.tree_map(np.array, ref.init(jax.random.PRNGKey(seed)))


def _port(c_in, c_out, params):
    layer = NLALayer(c_in, c_out, device="cpu", generator=torch.Generator().manual_seed(1))
    return interop.nla_params_from_numpy(layer, params)


def _data(c_in, c_out, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (BATCH, c_in)).astype(np.float32)
    return x, rng.integers(0, c_out, BATCH).astype(np.int32)


def _ref_loss(ref, params, x, y):
    out, _ = ref.apply(params, x, train=True)
    return -jnp.mean(jax.nn.log_softmax(out)[jnp.arange(x.shape[0]), y])


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}" if prefix else k))
        return out
    return {prefix: np.asarray(tree)}


@pytest.mark.parametrize("c_in,c_out", SHAPES)
def test_structure_and_keys(c_in, c_out):
    ref = RefNLALayer(c_in, c_out)
    want = _flat(_ref_params(ref, 0))
    layer = NLALayer(c_in, c_out, device="cpu", generator=torch.Generator().manual_seed(0))
    got = _flat(interop.nla_params_to_numpy(layer))
    assert layer.n_leaves == ref.n_leaves
    assert {k: v.shape for k, v in got.items()} == {k: v.shape for k, v in want.items()}
    assert all(v.dtype == np.float32 for v in got.values())
    # one seed, one set of weights, on any device
    again = NLALayer(c_in, c_out, device="cpu", generator=torch.Generator().manual_seed(0))
    for k, v in _flat(interop.nla_params_to_numpy(again)).items():
        np.testing.assert_array_equal(v, got[k])


@pytest.mark.parametrize("c_in,c_out", SHAPES)
def test_forward_and_hard_indices_match_reference(c_in, c_out):
    ref = RefNLALayer(c_in, c_out)
    params = _ref_params(ref, c_in)
    # ties: two equal maxima in a few rows; both pick the first
    params["map_logits"][0, 0, :2] = 5.0
    params["map_logits"][-1, -1, -2:] = 5.0
    layer = _port(c_in, c_out, params)
    x, _ = _data(c_in, c_out, 1)
    want, aux = ref.apply(params, x)
    got, paux = layer(torch.as_tensor(x))
    want = np.asarray(want)
    assert got.shape == want.shape == (BATCH, c_out)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                               atol=FWD_RTOL * float(np.abs(want).max()))
    np.testing.assert_array_equal(
        torch.argmax(layer.map_logits, -1).numpy(),
        np.asarray(jnp.argmax(params["map_logits"], -1)))
    assert int(torch.argmax(layer.map_logits, -1)[0, 0]) == 0
    assert float(paux.ebops) == float(aux.ebops) == 0.0
    # leading batch axes pass through
    got3, _ = layer(torch.as_tensor(x.reshape(4, BATCH // 4, c_in)))
    np.testing.assert_allclose(got3.detach().numpy().reshape(BATCH, c_out),
                               got.detach().numpy(), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("c_in,c_out", SHAPES)
def test_gradients_match_jax_grad(c_in, c_out):
    ref = RefNLALayer(c_in, c_out)
    params = _ref_params(ref, 10 + c_in)
    x, y = _data(c_in, c_out, 2)
    want, want_x = jax.grad(lambda p, xx: _ref_loss(ref, p, xx, y), argnums=(0, 1))(
        jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(x))
    layer = _port(c_in, c_out, params)
    xt = torch.as_tensor(x).requires_grad_(True)
    out, _ = layer(xt)
    loss = -torch.mean(torch.log_softmax(out, -1).gather(-1, torch.as_tensor(y).long()[:, None]))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(_ref_loss(ref, params, x, y)),
                               rtol=1e-5)
    want = _flat(want)
    got = {name.replace(".", "/"): p.grad.numpy() for name, p in layer.named_parameters()}
    assert set(got) == set(want)
    for k, w in want.items():
        tol = GRAD_RTOL * float(np.abs(w).max())
        err = float(np.abs(got[k] - w).max())
        assert err <= tol, f"grad {k}: max|d| {err} > {tol}"
    assert np.abs(want["map_logits"]).max() > 0            # the softmax path
    w = np.asarray(want_x)
    assert float(np.abs(xt.grad.numpy() - w).max()) <= GRAD_RTOL * float(np.abs(w).max())


def test_mapping_logits_learn_through_the_softmax_path_only():
    """The logits' gradient is the leaves' gradient at the hard (gathered)
    inputs, pulled back through the soft einsum alone: argmax and the
    gather contribute nothing."""
    from repro_torch.core.nla_baseline import _mlp_apply

    layer = NLALayer(8, 3, device="cpu", generator=torch.Generator().manual_seed(3))
    x = torch.randn(16, 8, generator=torch.Generator().manual_seed(4))
    out, _ = layer(x)
    got = torch.autograd.grad(out.square().sum(), layer.map_logits)[0]
    idx = torch.argmax(layer.map_logits, -1)
    h = x[:, idx.reshape(-1)].reshape(16, -1, layer.fan_in).requires_grad_(True)
    leaf = _mlp_apply(layer.leaf, h, layer.mlp_depth).reshape(16, 3, layer.n_leaves)
    y = _mlp_apply(layer.root, leaf, layer.mlp_depth)
    dh = torch.autograd.grad(y.square().sum(), h)[0]
    soft = torch.einsum("bi,nfi->bnf", x, torch.softmax(layer.map_logits, -1))
    want = torch.autograd.grad(soft, layer.map_logits, grad_outputs=dh)[0]
    assert float(want.abs().max()) > 0
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6 * float(want.abs().max()))


@pytest.mark.parametrize("c_in,c_out", SHAPES)
def test_numpy_round_trip(c_in, c_out):
    params = _ref_params(RefNLALayer(c_in, c_out), 20 + c_in)
    layer = _port(c_in, c_out, params)
    back = _flat(interop.nla_params_to_numpy(layer))
    for k, v in _flat(params).items():
        np.testing.assert_array_equal(back[k], v)
    bad = dict(params, map_logits=params["map_logits"][:, :, :-1])
    with pytest.raises(ValueError, match="map_logits"):
        _port(c_in, c_out, bad)
    with pytest.raises(KeyError, match="missing"):
        _port(c_in, c_out, {k: v for k, v in params.items() if k != "root"})
    with pytest.raises(TypeError):
        interop.nla_params_to_numpy(torch.nn.Linear(2, 2))
