"""Port parity for the HGQ layers: ``HGQDense`` and ``HGQConv1D`` eval and
train forwards, EBOPs and gradients, their carriers in ``interop``, and
their lowerings (``_lower_hgq_dense`` / ``_lower_hgq_conv1d`` through
``core.dais.compile_sequential`` and ``core.lower.lower``), against the JAX
package.

The same reference parameters (``repro.core.hgq_layers`` ``init``, with
heterogeneous widths, carried as numpy) and the same numpy inputs go through
both packages.

Tolerances, and why:
* The quantizers are the same projection in both packages (kernel B1's
  plain version, held bit for bit in ``test_torch_fake_quant.py``), so
  ``xq`` and ``wq`` are equal and no code flips.  ``xq @ wq`` sums its
  products in another order than XLA's: outputs hold to ``OUT_RTOL`` of
  their largest magnitude.  EBOPs are sums of integer width products:
  equal.
* Gradients hold to ``GRAD_RTOL`` of their tensor's largest magnitude plus
  ``GRAD_ATOL`` (float32 sums in another order).
* The lowering is integer: program arrays identical.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import hgq_layers as ref_hgq
from repro.core.dais import DaisProgram as RefDaisProgram
from repro.core.dais import compile_sequential as ref_compile_sequential
from repro.core.lower import GraphInput as RefGraphInput
from repro.core.lower import ModelGraph as RefModelGraph
from repro.core.lower import lower as ref_lower
from repro_torch.core import lower as port_lower
from repro_torch.core.dais import compile_sequential
from repro_torch.core.hgq_layers import QA_DEFAULT, QW_DEFAULT, HGQConv1D, HGQDense
from repro_torch.interop import (hgq_dense_params_from_numpy,
                                 hgq_dense_params_to_numpy,
                                 layer_params_from_numpy)

torch.set_num_threads(2)

OUT_RTOL = 1e-6
GRAD_RTOL = 1e-5
GRAD_ATOL = 1e-6

LAYERS = {
    "dense": (dict(c_in=12, c_out=5), (32, 12)),
    "dense_relu": (dict(c_in=7, c_out=6, activation="relu"), (4, 9, 7)),
    "dense_tanh_nobias": (dict(c_in=5, c_out=3, activation="tanh", use_bias=False),
                          (40, 5)),
    "conv_front": (dict(c_in=1, c_out=8, kernel=20, stride=20, activation="relu"),
                   (16, 200, 1)),
    "conv_same": (dict(c_in=3, c_out=4, kernel=3, stride=2, padding="SAME"),
                  (16, 13, 3)),
}


def _ref_params(ref_dense, seed):
    """Reference init with heterogeneous widths and a non-zero bias."""
    p = jax.tree_util.tree_map(np.asarray, ref_dense.init(jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    wg, ag = p["q_w"]["f"].shape, p["q_a"]["f"].shape
    p["q_w"] = {"f": rng.integers(3, 8, wg) + rng.uniform(-0.3, 0.3, wg),
                "i": rng.integers(0, 2, wg) + rng.uniform(-0.3, 0.3, wg)}
    p["q_a"] = {"f": rng.integers(3, 7, ag) + rng.uniform(-0.3, 0.3, ag),
                "i": rng.integers(1, 4, ag) + rng.uniform(-0.3, 0.3, ag)}
    p["q_w"]["f"][0, :2] = [-8.0, 12.0]                 # on the clip bounds
    if "b" in p:
        p["b"] = rng.normal(0, 0.3, p["b"].shape)
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), p)


def _pair(name, seed):
    kw, x_shape = LAYERS[name]
    if name.startswith("conv"):
        ref = ref_hgq.HGQConv1D(**kw)
        port = HGQConv1D(device="cpu", generator=torch.Generator().manual_seed(seed), **kw)
    else:
        ref = ref_hgq.HGQDense(**kw)
        port = HGQDense(device="cpu", generator=torch.Generator().manual_seed(seed), **kw)
    p = _ref_params(ref.dense if name.startswith("conv") else ref, seed)
    layer_params_from_numpy(port, p)
    x = np.random.default_rng(seed + 1).normal(0, 2, x_shape).astype(np.float32)
    return ref, p, port, x


def test_default_quantizers_match_reference():
    for mine, want in ((QW_DEFAULT, ref_hgq.QW_DEFAULT), (QA_DEFAULT, ref_hgq.QA_DEFAULT)):
        assert dataclasses.asdict(mine) == dataclasses.asdict(want)


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_init_shapes_and_keys_match_reference(name):
    ref, p, port, _x = _pair(name, seed=0)
    fresh = jax.tree_util.tree_map(np.asarray, (ref.dense if name.startswith("conv")
                                                else ref).init(jax.random.PRNGKey(0)))
    dense = getattr(port, "dense", port)
    back = hgq_dense_params_to_numpy(dense)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(fresh)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(p)):
        np.testing.assert_array_equal(a, b)
    gen = torch.Generator().manual_seed(0)
    new = HGQDense(dense.c_in, dense.c_out, dense.use_bias, device="cpu", generator=gen)
    assert float(new.w.detach().std()) == pytest.approx(dense.c_in ** -0.5, rel=0.5)
    for k, v in hgq_dense_params_to_numpy(new).items():
        want = fresh[k]
        if isinstance(v, dict):
            for s in v:
                np.testing.assert_array_equal(v[s], want[s])      # init widths
        else:
            assert v.shape == want.shape


@pytest.mark.parametrize("name", sorted(LAYERS))
@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_forward_and_ebops_match_reference(name, train):
    ref, p, port, x = _pair(name, seed=2)
    want, aux = ref.apply(jax.tree_util.tree_map(jnp.asarray, p), jnp.asarray(x),
                          train=train)
    port.train(train)
    with torch.no_grad():
        got, paux = port(torch.as_tensor(x))
    want = np.asarray(want)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=OUT_RTOL * float(np.abs(want).max()))
    assert float(paux.ebops) == float(aux.ebops)
    assert paux.updates == {}


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_train_gradients_match_reference(name):
    """Gradients of sum(y * r) + 1e-4 * EBOPs, every parameter: ``w``,
    ``b`` and the four bit-width tensors."""
    ref, p, port, x = _pair(name, seed=4)
    pj = jax.tree_util.tree_map(jnp.asarray, p)
    y0, _ = ref.apply(pj, jnp.asarray(x), train=True)
    r = np.random.default_rng(5).normal(0, 1, y0.shape).astype(np.float32)

    def loss(params):
        y, aux = ref.apply(params, jnp.asarray(x), train=True)
        return jnp.sum(y * r) + 1e-4 * aux.ebops

    want = jax.grad(loss)(pj)
    port.train(True)
    y, aux = port(torch.as_tensor(x))
    total = torch.sum(y * torch.as_tensor(r)) + 1e-4 * aux.ebops
    dense = getattr(port, "dense", port)
    names = [n for n, _ in dense.named_parameters()]
    assert sorted(names) == sorted(
        f"{k}.{s}" if isinstance(v, dict) else k for k, v in p.items()
        for s in (v if isinstance(v, dict) else [None]))
    grads = torch.autograd.grad(total, list(dense.parameters()))
    for n, g in zip(names, grads):
        key, _, sub = n.partition(".")
        w = np.asarray(want[key][sub] if sub else want[key])
        tol = GRAD_RTOL * float(np.abs(w).max()) + GRAD_ATOL
        err = float(np.abs(g.numpy() - w).max())
        assert err <= tol, f"grad {n}: max|d| {err} > {tol}"


def test_carrier_checks_keys_types_and_shapes():
    _ref, p, port, _x = _pair("dense", seed=1)
    with pytest.raises(KeyError):
        hgq_dense_params_from_numpy(port, {k: v for k, v in p.items() if k != "b"})
    with pytest.raises(ValueError):
        hgq_dense_params_from_numpy(port, dict(p, w=p["w"][:, :2]))
    with pytest.raises(TypeError):
        hgq_dense_params_from_numpy(torch.nn.Linear(2, 2), p)


def test_fused_flag_is_accepted_and_changes_nothing():
    _ref, _p, port, x = _pair("conv_front", seed=3)
    a, _ = port(torch.as_tensor(x))
    b, _ = port(torch.as_tensor(x), fused=True)
    assert torch.equal(a, b)


# --------------------------------------------------------------- lowering
def _assert_arrays_equal(got, want):
    a, b = got.to_arrays(), want.to_arrays()
    assert sorted(a) == sorted(b)
    for k in b:
        assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("names", [("dense",), ("dense_relu_flat", "dense2")])
def test_compile_sequential_identical(names):
    """HGQ dense stacks through ``core.dais.compile_sequential`` (the
    reference's wrapper, kept in the port): identical program arrays, and
    the programs agree on random codes."""
    specs = {"dense": dict(c_in=12, c_out=5),
             "dense_relu_flat": dict(c_in=6, c_out=7, activation="relu"),
             "dense2": dict(c_in=7, c_out=3)}
    refs, ports, params = [], [], []
    for k, n in enumerate(names):
        ref = ref_hgq.HGQDense(**specs[n])
        p = _ref_params(ref, seed=10 + k)
        port = HGQDense(device="cpu", generator=torch.Generator().manual_seed(k),
                        **specs[n])
        hgq_dense_params_from_numpy(port, p)
        refs.append(ref)
        ports.append(port)
        params.append(jax.tree_util.tree_map(jnp.asarray, p))
    want = ref_compile_sequential(refs, params, 3, 2)
    got = compile_sequential(ports, 3, 2)
    _assert_arrays_equal(got, want)
    codes = np.random.default_rng(0).integers(-32, 32, (256, specs[names[0]]["c_in"]))
    np.testing.assert_array_equal(got.run(codes), want.run(codes))


@pytest.mark.parametrize("name", ["conv_front", "conv_same", "dense_relu"])
def test_lowering_identical_and_close_to_the_forward(name):
    """One HGQ layer lowered by both packages: identical program arrays; the
    program's float output and the port's eval forward differ only by the
    bias rounding onto the output grid."""
    ref, p, port, x = _pair(name, seed=6)
    shape = LAYERS[name][1][1:]
    gi = dict(shape=shape, f=6, i=2)
    want = ref_lower(RefModelGraph(RefGraphInput(**gi), [ref]),
                     [jax.tree_util.tree_map(jnp.asarray, p)])
    got = port_lower.lower(port_lower.ModelGraph(port_lower.GraphInput(**gi), [port]))
    _assert_arrays_equal(got, want)
    assert {s.kind for s in got.segments} == {"hgq"}
    xg = np.round(np.clip(x, -4, 4 - 2 ** -6) * 64) / 64          # the input grid
    port.eval()
    with torch.no_grad():
        y, _ = port(torch.as_tensor(xg.astype(np.float32)))
    flat = xg.reshape(xg.shape[0], -1)
    prog_y = got.run_float(flat).reshape(y.shape)
    f_out = np.asarray(got.output_f).reshape(y.shape[1:])
    assert np.all(np.abs(prog_y - y.numpy()) <= 2.0 ** -f_out + 1e-6)
    codes = np.round(flat * 64).astype(np.int64)
    np.testing.assert_array_equal(
        got.run(codes), RefDaisProgram.from_arrays(got.to_arrays()).run(codes))
