"""Port parity for the training slice: β schedule and EBOPs helpers, Adam
with cosine restarts, the LUT-Dense train forward, and whole train steps of
the JSC-HLF stack (16 -> 20 with BN -> 5, H = 8) against the JAX package.

The reference step is the JAX *einsum* step (``lut_use_fused=False``): the
Pallas backward does not run under the installed JAX (ROADMAP C1).  The
port's fused step (B2 forward, B3 backward on the card; their plain
versions here) and its einsum step are both held against it.

Tolerances, and why:
* XLA's einsum and torch's index-order sum over the hidden axis, and the two
  CPU ``tanh``s, differ in the last ulps of a cell's pre-quantization value,
  so a value on a rounding boundary of its grid may take the neighbouring
  code.  Each comparison counts such flipped cells (at most ``FLIP_FRAC`` of
  them); a flipped cell moves its row's gradient terms, which is allowed as
  ``FLIP_ATOL`` of absolute error per flip.
* Otherwise gradients hold to ``GRAD_RTOL`` of their tensor's largest
  magnitude plus ``GRAD_ATOL`` (float32 sums in another order; ``l0/b_out``
  has an exactly-zero gradient under train-mode BN, so it is all noise:
  ``ZERO_GRAD``).
* Adam's first steps move a parameter by about ``sign(g)·lr``, so an element
  whose gradient is within noise of 0 (at some step, no larger than
  ``GRAD_RTOL`` of its tensor's largest, or the two packages' gradients
  differ by more than ``NOISE_REL`` of it) may land up to ``2·lr`` per step apart.  Those
  elements are counted (measured: 2.5% of them after one step, 6% after
  three; at most ``NOISY_FRAC_PER_STEP`` a step is allowed) and held to that
  bound; every other updated parameter holds to ``PARAM_ATOL`` plus 1e-3 of
  itself, and the Adam moments likewise.
* The batch mean of layer 0's cells carries ``l0/b_out`` one for one (it is
  added to every row), and that bias moves by noise in both packages (see
  ``ZERO_GRAD``), so the moving mean is compared after taking out the two
  runs' ``b_out`` gap, step by step as the moving average took it in
  (``_walk_steps``' ``bn_shift``); the variance does not see the bias.
"""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ebops as ref_ebops
from repro.core.lut_layers import LUTDense as RefLUTDense
from repro.core.quant import fake_quant as ref_fake_quant
from repro.nn.base import merge_aux as ref_merge_aux
from repro.nn.base import scoped_updates as ref_scoped_updates
from repro.optim import adam as ref_adam
from repro.train.steps import TrainHParams as RefHParams
from repro.train.steps import make_lut_train_step as ref_make_step
from repro_torch import interop
from repro_torch.core import ebops as port_ebops
from repro_torch.core.lut_layers import LUTDense
from repro_torch.nn.base import Aux, merge_aux, scoped_updates
from repro_torch.optim import adam as port_adam
from repro_torch.train.steps import TrainHParams, lut_loss_and_grads, make_lut_train_step

torch.set_num_threads(2)

BATCH = 64
HIDDEN = 8
LR = 3e-3
FLIP_FRAC = 2e-3
FLIP_ATOL = 2e-3
GRAD_RTOL = 1e-4
GRAD_ATOL = 2e-6
NOISE_REL = 0.05
PARAM_ATOL = 2e-5
NOISY_FRAC_PER_STEP = 0.03
# train-mode BN subtracts the batch mean, so the layer's output does not
# depend on the bias before it: this gradient is exactly zero in exact
# arithmetic, and both packages return rounding noise (differently under
# jit and eagerly), so all of its elements count as noisy
ZERO_GRAD = ("l0/b_out",)


# ---------------------------------------------------------------- modules
@pytest.mark.parametrize("b0,b1,total", [(5e-7, 1e-4, 600), (5e-7, 1e-3, 1),
                                         (1e-6, None, 10)])
def test_beta_schedule_values(b0, b1, total):
    ref = ref_ebops.BetaSchedule(b0, b1, total)
    port = port_ebops.BetaSchedule(b0, b1, total)
    steps = np.array([0, 1, 7, total // 2, total - 1, total, 3 * total], np.int32)
    want = np.asarray(ref(jnp.asarray(steps)))
    got = port(torch.as_tensor(steps)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=2e-6)   # float32 exp/log ulps


def test_beta_schedule_raise_warning_and_errors():
    for mod in (ref_ebops, port_ebops):
        with pytest.raises(ValueError, match="beta_final=0.0"):
            mod.BetaSchedule(5e-7, 0.0, 10)
        with pytest.warns(UserWarning, match="flooring"):
            s = mod.BetaSchedule(0.0, 1e-4, 10)
        assert s.beta_init == mod.BETA_RAMP_EPS
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            mod.BetaSchedule(0.0, None, 10)          # constant β takes 0
    assert port_ebops.BETA_RAMP_EPS == ref_ebops.BETA_RAMP_EPS
    for args in [(5e-7, None), (5e-7, 0.0), (5e-7, -1.0), (0.0, 1e-3),
                 (-1.0, 1e-3), (5e-7, 1e-3)]:
        assert port_ebops.beta_ramp_error(*args) == ref_ebops.beta_ramp_error(*args)


def test_ebops_mac_np_and_estimate_luts():
    rng = np.random.default_rng(2)
    w = rng.integers(-1, 9, (3, 7, 5)).astype(np.float32)
    a = rng.integers(-1, 9, (3, 7)).astype(np.float32)
    assert float(port_ebops.ebops_mac(torch.as_tensor(w), torch.as_tensor(a))) == \
        float(ref_ebops.ebops_mac(jnp.asarray(w), jnp.asarray(a)))
    m, n = w[0], w[1]
    assert port_ebops.ebops_lut_np(m, n) == ref_ebops.ebops_lut_np(m, n)
    for e in (0.0, -3.0, 1.0, 26880.0, 1e7):
        assert port_ebops.estimate_luts(e) == ref_ebops.estimate_luts(e)


def test_aux_helpers():
    a = Aux(ebops=torch.tensor(2.0), aux_loss=torch.tensor(0.5), updates={"bn_mean": 1})
    b = Aux(ebops=torch.tensor(3.0), updates={"bn_var": 2})
    m = merge_aux(scoped_updates("l0", a), scoped_updates("l1", b))
    assert float(m.ebops) == 5.0 and float(m.aux_loss) == 0.5
    assert m.updates == {"l0/bn_mean": 1, "l1/bn_var": 2}
    z = Aux.zero("cpu")
    assert float(z.ebops) == 0.0 and z.ebops.dtype == torch.float32
    assert merge_aux().ebops == 0.0


@pytest.mark.parametrize("t_mult,wd", [(2, 0.1), (1, 0.0)])
def test_adam_update_several_steps(t_mult, wd):
    """Same gradients into both optimizers for 6 steps: clipping active,
    weight decay on (masked by path), warm-up and a restart inside."""
    rng = np.random.default_rng(t_mult)
    shapes = {"l0/w0": (4, 3, 2), "l0/b0": (4, 3, 2), "l0/q_in/f": (4, 3),
              "l1/w_out": (3, 2, 2), "l1/bn_scale": (3, 2), "l1/norm_g": (5,)}
    params = {k: rng.normal(0, 1, s).astype(np.float32) for k, s in shapes.items()}
    cfg = dict(lr=LR, b1=0.9, b2=0.95, eps=1e-8, weight_decay=wd, clip_norm=1.0)
    rs = ref_adam.cosine_restarts(LR, first_period=2, t_mult=t_mult, warmup=2)
    ps = port_adam.cosine_restarts(LR, first_period=2, t_mult=t_mult, warmup=2)

    def nest(d):
        out = {}
        for k, v in d.items():
            node = out
            *head, last = k.split("/")
            for h in head:
                node = node.setdefault(h, {})
            node[last] = jnp.asarray(v)
        return out

    rp, ro = nest(params), ref_adam.adam_init(nest(params))
    pp = {k: torch.as_tensor(v) for k, v in params.items()}
    po = port_adam.adam_init(pp)
    for step in range(6):
        grads = {k: rng.normal(0, 3, s).astype(np.float32) for k, s in shapes.items()}
        rp, ro, rm = ref_adam.adam_update(rp, nest(grads), ro,
                                          ref_adam.AdamConfig(**cfg), rs)
        pp, po, pm = port_adam.adam_update(pp, {k: torch.as_tensor(v) for k, v in grads.items()},
                                           po, port_adam.AdamConfig(**cfg), ps)
        assert int(po["step"]) == int(ro["step"]) == step + 1
        np.testing.assert_allclose(float(pm["lr"]), float(rm["lr"]), rtol=1e-6)
        np.testing.assert_allclose(float(pm["grad_norm"]), float(rm["grad_norm"]), rtol=1e-6)
        assert float(rm["grad_norm"]) > 1.0                 # clipping was active
        for name, got, want in (("p", pp, rp), ("m", po["m"], ro["m"]),
                                ("v", po["v"], ro["v"])):
            for k in shapes:
                np.testing.assert_allclose(got[k].numpy(), _leaf(want, k), rtol=2e-6,
                                           atol=1e-7, err_msg=f"{name} {k}")


def test_decay_mask_uses_reference_paths():
    for path in ("l0/w0", "l0/w_out", "l1/b0", "l1/q_out/f", "l0/bn_scale",
                 "l0/b_out", "blocks/norm/scale", "l2/w1"):
        assert port_adam._decay_mask(path) == ref_adam._decay_mask(path)
    assert port_adam._decay_mask("l0/q_in/f") == 0.0
    assert port_adam._decay_mask("l0.q_in.f") == 0.0      # substring, like the reference
    assert port_adam.NO_DECAY_KEYS == ref_adam.NO_DECAY_KEYS


# -------------------------------------------------------- stack fixtures
def _ref_layers():
    return [RefLUTDense(16, 20, hidden=HIDDEN, use_batchnorm=True),
            RefLUTDense(20, 5, hidden=HIDDEN)]


def _ref_params(seed):
    """Reference init with heterogeneous widths, biases and BN state."""
    rng = np.random.default_rng(seed)
    ks = jax.random.split(jax.random.PRNGKey(seed), 2)
    out = {}
    for k, (layer, key) in enumerate(zip(_ref_layers(), ks)):
        p = jax.tree_util.tree_map(np.asarray, layer.init(key))
        grid = (layer.c_in, layer.c_out)
        p["q_in"] = {"f": rng.integers(2, 6, grid) + rng.uniform(-0.3, 0.3, grid),
                     "i": rng.integers(1, 4, grid) + rng.uniform(-0.3, 0.3, grid)}
        p["q_out"] = {"f": rng.integers(2, 6, grid) + rng.uniform(-0.3, 0.3, grid),
                      "i": rng.integers(0, 3, grid) + rng.uniform(-0.3, 0.3, grid)}
        p["q_out"]["f"][0, :3] = [-8.0, 12.0, 6.0]        # on the clip bounds
        p["b_out"] = rng.normal(0, 0.2, grid)
        if layer.use_batchnorm:
            p["bn_scale"] = rng.uniform(0.5, 1.5, grid)
            p["bn_bias"] = rng.normal(0, 0.3, grid)
            p["bn_mean"] = rng.normal(0, 0.3, grid)
            p["bn_var"] = rng.uniform(0.2, 2.0, grid)
        out[f"l{k}"] = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), p)
    return out


def _batch(seed, n=BATCH):
    rng = np.random.default_rng(seed + 1000)
    x = np.round(rng.normal(0, 2, (n, 16)) * 16) / 16      # f=4 input grid
    return x.astype(np.float32), rng.integers(0, 5, n).astype(np.int32)


def _port_layers(params):
    layers = [LUTDense(16, 20, hidden=HIDDEN, use_batchnorm=True, device="cpu",
                       generator=torch.Generator().manual_seed(0)),
              LUTDense(20, 5, hidden=HIDDEN, device="cpu",
                       generator=torch.Generator().manual_seed(1))]
    return interop.stack_params_from_numpy(layers, params)


def _leaf(tree, path):
    node = tree
    for k in path.split("/"):
        node = node[k]
    return np.asarray(node)


def _cell_codes_ref(layers, params, x):
    """Per-cell SAT output values of each layer's train forward (JAX)."""
    codes, h = [], jnp.asarray(x)
    for k, layer in enumerate(layers):
        p = jax.tree_util.tree_map(jnp.asarray, params[f"l{k}"])
        xb = jnp.broadcast_to(h[..., :, None], h.shape + (layer.c_out,))
        y = layer.cell_mlp(p, ref_fake_quant(p["q_in"], xb, layer.q_in))
        if layer.use_batchnorm:
            y = (y - jnp.mean(y, 0)) * jax.lax.rsqrt(jnp.var(y, 0) + 1e-5) \
                * p["bn_scale"] + p["bn_bias"]
        yq = ref_fake_quant(p["q_out"], y, layer.q_out)
        codes.append(np.asarray(yq))
        h = jnp.sum(yq, axis=-2)
    return codes


def _cell_codes_port(layers, x):
    codes, h = [], torch.as_tensor(x)
    with torch.no_grad():
        for layer in layers:
            yq, _ = layer._cells(h, True)
            codes.append(yq.numpy())
            h = torch.sum(yq, dim=-2)
    return codes


def _n_flips(ref_params, port_layers, x):
    want = _cell_codes_ref(_ref_layers(), ref_params, x)
    got = _cell_codes_port(port_layers, x)
    n = sum(int((a != b).sum()) for a, b in zip(got, want))
    cells = sum(a.size for a in want)
    assert n <= FLIP_FRAC * cells, f"{n} of {cells} cells flipped"
    return n


def _ref_loss_and_grads(params, x, y, beta, step):
    layers = _ref_layers()

    def loss_fn(ps):
        h, auxes = jnp.asarray(x), []
        for idx, layer in enumerate(layers):
            h, a = layer.apply(ps[f"l{idx}"], h, train=True)
            auxes.append(ref_scoped_updates(f"l{idx}", a))
        aux = ref_merge_aux(*auxes)
        ce = -jnp.mean(jax.nn.log_softmax(h)[jnp.arange(h.shape[0]), jnp.asarray(y)])
        return ce + beta(step) * aux.ebops, (ce, aux)

    (loss, (ce, aux)), g = jax.value_and_grad(loss_fn, has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, params))
    return float(loss), float(ce), float(aux.ebops), g


def _check_grads(got, want_tree, n_flips):
    for path, g in got.items():
        w = _leaf(want_tree, path)
        tol = GRAD_RTOL * float(np.abs(w).max()) + GRAD_ATOL + FLIP_ATOL * n_flips
        err = float(np.abs(g.detach().numpy() - w).max())
        assert err <= tol, f"grad {path}: max|d| {err} > {tol}"


# ------------------------------------------------------ layer train forward
@pytest.mark.parametrize("layer_idx,fused", [(0, False), (0, True), (1, False), (1, True)])
def test_lut_dense_train_forward(layer_idx, fused):
    """Outputs, BN ``Aux.updates`` and EBOPs of ``LUTDense`` in train mode
    against ``repro`` ``LUTDense.apply(train=True)``.  Layer 0 has BN, so
    ``fused`` takes the batch-statistics pair there, folded into the fused
    pair (their plain versions on the CPU); the reference's einsum path
    computes the same statistics."""
    params = _ref_params(3)
    ref_layer = _ref_layers()[layer_idx]
    p = params[f"l{layer_idx}"]
    x = np.random.default_rng(9).normal(0, 2, (BATCH, ref_layer.c_in)).astype(np.float32)
    want, aux = ref_layer.apply(jax.tree_util.tree_map(jnp.asarray, p), jnp.asarray(x),
                                train=True)
    layer = _port_layers(params)[layer_idx]
    layer.train(True)
    got, paux = layer(torch.as_tensor(x), fused=fused)
    step = 2.0 ** -float(np.round(np.clip(p["q_out"]["f"], -8, 12)).max())
    d = np.abs(got.detach().numpy() - np.asarray(want))
    # each output is a sum of C_in cell codes; a flipped cell moves it by a
    # step of that cell's grid, at most 2^-min(f) and at least the finest
    assert (d == 0).mean() >= 1 - FLIP_FRAC * ref_layer.c_in
    assert float(paux.ebops.detach()) == pytest.approx(float(aux.ebops), rel=1e-6)
    assert set(paux.updates) == set(aux.updates)
    for k in aux.updates:
        np.testing.assert_allclose(paux.updates[k].numpy(), np.asarray(aux.updates[k]),
                                   rtol=1e-5, atol=1e-6)
    if layer_idx == 0:
        assert set(paux.updates) == {"bn_mean", "bn_var"}
    assert step > 0


# ----------------------------------------------------------- whole steps
def _hparams(fused, n_steps):
    """The quickstart's Adam, cosine and β settings over ``n_steps``, for the
    reference and the port."""
    beta_args = (5e-7, 1e-4, n_steps)
    sched_args = dict(first_period=max(n_steps // 2, 1), warmup=min(30, n_steps // 2))
    rhp = RefHParams(adam=ref_adam.AdamConfig(lr=LR), beta=ref_ebops.BetaSchedule(*beta_args),
                     lr_schedule=ref_adam.cosine_restarts(LR, **sched_args))
    php = TrainHParams(adam=port_adam.AdamConfig(lr=LR),
                       beta=port_ebops.BetaSchedule(*beta_args),
                       lr_schedule=port_adam.cosine_restarts(LR, **sched_args),
                       lut_use_fused=fused)
    return rhp, php


def _walk_steps(params, rhp, php, batches):
    """The reference's einsum step and the port's step side by side from
    ``params``, one step per ``(x, y)`` of ``batches``, each step's gradients
    and metrics checked.  Returns ``(rp, ro, layers, po, noisy, total_flips,
    bn_shift)``: both packages' states after the last step, the elements
    whose gradient was noise at some step, the cell codes flipped on the
    way, and what the two runs' ``l0/b_out`` gap put into the port's moving
    batch mean beyond the reference's."""
    ref_step, _ = ref_make_step(_ref_layers(), rhp, donate=False)
    layers = _port_layers(params)
    step_fn, init_fn = make_lut_train_step(layers, php)
    assert all(not layer.use_fused for layer in layers)
    rp = jax.tree_util.tree_map(jnp.asarray, params)
    ro = ref_adam.adam_init(rp)
    po = init_fn()
    noisy = {}
    total_flips = 0
    bn_shift = np.zeros_like(params["l0"]["bn_mean"])
    mom = layers[0].bn_momentum
    for s, (x, y) in enumerate(batches):
        batch_r = {"x": jnp.asarray(x), "y": jnp.asarray(y)}
        batch_p = {"x": torch.as_tensor(x), "y": torch.as_tensor(y)}
        rnp = jax.tree_util.tree_map(np.asarray, rp)
        gap = layers[0].b_out.detach().numpy() - rnp["l0"]["b_out"]
        bn_shift = mom * bn_shift + (1 - mom) * gap
        n_flips = _n_flips(rnp, layers, x)
        total_flips += n_flips
        loss, ce, ebops, rg = _ref_loss_and_grads(rnp, x, y, rhp.beta, s)
        ploss, pce, paux, pg = lut_loss_and_grads(layers, php, po["step"], batch_p)
        _check_grads(pg, rg, n_flips)
        for path, g in pg.items():
            w = _leaf(rg, path)
            d = np.abs(g.numpy() - w)
            floor = GRAD_RTOL * float(np.abs(w).max())
            bad = (d > 0) & ((np.abs(w) <= floor) | (d > NOISE_REL * np.abs(w)))
            if path in ZERO_GRAD:
                bad = np.ones_like(bad)
            noisy[path] = noisy.get(path, False) | bad
        rp, ro, rm = ref_step(rp, ro, batch_r)
        po, pm = step_fn(po, batch_p)
        for k, v in (("loss", loss), ("ce", ce), ("ebops", ebops)):
            assert float(rm[k]) == pytest.approx(v, rel=1e-6)
        _check_metrics(pm, rm, n_flips)
    return rp, ro, layers, po, noisy, total_flips, bn_shift


def _check_metrics(pm, rm, n_flips):
    """One step's metrics of the port against the reference's."""
    assert float(pm["loss"]) == pytest.approx(float(rm["loss"]), rel=1e-5, abs=1e-6)
    assert float(pm["ce"]) == pytest.approx(float(rm["ce"]), rel=1e-5, abs=1e-6)
    assert float(pm["ebops"]) == pytest.approx(float(rm["ebops"]), rel=1e-6)
    assert float(pm["lr"]) == pytest.approx(float(rm["lr"]), rel=1e-6)
    assert float(pm["grad_norm"]) == pytest.approx(float(rm["grad_norm"]),
                                                   rel=1e-3 if n_flips else 1e-4)


def _check_final_state(layers, po, rp, ro, noisy, total_flips, n_steps, bn_shift=0.0):
    """The port's parameters, Adam moments and BN stats after ``n_steps``
    against the reference's, within the module's tolerances; ``bn_shift``
    is taken out of the port's moving mean first (``_walk_steps``)."""
    assert int(po["step"]) == int(ro["step"]) == n_steps
    got = interop.stack_params_to_numpy(layers)
    want = jax.tree_util.tree_map(np.asarray, rp)
    got_opt = interop.opt_state_to_numpy(layers, po)
    want_opt = jax.tree_util.tree_map(np.asarray, ro)
    n_noisy = n_total = 0
    lr_bound = 2 * LR * n_steps
    for path in noisy:
        mask = noisy[path]
        if path not in ZERO_GRAD:
            n_noisy += int(mask.sum())
            n_total += mask.size
        for name, a, b, quiet_tol, noisy_tol in (
                ("param", got, want, PARAM_ATOL + FLIP_ATOL * total_flips, lr_bound),
                ("m", got_opt["m"], want_opt["m"], 1e-4 + FLIP_ATOL * total_flips, 1.0),
                ("v", got_opt["v"], want_opt["v"], 1e-5 + FLIP_ATOL * total_flips, 1.0)):
            d = np.abs(_leaf(a, path) - _leaf(b, path))
            w = np.abs(_leaf(b, path))
            tol = np.where(mask, noisy_tol, quiet_tol + 1e-3 * w)
            bad = np.argwhere(d > tol)[:5]
            assert (d <= tol).all(), (f"{name} {path}: max|d| {d.max()} at "
                                      f"{bad.tolist()}: {d[tuple(bad.T)]} > {tol[tuple(bad.T)]}")
    # BN moving stats: written after Adam, from the batch statistics
    for key, shift in (("bn_mean", bn_shift), ("bn_var", 0.0)):
        np.testing.assert_allclose(got["l0"][key] - shift, want["l0"][key], rtol=1e-5,
                                   atol=1e-6 + FLIP_ATOL * total_flips)
        assert not want_opt["m"]["l0"][key].any() and not got_opt["m"]["l0"][key].any()
    # the noisy elements are few: a share of the near-zero gradients, which
    # grows as the two runs' parameters drift apart by up to 2·lr a step
    print(f"noisy elements after {n_steps} step(s): {n_noisy} of {n_total}")
    assert n_noisy <= NOISY_FRAC_PER_STEP * n_steps * n_total, (f"{n_noisy} of {n_total} elements noisy: "
                                       f"{ {k: int(v.sum()) for k, v in noisy.items()} }")


@pytest.mark.parametrize("n_steps", [1, 3])
@pytest.mark.parametrize("fused", [False, True], ids=["einsum", "fused"])
def test_train_steps_match_reference_einsum_step(fused, n_steps):
    seed = 5
    params = _ref_params(seed)
    rhp, php = _hparams(fused, n_steps)
    x, y = _batch(seed)
    rp, ro, layers, po, noisy, total_flips, bn_shift = _walk_steps(params, rhp, php,
                                                                   [(x, y)] * n_steps)
    _check_final_state(layers, po, rp, ro, noisy, total_flips, n_steps, bn_shift)


# ------------------------------------------------------------------ interop
def test_interop_round_trip_stack_and_opt_state():
    params = _ref_params(8)
    rng = np.random.default_rng(8)
    opt = ref_adam.adam_init(jax.tree_util.tree_map(jnp.asarray, params))
    opt = {"m": jax.tree_util.tree_map(lambda a: rng.normal(0, 1, a.shape).astype(np.float32),
                                       opt["m"]),
           "v": jax.tree_util.tree_map(lambda a: rng.uniform(0, 1, a.shape).astype(np.float32),
                                       opt["v"]),
           "step": np.int32(17)}
    for k in ("bn_mean", "bn_var"):                 # zero in the reference
        opt["m"]["l0"][k][:] = 0.0
        opt["v"]["l0"][k][:] = 0.0
    layers = _port_layers(params)
    back = interop.stack_params_to_numpy(layers)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(params)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(a, b)
    po = interop.opt_state_from_numpy(layers, opt)
    assert int(po["step"]) == 17 and po["step"].dtype == torch.int32
    assert "l0/bn_mean" not in po["m"] and "l0/q_in/f" in po["m"]
    back = interop.opt_state_to_numpy(layers, po)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(opt)
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(opt)):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(KeyError):
        interop.stack_params_from_numpy(layers, {"l0": params["l0"]})


# ---------------------------------------------------------------- quickstart
def test_quickstart_smoke_runs_to_the_end_on_cpu(capsys, tmp_path):
    from repro_torch.examples import quickstart

    verilog = tmp_path / "model.v"
    out = quickstart.main(["--device", "cpu", "--smoke", "--steps", "3",
                           "--verilog", str(verilog)])
    assert out["exact"] == 0.0 and out["steps"] == 3
    assert out["path"] == "pallas" and out["served"] == 500
    assert out["lint"]["ok"] and out["lint"]["dce_validated"]
    assert out["rtl"]["verdict"] == "bit-exact" and out["rtl"]["engine_path"] == "pallas"
    assert verilog.read_text().startswith("module hgq_lut_model")
    text = capsys.readouterr().out
    assert "BIT-EXACT" in text and "RTL simulation: bit-exact three ways" in text
